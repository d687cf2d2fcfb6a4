"""The port's WidebandReceiver against the JAX package's on the CPU where
the DQPSK loop's window is W = 20, and with no decoder named.

* 25 kHz channels (``channel_bandwidth=25000.0``): a 50 kHz channel rate,
  so C4FM and DMR (4800 Bd) run the DQPSK loop at W = floor(2 * 50000 /
  4800) = 20, a width the card's kernel takes since its lane layout and
  ring follow W. Two channels of random dibits at +75 and -125 kHz of an
  800 kHz capture through ``build()`` (about 8900 samples a channel):
  ``valid`` exact, the dibits under it exact, the front end's carried
  state (FIR, AGC, power) within 1e-5, and the DQPSK loop's state within
  the bound stated per decoder below. The loop is chaotic (tests/
  test_torch_dmr.py): the reference's XLA:CPU contractions differ from
  the port's single roundings by an ulp now and then, and over this block
  the loop carries them to 3.3e-4 (C4FM) and 1.4e-3 (DMR) in the sampling
  point, 4.1e-5 and 1.5e-5 in the window and phase; the DQPSK tests'
  1e-5 holds over their 1024 samples, not here. None is hidden: the
  bounds are the drift this scene shows, rounded up.
* ``WidebandReceiver(fs, offsets)`` with no decoder decodes NBFM, as the
  reference's does: the reference's output keys (audio, audio_gate,
  power_db) and its audio within 1e-4 (tests/test_torch_receiver_static
  .py's NBFM tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrtrunk_tpu.receiver import WidebandReceiver as JWidebandReceiver
from sdrtrunk_tpu.signal import generators
from sdrtrunk_tpu_torch.receiver import WidebandReceiver

torch.set_num_threads(1)

FS = 800000.0
OFFSETS = [75000.0, -125000.0]
FRONT_TOL = 1e-5
# max |loop state - reference| on this scene, per decoder (see above)
LOOP_TOL = {"c4fm": 5e-4, "dmr": 2e-3}
AUDIO_TOL = 1e-4
TONES_HZ = [900.0, 1300.0]


def _capture(modulate, n_sym: int, seed: int) -> np.ndarray:
    """The channels' signals at their offsets, a multiple of 32 samples."""
    wide = None
    for i, off in enumerate(OFFSETS):
        iq = modulate(np.random.default_rng(seed + i).integers(
            0, 4, n_sym).astype(np.uint8))
        if wide is None:
            n = len(iq) // 32 * 32
            wide = np.zeros(n, np.complex64)
        t = np.arange(n) / FS
        wide += (0.5 * iq[:n] * np.exp(2j * np.pi * off * t)
                 ).astype(np.complex64)
    return wide


@pytest.mark.parametrize("decoder", ["c4fm", "dmr"])
def test_25k_channels_equal_reference(decoder):
    rx = WidebandReceiver(FS, OFFSETS, channel_bandwidth=25000.0,
                          decoder=decoder, device="cpu")
    jrx = JWidebandReceiver(FS, OFFSETS, channel_bandwidth=25000.0,
                            decoder=decoder)
    assert rx.channelizer.channel_sample_rate == 50000.0
    assert rx.decoder.demod.window_len == jrx.decoder.demod.window_len == 20
    wide = _capture(lambda d: generators.c4fm_modulate(d, FS), 860, 1)
    out, state = rx.build()(torch.as_tensor(wide), rx.init_state())
    jout, jstate = jrx.build()(jnp.asarray(wide), jrx.init_state())
    valid, jvalid = out["valid"].numpy(), np.asarray(jout["valid"])
    np.testing.assert_array_equal(valid, jvalid)
    assert valid.sum(1).min() > 750                  # symbols on both
    np.testing.assert_array_equal(out["dibits"].numpy()[valid],
                                  np.asarray(jout["dibits"])[jvalid])
    for key in ("fir", "agc", "power"):
        np.testing.assert_allclose(state["dec"][key].numpy(),
                                   np.asarray(jstate["dec"][key]), rtol=0,
                                   atol=FRONT_TOL, err_msg=key)
    psk, jpsk = state["dec"]["psk"], jstate["dec"]["psk"]
    for name in type(psk)._fields:
        got = getattr(psk, name).numpy()
        want = np.asarray(getattr(jpsk, name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=LOOP_TOL[decoder], err_msg=name)


def test_default_decoder_is_nbfm():
    wide = None
    for off, hz in zip(OFFSETS, TONES_HZ):
        tone = np.sin(2 * np.pi * hz * np.arange(2000) / 8000.0)
        iq = generators.nbfm_modulate(tone, 8000.0, FS)
        if wide is None:
            n = len(iq) // 32 * 32
            wide = np.zeros(n, np.complex64)
        t = np.arange(n) / FS
        wide += (0.5 * iq[:n] * np.exp(2j * np.pi * off * t)
                 ).astype(np.complex64)
    rx = WidebandReceiver(FS, OFFSETS, device="cpu")
    jrx = JWidebandReceiver(FS, OFFSETS)
    out, _ = rx.build()(torch.as_tensor(wide), rx.init_state())
    jout, _ = jrx.build()(jnp.asarray(wide), jrx.init_state())
    assert sorted(out) == sorted(jout) == ["audio", "audio_gate", "power_db"]
    np.testing.assert_allclose(out["audio"].numpy(),
                               np.asarray(jout["audio"]), rtol=0,
                               atol=AUDIO_TOL)
    np.testing.assert_array_equal(out["audio_gate"].numpy(),
                                  np.asarray(jout["audio_gate"]))
    for audio, hz in zip(out["audio"].numpy(), TONES_HZ):
        f = np.fft.rfftfreq(len(audio) - 800, 1 / 8000)
        assert f[np.argmax(np.abs(np.fft.rfft(audio[800:])))] == \
            pytest.approx(hz, abs=20.0)
