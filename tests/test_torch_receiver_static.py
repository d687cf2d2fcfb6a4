"""The port's static receiver, ``WidebandReceiver.build()``, against the JAX
package's on the CPU.

``build()`` fixes the channel plan (``plan_channels`` of the offsets and
``channel_bandwidths``: a bin per channel, or the adjacent pair joined by
the two-bin synthesizer for a channel wider than one bin) and runs
``build_dynamic()``'s step over it, so on the same plan the two give the
same outputs and state bit for bit (held here on a plan of single-bin and
wide channels). Against the reference:

* tests/test_receiver_digital.py's scene, three P25 TSBK channels in a
  64-bin capture with 32 channels planned: the port frames the same two
  TSBKs on each active channel and none on idle ones, and its dibits and
  valid equal the reference's ``build()`` exactly on the active channels
  (the idle ones carry only leakage, whose symbol decisions are noise);
* tests/test_twobin.py's 25 kHz NBFM channel between two 12.5 kHz bins,
  with a decoder object in place of a name: the plan is the reference's,
  the tone comes out within 20 Hz, and the audio equals the reference's
  within 1e-4 (tests/test_torch_per_channel.py's audio tolerance);
* the plan (bins, residual offsets, wide mask, rate) equals the
  reference's on a mixed plan, and more than two bins is refused.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrtrunk_tpu.decoders.nbfm import NBFMConfig as JNBFMConfig
from sdrtrunk_tpu.decoders.nbfm import NBFMDecoder as JNBFMDecoder
from sdrtrunk_tpu.protocol.p25p1.framer import P25P1FrameAssembler
from sdrtrunk_tpu.receiver import WidebandReceiver as JWidebandReceiver
from sdrtrunk_tpu.signal import generators
from sdrtrunk_tpu_torch.decoders.nbfm import NBFMConfig, NBFMDecoder
from sdrtrunk_tpu_torch.protocol.p25p1.framer import P25P1Framer
from sdrtrunk_tpu_torch.protocol.p25p1.messages import decode_frame
from sdrtrunk_tpu_torch.receiver import WidebandReceiver
from sdrtrunk_tpu_torch.tree import tree_leaves
from test_receiver_digital import _tx_dibits

torch.set_num_threads(1)

TWO_BIN_FS = 32 * 12500.0
AUDIO_TOL = 1e-4


def _c4fm_scene():
    """tests/test_receiver_digital.py's capture: (fs, offsets, wide IQ,
    {channel: (dibits, opcode, args)})."""
    m = 64
    fs = m * 12500.0
    actives = {5: 0x3B, 17: 0x3A, 29: 0x00}
    offsets = [(i - 16) * 12500.0 for i in range(32)]
    asm = P25P1FrameAssembler(nac=0x293)
    txs, wide, n = {}, None, None
    for ch_idx, opcode in actives.items():
        dibits, args = _tx_dibits(opcode, seed=ch_idx, asm=asm)
        iq = generators.c4fm_modulate(dibits, fs)
        if wide is None:
            n = len(iq) // m * m
            wide = np.zeros(n, np.complex64)
        t = np.arange(n) / fs
        wide += (iq[:n] * np.exp(2j * np.pi * offsets[ch_idx] * t)
                 ).astype(np.complex64)
        txs[ch_idx] = (dibits, opcode, args)
    return fs, offsets, wide, txs


def _nbfm_scene():
    """tests/test_twobin.py's 25 kHz NBFM channel at 31.25 kHz, between
    bins 2 and 3 of a 32-bin capture."""
    center = 31250.0
    audio = np.sin(2 * np.pi * 1100.0 * np.arange(int(0.25 * 8000)) / 8000)
    iq = generators.nbfm_modulate(audio, 8000, TWO_BIN_FS,
                                  deviation_hz=5000.0)
    n = len(iq) // 32 * 32
    t = np.arange(n) / TWO_BIN_FS
    return center, (iq[:n] * np.exp(2j * np.pi * center * t)
                    ).astype(np.complex64)


def test_c4fm_build_frames_like_reference():
    fs, offsets, wide, txs = _c4fm_scene()
    rx = WidebandReceiver(fs, offsets, decoder="c4fm", device="cpu")
    jrx = JWidebandReceiver(fs, offsets, decoder="c4fm")
    assert rx.num_channels == jrx.num_channels == 32
    np.testing.assert_array_equal(rx.channelizer.hmat.numpy(),
                                  jrx.channelizer.hmat)
    out, _ = rx.build()(torch.as_tensor(wide), rx.init_state())
    jout, _ = jrx.build()(jnp.asarray(wide), jrx.init_state())
    dib, val = out["dibits"].numpy(), out["valid"].numpy()
    jdib, jval = np.asarray(jout["dibits"]), np.asarray(jout["valid"])
    assert dib.shape == jdib.shape
    for ch_idx, (_, opcode, args) in txs.items():
        np.testing.assert_array_equal(val[ch_idx], jval[ch_idx])
        np.testing.assert_array_equal(dib[ch_idx][val[ch_idx]],
                                      jdib[ch_idx][jval[ch_idx]])
        frames = P25P1Framer().process(dib[ch_idx][val[ch_idx]])
        assert len(frames) == 2
        for frame in frames:
            msg = decode_frame(frame)
            assert msg.valid and msg.nac == 0x293
            assert msg.content.opcode == opcode
            assert np.array_equal(msg.content.args, args)
    idle = [i for i in range(len(offsets)) if i not in txs][:4]
    for ch_idx in idle:
        assert not P25P1Framer().process(dib[ch_idx][val[ch_idx]])


def test_twobin_nbfm_build_like_reference():
    center, wide = _nbfm_scene()
    rx = WidebandReceiver(
        TWO_BIN_FS, [center], channel_bandwidths=[25000.0],
        decoder=NBFMDecoder(NBFMConfig(sample_rate=25000.0,
                                       bandwidth=25000.0), device="cpu"),
        device="cpu")
    jrx = JWidebandReceiver(
        TWO_BIN_FS, [center], channel_bandwidths=[25000.0],
        decoder=JNBFMDecoder(JNBFMConfig(sample_rate=25000.0,
                                         bandwidth=25000.0)))
    assert rx.plan.wide[0] and tuple(rx.plan.bins[0]) == (2, 3)
    np.testing.assert_array_equal(rx.plan.bins, jrx.plan.bins)
    out, state = rx.build()(torch.as_tensor(wide), rx.init_state())
    jout, jstate = jrx.build()(jnp.asarray(wide), jrx.init_state())
    audio = out["audio"][0].numpy()
    np.testing.assert_allclose(audio, np.asarray(jout["audio"][0]), rtol=0,
                               atol=AUDIO_TOL)
    assert int(state["rot"]) == int(jstate["rot"])
    np.testing.assert_allclose(state["mixer_phase"].numpy(),
                               np.asarray(jstate["mixer_phase"]), atol=1e-6)
    tail = audio[800:]
    f = np.fft.rfftfreq(len(tail), 1 / 8000)
    assert f[np.argmax(np.abs(np.fft.rfft(tail)))] == pytest.approx(
        1100.0, abs=20.0)
    # the (N, 2) float32 pair form gives the same
    pairs = torch.view_as_real(torch.as_tensor(wide)).contiguous()
    out2, _ = rx.build()(pairs, rx.init_state())
    assert torch.equal(out2["audio"], out["audio"])


def test_build_equals_build_dynamic_bit_for_bit():
    """A plan of a wide channel, a single-bin one with a residual offset
    and a wide one across the bin wrap, over two chunks."""
    center, wide = _nbfm_scene()
    offsets = [center, 25000.0 + 1500.0, -6250.0]
    rx = WidebandReceiver(
        TWO_BIN_FS, offsets, channel_bandwidths=[25000.0, 12500.0, 25000.0],
        decoder=NBFMDecoder(NBFMConfig(sample_rate=25000.0,
                                       bandwidth=25000.0), device="cpu"),
        device="cpu")
    assert list(rx.plan.wide) == [True, False, True]
    static, dynamic = rx.build(), rx.build_dynamic()
    bins = torch.as_tensor(rx.plan.bins)
    step_rad = torch.as_tensor((2.0 * np.pi * rx.plan.offsets / rx.plan.rate)
                               .astype(np.float32))
    s_state, d_state = rx.init_state(), rx.init_state()
    half = len(wide) // 64 * 32
    for part in (wide[:half], wide[half:]):
        s_out, s_state = static(torch.as_tensor(part), s_state)
        d_out, d_state = dynamic(torch.as_tensor(part), d_state, bins,
                                 step_rad)
        for key in s_out:
            assert torch.equal(s_out[key], d_out[key]), key
        for a, b in zip(tree_leaves(s_state), tree_leaves(d_state)):
            assert torch.equal(a, b)


def test_plan_matches_reference():
    offsets = [25000.0, 31250.0, -50000.0, 12500.0 * 7 + 900.0]
    bws = [12500.0, 25000.0, 25000.0, 12500.0]
    rx = WidebandReceiver(TWO_BIN_FS, offsets, channel_bandwidths=bws,
                          decoder="nbfm", device="cpu")
    jrx = JWidebandReceiver(TWO_BIN_FS, offsets, channel_bandwidths=bws)
    np.testing.assert_array_equal(rx.plan.bins, jrx.plan.bins)
    np.testing.assert_array_equal(rx.plan.offsets, jrx.plan.offsets)
    np.testing.assert_array_equal(rx.plan.wide, jrx.plan.wide)
    assert rx.plan.rate == jrx.plan.rate
    assert rx.num_channels == jrx.num_channels == 4
    assert rx.init_state()["mixer_phase"].shape == (4,)
    with pytest.raises(ValueError):
        WidebandReceiver(TWO_BIN_FS, [0.0], channel_bandwidths=[30000.0],
                         device="cpu")
