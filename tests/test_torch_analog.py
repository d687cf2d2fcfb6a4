"""The port's analog DSP and its NBFM and AM decoders against the JAX
reference on the CPU.

Each new function of dsp/demod.py, dsp/iir.py and dsp/fir.py gets the same
NumPy input, made from a seed, as its JAX counterpart (vmapped over the
channels where the JAX function takes one), streamed over two blocks with
the state carried between them. The decoders' ``batched_call`` runs two
chunks of six channels (five carrying a signal, one of noise only near the
squelch threshold) against the JAX decoders vmapped over the same
channels.

Tolerances (float32; the two frameworks sum in other orders):
* float audio and the filters' streams within 1e-4 (ROADMAP Queue 1
  item 12), the carried float state within 1e-5;
* power_db within 1e-4 dB; the squelch gate exactly, except at samples
  whose power lies within 1e-3 dB of the -78 dB threshold (counted and
  reported; none is expected on these inputs);
* the FM discriminator near +/-pi: an ulp of difference in the conjugate
  product can flip atan2's sign there and move one sample by 2*pi*gain,
  so FM audio is compared on signal-bearing channels only, and the
  noise-only channel is compared by its gate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrtrunk_tpu.decoders.am import AMDecoder as JAMDecoder
from sdrtrunk_tpu.decoders.nbfm import NBFMDecoder as JNBFMDecoder
from sdrtrunk_tpu.dsp import demod as jdemod
from sdrtrunk_tpu.dsp import fir as jfir
from sdrtrunk_tpu.dsp import iir as jiir
from sdrtrunk_tpu.signal.generators import nbfm_modulate
from sdrtrunk_tpu_torch.convert import tree_map
from sdrtrunk_tpu_torch.decoders.am import AMDecoder
from sdrtrunk_tpu_torch.decoders.nbfm import NBFMDecoder
from sdrtrunk_tpu_torch.dsp import demod, fir, iir

torch.set_num_threads(1)

FS = 25000.0
THRESHOLD_DB = -78.0
AUDIO_TOL = 1e-4
STATE_TOL = 1e-5


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _nbfm_rows(c, t, seed):
    """(c, t) complex64: NBFM tones at 25 kHz with offsets and levels."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(c):
        f = 400.0 + 150.0 * i
        audio = 0.7 * np.sin(2 * np.pi * f * np.arange(t // 3 + 80) / 8000.0)
        iq = nbfm_modulate(audio, 8000.0, FS)[:t]
        iq = iq * (0.05 + 0.1 * i) * np.exp(1j * rng.uniform(0, 2 * np.pi))
        rows.append(iq + 1e-3 * (rng.standard_normal(t)
                                 + 1j * rng.standard_normal(t)))
    return np.stack(rows).astype(np.complex64)


def _am_rows(c, t, seed):
    """(c, t) complex64: 50% AM tones with a small carrier offset."""
    rng = np.random.default_rng(seed)
    n = np.arange(t)
    rows = []
    for i in range(c):
        env = 1.0 + 0.5 * np.sin(2 * np.pi * (600.0 + 200.0 * i) * n / FS)
        carrier = np.exp(1j * (2 * np.pi * 37.0 * i * n / FS
                               + rng.uniform(0, 2 * np.pi)))
        rows.append((0.05 + 0.1 * i) * env * carrier
                    + 1e-3 * (rng.standard_normal(t)
                              + 1j * rng.standard_normal(t)))
    return np.stack(rows).astype(np.complex64)


def _noise_row(t, seed, power_db=THRESHOLD_DB + 3.0):
    """Complex noise whose mean power sits 3 dB above the threshold: its
    smoothed power, from 0, crosses it after about 1700 samples."""
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(10.0 ** (power_db / 10.0) / 2.0)
    return (sigma * (rng.standard_normal(t) + 1j * rng.standard_normal(t))
            ).astype(np.complex64)


def _halves(x, split):
    return x[:, :split], x[:, split:]


# ------------------------------------------------------------ demod


def test_fm_demodulate_streams_like_reference():
    x = _nbfm_rows(4, 2000, 1)
    gain = jdemod.fm_gain(FS, 6250.0)
    assert demod.fm_gain(FS, 6250.0) == gain
    prev = jnp.zeros((4,), jnp.complex64)
    tprev = torch.zeros((4,), dtype=torch.complex64)
    for part in _halves(x, 900):
        want, prev = jax.vmap(lambda v, p: jdemod.fm_demodulate(v, p, gain))(
            jnp.asarray(part), prev)
        got, tprev = demod.fm_demodulate(_t(part), tprev, gain)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=AUDIO_TOL)
        np.testing.assert_array_equal(tprev.numpy(), np.asarray(prev))
    assert float(np.abs(np.asarray(want)).max()) > 0.3   # a real signal


def test_am_demodulate_matches_reference():
    x = _am_rows(3, 700, 2)
    want = jax.vmap(jdemod.am_demodulate)(jnp.asarray(x))
    np.testing.assert_allclose(demod.am_demodulate(_t(x)).numpy(),
                               np.asarray(want), rtol=1e-6, atol=0)


def _gate_mismatches(got_gate, want_gate, want_db):
    """Samples where the gates differ; each must lie within 1e-3 dB of
    the threshold. Returns how many there were."""
    bad = got_gate != want_gate
    assert np.all(np.abs(want_db[bad] - THRESHOLD_DB) < 1e-3), \
        "a gate differs away from the threshold"
    return int(bad.sum())


def test_power_squelch_streams_like_reference():
    x = np.concatenate([_nbfm_rows(2, 3000, 3),
                        _noise_row(3000, 4)[None, :]])
    state = jnp.zeros((3,), jnp.float32)
    tstate = torch.zeros((3,), dtype=torch.float32)
    near = 0
    gates = []
    for part in _halves(x, 1100):
        gate, pdb, state = jax.vmap(
            lambda v, s: jdemod.power_squelch(v, THRESHOLD_DB, 0.0004, s))(
            jnp.asarray(part), state)
        tgate, tpdb, tstate = demod.power_squelch(_t(part), THRESHOLD_DB,
                                                  0.0004, tstate)
        np.testing.assert_allclose(tpdb.numpy(), np.asarray(pdb), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(tstate.numpy(), np.asarray(state),
                                   rtol=1e-5, atol=0)
        near += _gate_mismatches(tgate.numpy(), np.asarray(gate),
                                 np.asarray(pdb))
        gates.append(np.asarray(gate))
    assert near == 0
    # the noise row's gate opens as its smoothed power climbs past the
    # threshold: both states of the gate are compared
    gate = np.concatenate(gates, axis=1)
    assert gate[:2, -1000:].all() and gate[2].any() and not gate[2].all()


# ------------------------------------------------------------ iir


def test_deemphasis_constants_match_reference():
    for rate in (25000.0, 50000.0):
        assert iir.deemphasis_alpha(rate) == jiir.deemphasis_alpha(rate)
        assert iir.deemphasis_makeup_gain(rate) == \
            jiir.deemphasis_makeup_gain(rate)


def test_deemphasis_streams_like_reference():
    rng = np.random.default_rng(5)
    x = (0.6 * rng.standard_normal((3, 1500))).astype(np.float32)
    state = jnp.zeros((3,), jnp.float32)
    tstate = torch.zeros((3,), dtype=torch.float32)
    for part in _halves(x, 700):
        want, state = jax.vmap(lambda v, s: jiir.deemphasis(v, FS, 750e-6, s))(
            jnp.asarray(part), state)
        got, tstate = iir.deemphasis(_t(part), FS, 750e-6, tstate)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=AUDIO_TOL)
        np.testing.assert_allclose(tstate.numpy(), np.asarray(state),
                                   rtol=0, atol=STATE_TOL)
    assert np.abs(np.asarray(want)).max() == pytest.approx(0.95)  # clipped


def test_dc_removal_streams_like_reference():
    rng = np.random.default_rng(6)
    x = (0.5 + 0.2 * rng.standard_normal((3, 1500))).astype(np.float32)
    state = (jnp.zeros((3,)), jnp.zeros((3,)))
    tstate = (torch.zeros(3), torch.zeros(3))
    for part in _halves(x, 800):
        want, state = jax.vmap(lambda v, s: jiir.dc_removal(v, 0.95, s))(
            jnp.asarray(part), state)
        got, tstate = iir.dc_removal(_t(part), 0.95, tstate)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=AUDIO_TOL)
        for a, b in zip(tstate, state):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=STATE_TOL)


# ------------------------------------------------------------ fir


def test_resample_design_matches_reference():
    for up, down in ((8, 25), (3, 2), (1, 4)):
        want = jfir.resample_taps(up, down)
        got = fir.resample_taps(up, down)
        np.testing.assert_array_equal(got, want)
        assert fir.resample_init(len(got), up, device="cpu").shape == \
            jfir.resample_init(len(want), up).shape
    for factor in (2, 8):
        for a, b in zip(fir.decimation_cascade_taps(factor),
                        jfir.decimation_cascade_taps(factor)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="power of two"):
        fir.decimation_cascade_taps(6)


@pytest.mark.parametrize("up,down", [(8, 25), (3, 2), (2, 3)])
def test_polyphase_resample_streams_like_reference(up, down):
    """The upfirdn alignment, streamed over two blocks of whole phase
    periods with the last tpp input samples carried as state."""
    rng = np.random.default_rng(up * 100 + down)
    taps = np.asarray(jfir.resample_taps(up, down), np.float32)
    tpp = len(taps) // up
    x = rng.standard_normal((3, 30 * down)).astype(np.float32)
    jstate = np.zeros((3, tpp), np.float32)
    tstate = torch.zeros((3, tpp))
    outs = []
    for part in _halves(x, 12 * down):
        want = np.stack([np.asarray(jfir.polyphase_resample(
            jnp.asarray(part[i]), jnp.asarray(taps), up, down,
            jnp.asarray(jstate[i]))) for i in range(3)])
        got = fir.polyphase_resample(_t(part), _t(taps), up, down, tstate)
        assert got.shape == want.shape == (3, part.shape[1] * up // down)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=AUDIO_TOL)
        jstate, tstate = part[:, -tpp:], _t(part[:, -tpp:])
        outs.append(got)
    one_shot = fir.polyphase_resample(_t(x), _t(taps), up, down)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), one_shot.numpy(),
                               rtol=0, atol=1e-6)


def test_polyphase_resample_odd_length_matches_reference():
    """A block that is no multiple of down: n*up//down outputs."""
    rng = np.random.default_rng(8)
    taps = np.asarray(jfir.resample_taps(8, 25), np.float32)
    x = rng.standard_normal((2, 333)).astype(np.float32)
    want = np.stack([np.asarray(jfir.polyphase_resample(
        jnp.asarray(r), jnp.asarray(taps), 8, 25)) for r in x])
    got = fir.polyphase_resample(_t(x), _t(taps), 8, 25)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=AUDIO_TOL)


def test_fir_filter_and_decimate_stream_like_reference():
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((2, 512))
         + 1j * rng.standard_normal((2, 512))).astype(np.complex64)
    taps = np.asarray(jfir.decimation_cascade_taps(2)[0], np.float32)
    want = np.stack([np.asarray(jfir.fir_filter(jnp.asarray(r),
                                                jnp.asarray(taps)))
                     for r in x])
    np.testing.assert_allclose(fir.fir_filter(_t(x), _t(taps)).numpy(), want,
                               rtol=0, atol=AUDIO_TOL)
    jst = [None, None]
    tst = None
    for part in _halves(x, 256):
        want = []
        for i in range(2):
            y, jst[i] = jfir.fir_decimate(jnp.asarray(part[i]),
                                          jnp.asarray(taps), 4, jst[i])
            want.append(np.asarray(y))
        got, tst = fir.fir_decimate(_t(part), _t(taps), 4, tst)
        np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=0,
                                   atol=AUDIO_TOL)
        np.testing.assert_array_equal(tst.numpy(),
                                      np.stack([np.asarray(s) for s in jst]))
    got, _ = fir.half_band_decimate(_t(x), _t(taps))
    want = np.stack([np.asarray(jfir.half_band_decimate(
        jnp.asarray(r), jnp.asarray(taps))[0]) for r in x])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=AUDIO_TOL)


def test_decimate_by_power2_streams_like_reference():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 1024)).astype(np.float32)
    stages = jfir.decimation_cascade_taps(8)
    jst = [None, None]
    tst = None
    for part in _halves(x, 512):
        want = []
        for i in range(2):
            y, jst[i] = jfir.decimate_by_power2(jnp.asarray(part[i]), stages,
                                                jst[i])
            want.append(np.asarray(y))
        got, tst = fir.decimate_by_power2(_t(part), stages, tst)
        assert got.shape == (2, 64)
        np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=0,
                                   atol=AUDIO_TOL)


# ------------------------------------------------------------ decoders


def _jax_state(dec, c):
    return jax.tree.map(lambda a: jnp.broadcast_to(a, (c,) + a.shape),
                        dec.init_state())


def _port_state(jstate):
    def leaf(a):
        return torch.as_tensor(np.array(a))
    return {k: tuple(leaf(a) for a in v) if isinstance(v, tuple) else leaf(v)
            for k, v in jstate.items()}


def _run_decoders(jdec, tdec, x, split):
    """Both decoders over two chunks from one state: per chunk (JAX
    outputs, port outputs), and the final (JAX, port) states."""
    c = x.shape[0]
    jstate = _jax_state(jdec, c)
    tstate = _port_state(jstate)
    chunks = []
    for part in _halves(x, split):
        jout, jstate = jax.vmap(jdec.__call__)(jnp.asarray(part), jstate)
        tout, tstate = tdec.batched_call(_t(part), tstate)
        chunks.append(({k: np.asarray(v) for k, v in jout.items()},
                       {k: v.numpy() for k, v in tout.items()}))
    return chunks, jstate, tstate


def _check_decoder(chunks, jstate, tstate, audio_rows, ka):
    near = 0
    for jout, tout in chunks:
        assert tout["audio"].shape == jout["audio"].shape == (
            len(jout["audio"]), ka)
        assert tout["audio"].dtype == np.float32
        np.testing.assert_allclose(tout["audio"][audio_rows],
                                   jout["audio"][audio_rows], rtol=0,
                                   atol=AUDIO_TOL)
        np.testing.assert_allclose(tout["power_db"], jout["power_db"],
                                   rtol=0, atol=1e-4)
        idx = np.arange(ka) * 25 // 8
        near += _gate_mismatches(tout["audio_gate"], jout["audio_gate"],
                                 jout["power_db"][:, idx])
    assert near == 0
    want = jax.tree.map(np.asarray, jstate)
    for key in want:
        for a, b in zip(jax.tree.leaves(want[key]),
                        jax.tree.leaves(tree_map(lambda t: t.numpy(),
                                                 tstate[key]))):
            np.testing.assert_allclose(b, a, rtol=0, atol=STATE_TOL,
                                       err_msg=key)


def test_nbfm_decoder_matches_reference():
    jdec, tdec = JNBFMDecoder(), NBFMDecoder(device="cpu")
    np.testing.assert_array_equal(tdec.baseband_taps.numpy(),
                                  jdec.baseband_taps)
    np.testing.assert_array_equal(tdec.resampler_taps.numpy(),
                                  jdec.resampler_taps)
    assert (tdec.up, tdec.down, tdec.fm_gain) == (jdec.up, jdec.down,
                                                  jdec.fm_gain)
    x = np.concatenate([_nbfm_rows(5, 5000, 11),
                        _noise_row(5000, 12)[None, :]])
    chunks, jstate, tstate = _run_decoders(jdec, tdec, x, 2500)
    _check_decoder(chunks, jstate, tstate, slice(0, 5), 800)
    gate = np.concatenate([c[0]["audio_gate"] for c in chunks], axis=1)
    assert gate[:5, 10:].all() and not gate[5].all()


def test_am_decoder_matches_reference():
    jdec, tdec = JAMDecoder(), AMDecoder(device="cpu")
    np.testing.assert_array_equal(tdec.baseband_taps.numpy(),
                                  jdec.baseband_taps)
    x = np.concatenate([_am_rows(5, 5000, 13),
                        _noise_row(5000, 14)[None, :]])
    chunks, jstate, tstate = _run_decoders(jdec, tdec, x, 2500)
    # the envelope has no phase wrap: every row's audio is compared
    _check_decoder(chunks, jstate, tstate, slice(0, 6), 800)
    assert isinstance(tstate["dc"], tuple) and len(tstate["dc"]) == 2
