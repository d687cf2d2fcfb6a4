"""The two bit demodulators of the analog-trunking slice against the JAX
package on the CPU, and the kernel's arithmetic rehearsed in Python.

* ``LTRFSKDemodulator`` (dsp/fsk.py) and ``AFSK1200Demodulator``
  (dsp/afsk.py, also inverted) on ten seeds each, one shot and as two
  blocks with carried state, against the JAX demodulators (their own
  ``lax.scan``, jitted, a channel at a time): valid exact, bits exact
  where valid (the port leaves bits 0 elsewhere; every caller reads
  bits[valid] only), the window exact and the sampling point within 1e-5
  (it is equal on every seed here: the update is taken as the fused
  multiply-add XLA:CPU compiles). Float streams and state: the FSK
  low-pass history and the AFSK correlator and resampler histories within
  1e-6; the DC accumulator within 1e-8 + 1e-5 relative (the port solves
  the single pole by blocked matmuls, the reference by a sequential
  float32 scan). A slicer decision could differ only where the filtered
  value lies within such an error of zero; on these signal-bearing inputs
  none does. A noise-only channel is held to the same rule: its decisions
  are the signs of a low-passed noise, and a value within 1e-6 of zero
  would be needed to flip one.
* ``bit_timing_plain`` against a pure-Python model of the kernel's
  arithmetic (csrc/bit_timing.cu) at W <= 64: the delay line as one
  64-bit integer (tests/test_torch_bit_timing_walk.py models the line of
  ceil(W / 64) words),
  votes and crossings by masks and popcounts, the first and last crossing
  by the highest and lowest set bit, bit for bit on random decisions for
  both geometries, the two-crossing rule on a geometry where two crossings
  can tie, inversion, T = 1, and carried state.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrtrunk_tpu.dsp.afsk import AFSK1200Demodulator as JAFSK
from sdrtrunk_tpu.dsp.fsk import LTRFSKDemodulator as JFSK
from sdrtrunk_tpu_torch.convert import tree_map
from sdrtrunk_tpu_torch.dsp.afsk import AFSK1200Demodulator, AFSKState
from sdrtrunk_tpu_torch.dsp.bit_timing import (BitTimingGeometry, bit_timing,
                                               bit_timing_plain)
from sdrtrunk_tpu_torch.dsp.fsk import LTRFSKDemodulator, LTRFSKState
from test_ltr import _fsk_modulate
from test_mpt1327 import _afsk_modulate

torch.set_num_threads(1)

SEEDS = list(range(10))


def _batched(state):
    return tree_map(lambda a: a[None].clone(), state)


def _fsk_audio(seed):
    """120 random bits of sub-audible square FSK with a DC offset, an
    800 Hz tone and noise; seed 9 is noise only."""
    rng = np.random.default_rng(seed)
    audio = _fsk_modulate(rng.integers(0, 2, 120).astype(np.uint8))
    n = np.arange(len(audio))
    audio = audio + 0.05 + 0.3 * np.sin(2 * np.pi * 800.0 * n / 8000.0)
    if seed == 9:
        audio = np.zeros_like(audio)
    return (audio + 0.05 * rng.standard_normal(len(audio))).astype(np.float32)


def _afsk_audio(seed):
    """300 random bits of 1200-baud AFSK with noise, a multiple of 10
    samples; seed 9 is noise only."""
    rng = np.random.default_rng(100 + seed)
    audio = _afsk_modulate(rng.integers(0, 2, 300).astype(np.uint8))
    audio = audio[:len(audio) // 10 * 10]
    if seed == 9:
        audio = np.zeros_like(audio)
    return (audio + 0.05 * rng.standard_normal(len(audio))).astype(np.float32)


@pytest.fixture(scope="module")
def fsk_pair():
    jd = JFSK()
    td = LTRFSKDemodulator(device="cpu")
    np.testing.assert_array_equal(td.taps.numpy(), np.asarray(jd.taps))
    assert (td.window_len, td.half_sps, td.int_sps, td.zc_len) == \
        (jd.window_len, jd.half_sps, jd.int_sps, jd.zc_len) == (53, 13, 27, 27)
    return jd, jax.jit(jd.__call__), td


@pytest.fixture(scope="module", params=[False, True],
                ids=["normal", "inverted"])
def afsk_pair(request):
    jd = JAFSK(invert=request.param)
    td = AFSK1200Demodulator(invert=request.param, device="cpu")
    np.testing.assert_array_equal(td.rtaps.numpy(), np.asarray(jd.rtaps))
    np.testing.assert_array_equal(
        td.tone_taps.numpy(), np.stack([*jd.mark_taps, *jd.space_taps]))
    np.testing.assert_array_equal(td.avg_taps.numpy(), jd.avg_taps)
    return jd, jax.jit(jd.__call__), td


def _check_symbols(got_bits, got_valid, jbits, jvalid, expected):
    jvalid = np.asarray(jvalid)
    valid = got_valid[0].numpy()
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_array_equal(got_bits[0].numpy()[valid],
                                  np.asarray(jbits)[jvalid])
    assert not got_bits[0].numpy()[~valid].any()
    assert abs(int(valid.sum()) - expected) <= 2


def _check_fsk_state(state, jstate):
    np.testing.assert_array_equal(state.window[0].numpy(),
                                  np.asarray(jstate.window))
    assert abs(float(state.sampling_point[0])
               - float(jstate.sampling_point)) <= 1e-5
    assert abs(float(state.dc[0]) - float(jstate.dc)) <= \
        1e-8 + 1e-5 * abs(float(jstate.dc))
    np.testing.assert_allclose(state.fir[0].numpy(), np.asarray(jstate.fir),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", SEEDS)
def test_fsk_matches_reference_one_shot(fsk_pair, seed):
    jd, jcall, td = fsk_pair
    audio = _fsk_audio(seed)
    jbits, jvalid, jstate = jcall(jnp.asarray(audio), jd.init_state())
    bits, valid, state = td.batched(torch.as_tensor(audio)[None],
                                    _batched(td.init_state()))
    assert isinstance(state, LTRFSKState) and bits.dtype == torch.int8
    _check_symbols(bits, valid, jbits, jvalid, len(audio) * 300 / 8000)
    _check_fsk_state(state, jstate)


@pytest.mark.parametrize("seed", SEEDS)
def test_fsk_matches_reference_in_two_blocks(fsk_pair, seed):
    jd, jcall, td = fsk_pair
    audio = _fsk_audio(seed)
    split = 1000 + 37 * seed
    jbits, jvalid, jstate = jcall(jnp.asarray(audio), jd.init_state())
    x = torch.as_tensor(audio)[None]
    b1, v1, s1 = td.batched(x[:, :split], _batched(td.init_state()))
    b2, v2, s2 = td.batched(x[:, split:], s1)
    _check_symbols(torch.cat([b1, b2], 1), torch.cat([v1, v2], 1), jbits,
                   jvalid, len(audio) * 300 / 8000)
    _check_fsk_state(s2, jstate)
    # the reference too, carried across the same split
    _, _, j1 = jcall(jnp.asarray(audio[:split]), jd.init_state())
    np.testing.assert_array_equal(s1.window[0].numpy(), np.asarray(j1.window))
    assert abs(float(s1.sampling_point[0]) - float(j1.sampling_point)) <= 1e-5


def _check_afsk_state(state, jstate):
    np.testing.assert_array_equal(state.window[0].numpy(),
                                  np.asarray(jstate.window))
    assert abs(float(state.sampling_point[0])
               - float(jstate.sampling_point)) <= 1e-5
    np.testing.assert_allclose(state.corr[0].numpy(),
                               np.asarray(jstate.corr), atol=1e-6, rtol=0)
    np.testing.assert_allclose(state.resample[0].numpy(),
                               np.asarray(jstate.resample), atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", SEEDS)
def test_afsk_matches_reference_one_shot(afsk_pair, seed):
    jd, jcall, td = afsk_pair
    audio = _afsk_audio(seed)
    jbits, jvalid, jstate = jcall(jnp.asarray(audio), jd.init_state())
    bits, valid, state = td.batched(torch.as_tensor(audio)[None],
                                    _batched(td.init_state()))
    assert isinstance(state, AFSKState)
    assert bits.shape == (1, len(audio) * 9 // 10)
    _check_symbols(bits, valid, jbits, jvalid, len(audio) * 1200 / 8000)
    _check_afsk_state(state, jstate)


@pytest.mark.parametrize("seed", SEEDS)
def test_afsk_matches_reference_in_two_blocks(afsk_pair, seed):
    jd, jcall, td = afsk_pair
    audio = _afsk_audio(seed)
    split = 800 + 10 * seed
    jbits, jvalid, jstate = jcall(jnp.asarray(audio), jd.init_state())
    x = torch.as_tensor(audio)[None]
    b1, v1, s1 = td.batched(x[:, :split], _batched(td.init_state()))
    b2, v2, s2 = td.batched(x[:, split:], s1)
    _check_symbols(torch.cat([b1, b2], 1), torch.cat([v1, v2], 1), jbits,
                   jvalid, len(audio) * 1200 / 8000)
    _check_afsk_state(s2, jstate)


def test_float_streams_match_reference(fsk_pair):
    """The slicers' inputs: the FSK chain's DC-removed, low-passed audio
    within 1e-6 of the reference's (its scan for the DC removal, then its
    FIR), and the AFSK chain's mark-minus-space correlation within 1e-6 +
    2e-6 relative (sums of float32 squares that reach 2; the two packages
    add them in another order)."""
    jd, _, td = fsk_pair
    audio = _fsk_audio(3)

    def dc_step(acc, x):
        y = x - acc
        return acc + (1.0 - jd.dc_ratio) * y, y
    from sdrtrunk_tpu.dsp import fir as jfir
    _, no_dc = jax.lax.scan(dc_step, jnp.zeros((), jnp.float32),
                            jnp.asarray(audio))
    want, _ = jfir.fir_apply(no_dc, jd.taps, jd.init_state().fir)
    got = td.front(torch.as_tensor(audio)[None],
                   _batched(td.init_state()))[0]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    assert float(np.abs(np.asarray(want)).max()) > 0.1

    ja = JAFSK()
    ta = AFSK1200Demodulator(device="cpu")
    audio = _afsk_audio(3)
    s0 = ja.init_state()
    resampled = jfir.polyphase_resample(jnp.asarray(audio), ja.rtaps, 9, 10,
                                        s0.resample)
    want = ja._correlate(jnp.concatenate([s0.corr, resampled]))
    got = ta.front(torch.as_tensor(audio)[None],
                   _batched(ta.init_state()))[0]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-6,
                               rtol=2e-6)
    assert float(np.abs(np.asarray(want)).max()) > 0.1


# --- the kernel's 64-bit-mask arithmetic, in Python -----------------------

def _model(geom: BitTimingGeometry, x, window, sp, invert=False):
    """csrc/bit_timing.cu for one channel in Python integers and NumPy
    float32: the delay line one 64-bit word with the newest decision in
    bit 0, votes and crossings under masks, clz and ffs for the first and
    last crossing, and the counter update as the float64 product plus sum
    rounded once."""
    f32, f64 = np.float32, np.float64
    k = geom.constants()
    w_len, zl = geom.window_len, geom.zc_len
    ones = lambda n: (1 << n) - 1                               # noqa: E731
    line_mask = ones(w_len)
    vote_mask = ones(geom.vote_len) << (w_len - geom.vote_start
                                        - geom.vote_len)
    zc_mask = ones(zl - 1)
    w = 0
    for d in window:
        w = (w << 1) | int(d != 0)
    sp = f32(sp)
    bits = np.zeros(len(x), np.int8)
    valid = np.zeros(len(x), bool)
    for t, v in enumerate(x):
        d = (v > 0.0) != invert
        w = ((w << 1) | int(d)) & line_mask
        sp = f32(sp - f32(1.0))
        if not sp < f32(1.0):
            continue
        votes = bin(w & vote_mask).count("1")
        cr = (w ^ (w >> 1)) & zc_mask
        count = bin(cr).count("1")
        error = f32(0.0)
        if count == 1 or (count == 2 and geom.two_crossings):
            first = zl - 2 - (cr.bit_length() - 1)          # 63 - clz
            error = f32(f32(first) + f32(0.5)) - f32(k["zc_ideal"])
            if count == 2:
                last = zl - 2 - ((cr & -cr).bit_length() - 1)   # ffs - 1
                err2 = f32(f32(last) + f32(0.5)) - f32(k["zc_ideal"])
                error = error if abs(error) < abs(err2) else err2
        sp = f32(f64(error) * f64(f32(k["gain"]))
                 + f64(f32(sp + f32(k["sps"]))))
        bits[t] = votes > geom.vote_len // 2
        valid[t] = True
    new_window = np.array([(w >> (w_len - 1 - i)) & 1 for i in range(w_len)],
                          np.int8)
    return bits, valid, new_window, sp


_LTR = LTRFSKDemodulator(device="cpu").geometry
_AFSK = AFSK1200Demodulator(device="cpu").geometry
_GEOMETRIES = {"ltr": _LTR, "afsk": _AFSK,
               "afsk_two_crossings": dataclasses.replace(
                   _AFSK, two_crossings=True),
               "w64": BitTimingGeometry(64, 16, 32, 33, 16.0, 32.0, 0.25,
                                        True)}


def _decisions(geom, rng, c, t):
    """Slicer inputs whose crossings come and go in the window: square
    waves around the symbol period with noise, one all-zero row."""
    period = rng.uniform(0.7, 1.6, (c, 1)) * 2.0 * geom.sps
    x = np.sign(np.sin(2 * np.pi * np.arange(t)[None, :] / period
                       + rng.uniform(0, 6.28, (c, 1))))
    x = x + 0.4 * rng.standard_normal((c, t))
    x[0] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("invert", [False, True], ids=["normal", "inverted"])
@pytest.mark.parametrize("name", list(_GEOMETRIES))
def test_mask_model_equals_plain_loop(name, invert):
    geom = _GEOMETRIES[name]
    rng = np.random.default_rng(5)
    c, t = 9, 700
    x = _decisions(geom, rng, c, t)
    window = rng.integers(0, 2, (c, geom.window_len)).astype(np.int8)
    sp = rng.uniform(1.0, geom.sps * 1.5, c).astype(np.float32)
    sp[::3] = 1.5                                    # a symbol due at t = 0
    bits, valid, new_window, new_sp = bit_timing_plain(
        geom, torch.as_tensor(x), torch.as_tensor(window),
        torch.as_tensor(sp), invert)
    assert bool(valid[::3, 0].all())
    for ch in range(c):
        mb, mv, mw, msp = _model(geom, x[ch], window[ch], sp[ch], invert)
        np.testing.assert_array_equal(valid[ch].numpy(), mv)
        np.testing.assert_array_equal(bits[ch].numpy(), mb)
        np.testing.assert_array_equal(new_window[ch].numpy(), mw)
        assert float(new_sp[ch]) == float(msp)
    assert int(valid.sum()) >= c * (t / geom.sps - 3)
    # T = 1 and carried state: two calls equal one
    b1, v1, w1, s1 = bit_timing(geom, torch.as_tensor(x[:, :1]),
                                torch.as_tensor(window), torch.as_tensor(sp),
                                invert)
    b2, v2, w2, s2 = bit_timing(geom, torch.as_tensor(x[:, 1:]), w1, s1,
                                invert)
    assert torch.equal(torch.cat([b1, b2], 1), bits)
    assert torch.equal(torch.cat([v1, v2], 1), valid)
    assert torch.equal(w2, new_window) and torch.equal(s2, new_sp)


@pytest.mark.parametrize("crossings,want_error", [
    ([], 0.0), ([4], 1.5), ([1, 3], 0.5), ([3, 5], 0.5), ([1, 4], 1.5),
    ([0, 2, 4], 0.0)])
def test_crossing_rules(crossings, want_error):
    """One crossing gives its error; two, the nearer to the ideal (3.0 at 6
    samples a symbol) and the last on a tie (crossings 1 and 4: -1.5 and
    +1.5); none or three, no error. The AFSK rule ignores two."""
    afsk, tie = _GEOMETRIES["afsk"], _GEOMETRIES["afsk_two_crossings"]
    zc = np.zeros(afsk.zc_len, np.int8)
    level = 0
    for i in range(afsk.zc_len):
        zc[i] = level
        if i in crossings:
            level ^= 1
    window = np.zeros((1, afsk.window_len), np.int8)
    window[0, -(afsk.zc_len - 1):] = zc[:-1]
    x = np.array([[1.0 if zc[-1] else -1.0]], np.float32)
    sp = np.array([1.5], np.float32)
    for geom in (afsk, tie):
        error = want_error if (geom.two_crossings or len(crossings) != 2) \
            else 0.0
        _, valid, _, new_sp = bit_timing_plain(
            geom, torch.as_tensor(x), torch.as_tensor(window),
            torch.as_tensor(sp))
        assert bool(valid[0, 0])
        want = np.float32(np.float64(np.float32(error))
                          * np.float64(np.float32(geom.timing_gain))
                          + np.float64(np.float32(6.5)))
        assert float(new_sp[0]) == float(want)
        assert float(_model(geom, x[0], window[0], sp[0])[3]) == float(want)


def test_geometry_is_checked():
    """The crossing window must lie in the delay line, as the vote window
    must; the line itself may be longer than the kernel's 512 decisions
    (the plain loop takes any W, as the reference does; the kernel's
    wrapper refuses W > 512, tests/test_torch_symbol_loop.py)."""
    with pytest.raises(ValueError, match="window_len"):
        BitTimingGeometry(16, 4, 8, 17, 8.0, 8.0, 0.25, True)
    assert BitTimingGeometry(65, 16, 32, 33, 16.0, 32.0, 0.25,
                             True).window_len == 65
    with pytest.raises(ValueError, match="vote window"):
        BitTimingGeometry(12, 8, 6, 7, 3.0, 6.0, 0.3, False)


def test_fsk_above_the_kernels_window_matches_reference():
    """LTR's demodulator at 16 kHz audio (W = 106, a line of two 64-bit
    words in the kernel) on the CPU against the reference at the same
    rate: the plain loop takes any W."""
    jd = JFSK(sample_rate=16000.0)
    td = LTRFSKDemodulator(sample_rate=16000.0, device="cpu")
    assert td.window_len == jd.window_len == 106
    rng = np.random.default_rng(3)
    audio = _fsk_modulate(rng.integers(0, 2, 60).astype(np.uint8),
                          fs=16000.0)
    audio = (audio + 0.05 + 0.05 * rng.standard_normal(len(audio))
             ).astype(np.float32)
    jbits, jvalid, jstate = jax.jit(jd.__call__)(jnp.asarray(audio),
                                                 jd.init_state())
    bits, valid, state = td.batched(torch.as_tensor(audio)[None],
                                    _batched(td.init_state()))
    _check_symbols(bits, valid, jbits, jvalid, len(audio) * 300 / 16000)
    _check_fsk_state(state, jstate)


@pytest.mark.parametrize("seed", [0, 1])
def test_ltr_decoder_at_48k_audio_matches_reference(seed):
    """``LTRDecoder(LTRConfig(audio_rate=48000.0))``, a sound card's rate
    (W = 320: a line of five 64-bit words in the kernel), on the CPU
    against the reference's decoder at the same config, one shot and as
    two blocks with carried state: bits and valid exact, the window exact
    and the sampling point within 1e-5, as the 8 kHz cases above."""
    from sdrtrunk_tpu.decoders.ltr import LTRConfig as JLTRConfig
    from sdrtrunk_tpu.decoders.ltr import LTRDecoder as JLTRDecoder
    from sdrtrunk_tpu_torch.decoders.ltr import LTRConfig, LTRDecoder

    jd = JLTRDecoder(JLTRConfig(audio_rate=48000.0))
    td = LTRDecoder(LTRConfig(audio_rate=48000.0), device="cpu")
    assert td.fsk.window_len == jd.fsk.window_len == 320
    rng = np.random.default_rng(40 + seed)
    audio = _fsk_modulate(rng.integers(0, 2, 60).astype(np.uint8),
                          fs=48000.0)
    n = np.arange(len(audio))
    audio = (audio + 0.05 + 0.3 * np.sin(2 * np.pi * 800.0 * n / 48000.0)
             + 0.05 * rng.standard_normal(len(audio))).astype(np.float32)
    jcall = jax.jit(jd.__call__)
    jout, jstate = jcall(jnp.asarray(audio), jd.init_state())
    out, state = td(torch.as_tensor(audio), td.init_state())
    _check_symbols(out["bits"][None], out["valid"][None], jout["bits"],
                   jout["valid"], len(audio) * 300 / 48000)
    _check_fsk_state(_batched(state), jstate)
    split = len(audio) // 3
    out1, s1 = td(torch.as_tensor(audio[:split]), td.init_state())
    out2, s2 = td(torch.as_tensor(audio[split:]), s1)
    assert torch.equal(torch.cat([out1["valid"], out2["valid"]]),
                       out["valid"])
    assert torch.equal(torch.cat([out1["bits"], out2["bits"]]), out["bits"])
    assert torch.equal(s2.window, state.window)
    assert torch.equal(s2.sampling_point, state.sampling_point)
