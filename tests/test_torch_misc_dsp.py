"""The rest of the port's DSP against the JAX package on the CPU:
dsp/oscillator.py, dsp/cic.py, dsp/misc.py, the two-channel synthesizer
(dsp/synthesizer.py) and the channelizer's ``from_taps`` / ``channelize``.

Each case of tests/test_misc_dsp.py runs on the port (the same input,
made from the same seed, and the same property asserted) and the port's
output is held against the JAX function's on that input.

Tolerances, all float32: the oscillator, mixers and Goertzel probe
within 1e-6 (cos and sin of the same float32 angles from two libraries,
an ulp apart); the CIC means and the Hilbert filter within 1e-6 (sums in
another order); the IQ correction's running mean within 1e-6 (the port
solves the single pole by blocked matmuls, the reference by its own
blocked form); the biquad within 1e-5 relative (a feedback loop: XLA:CPU
contracts ``b * x + z`` into fused multiply-adds, the port's loop rounds
the product and the sum apart, and the loop carries the difference);
the CMA equalizer within 1e-4 over 1000 samples for the same reason
(its taps adapt on every sample; the port also takes |y|^2 as yr yr + yi
yi and sums the taps' products as a halving tree, the kernel's order,
where the reference takes hypot and its own sum); the synthesizer, the
channelizer and the CIC channel's cleanup FIR within 1e-5.

The biquad and the CMA kernels (csrc/biquad.cu, csrc/cma.cu) run only on
the card (tests/test_torch_cuda.py holds them bit for bit against the
plain versions there); here their arithmetic is rehearsed in NumPy
float32, scalar and lane by lane as the kernels take it (a complex row as
two real recurrences; the taps' sum as the warp's xor butterfly), and held
bit for bit against the plain versions, and a CPU tensor is shown never
to reach a kernel wrapper.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from sdrtrunk_tpu.dsp import cic as jcic
from sdrtrunk_tpu.dsp import misc as jmisc
from sdrtrunk_tpu.dsp import oscillator as josc
from sdrtrunk_tpu.dsp import synthesizer as jsyn
from sdrtrunk_tpu.dsp.channelizer import Channelizer as JChannelizer
from sdrtrunk_tpu.dsp.channelizer import channelize as jchannelize
from sdrtrunk_tpu_torch.dsp import design
from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer, channelize
from sdrtrunk_tpu_torch.dsp.cic import CICChannel, cic_decimate, prime_factors
from sdrtrunk_tpu_torch.dsp.misc import (biquad_apply, biquad_apply_plain,
                                         biquad_design, biquad_init,
                                         cma_equalize, cma_equalize_plain,
                                         cma_init, goertzel_magnitude,
                                         goertzel_power, hilbert_taps,
                                         iq_correction, real_to_complex)
from sdrtrunk_tpu_torch.dsp.oscillator import (fs4_down_convert, mix_down,
                                               mix_up, oscillate)
from sdrtrunk_tpu_torch.dsp.synthesizer import (TwoChannelSynthesizer,
                                                synthesize_two)

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, tol, rtol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=tol)


# --- oscillator ---------------------------------------------------------

@pytest.mark.parametrize("phase", [0.0, 1.25])
def test_oscillator_and_mixers_match_reference(phase):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(3000) + 1j * rng.standard_normal(3000)
         ).astype(np.complex64)
    s, nxt = oscillate(1234.5, 48000.0, 3000, phase, device="cpu")
    js, jnxt = josc.oscillate(1234.5, 48000.0, 3000, phase)
    assert s.dtype == torch.complex64
    _close(s, js, 1e-6)
    _close(nxt, jnxt, 1e-6)
    for fn, jfn in ((mix_down, josc.mix_down), (mix_up, josc.mix_up)):
        y, p = fn(_t(x), -2500.0, 48000.0, torch.tensor(phase))
        jy, jp = jfn(jnp.asarray(x), -2500.0, 48000.0, jnp.float32(phase))
        _close(y, jy, 1e-5)
        _close(p, jp, 1e-6)
    _close(fs4_down_convert(_t(x[:1001])), josc.fs4_down_convert(
        jnp.asarray(x[:1001])), 0.0)


def test_mix_down_streams_phase_continuously():
    x = torch.ones(2000, dtype=torch.complex64)
    full, _ = mix_down(x, 300.0, 8000.0)
    a, p = mix_down(x[:700], 300.0, 8000.0)
    b, _ = mix_down(x[700:], 300.0, 8000.0, p)
    _close(torch.cat([a, b]), full.numpy(), 2e-4)


# --- Goertzel, biquad, CMA, IQ correction, Hilbert -----------------------

def test_goertzel_detects_tone():
    fs = 8000.0
    t = np.arange(1024) / fs
    x = (0.8 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.float32)
    assert float(goertzel_magnitude(_t(x), 1000.0, fs)) == pytest.approx(
        0.8, abs=0.02)
    assert float(goertzel_power(_t(x), 2500.0, fs)) < 1e-4
    for f in (1000.0, 2500.0):
        _close(goertzel_power(_t(x), f, fs),
               jmisc.goertzel_power(jnp.asarray(x), f, fs), 1e-6)
    # leading axes reduce the last one
    xx = np.stack([x, 0.5 * x])
    _close(goertzel_magnitude(_t(xx), 1000.0, fs),
           jmisc.goertzel_magnitude(jnp.asarray(xx), 1000.0, fs), 1e-6)


@pytest.mark.parametrize("kind", ["lowpass", "highpass", "bandpass", "notch"])
def test_biquad_design_equals_reference(kind):
    for got, want in zip(biquad_design(kind, 1000.0, 8000.0, 2.0),
                         jmisc.biquad_design(kind, 1000.0, 8000.0, 2.0)):
        np.testing.assert_array_equal(got, want)


def test_biquad_matches_scipy_lfilter_and_reference():
    b, a = biquad_design("lowpass", 1000.0, 8000.0)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(500).astype(np.float32)
    y, st = biquad_apply(_t(x), b, a)
    np.testing.assert_allclose(y.numpy(), sps.lfilter(b, a, x), atol=1e-4)
    jy, jst = jmisc.biquad_apply(jnp.asarray(x), b, a)
    _close(y, jy, 1e-5, rtol=1e-5)
    _close(st, jst, 1e-5, rtol=1e-5)
    assert torch.equal(biquad_init(device="cpu"), torch.zeros(2))


def test_biquad_streaming_equals_oneshot_and_batches():
    b, a = biquad_design("bandpass", 1200.0, 8000.0, q=5.0)
    rng = np.random.default_rng(4)
    x = rng.standard_normal(400).astype(np.float32)
    full, _ = biquad_apply(_t(x), b, a)
    st, parts = None, []
    for chunk in np.split(x, 4):
        y, st = biquad_apply(_t(chunk), b, a, st)
        parts.append(y)
    # the same operations in the same order: equal, not only close
    assert torch.equal(torch.cat(parts), full)
    jfull, _ = jmisc.biquad_apply(jnp.asarray(x), b, a)
    _close(full, jfull, 1e-5, rtol=1e-5)
    # two channels at once, each as it runs alone
    xx = np.stack([x, x[::-1].copy()])
    yy, sst = biquad_apply(_t(xx), b, a)
    assert yy.shape == (2, 400) and sst.shape == (2, 2)
    assert torch.equal(yy[0], full)
    assert torch.equal(yy[1], biquad_apply(_t(xx[1]), b, a)[0])


def test_cma_equalizer_restores_modulus_like_reference():
    rng = np.random.default_rng(5)
    syms = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, 4000)))
    chan = np.array([1.0, 0.25 - 0.1j])
    x = np.convolve(syms, chan)[: len(syms)].astype(np.complex64)
    y, taps = cma_equalize(_t(x), mu=0.003)
    tail = np.abs(y.numpy()[-500:])
    head = np.abs(x[:500])
    assert tail.std() < head.std() * 0.5
    assert tail.mean() == pytest.approx(1.0, abs=0.05)
    jy, jtaps = jmisc.cma_equalize(jnp.asarray(x[:1000]), mu=0.003)
    y1, taps1 = cma_equalize(_t(x[:1000]), cma_init(device="cpu"), mu=0.003)
    _close(y1, jy, 1e-4)
    _close(taps1, jtaps, 1e-4)
    _close(cma_init(device="cpu"), jmisc.cma_init(), 0.0)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64],
                         ids=["float32", "complex64"])
def test_biquad_rows_and_carried_state_match_reference(dtype):
    """Three rows (float32, and complex64 as the reference accepts) in two
    calls with carried state, each row against the reference's
    ``biquad_apply`` over the whole row (the reference takes a 1-D row;
    it vmaps over leading axes)."""
    b, a = biquad_design("highpass", 300.0, 8000.0, q=0.9)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 600))
    if dtype is np.complex64:
        x = x + 1j * rng.standard_normal((3, 600))
    x = x.astype(dtype)
    y1, s1 = biquad_apply(_t(x[:, :250]), b, a)
    y2, s2 = biquad_apply(_t(x[:, 250:]), b, a, s1)
    assert y1.dtype == s2.dtype == torch.as_tensor(x).dtype
    assert s2.shape == (3, 2)
    y = torch.cat([y1, y2], 1)
    for row in range(3):
        jy, jst = jmisc.biquad_apply(jnp.asarray(x[row]), b, a)
        _close(y[row], jy, 1e-5, rtol=1e-5)
        _close(s2[row], jst, 1e-5, rtol=1e-5)


def _biquad_kernel_model(x, b, a, state):
    """csrc/biquad.cu for one float32 row in NumPy float32 scalars: the
    step in its order, a product and a sum rounded apart (--fmad=false)."""
    f32 = np.float32
    b0, b1, b2 = (f32(v) for v in b)
    a1, a2 = f32(a[1]), f32(a[2])
    z1, z2 = f32(state[0]), f32(state[1])
    y = np.empty(len(x), np.float32)
    for n, xn in enumerate(x.astype(np.float32)):
        y[n] = f32(f32(b0 * xn) + z1)
        z1 = f32(f32(f32(b1 * xn) - f32(a1 * y[n])) + z2)
        z2 = f32(f32(b2 * xn) - f32(a2 * y[n]))
    return y, np.array([z1, z2], np.float32)


def test_biquad_kernel_arithmetic_equals_plain_loop():
    """The kernel's step, and a complex row as two real recurrences (real
    coefficients), bit for bit against the plain loop's float32 and
    complex64 operations."""
    b, a = biquad_design("bandpass", 1200.0, 8000.0, q=5.0)
    rng = np.random.default_rng(12)
    x = (rng.standard_normal(300) + 1j * rng.standard_normal(300)
         ).astype(np.complex64)
    st = np.array([0.25 - 0.5j, -0.125 + 0.75j], np.complex64)
    for part in (np.real, np.imag):
        y, z = biquad_apply_plain(_t(part(x).copy()), b, a,
                                  _t(part(st).copy()))
        my, mz = _biquad_kernel_model(part(x), b, a, part(st))
        assert np.array_equal(y.numpy(), my) and np.array_equal(z.numpy(), mz)
    y, z = biquad_apply_plain(_t(x), b, a, _t(st))
    for part in (np.real, np.imag):
        my, mz = _biquad_kernel_model(part(x), b, a, part(st))
        assert np.array_equal(part(y.numpy()), my)
        assert np.array_equal(part(z.numpy()), mz)


def _cma_source_constants() -> dict:
    """kTile, kHist, kLaneTaps and kClip of csrc/cma.cu."""
    text = (Path(__file__).resolve().parent.parent / "sdrtrunk_tpu_torch"
            / "csrc" / "cma.cu").read_text()
    got = {name: re.search(rf"constexpr \w+ {name} = ([0-9.]+)f?;",
                           text).group(1)
           for name in ("kTile", "kHist", "kLaneTaps", "kClip")}
    return {k: float(v) if k == "kClip" else int(v) for k, v in got.items()}


def _cma_kernel_model(x, taps, modulus, mu):
    """csrc/cma.cu in NumPy float32, lane by lane: slot i of lane j < Q =
    P / T (T = min(P, kLaneTaps)) holds tap j + Q i and reads its delay
    line from the staged tile by index (two tiles of kTile samples, the
    last kHist of one carried in front of the next); a slot past the taps,
    and every slot of a lane at or above Q, reads +0 and holds +0 taps.
    Every slot's products (+0 exactly for those), its lane's own halving
    sums (the tree's first log2 T levels), then the xor butterfly over Q
    lanes (every lane below Q ends with the sum); the error; every slot's
    update, taken from the clipped error (the square root and divisions)
    only when er er + ei ei > kClip. The square root is the device's: the
    card's (the kernel's sqrtf and torch's on a CUDA tensor) is correctly
    rounded, torch's on this CPU is an ulp off for some inputs
    (sqrt(4.802518) gives 2.1914647, not 2.191465), so the model takes
    torch's, as the plain version does here."""
    f32 = np.float32
    c = _cma_source_constants()
    tile, hist = c["kTile"], c["kHist"]
    n_taps = len(taps)
    p = 1 << (n_taps - 1).bit_length()
    t = min(p, c["kLaneTaps"])
    q = p // t
    lane = np.arange(32)[:, None]
    tap = lane + q * np.arange(t)[None, :]              # (32, T)
    on = (lane < q) & (tap < n_taps)
    back = np.where(lane < q, tap, 0)
    taps = np.asarray(taps, np.complex64)
    tr = np.where(on, taps.real[np.minimum(tap, n_taps - 1)], f32(0.0))
    ti = np.where(on, taps.imag[np.minimum(tap, n_taps - 1)], f32(0.0))
    tr, ti = tr.astype(np.float32), ti.astype(np.float32)
    mod, mu, clip = f32(modulus), f32(mu), f32(c["kClip"])
    x = np.asarray(x, np.complex64)
    y = np.empty(len(x), np.complex64)
    sx = np.zeros((2, hist + tile + 1), np.complex64)
    tiles = -(-len(x) // tile)
    for k in range(tiles):
        t0, n = k * tile, min(tile, len(x) - k * tile)
        sx[k & 1, hist:hist + n] = x[t0:t0 + n]
        for m in range(n):
            b = np.where(on, sx[k & 1, hist + m - back], np.complex64(0))
            br, bi = b.real.astype(np.float32), b.imag.astype(np.float32)
            pr, pi = tr * br - ti * bi, tr * bi + ti * br
            h = t // 2
            while h:
                pr = pr[:, :h] + pr[:, h:2 * h]
                pi = pi[:, :h] + pi[:, h:2 * h]
                h //= 2
            yr, yi = pr[:, 0], pi[:, 0]
            off = q // 2
            while off:
                yr = yr + yr[np.arange(32) ^ off]
                yi = yi + yi[np.arange(32) ^ off]
                off //= 2
            assert len({float(v) for v in yr[:q]}) == 1
            r, i = yr[0], yi[0]
            f = f32(f32(f32(r * r) + f32(i * i)) - mod)
            er, ei = f32(r * f), f32(i * f)
            m2 = f32(f32(er * er) + f32(ei * ei))
            if m2 > clip:
                # the square root as the plain version takes it here
                d = max(f32(torch.sqrt(torch.tensor(m2)).item()), f32(1e-12))
                er, ei = f32(er / d), f32(ei / d)
            tr, ti = (tr - mu * (br * er + bi * ei),
                      ti - mu * (br * ei - bi * er))
            # the off slots stay +0 (or NaN once er is, as every tap then)
            off_slots = np.concatenate([tr[~on], ti[~on]])
            assert np.all((off_slots == 0) & ~np.signbit(off_slots)) \
                or np.isnan(er)
            y[t0 + m] = complex(r, i)
        if k + 1 < tiles:
            sx[(k + 1) & 1, :hist] = sx[k & 1, tile:tile + hist]
    out = np.zeros(n_taps, np.complex64)
    out.real[tap[on]] = tr[on]
    out.imag[tap[on]] = ti[on]
    return y, out


def _cma_input(n, n_taps, seed):
    """QPSK through a static channel, scaled so that the clip engages
    (|e| > 1) at the start, and taps near a center spike."""
    rng = np.random.default_rng(seed)
    syms = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, n)))
    x = (1.6 * np.convolve(syms, [1.0, 0.25 - 0.1j])[:n]).astype(np.complex64)
    taps = np.zeros(n_taps, np.complex64)
    taps[0] = 1.0
    taps[1:] = 0.01 * (rng.standard_normal(n_taps - 1)
                       + 1j * rng.standard_normal(n_taps - 1))
    return x, taps


@pytest.mark.parametrize("n_taps", [11, 1, 4, 5, 16, 17, 32])
def test_cma_kernel_arithmetic_equals_plain_loop(n_taps):
    """The kernel's lane-by-lane arithmetic bit for bit against the plain
    version, at the default 11 taps (a tree over 16: 8 lanes of 2 taps,
    three shuffled levels), one tap (no tree), four, five, sixteen,
    seventeen and the kernel's 32 (16 lanes, four shuffled levels); QPSK
    through a static channel, with samples whose clip engages (|e| > 1)
    at the start."""
    x, taps = _cma_input(300, n_taps, 13)
    y, t = cma_equalize_plain(_t(x), _t(taps), modulus=1.0, mu=0.003)
    my, mt = _cma_kernel_model(x, taps, 1.0, 0.003)
    assert np.array_equal(y.numpy(), my)
    assert np.array_equal(t.numpy(), mt)


@pytest.mark.parametrize("n_taps", [11, 32])
def test_cma_kernel_tiles_carry_the_delay_line(n_taps):
    """A stream longer than the kernel's tile (kTile + 300 samples): the
    delay line read across the tile boundary from the kHist samples
    carried in front of the next tile, bit for bit against the plain
    version."""
    tile = _cma_source_constants()["kTile"]
    x, taps = _cma_input(tile + 300, n_taps, 15)
    y, t = cma_equalize_plain(_t(x), _t(taps), modulus=1.0, mu=0.003)
    my, mt = _cma_kernel_model(x, taps, 1.0, 0.003)
    assert np.array_equal(y.numpy(), my)
    assert np.array_equal(t.numpy(), mt)


def test_cma_clip_threshold_equals_the_square_root_test():
    """The kernel takes the clip's square root only when m = er er + ei ei
    > kClip = 1 + 2^-23: a correctly rounded square root is monotone and
    rounds sqrt(1 + 2^-23) to 1, so the test equals sqrt(m) > 1 exactly.
    Held on every float32 within 2^-10 of 1, and 0, inf and nan."""
    clip = np.float32(_cma_source_constants()["kClip"])
    assert clip == np.float32(1) + np.float32(2.0 ** -23)
    lo = np.float32(1 - 2.0 ** -10).view(np.int32)
    hi = np.float32(1 + 2.0 ** -10).view(np.int32)
    m = np.arange(lo, hi + 1, dtype=np.int32).view(np.float32)
    m = np.concatenate([m, np.float32([0.0, np.inf, np.nan])])
    assert len(m) == 2 ** 13 + 2 ** 14 + 1 + 3
    with np.errstate(invalid="ignore"):
        assert np.array_equal(m > clip, np.sqrt(m) > np.float32(1))
    # and against torch's square root on this CPU, which the plain version
    # takes here (not correctly rounded everywhere, but not near 1)
    assert np.array_equal(m > clip, (torch.sqrt(_t(m)) > 1).numpy())
    assert np.sqrt(clip) == 1 and np.sqrt(np.nextafter(clip, np.inf)) > 1


def _biquad_tiles_model(x, b, a, state, tile, stages, kv):
    """csrc/biquad.cu's data movement for one row of NF floats (kv floats
    a sample, a complex row interleaved): tiles of `tile` floats through a
    ring of `stages` stage buffers filled stages - 1 tiles ahead, each
    walked a float4 at a time with the float4 after it read ahead, then an
    unaligned tail, y written in place and stored; the step as
    ``_biquad_kernel_model``'s."""
    f32 = np.float32
    b0, b1, b2 = (f32(v) for v in b)
    a1, a2 = f32(a[1]), f32(a[2])
    z1 = [f32(v) for v in state[0]]
    z2 = [f32(v) for v in state[1]]
    nf = len(x)
    ring = np.full((stages, tile + 4), np.nan, np.float32)
    y = np.full(nf, np.nan, np.float32)
    tiles = -(-nf // tile)

    def fill(i):
        n = min(tile, nf - i * tile)
        ring[i % stages, :n] = x[i * tile:i * tile + n]

    def step(xn, v):
        yn = f32(f32(b0 * xn) + z1[v])
        z1[v] = f32(f32(f32(b1 * xn) - f32(a1 * yn)) + z2[v])
        z2[v] = f32(f32(b2 * xn) - f32(a2 * yn))
        return yn

    for i in range(min(stages - 1, tiles)):
        fill(i)
    for i in range(tiles):
        row, n = ring[i % stages], min(tile, nf - i * tile)
        n4 = n & ~3
        cur = row[0:4].copy()
        for f in range(0, n4, 4):
            nxt = row[f + 4:f + 8].copy()
            row[f:f + 4] = [step(cur[j], j % kv) for j in range(4)]
            cur = nxt
        for f in range(n4, n, kv):
            for v in range(kv):
                row[f + v] = step(row[f + v], v)
        y[i * tile:i * tile + n] = row[:n]
        if i + stages - 1 < tiles:
            fill(i + stages - 1)
    return y, np.array([z1, z2], np.float32)


@pytest.mark.parametrize("nf,kv", [(1000, 1), (1003, 1), (64, 1), (3, 1),
                                   (1002, 2), (1000, 2), (2, 2)])
def test_biquad_kernel_tiles_equal_plain_loop(nf, kv):
    """The kernel's tiling (read from csrc/biquad.cu, at a quarter of its
    tile to cross more tiles) with its float4 walk and tail, bit for bit
    against the plain loop on a float32 row and on a complex64 row's
    interleaved floats, rows whose length is a multiple of 4 (the bulk
    copies) or not."""
    text = (Path(__file__).resolve().parent.parent / "sdrtrunk_tpu_torch"
            / "csrc" / "biquad.cu").read_text()
    tile = int(re.search(r"constexpr int kTile = (\d+);", text).group(1)) // 4
    stages = int(re.search(r"constexpr int kStages = (\d+);", text).group(1))
    b, a = biquad_design("bandpass", 1200.0, 8000.0, q=5.0)
    x = np.random.default_rng(16).standard_normal(nf).astype(np.float32)
    st = np.array([[0.25, -0.5], [-0.125, 0.75]], np.float32)[:, :kv]
    if kv == 1:
        want, want_st = biquad_apply_plain(_t(x), b, a, _t(st[:, 0].copy()))
        want, want_st = want.numpy(), want_st.numpy()[:, None]
    else:
        z = x.view(np.complex64)
        w, ws = biquad_apply_plain(_t(z), b, a,
                                   _t(st[:, 0] + 1j * st[:, 1]).to(
                                       torch.complex64))
        want = w.numpy().view(np.float32)
        want_st = np.stack([ws.numpy().real, ws.numpy().imag], 1)
    y, z = _biquad_tiles_model(x, b, a, st, tile, stages, kv)
    assert np.array_equal(y, want) and np.array_equal(z, want_st)


def test_cpu_tensors_never_reach_the_kernel_wrappers(monkeypatch):
    """``biquad_apply`` and ``cma_equalize`` send a CPU tensor to their
    plain versions: with both wrappers' builds made to raise, the CPU
    calls still return the plain versions' results. A tensor elsewhere
    (here on the meta device) goes to the wrapper, which refuses it, and
    the plain versions do not run in its place."""
    from sdrtrunk_tpu_torch.dsp import biquad_cuda, cma_cuda, misc

    def fail():
        raise AssertionError("a CPU tensor reached a kernel wrapper")

    monkeypatch.setattr(biquad_cuda, "build", fail)
    monkeypatch.setattr(cma_cuda, "build", fail)
    b, a = biquad_design("lowpass", 1000.0, 8000.0)
    x = torch.as_tensor(np.random.default_rng(14).standard_normal(
        (2, 64)).astype(np.float32))
    got = biquad_apply(x, b, a)
    want = biquad_apply_plain(x, b, a)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    z = torch.complex(x[0], x[1])
    got = cma_equalize(z, mu=0.003)
    want = cma_equalize_plain(z, cma_init(device="cpu"), mu=0.003)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    def plain(*args, **kwargs):
        raise AssertionError("the plain loop ran for a non-CPU tensor")

    monkeypatch.setattr(misc, "biquad_apply_plain", plain)
    monkeypatch.setattr(misc, "cma_equalize_plain", plain)
    with pytest.raises(ValueError, match="CUDA"):
        misc.biquad_apply(x.to("meta"), b, a)
    with pytest.raises(ValueError, match="CUDA"):
        misc.cma_equalize(z.to("meta"), cma_init(device="meta"))


def test_iq_correction_removes_dc_like_reference():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal(20000) + 1j * rng.standard_normal(20000)
         + (0.3 - 0.2j)).astype(np.complex64)
    y, mean = iq_correction(_t(x), ratio=0.005)
    assert abs(y.numpy()[-2000:].mean()) < 0.02
    assert complex(mean) == pytest.approx(0.3 - 0.2j, abs=0.15)
    jy, jmean = jmisc.iq_correction(jnp.asarray(x), ratio=0.005)
    _close(y, jy, 1e-5)
    _close(mean, jmean, 1e-6)
    # streaming: the second block continues from the first's mean
    y1, m1 = iq_correction(_t(x[:9000]), 0.005)
    y2, _ = iq_correction(_t(x[9000:]), 0.005, m1)
    _close(torch.cat([y1, y2]), y.numpy(), 1e-5)


def test_hilbert_produces_analytic_signal_like_reference():
    fs = 100e3
    hb = design.half_band(22)  # 23 taps: (23+1)%4==0
    jc, jg, jq = jmisc.hilbert_taps(hb)
    c, g, q = hilbert_taps(hb)
    assert (c, g) == (jc, jg)
    np.testing.assert_array_equal(q, jq)
    t = np.arange(8192) / fs
    f = 20e3
    x = np.cos(2 * np.pi * f * t).astype(np.float32)
    y, st = real_to_complex(_t(x), hb)
    jy, jst = jmisc.real_to_complex(jnp.asarray(x), hb)
    _close(y, jy, 1e-6)
    _close(st, jst, 0.0)
    y = y.numpy()[200:-200]
    spec = np.fft.fftshift(np.fft.fft(y * np.hanning(len(y))))
    freqs = np.fft.fftshift(np.fft.fftfreq(len(y), 1 / fs))
    pos = np.abs(spec[np.argmin(np.abs(freqs - f))])
    neg = np.abs(spec[np.argmin(np.abs(freqs + f))])
    assert pos / max(neg, 1e-9) > 100.0  # negative image suppressed > 40 dB
    # streaming equals one shot
    a, s1 = real_to_complex(_t(x[:3000]), hb)
    b, _ = real_to_complex(_t(x[3000:]), hb, s1)
    full, _ = real_to_complex(_t(x), hb)
    _close(torch.cat([a, b]), full.numpy(), 1e-6)


# --- CIC -------------------------------------------------------------

def test_prime_factors():
    for n in (96, 1, 53, 2801 * 53 * 59, 360):
        assert prime_factors(n) == jcic.prime_factors(n)
    assert prime_factors(96) == [3, 2, 2, 2, 2, 2]
    with pytest.raises(ValueError):
        prime_factors(0)


def test_cic_decimate_matches_reference():
    x = torch.ones(960, dtype=torch.complex64)
    y = cic_decimate(x, 96)
    assert y.shape == (10,)
    _close(y, np.ones(10), 1e-6)
    rng = np.random.default_rng(8)
    z = (rng.standard_normal((3, 960)) + 1j * rng.standard_normal((3, 960))
         ).astype(np.complex64)
    _close(cic_decimate(_t(z), 96), jcic.cic_decimate(jnp.asarray(z), 96),
           1e-6)
    with pytest.raises(ValueError):
        cic_decimate(x[:100], 96)


@pytest.mark.parametrize("offset_hz, tone_hz", [(300e3, 2e3), (300e3, 60e3)])
def test_cic_channel_matches_reference(offset_hz, tone_hz):
    fs = 2_400_000.0
    ddc = CICChannel.design(fs, frequency_offset=offset_hz, channel_rate=25e3,
                            device="cpu")
    jddc = jcic.CICChannel.design(fs, frequency_offset=offset_hz,
                                  channel_rate=25e3)
    assert ddc.decimation == jddc.decimation == 96
    np.testing.assert_array_equal(ddc.cleanup_taps, jddc.cleanup_taps)
    n = 96 * 800
    t = np.arange(n) / fs
    x = np.exp(2j * np.pi * (offset_hz + tone_hz) * t).astype(np.complex64)
    y, (phase, hist) = ddc(_t(x))
    jy, (jphase, jhist) = jddc(jnp.asarray(x))
    _close(y, jy, 1e-5)
    _close(phase, jphase, 1e-6)
    _close(hist, jhist, 1e-5)
    y = y.numpy()[200:]
    if tone_hz < 10e3:          # the tone in the channel: found and kept
        ph = np.angle(y[1:] * np.conj(y[:-1]))
        assert ph.mean() * ddc.output_rate / (2 * np.pi) == pytest.approx(
            tone_hz, abs=20.0)
        assert np.abs(y).mean() == pytest.approx(1.0, abs=0.1)
    else:                       # a distant tone: rejected
        assert np.abs(y).mean() < 0.05
    # two blocks with the carried phase and history, as the reference
    a, st = ddc(_t(x[:96 * 300]))
    b, _ = ddc(_t(x[96 * 300:]), st)
    ja, jst = jddc(jnp.asarray(x[:96 * 300]))
    jb, _ = jddc(jnp.asarray(x[96 * 300:]), jst)
    _close(torch.cat([a, b]), np.concatenate([ja, jb]), 1e-5)


# --- two-channel synthesizer and the channelizer's helpers ----------------

def _two_bin_setup(m=8, m0=2):
    bw = 12500.0
    fs = m * bw
    return (Channelizer.design(fs, bw, 9, channels=m, device="cpu"),
            JChannelizer.design(fs, bw, 9, channels=m), bw, fs, m0)


def test_two_channel_synthesizer_joint_band_like_reference():
    ch, jch, bw, fs, m0 = _two_bin_setup()
    syn = TwoChannelSynthesizer(channel_sample_rate=2 * bw, device="cpu")
    jsyn_ = jsyn.TwoChannelSynthesizer(channel_sample_rate=2 * bw)
    n = ch.channels * 600
    t = np.arange(n) / fs
    for nu in (-0.3, 0.0, 0.5, 1.0, 1.3):
        x = np.exp(2j * np.pi * (m0 + nu) * bw * t).astype(np.complex64)
        y, _ = ch(_t(x))
        z, st = syn(y[:, m0], y[:, m0 + 1], syn.init_state())
        jy, _ = jch(jnp.asarray(x))
        jz, jst = jsyn_(jy[:, m0], jy[:, m0 + 1], jsyn_.init_state())
        _close(z, jz, 1e-5)
        assert int(st) == int(jst)
        seg = z.numpy()[300:-300]
        ph = np.angle(seg[1:] * np.conj(seg[:-1]))
        assert ph.mean() * 2 * bw / (2 * np.pi) == pytest.approx(
            (nu - 0.5) * bw, abs=10.0)
        assert np.abs(seg).mean() == pytest.approx(1.0, abs=0.025)
        assert np.abs(seg).std() < 0.01
    # non-adjacent bin rejection
    x = np.exp(2j * np.pi * (m0 + 2.0) * bw * t).astype(np.complex64)
    y, _ = ch(_t(x))
    z, _ = synthesize_two(y[:, m0], y[:, m0 + 1])
    assert np.abs(z.numpy()[300:-300]).mean() < 1e-3


def test_two_channel_synthesizer_streams_and_wraps():
    ch, _, bw, fs, m0 = _two_bin_setup()
    n = ch.channels * 400
    t = np.arange(n) / fs
    x = np.exp(2j * np.pi * (m0 + 0.4) * bw * t).astype(np.complex64)
    y, _ = ch(_t(x))
    c1, c2 = y[:, m0], y[:, m0 + 1]
    full, _ = synthesize_two(c1, c2)
    st, parts = None, []
    quarter = c1.shape[0] // 4
    for i in range(4):
        z, st = synthesize_two(c1[i * quarter:(i + 1) * quarter],
                               c2[i * quarter:(i + 1) * quarter], st)
        parts.append(z)
    assert torch.equal(torch.cat(parts), full)
    # a batch of pairs: leading axes broadcast
    zz, _ = synthesize_two(torch.stack([c1, c2]), torch.stack([c2, c1]))
    assert torch.equal(zz[0], full)
    # the upper bin wraps to bin 0
    m0 = ch.channels - 1
    x = np.exp(2j * np.pi * (m0 + 0.5) * bw * np.arange(ch.channels * 600)
               / fs).astype(np.complex64)
    y, _ = ch(_t(x))
    z, _ = synthesize_two(y[:, m0], y[:, 0])
    assert np.abs(z.numpy()[300:-300]).mean() == pytest.approx(1.0, abs=0.02)


def test_channelizer_from_taps_and_channelize_match_reference():
    m = 16
    proto = design.sinc_m2_channelizer(12500.0, m, 9)
    ch = Channelizer.from_taps(proto, m * 12500.0, m, device="cpu")
    jch = JChannelizer.from_taps(proto, m * 12500.0, m)
    np.testing.assert_array_equal(ch.hmat.numpy(), jch.hmat)
    assert (ch.channels, ch.taps_per_channel) == (jch.channels,
                                                  jch.taps_per_channel)
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(m * 64) + 1j * rng.standard_normal(m * 64)
         ).astype(np.complex64)
    y = channelize(_t(x), proto, m, m * 12500.0)
    _close(y, jchannelize(jnp.asarray(x), proto, m, m * 12500.0), 1e-5)
    assert y.shape == (128, m)
