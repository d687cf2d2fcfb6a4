"""Tests of the CUDA kernels (DQPSK, Gardner DQPSK, bit timing, the biquad,
the CMA equalizer and the channelizer's branch sums) and of the analog and
analog-trunking chains on the card; they need a card and skip without one.

The file imports no JAX, so that it runs on a machine with a card and no
JAX installed. tests/conftest.py imports JAX, so run it there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from sdrtrunk_tpu_torch.signal.generators import (awgn, c4fm_modulate,
                                                  lsm_modulate, nbfm_modulate,
                                                  random_dibits)
from sdrtrunk_tpu_torch.convert import tree_map
from sdrtrunk_tpu_torch.decoders.ltr import LTRLiveDecoder
from sdrtrunk_tpu_torch.decoders.nbfm import NBFMDecoder
from sdrtrunk_tpu_torch.dsp import bit_timing_cuda, dqpsk_cuda, gardner_cuda
from sdrtrunk_tpu_torch.dsp.afsk import AFSK1200Demodulator
from sdrtrunk_tpu_torch.dsp.bit_timing import (BitTimingGeometry, bit_timing,
                                               bit_timing_plain)
from sdrtrunk_tpu_torch.dsp.fsk import LTRFSKDemodulator
from sdrtrunk_tpu_torch.dsp.psk import (DQPSKDemodulator, DQPSKState,
                                        GardnerDQPSKDemodulator, GardnerState)
from sdrtrunk_tpu_torch.tree import tree_leaves
import test_torch_bit_timing_walk as walk

torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _c4fm_block(channels: int, t: int, seed: int) -> np.ndarray:
    rows = []
    for c in range(channels):
        x = c4fm_modulate(random_dibits(t // 5 + 16, seed=seed + c), 25000.0)
        rows.append(awgn(x[:t], snr_db=30.0,
                         rng=np.random.default_rng(seed + 100 + c)))
    return np.stack(rows).astype(np.complex64)


def _state(demod, c):
    return DQPSKState(*[a.expand((c,) + a.shape).clone()
                        for a in demod.init_state()])


@pytest.mark.cuda
def test_kernel_matches_plain_loop_on_card(card):
    """The kernel and the plain loop agree bit for bit on the card."""
    c, t = 64, 2048
    x = torch.as_tensor(_c4fm_block(c, t, 3), device=card)
    demod = DQPSKDemodulator(25000.0, device=card)
    s0 = _state(demod, c)
    before = dqpsk_cuda.dqpsk_cuda.launches
    by_key = dqpsk_cuda.dqpsk_cuda.launches_by[(0.3, 10)]
    dibits, valid, state = demod.batched(x, s0)
    assert dqpsk_cuda.dqpsk_cuda.launches == before + 1
    assert dqpsk_cuda.dqpsk_cuda.launches_by[(0.3, 10)] == by_key + 1
    ref_dibits, ref_valid, ref_state = demod.scan_batched(x, s0)
    assert float(valid.float().mean()) > 0.15
    assert torch.equal(valid, ref_valid)
    assert torch.equal(dibits, ref_dibits)
    for a, b in zip(state, ref_state):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(card):
    demod = DQPSKDemodulator(25000.0, device=card)
    s0 = _state(demod, 2)
    with pytest.raises(ValueError, match="complex64"):
        demod.batched(torch.zeros((2, 16), dtype=torch.complex128,
                                  device=card), s0)
    with pytest.raises(ValueError, match="window"):
        demod.batched(torch.zeros((3, 16), dtype=torch.complex64,
                                  device=card), s0)
    # above the kernels' widest window (W = 128): refused before a launch
    launches = dqpsk_cuda.dqpsk_cuda.launches
    wide = DQPSKDemodulator(312000.0, 4800.0, device=card)    # W = 130
    with pytest.raises(ValueError, match="W = 130 .*312000.0 Hz, 4800.0 Bd"
                                         r".*\[8, 128\]"):
        wide.batched(torch.zeros((2, 16), dtype=torch.complex64,
                                 device=card), _state(wide, 2))
    assert dqpsk_cuda.dqpsk_cuda.launches == launches


@pytest.mark.cuda
def test_kernel_w16_matches_plain_loop_on_card(card):
    """P25 Phase 2's decision-directed timing: the DQPSK kernel's W = 16
    instantiation (50 kHz, 6000 Bd, gain 0.3) and its plain loop agree bit
    for bit, carried state included, across two calls."""
    c, t = 64, 4096
    rows = []
    for i in range(c):
        x = c4fm_modulate(random_dibits(t // 8 + 16, seed=40 + i), 50000.0,
                          6000.0)
        rows.append(awgn(x[:t], snr_db=30.0,
                         rng=np.random.default_rng(140 + i)))
    x = torch.as_tensor(np.stack(rows).astype(np.complex64), device=card)
    demod = DQPSKDemodulator(50000.0, 6000.0, 0.3, device=card)
    assert demod.window_len == 16
    s0 = _state(demod, c)
    before = dqpsk_cuda.dqpsk_cuda.launches_by[(0.3, 16)]
    d1, v1, s1 = demod.batched(x[:, :1500], s0)
    d2, v2, s2 = demod.batched(x[:, 1500:], s1)
    assert dqpsk_cuda.dqpsk_cuda.launches_by[(0.3, 16)] == before + 2
    ref_d, ref_v, ref_s = demod.scan_batched(x, s0)
    assert float(ref_v.float().mean()) > 0.1
    assert torch.equal(torch.cat([v1, v2], 1), ref_v)
    assert torch.equal(torch.cat([d1, d2], 1), ref_d)
    for a, b in zip(s2, ref_s):
        assert torch.equal(a, b)


def _lsm_block(channels: int, t: int, seed: int, rate: float,
               baud: float) -> np.ndarray:
    rows = []
    for c in range(channels):
        dib = random_dibits(int(t * baud / rate) + 16, seed=seed + c)
        x = lsm_modulate(dib, sample_rate=rate, symbol_rate=baud)
        rows.append(awgn(x[:t], snr_db=30.0,
                         rng=np.random.default_rng(seed + 100 + c)))
    return np.stack(rows).astype(np.complex64)


def _gstate(demod, c):
    return GardnerState(*[a.expand((c,) + a.shape).clone()
                          for a in demod.init_state()])


@pytest.mark.cuda
@pytest.mark.parametrize("rate,baud,gain,window", [
    (25000.0, 4800.0, 0.3, 11),        # LSM
    (50000.0, 6000.0, 0.1, 16)])       # P25 Phase 2
def test_gardner_kernel_matches_plain_loop_on_card(card, rate, baud, gain,
                                                   window):
    """The Gardner kernel and its plain loop agree bit for bit, carried
    state included, across two calls."""
    c, t = 64, 2048
    x = torch.as_tensor(_lsm_block(c, t, 5, rate, baud), device=card)
    demod = GardnerDQPSKDemodulator(rate, baud, gain, device=card)
    assert demod.window_len == window
    s0 = _gstate(demod, c)
    before = gardner_cuda.gardner_cuda.launches
    by_window = gardner_cuda.gardner_cuda.launches_by[window]
    d1, v1, s1 = demod.batched(x[:, :1000], s0)
    d2, v2, s2 = demod.batched(x[:, 1000:], s1)
    assert gardner_cuda.gardner_cuda.launches == before + 2
    assert gardner_cuda.gardner_cuda.launches_by[window] == by_window + 2
    ref_d, ref_v, ref_s = demod.scan_batched(x, s0)
    assert float(ref_v.float().mean()) > 0.1
    assert torch.equal(torch.cat([v1, v2], 1), ref_v)
    assert torch.equal(torch.cat([d1, d2], 1), ref_d)
    for a, b in zip(s2, ref_s):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_gardner_kernel_rejects_what_it_does_not_take(card):
    demod = GardnerDQPSKDemodulator(25000.0, device=card)
    s0 = _gstate(demod, 2)
    with pytest.raises(ValueError, match="complex64"):
        demod.batched(torch.zeros((2, 16), dtype=torch.complex128,
                                  device=card), s0)
    with pytest.raises(ValueError, match="window"):
        demod.batched(torch.zeros((3, 16), dtype=torch.complex64,
                                  device=card), s0)
    with pytest.raises(ValueError, match="prev_cur_symbol"):
        demod.batched(torch.zeros((2, 16), dtype=torch.complex64,
                                  device=card),
                      s0._replace(prev_cur_symbol=s0.pll_freq))
    launches = gardner_cuda.gardner_cuda.launches
    wide = GardnerDQPSKDemodulator(312000.0, device=card)    # W = 130
    with pytest.raises(ValueError, match="W = 130 .*312000.0 Hz, 4800.0 Bd"
                                         r".*\[8, 128\]"):
        wide.batched(torch.zeros((2, 16), dtype=torch.complex64,
                                 device=card), _gstate(wide, 2))
    assert gardner_cuda.gardner_cuda.launches == launches


# (kernel, sample rate, baud, timing gain): C4FM, DMR, LSM, P25 Phase 2,
# and P25 Phase 2 on the decision-directed loop (DQPSK at W = 16)
_LOOPS = {"dqpsk": ("dqpsk", 25000.0, 4800.0, 0.3),
          "dmr": ("dqpsk", 25000.0, 4800.0, 0.4),
          "lsm": ("gardner", 25000.0, 4800.0, 0.3),
          "p25p2": ("gardner", 50000.0, 6000.0, 0.1),
          "p25p2_decision": ("dqpsk", 50000.0, 6000.0, 0.3)}


def _spread_block(kind, c, t, rate, baud, seed):
    """(c, t) complex64 at 30 dB; channels 0-31 at symbol rates spread
    over +/-2%, the rest at the nominal rate."""
    rows = []
    for i in range(c):
        b = baud * (1.0 + 0.02 * (2.0 * i / 31 - 1.0)) if i < 32 else baud
        dib = random_dibits(int(t * b / rate) + 16, seed=seed + i)
        x = (c4fm_modulate(dib, rate, b) if kind == "dqpsk"
             else lsm_modulate(dib, sample_rate=rate, symbol_rate=b))
        rows.append(awgn(x[:t], snr_db=30.0,
                         rng=np.random.default_rng(seed + 100 + i)))
    return np.stack(rows).astype(np.complex64)


def _assert_same(got, want):
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("loop", list(_LOOPS))
def test_symbol_major_edge_cases_on_card(card, loop):
    """The cases the symbol-major loop creates, bit for bit against the
    plain loop: 37 channels (not a multiple of a warp) whose symbol rates
    drift apart, T = 997 (no run length divides it) and T = 1, a symbol
    due at t = 0, and two calls with carried state."""
    kind, rate, baud, gain = _LOOPS[loop]
    cls = DQPSKDemodulator if kind == "dqpsk" else GardnerDQPSKDemodulator
    demod = cls(rate, baud, gain, device=card)
    c, t = 37, 997
    x = torch.as_tensor(_spread_block(kind, c, t, rate, baud, 9), device=card)
    s0 = _state(demod, c) if kind == "dqpsk" else _gstate(demod, c)
    s0.sampling_point[::3] = 1.5
    want = demod.scan_batched(x, s0)
    assert bool(want[1][::3, 0].all())                 # due at t = 0
    _assert_same(demod.batched(x, s0), want)
    _assert_same(demod.batched(x[:, :1], s0), demod.scan_batched(x[:, :1], s0))
    d1, v1, s1 = demod.batched(x[:, :400], s0)
    d2, v2, s2 = demod.batched(x[:, 400:], s1)
    _assert_same((torch.cat([d1, d2], 1), torch.cat([v1, v2], 1), s2), want)


@pytest.mark.cuda
def test_nbfm_decoder_on_card_matches_cpu(card):
    """NBFMDecoder.batched_call on the card against the same call on the
    CPU, two chunks with carried state: audio within 1e-4 (TF32 is off, so
    the convolutions and matmuls run in float32 on both), the gate
    exactly. Every row carries a tone, so the FM discriminator's phase
    steps stay far from +/-pi."""
    c, t = 16, 5000
    rng = np.random.default_rng(7)
    rows = []
    for i in range(c):
        audio = 0.7 * np.sin(2 * np.pi * (400.0 + 50.0 * i)
                             * np.arange(t // 3 + 80) / 8000.0)
        iq = nbfm_modulate(audio, 8000.0, 25000.0)[:t] * (0.05 + 0.05 * i)
        rows.append(iq * np.exp(1j * rng.uniform(0, 2 * np.pi)))
    x = np.stack(rows).astype(np.complex64)
    out = {}
    for dev in ("cpu", card):
        dec = NBFMDecoder(device=dev)
        state = {k: v.expand((c,) + v.shape).clone()
                 for k, v in dec.init_state().items()}
        chunks = []
        for part in (x[:, :2500], x[:, 2500:]):
            o, state = dec.batched_call(torch.as_tensor(part, device=dev),
                                        state)
            chunks.append({k: v.cpu() for k, v in o.items()})
        out[str(dev)] = chunks
    for got, want in zip(out["cuda"], out["cpu"]):
        assert got["audio"].shape == want["audio"].shape == (c, 800)
        assert float((got["audio"] - want["audio"]).abs().max()) <= 1e-4
        assert float((got["power_db"] - want["power_db"]).abs().max()) <= 1e-4
        assert torch.equal(got["audio_gate"], want["audio_gate"])
    assert float(out["cpu"][1]["audio"].abs().max()) > 0.3


def _timing_block(geom, c, t, seed, device):
    """Slicer inputs whose crossings come and go in the window: square
    waves around the symbol period with noise, row 5 all zero; a random
    delay line, and a symbol due at t = 0 on every third channel."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    period = torch.linspace(0.7, 1.6, c)[:, None] * 2.0 * geom.sps
    x = torch.sign(torch.sin(2 * np.pi * torch.arange(t)[None, :] / period
                             + 0.3)) + 0.3 * torch.randn((c, t), generator=gen)
    x[5] = 0.0
    window = (torch.rand((c, geom.window_len), generator=gen) > 0.5
              ).to(torch.int8)
    sp = torch.full((c,), float(np.float32(geom.sps * 1.5)))
    sp[::3] = 1.5
    return x.to(device), window.to(device), sp.to(device)


_TIMING = {"ltr": (lambda: LTRFSKDemodulator(device="cpu").geometry, False),
           "afsk": (lambda: AFSK1200Demodulator(device="cpu").geometry,
                    False),
           "afsk_inverted": (
               lambda: AFSK1200Demodulator(device="cpu").geometry, True),
           "w64_two_crossings": (lambda: BitTimingGeometry(
               64, 16, 32, 33, 16.0, 32.0, 0.25, True), False)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_TIMING))
def test_bit_timing_kernel_matches_plain_loop_on_card(card, case):
    """The bit-timing kernel and its plain loop agree bit for bit (bits,
    valid, window, sampling point) on a small edge-case block: 37 channels,
    T = 997 and T = 1, a symbol due at t = 0, an all-zero channel, and two
    calls with carried state."""
    make, invert = _TIMING[case]
    geom = make()
    x, window, sp = _timing_block(geom, 37, 997, 11, card)
    want = bit_timing_plain(geom, x, window, sp, invert)
    assert bool(want[1][::3, 0].all())
    before = bit_timing_cuda.bit_timing_cuda.launches
    by_window = bit_timing_cuda.bit_timing_cuda.launches_by[geom.window_len]
    got = bit_timing(geom, x, window, sp, invert)
    assert bit_timing_cuda.bit_timing_cuda.launches == before + 1
    assert (bit_timing_cuda.bit_timing_cuda.launches_by[geom.window_len]
            == by_window + 1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(bit_timing(geom, x[:, :1], window, sp, invert),
                    bit_timing_plain(geom, x[:, :1], window, sp, invert)):
        assert torch.equal(a, b)
    b1, v1, w1, s1 = bit_timing(geom, x[:, :400], window, sp, invert)
    b2, v2, w2, s2 = bit_timing(geom, x[:, 400:], w1, s1, invert)
    assert torch.equal(torch.cat([b1, b2], 1), want[0])
    assert torch.equal(torch.cat([v1, v2], 1), want[1])
    assert torch.equal(w2, want[2]) and torch.equal(s2, want[3])


@pytest.mark.cuda
@pytest.mark.parametrize("geom_name,invert", walk.CASES, ids=walk.CASE_IDS)
def test_bit_timing_kernel_walk_edges_on_card(card, geom_name, invert):
    """The symbol-major kernel against its plain loop on the card, on the
    edge blocks its CPU model is held on (tests/test_torch_bit_timing_walk.py):
    37 channels (the last block part full) with an all-zero channel and
    counters entering at 1.5, 1, 0.3 and below zero; T = 1, T = 997 (rows
    off the 4-byte boundary) and T spanning two of the kernel's tiles; two
    calls with carried state; and counters entering at 2^23 and beyond,
    +-inf, NaN and integers. bits, valid, window and sampling point
    identical (the sampling point bit for bit, NaN included)."""
    geom = walk.GEOMETRIES[geom_name]
    x, window, _ = (torch.as_tensor(a, device=card) for a in
                    walk.edge_block(geom, len(walk.ODD_SP), 997, 44))
    sp = torch.as_tensor(walk.ODD_SP, device=card)
    got = bit_timing(geom, x, window, sp, invert)
    want = bit_timing_plain(geom, x, window, sp, invert)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert torch.equal(got[3].view(torch.int32), want[3].view(torch.int32))
    for t in (1, 997, walk.K_TILE + 997):
        x, window, sp = (torch.as_tensor(a, device=card)
                         for a in walk.edge_block(geom, 37, t, 5))
        want = bit_timing_plain(geom, x, window, sp, invert)
        got = bit_timing(geom, x, window, sp, invert)
        for a, b in zip(got, want):
            assert torch.equal(a, b), t
        if t == 997:
            b1, v1, w1, s1 = bit_timing(geom, x[:, :400], window, sp, invert)
            b2, v2, w2, s2 = bit_timing(geom, x[:, 400:], w1, s1, invert)
            assert torch.equal(torch.cat([b1, b2], 1), want[0])
            assert torch.equal(torch.cat([v1, v2], 1), want[1])
            assert torch.equal(w2, want[2]) and torch.equal(s2, want[3])


@pytest.mark.cuda
def test_bit_timing_kernel_rejects_what_it_does_not_take(card):
    geom = LTRFSKDemodulator(device="cpu").geometry
    x, window, sp = _timing_block(geom, 8, 16, 1, card)
    with pytest.raises(ValueError, match="float32"):
        bit_timing(geom, x.double(), window, sp)
    with pytest.raises(ValueError, match="window"):
        bit_timing(geom, x, window[:, :12].contiguous(), sp)
    with pytest.raises(ValueError, match="sampling_point"):
        bit_timing(geom, x, window, sp[:2])
    with pytest.raises(ValueError, match=r"\(C, T\)"):
        bit_timing(geom, x[0], window, sp)
    # a delay line longer than the kernel's eight 64-bit words (LTR at 77
    # kHz, W = 513), refused before a launch; the plain loop takes it
    wide = LTRFSKDemodulator(sample_rate=77000.0, device="cpu").geometry
    x, window, sp = _timing_block(wide, 8, 16, 1, card)
    launches = bit_timing_cuda.bit_timing_cuda.launches
    with pytest.raises(ValueError, match="W = 513 .* above the kernel's 512"):
        bit_timing(wide, x, window, sp)
    assert bit_timing_cuda.bit_timing_cuda.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("w", list(walk.WIDE))
def test_bit_timing_kernel_wide_windows_on_card(card, w):
    """LTR's demodulator at audio rates whose delay line is more than one
    64-bit word (W = 65, 106 at 16 kHz, 128, 320 at 48 kHz; and 53) on the
    card: one launch a call, counted under W, and bits, valid, window and
    sampling point identical to the plain loop on the edge blocks of
    tests/test_torch_bit_timing_walk.py, T = 1, two calls with carried
    state, and the odd counters."""
    geom = walk.WIDE_GEOMETRIES[w]
    t = int(40 * geom.sps) + 7
    x, window, sp = (torch.as_tensor(a, device=card)
                     for a in walk.edge_block(geom, 37, t, 50 + w))
    fn = bit_timing_cuda.bit_timing_cuda
    before, by_w = fn.launches, fn.launches_by[w]
    got = bit_timing(geom, x, window, sp)
    assert (fn.launches, fn.launches_by[w]) == (before + 1, by_w + 1)
    want = bit_timing_plain(geom, x, window, sp)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(want[1].sum()) >= 37 * (t / geom.sps - 3)
    for a, b in zip(bit_timing(geom, x[:, :1], window, sp),
                    bit_timing_plain(geom, x[:, :1], window, sp)):
        assert torch.equal(a, b)
    split = t // 3
    b1, v1, w1, s1 = bit_timing(geom, x[:, :split], window, sp, True)
    b2, v2, w2, s2 = bit_timing(geom, x[:, split:], w1, s1, True)
    want = bit_timing_plain(geom, x, window, sp, True)
    assert torch.equal(torch.cat([b1, b2], 1), want[0])
    assert torch.equal(torch.cat([v1, v2], 1), want[1])
    assert torch.equal(w2, want[2]) and torch.equal(s2, want[3])
    x, window, _ = (torch.as_tensor(a, device=card) for a in
                    walk.edge_block(geom, len(walk.ODD_SP), t, 70 + w))
    sp = torch.as_tensor(walk.ODD_SP, device=card)
    got = bit_timing(geom, x, window, sp)
    want = bit_timing_plain(geom, x, window, sp)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert torch.equal(got[3].view(torch.int32), want[3].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64],
                         ids=["float32", "complex64"])
def test_biquad_kernel_on_card(card, dtype):
    """``biquad_apply`` on the card launches the kernel once a call and
    equals ``biquad_apply_plain`` on the card bit for bit (rows (3, 37)
    of 1000 samples, not a multiple of its tile, in two calls with carried
    state), and the CPU's plain loop within tests/test_torch_misc_dsp.py's
    1e-5; another dtype is refused before the launch."""
    from sdrtrunk_tpu_torch.dsp import biquad_cuda
    from sdrtrunk_tpu_torch.dsp.misc import (biquad_apply, biquad_apply_plain,
                                             biquad_design)

    b, a = biquad_design("bandpass", 1200.0, 8000.0, q=5.0)
    rng = np.random.default_rng(21)
    x = rng.standard_normal((3, 37, 1000))
    if dtype == torch.complex64:
        x = x + 1j * rng.standard_normal((3, 37, 1000))
    x = torch.as_tensor(x).to(dtype)
    xc = x.to(card)
    fn = biquad_cuda.biquad_cuda
    before = fn.launches
    y1, s1 = biquad_apply(xc[..., :333], b, a)
    assert fn.launches == before + 1
    y2, s2 = biquad_apply(xc[..., 333:], b, a, s1)
    assert fn.launches == before + 2
    y = torch.cat([y1, y2], -1)
    want, want_s = biquad_apply_plain(xc, b, a)
    assert torch.equal(y, want) and torch.equal(s2, want_s)
    cpu, cpu_s = biquad_apply(x, b, a)
    np.testing.assert_allclose(y.cpu().numpy(), cpu.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(s2.cpu().numpy(), cpu_s.numpy(), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="float32 or complex64"):
        biquad_apply(xc.to(torch.complex128 if dtype == torch.complex64
                           else torch.float64), b, a)
    assert fn.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64],
                         ids=["float32", "complex64"])
def test_biquad_kernel_layouts_on_card(card, dtype):
    """The biquad kernel bit for bit against ``biquad_apply_plain`` on the
    card over its copy paths: rows whose length is a multiple of 4 floats
    (one bulk copy a row a stage) and rows whose length is not (4-byte
    copies, an unaligned tail), a row that starts off 16 bytes (a view at
    an offset), several tiles and less than one, and row counts that are
    not a multiple of the 8 rows a warp, with a carried state."""
    from sdrtrunk_tpu_torch.dsp import biquad_cuda
    from sdrtrunk_tpu_torch.dsp.misc import biquad_apply_plain, biquad_design

    b, a = biquad_design("lowpass", 900.0, 8000.0, q=0.9)
    rng = np.random.default_rng(23)
    fn = biquad_cuda.biquad_cuda
    for rows, n, offset in ((9, 5000, 0), (7, 5001, 0), (1, 3, 0),
                            (17, 1027, 0), (3, 2048, 1), (1, 513, 1)):
        x = rng.standard_normal((rows, n + offset))
        st = rng.standard_normal((rows, 2))
        if dtype == torch.complex64:
            x = x + 1j * rng.standard_normal(x.shape)
            st = st + 1j * rng.standard_normal(st.shape)
        x = torch.as_tensor(x).to(dtype).to(card)
        st = torch.as_tensor(st).to(dtype).to(card)
        if offset:                          # rows of a flat view, 4 bytes on
            x = x.flatten()[offset:offset + rows * n].view(rows, n)
            assert x.is_contiguous()
        before = fn.launches
        y, s2 = fn(x, b, a, st)
        assert fn.launches == before + 1
        want, want_s = biquad_apply_plain(x, b, a, st)
        assert torch.equal(y, want) and torch.equal(s2, want_s), \
            (rows, n, offset)


@pytest.mark.cuda
@pytest.mark.parametrize("n_taps", [1, 32])
def test_cma_kernel_over_tiles_on_card(card, n_taps):
    """The CMA kernel over several of its tiles (two of 2048 samples and
    part of a third; the delay line carried across each boundary), bit for
    bit against ``cma_equalize_plain`` on the card, at 1 tap (no tree) and
    at 32 (three shuffled levels)."""
    from sdrtrunk_tpu_torch.dsp import cma_cuda
    from sdrtrunk_tpu_torch.dsp.misc import cma_equalize_plain

    rng = np.random.default_rng(24)
    n = 2 * 2048 + 777
    syms = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, n)))
    x = torch.as_tensor((1.6 * np.convolve(syms, [1.0, 0.25 - 0.1j])[:n])
                        .astype(np.complex64)).to(card)
    taps = np.zeros(n_taps, np.complex64)
    taps[0] = 1.0
    taps[1:] = 0.01 * (rng.standard_normal(n_taps - 1)
                       + 1j * rng.standard_normal(n_taps - 1))
    taps = torch.as_tensor(taps).to(card)
    y, t = cma_cuda.cma_cuda(x, taps, mu=0.003)
    want, want_t = cma_equalize_plain(x, taps, mu=0.003)
    assert torch.equal(y, want) and torch.equal(t, want_t)


@pytest.mark.cuda
def test_cma_kernel_on_card(card):
    """``cma_equalize`` on the card launches the kernel once a call and
    equals ``cma_equalize_plain`` on the card bit for bit, on 2500 QPSK
    samples through a static channel, at 11 taps and at 32; the CPU's
    plain version within tests/test_torch_misc_dsp.py's 1e-4; more than
    32 taps is refused before a launch."""
    from sdrtrunk_tpu_torch.dsp import cma_cuda
    from sdrtrunk_tpu_torch.dsp.misc import (cma_equalize, cma_equalize_plain,
                                             cma_init)

    rng = np.random.default_rng(22)
    syms = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, 2500)))
    x = torch.as_tensor(np.convolve(syms, [1.0, 0.25 - 0.1j])[:2500]
                        .astype(np.complex64))
    fn = cma_cuda.cma_cuda
    for n_taps in (11, 32):
        taps = cma_init(n_taps, device="cpu")
        before = fn.launches
        y, t = cma_equalize(x.to(card), taps.to(card), mu=0.003)
        assert fn.launches == before + 1
        want, want_t = cma_equalize_plain(x.to(card), taps.to(card),
                                          mu=0.003)
        assert torch.equal(y, want) and torch.equal(t, want_t)
        cpu, cpu_t = cma_equalize(x, taps, mu=0.003)
        np.testing.assert_allclose(y.cpu().numpy(), cpu.numpy(), atol=1e-4)
        np.testing.assert_allclose(t.cpu().numpy(), cpu_t.numpy(), atol=1e-4)
    assert abs(float(y[-500:].abs().mean()) - 1.0) < 0.05
    before = fn.launches
    with pytest.raises(ValueError, match="33 taps"):
        cma_equalize(x.to(card), cma_init(33, device=card))
    assert fn.launches == before


@pytest.mark.cuda
def test_ltr_live_decoder_on_card_matches_cpu(card):
    """LTRLiveDecoder.batched_call on the card (the bit-timing kernel)
    against the same call on the CPU (the plain loop), two chunks with
    carried state: audio within 1e-4, the gate exactly, valid exactly and
    bits exactly. Every row carries sub-audible FSK under a voice tone, so
    the slicer's input stays clear of zero by far more than the 1e-4 the
    two devices' float sums may differ by, except within a sample of a
    crossing; on this seed no decision differs."""
    c, t = 16, 12500
    rng = np.random.default_rng(17)
    rows = []
    for i in range(c):
        n = np.arange(t * 8 // 25 + 80)
        bits = rng.integers(0, 2, 200)
        data = 0.35 * (2.0 * bits[np.minimum(
            (n * 300 / 8000).astype(np.int64), 199)] - 1.0)
        audio = data + 0.5 * np.sin(2 * np.pi * (700.0 + 20.0 * i) * n
                                    / 8000.0)
        iq = nbfm_modulate(audio, 8000.0, 25000.0)[:t] * (0.05 + 0.05 * i)
        rows.append(iq * np.exp(1j * rng.uniform(0, 2 * np.pi)))
    x = np.stack(rows).astype(np.complex64)
    out = {}
    before = bit_timing_cuda.bit_timing_cuda.launches
    for dev in ("cpu", card):
        dec = LTRLiveDecoder(device=dev)
        state = tree_map(lambda a: a.expand((c,) + a.shape).clone(),
                         dec.init_state())
        chunks = []
        for part in (x[:, :6250], x[:, 6250:]):
            o, state = dec.batched_call(torch.as_tensor(part, device=dev),
                                        state)
            chunks.append({k: v.cpu() for k, v in o.items()})
        out[str(dev)] = chunks
    assert bit_timing_cuda.bit_timing_cuda.launches == before + 2
    symbols = 0
    for got, want in zip(out["cuda"], out["cpu"]):
        assert got["audio"].shape == want["audio"].shape == (c, 2000)
        assert float((got["audio"] - want["audio"]).abs().max()) <= 1e-4
        assert torch.equal(got["audio_gate"], want["audio_gate"])
        assert torch.equal(got["valid"], want["valid"])
        assert torch.equal(got["bits"], want["bits"])
        symbols += int(want["valid"].sum())
    assert abs(symbols - c * 4000 * 300 / 8000) <= 2 * c


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["p25p1", "p25p1_48k"])
def test_cli_decode_on_card_matches_cpu(card, tmp_path, scene):
    """``decode --protocol p25p1`` prints the same messages on the card (one
    DQPSK launch; at W = 20 for the 48 kHz capture) as with --platform cpu
    (the plain loop)."""
    import contextlib
    import io

    import chip_smoke
    from sdrtrunk_tpu_torch import cli

    path = next(p for name, _, p, _, _ in chip_smoke.decode_scenes(tmp_path)
                if name == scene)

    def decode(*platform):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert cli.main([*platform, "decode", str(path),
                             "--protocol", "p25p1"]) == 0
        return out.getvalue().splitlines()
    before = dqpsk_cuda.dqpsk_cuda.launches
    on_card = decode()
    assert dqpsk_cuda.dqpsk_cuda.launches == before + 1
    assert on_card == decode("--platform", "cpu")
    assert '"messages": 2' in on_card[-1]


@pytest.mark.cuda
def test_int4_unpack_on_card_matches_cpu(card):
    """ingest_format="int4": a chunk packed on the host (``_prepare``)
    unpacks on the card (``ingest``) to the CPU's floats bit for bit, and
    the bank runs a chunk of it on the card."""
    from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator, ingest

    args = dict(slots=4, bank_mode=True, ppm_correction=False,
                ingest_format="int4")
    orch = Orchestrator(lambda n: None, 800000.0, 450e6, [0.0],
                        device=card, **args)
    rng = np.random.default_rng(6)
    iq8 = rng.integers(-128, 128, (orch.chunk_samples, 2)).astype(np.int8)
    packed = orch._prepare(iq8)
    assert packed.dtype == np.uint8 and packed.shape == (orch.chunk_samples,)
    on_card = ingest(torch.as_tensor(packed, device=card))
    assert on_card.device.type == "cuda"
    assert torch.equal(on_card.cpu(), ingest(torch.as_tensor(packed)))
    metrics = orch.run_chunk(iq8)
    assert metrics["samples"] == orch.chunk_samples
    orch.close()


def _per_channel_input(kind: str) -> np.ndarray:
    """One channel's 25 kHz block: C4FM at 30 dB, LSM at 30 dB, or NBFM
    carrying sub-audible LTR FSK under a voice tone."""
    rng = np.random.default_rng(23)
    if kind == "c4fm":
        x = c4fm_modulate(random_dibits(900, seed=23), 25000.0)[:4000]
    elif kind == "lsm":
        x = lsm_modulate(random_dibits(900, seed=23), sample_rate=25000.0,
                         symbol_rate=4800.0)[:4000]
    else:
        n = np.arange(12500 * 8 // 25 + 80)
        bits = rng.integers(0, 2, 200)
        audio = 0.35 * (2.0 * bits[np.minimum(
            (n * 300 / 8000).astype(np.int64), 199)] - 1.0) \
            + 0.5 * np.sin(2 * np.pi * 700.0 * n / 8000.0)
        return nbfm_modulate(audio, 8000.0, 25000.0)[:12500].astype(
            np.complex64)
    return awgn(x, snr_db=30.0, rng=rng).astype(np.complex64)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["c4fm", "lsm", "ltr"])
def test_per_channel_call_on_card_matches_cpu(card, kind):
    """``dec(x, state)`` on one channel's 1-D block, two chunks with carried
    state: on the card one launch a chunk at C = 1 (DQPSK, Gardner W = 11,
    bit timing W = 53), each launch's (C, T) recorded; the symbols (dibits
    or bits, and valid) equal the same call's on the CPU (the plain loops)
    exactly, as the batched chains' card tests hold them: the front's
    float sums differ between the devices by far less than any decision
    margin on this seed. The state comes back in init_state()'s layout."""
    from sdrtrunk_tpu_torch.decoders.c4fm import C4FMDecoder
    from sdrtrunk_tpu_torch.decoders.lsm import LSMDecoder

    cls, wrapper, sym = {
        "c4fm": (C4FMDecoder, dqpsk_cuda.dqpsk_cuda, "dibits"),
        "lsm": (LSMDecoder, gardner_cuda.gardner_cuda, "dibits"),
        "ltr": (LTRLiveDecoder, bit_timing_cuda.bit_timing_cuda, "bits"),
    }[kind]
    x = _per_channel_input(kind)
    split = len(x) // 2 // 125 * 125
    out = {}
    before = wrapper.launches
    for dev in ("cpu", card):
        dec = cls(device=dev)
        state = dec.init_state()
        shapes = [tuple(a.shape) for a in tree_leaves(state)]
        chunks = []
        for part in (x[:split], x[split:]):
            o, state = dec(torch.as_tensor(part, device=dev), state)
            chunks.append({k: v.cpu() for k, v in o.items()})
        assert [tuple(a.shape) for a in tree_leaves(state)] == shapes
        out[str(dev)] = chunks
    assert wrapper.launches == before + 2
    symbols = 0
    for got, want in zip(out["cuda"], out["cpu"]):
        assert torch.equal(got["valid"], want["valid"])
        assert torch.equal(got[sym][got["valid"]], want[sym][want["valid"]])
        symbols += int(want["valid"].sum())
    assert symbols > 100


@pytest.mark.cuda
def test_static_build_equals_build_dynamic_on_card(card):
    """``WidebandReceiver.build()`` and ``build_dynamic()`` with the plan's
    bins and steps give the same outputs and state bit for bit on the
    card (the DQPSK kernel under both), over two chunks."""
    from sdrtrunk_tpu_torch.receiver import WidebandReceiver

    m, fs = 32, 32 * 12500.0
    offsets = [-37500.0, 0.0, 12500.0 * 5 + 700.0]
    rx = WidebandReceiver(fs, offsets, decoder="c4fm", device=card)
    rng = np.random.default_rng(29)
    n = m * 400
    t = np.arange(n) / fs
    x = sum(c4fm_modulate(random_dibits(600, seed=i), fs)[:n]
            * np.exp(2j * np.pi * f * t) for i, f in enumerate(offsets))
    x = torch.as_tensor(awgn(x, 30.0, rng=rng).astype(np.complex64),
                        device=card)
    bins = torch.as_tensor(rx.plan.bins, device=card)
    step_rad = torch.as_tensor((2.0 * np.pi * rx.plan.offsets / rx.plan.rate)
                               .astype(np.float32), device=card)
    static, dynamic = rx.build(), rx.build_dynamic()
    s_state, d_state = rx.init_state(), rx.init_state()
    before = dqpsk_cuda.dqpsk_cuda.launches
    for part in (x[:n // 2], x[n // 2:]):
        s_out, s_state = static(part, s_state)
        d_out, d_state = dynamic(part, d_state, bins, step_rad)
        for key in s_out:
            assert torch.equal(s_out[key], d_out[key]), key
        for a, b in zip(tree_leaves(s_state), tree_leaves(d_state)):
            assert torch.equal(a, b)
    assert dqpsk_cuda.dqpsk_cuda.launches == before + 4
    assert int(s_out["valid"].sum()) > 100


@pytest.mark.cuda
def test_pipeline_world_size_one_over_nccl_on_card(card, tmp_path):
    """ShardedChannelizerPipeline over a one-rank NCCL group on the card:
    build() and three build_streaming() chunks bit for bit equal to the
    single-device Channelizer + extract_channels on the card."""
    import torch.distributed as dist

    from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer
    from sdrtrunk_tpu_torch.dsp.extract import extract_channels, plan_channels
    from sdrtrunk_tpu_torch.parallel.pipeline import (
        ShardedChannelizerPipeline)

    m = 32
    ch = Channelizer.design(m * 12500.0, 12500.0, 9, channels=m, device=card)
    plan = plan_channels(ch, [((i % (m - 2)) - (m // 2 - 1)) * 12500.0 + 700.0
                              for i in range(8)], 25000.0)
    rng = np.random.default_rng(11)
    chunks = [torch.as_tensor((rng.standard_normal(m * 256)
                               + 1j * rng.standard_normal(m * 256))
                              .astype(np.complex64), device=card)
              for _ in range(3)]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        pipe = ShardedChannelizerPipeline(ch, plan)
        assert pipe.device.type == "cuda" and pipe.n_shards == 1
        y, _ = ch(chunks[0])
        want, _ = extract_channels(y, plan)
        assert torch.equal(pipe.build()(chunks[0]), want)
        run, carry = pipe.build_streaming(), pipe.init_carry()
        state, phase = ch.init_state(), None
        for x in chunks:
            got, carry = run(x, carry)
            y, state = ch(x, state)
            want, phase = extract_channels(y, plan, phase)
            assert torch.equal(got, want)
        assert torch.equal(carry["tail"], state)
    finally:
        dist.destroy_process_group()


def _channelize_inputs(m: int, t: int, k: int, seed: int,
                       taps: int | None = None):
    """A padded block ((T M + N,) complex64, its T M history nonzero) and
    (T, M) branches: the sinc prototype the cells design at M = 1024, else
    ``taps`` (T M when None) random taps."""
    from sdrtrunk_tpu_torch.dsp.channelizer import (Channelizer,
                                                    polyphase_branch_filters)

    rng = np.random.default_rng(seed)
    if m == 1024 and taps is None:
        hmat = Channelizer.design(12_800_000.0, 12500.0, device="cpu").hmat
    else:
        hmat = torch.as_tensor(polyphase_branch_filters(
            rng.standard_normal(taps or t * m) / m, m).astype(np.float32))
    assert tuple(hmat.shape) == (t, m)
    n = t * m + k * m // 2
    xp = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / 4
    return torch.as_tensor(xp.astype(np.complex64)), hmat


def _bits(z: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(z).view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("m,t,k,taps", [
    (1024, 9, 40960, None), (1024, 9, 51200, None), (192, 9, 100, None),
    (64, 9, 2, None), (64, 1, 30, None), (48, 4, 10, 150),
    (1024, 9, 32, None), (1024, 9, 300, None)],
    ids=["c4fm_bank", "nbfm_bank", "m192", "k2", "t1", "proto150",
         "k32", "k300"])
def test_channelize_kernel_matches_plain_on_card(card, m, t, k, taps):
    """``channelize_core`` on the card launches the branch-sum kernel once
    and equals ``channelize_core_plain`` on the same card tensors bit for
    bit, the kernel's u equal to ``branch_sums_plain``'s: at the cells'
    shapes (M = 1024, T = 9, K = 40960 and 51200, the designed prototype),
    at M = 192 (not a power of two: the scaled IFFT), at K = 2, at T = 1,
    with a prototype of 150 taps at M = 48, and at K = 32 and K = 300 (a
    whole and a partial last tile of 16 blocks)."""
    from sdrtrunk_tpu_torch.dsp import channelize_cuda
    from sdrtrunk_tpu_torch.dsp.channelizer import (branch_sums_plain,
                                                    channelize_core,
                                                    channelize_core_plain)

    xp, hmat = _channelize_inputs(m, t, k, seed=m + t + k, taps=taps)
    xp, hmat = xp.to(card), hmat.to(card)
    fn = channelize_cuda.channelize_cuda
    before = fn.launches
    y = channelize_core(xp, hmat)
    assert fn.launches == before + 1
    want = channelize_core_plain(xp, hmat)
    assert y.shape == (k, m)
    assert torch.equal(_bits(y), _bits(want))
    assert torch.equal(_bits(fn(xp, hmat)), _bits(branch_sums_plain(xp, hmat)))
    assert fn.launches == before + 2


@pytest.mark.cuda
def test_channelize_kernel_rejects_what_it_does_not_take(card):
    """A non-contiguous, complex128 or float64, or odd-M input is refused
    with ValueError before any launch."""
    from sdrtrunk_tpu_torch.dsp import channelize_cuda
    from sdrtrunk_tpu_torch.dsp.channelizer import channelize_core

    xp, hmat = _channelize_inputs(64, 9, 8, seed=3)
    xp, hmat = xp.to(card), hmat.to(card)
    fn = channelize_cuda.channelize_cuda
    before = fn.launches
    spread = torch.zeros(2 * xp.shape[0], dtype=torch.complex64,
                         device=card)[::2]
    spread.copy_(xp)
    odd = torch.ones((9, 63), dtype=torch.float32, device=card)
    for bad_xp, bad_h, match in (
            (spread, hmat, "contiguous"),
            (xp.to(torch.complex128), hmat, "complex64"),
            (xp, hmat.double(), "float32"),
            (xp[:9 * 63 + 63], odd, "even M")):
        with pytest.raises(ValueError, match=match):
            channelize_core(bad_xp, bad_h)
    assert fn.launches == before


@pytest.mark.cuda
def test_tracer_on_card(card):
    """The port's tracer over a small C4FM bank's ``run()`` on the card:
    every chunk's upload stages and launches its copy under its own spans,
    and waits on its pinned buffer's previous copy from the third chunk on
    (two buffers); the metrics line gives the copy's device time, the
    first step's 5 host-built constants copied to the card with the slots'
    plan (7), and no copy after: each warm step takes the 5 from the
    card. Each step channelizes through the branch-sum kernel: the counter
    ``channelize.kernel`` and the wrapper's launches rise by one a chunk."""
    import json

    from sdrtrunk_tpu_torch.dsp.channelize_cuda import channelize_cuda
    from sdrtrunk_tpu_torch.runtime import tracing
    from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator

    orch = Orchestrator(None, 800000.0, 450e6, [0.0], slots=40,
                        bank_mode=True, ppm_correction=False,
                        chunk_samples=64 * 400, device=card)
    rng = np.random.default_rng(8)
    chunks = iter([rng.integers(-128, 128, (orch.chunk_samples, 2))
                   .astype(np.int8) for _ in range(5)])
    orch.source = lambda n: next(chunks)
    lines = []
    orch.metrics_sink = lambda line: lines.append(json.loads(line))
    tracing.drain()
    tracing.forget_constants()
    launched = channelize_cuda.launches
    tracing.enable(True)
    try:
        orch.run(max_chunks=5)
    finally:
        tracing.enable(False)
    records, counts = tracing.drain()
    orch.close()
    assert counts["channelize.kernel"] == 5
    assert channelize_cuda.launches == launched + 5
    names = {(r.name, r.chunk): r for r in records}
    for g in range(5):
        for part in ("upload.stage", "upload.copy"):
            assert names[(part, g)].parent is names[("upload", g)]
        assert (("upload.ring_wait", g) in names) == (g >= 2)
    assert counts.get("upload.ring_waits", 0) <= 3
    assert [line["h2d_copies"] for line in lines] == [7, 0, 0, 0, 0]
    assert [line["h2d_cached"] for line in lines] == [0, 5, 5, 5, 5]
    for line in lines:
        assert 0 < line["upload_ms"] < 50
        assert line["upload_mbps"] > 0
        assert {"upload.stage", "upload.copy"} <= set(line["stages_ms"])
