"""A model of the bit-timing kernel's symbol-major walk (csrc/bit_timing.cu)
in Python integers and NumPy float32, held bit for bit against the plain
loop (dsp/bit_timing.py::bit_timing_plain) on the CPU. No JAX.

The model follows the kernel step by step: the decisions of a tile packed
32 to a word as ``__ballot_sync`` packs them, behind two words holding the
64 decisions before the tile (at the first tile the carried window); the
counter run down to the next symbol at once where the per-sample loop's
steps are exact (1 <= sp < 2^23: the symbol falls floor(sp) samples on,
leaving sp - floor(sp)) and one step at a time as the loop takes them
otherwise (below 1, negative, huge, NaN); the 64-bit line at a symbol built from three
words by two funnel shifts and a bit reversal; the symbol step as
``symbol()``; the bits and valid bitmaps expanded to bytes with the
kernel's head / four-byte / tail split at the row's real alignment; the
new window from the last tile's history. Rehearse a change to the kernel's
packing, walk or tiling here before spending time on the card.

Cases, for the LTR and the AFSK geometry (dsp/fsk.py, dsp/afsk.py), each
with ``invert`` both ways: ten seeds at T = 997; T = 1; T spanning two of
the kernel's tiles (its ``kTile`` is read from the source); a tile of 32
and one of 96 samples, so that T = 997 crosses many tile boundaries; and
two calls with carried state. Each block has an all-zero channel and
channels whose counter enters at 1.5 (a symbol due at t = 0), exactly 1,
0.3 and below zero; one more block enters at counters where the steps are
not all exact (2^23 and beyond, infinities, NaN) and at integers.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sdrtrunk_tpu_torch.dsp.afsk import AFSK1200Demodulator
from sdrtrunk_tpu_torch.dsp.bit_timing import BitTimingGeometry, bit_timing_plain
from sdrtrunk_tpu_torch.dsp.fsk import LTRFSKDemodulator

torch.set_num_threads(1)

SOURCE = (Path(__file__).resolve().parent.parent / "sdrtrunk_tpu_torch"
          / "csrc" / "bit_timing.cu")
K_TILE = int(re.search(r"constexpr int kTile = (\d+);",
                       SOURCE.read_text()).group(1))
M32, M64 = (1 << 32) - 1, (1 << 64) - 1
f32, f64 = np.float32, np.float64

GEOMETRIES = {"ltr": LTRFSKDemodulator(device="cpu").geometry,
              "afsk": AFSK1200Demodulator(device="cpu").geometry}
# LTR's demodulator at audio rates that give lines of one to five 64-bit
# words, W = floor(2 * rate / 300): 53 at 8 kHz (one word), 65 (two, one
# bit in the second), 106 at 16 kHz, 128 (two full words), 320 at 48 kHz
# (five)
WIDE = {53: 8000.0, 65: 9750.0, 106: 16000.0, 128: 19200.0, 320: 48000.0}
WIDE_GEOMETRIES = {w: LTRFSKDemodulator(sample_rate=rate,
                                        device="cpu").geometry
                   for w, rate in WIDE.items()}
CASES = [(g, inv) for g in GEOMETRIES for inv in (False, True)]
CASE_IDS = [f"{g}-{'inverted' if inv else 'normal'}" for g, inv in CASES]
# counters on entry of the edge channels 1-4 (channel 0 is all zero)
EDGE_SP = (1.5, 1.0, 0.3, -2.7)
# counters on entry where the run-down's steps are not all exact
# subtractions of 1 (the first eight), and integers, where it ends at 0
ODD_SP = np.array([2.0 ** 23 - 0.5, 2.0 ** 23, 2.0 ** 23 + 3, 2.0 ** 24 + 2,
                   1e30, np.inf, -np.inf, np.nan, 3.0, 27.0, -0.0], np.float32)


def _funnel_r(lo: int, hi: int, r: int) -> int:
    return (((hi << 32) | lo) >> (r & 31)) & M32


def _bits64(words, s: int) -> int:
    """P[s .. s + 63], bit b = P[s + b] (kernel ``bits64``)."""
    q, r = s >> 5, s & 31
    lo = _funnel_r(words[q], words[q + 1], r)
    hi = _funnel_r(words[q + 1], words[q + 2], r)
    return (hi << 32) | lo


def _brev64(v: int) -> int:
    return int(f"{v:064b}"[::-1], 2)


def _popc(v: int) -> int:
    return bin(v).count("1")


def _line_words(geom: BitTimingGeometry) -> int:
    """L, the kernel's 64-bit words of the line (its launch picks the
    instantiation ceil(W / 64))."""
    return (geom.window_len + 63) // 64


def _span(m: int, lo: int, hi: int) -> int:
    """Line bits lo .. hi - 1 that fall in word m (the kernel's ``span``)."""
    a, b = max(lo - 64 * m, 0), min(hi - 64 * m, 64)
    return 0 if a >= b else ((1 << b) - 1) & ~((1 << a) - 1)


def _symbol(w: list, geom: BitTimingGeometry, sp):
    """The kernel's ``symbol()`` on the line w (L words, newest decision in
    bit 0 of word 0): (bit, new counter). Votes and crossings a word at a
    time under the word's masks, each word's crossings taking the next
    word's bit 0 in at bit 63; the oldest crossing from the highest word
    holding one (63 - clz), the newest from the lowest (ffs - 1)."""
    k = geom.constants()
    w_len, zl = geom.window_len, geom.zc_len
    votes = count = 0
    oldest = newest = -1
    for m in range(len(w)):
        votes += _popc(w[m] & _span(m, w_len - geom.vote_start
                                    - geom.vote_len, w_len - geom.vote_start))
        carry = ((w[m + 1] << 63) & M64) if m + 1 < len(w) else 0
        cr = (w[m] ^ ((w[m] >> 1) | carry)) & _span(m, 0, zl - 1)
        count += _popc(cr)
        if cr:
            oldest = 64 * m + cr.bit_length() - 1           # 63 - clz
            if newest < 0:
                newest = 64 * m + (cr & -cr).bit_length() - 1   # ffs - 1
    error = f32(0.0)
    if count == 1 or (count == 2 and geom.two_crossings):
        first = zl - 2 - oldest
        error = f32(f32(first) + f32(0.5)) - f32(k["zc_ideal"])
        if count == 2:
            last = zl - 2 - newest
            err2 = f32(f32(last) + f32(0.5)) - f32(k["zc_ideal"])
            error = error if abs(error) < abs(err2) else err2
    sp = f32(f64(error) * f64(f32(k["gain"]))
             + f64(f32(sp + f32(k["sps"]))))
    return int(votes > geom.vote_len // 2), sp


def _expand(bm, n: int, head: int) -> list[int]:
    """The kernel's ``expand``: bytes of bitmap bits 0 .. n - 1, head
    single bytes up to the row's 4-byte boundary, then four a store."""
    head = min(n, head)
    out = [(bm[0] >> lane) & 1 for lane in range(head)]
    for k in range((n - head) >> 2):
        j = head + 4 * k
        nib = _funnel_r(bm[j >> 5], bm[(j >> 5) + 1], j & 31) & 0xF
        word = (nib * 0x00204081) & 0x01010101
        out += [(word >> (8 * b)) & 0xFF for b in range(4)]
    j = head + 4 * ((n - head) >> 2)
    out += [(bm[i >> 5] >> (i & 31)) & 1 for i in range(j, n)]
    return out


def kernel_model(geom: BitTimingGeometry, x, window, sp, invert: bool,
                 tile: int, row_offset: int):
    """One channel through the kernel: x (T,) float32, window (W,) int8,
    sp float32; row_offset is the row's byte offset in the output planes
    (their base is aligned). Returns (bits, valid, new window, new sp)."""
    t_len, w_len = len(x), geom.window_len
    n_words = _line_words(geom)
    hist_len = 64 * n_words                 # the kernel's kHist
    # the history before the first tile by ballots: bit b of 32-bit word q
    # is window[32 q + b - (kHist - W)]
    def ballot(q):
        return sum(int(0 <= i < w_len and window[i] != 0) << lane
                   for lane in range(32)
                   for i in (32 * q + lane - (hist_len - w_len),))
    hist = [ballot(2 * m) | (ballot(2 * m + 1) << 32) for m in range(n_words)]
    line_mask = [_span(m, 0, w_len) for m in range(n_words)]
    sp = f32(sp)
    bits, valid = [], []
    for t0 in range(0, t_len, tile):
        n = min(tile, t_len - t0)
        nw = (n + 31) >> 5
        # pack: a ballot a word behind the 2L history words, one zero
        # word after
        words = [v for h in hist for v in (h & M32, h >> 32)]
        for k in range(nw):
            words.append(sum(
                int(32 * k + lane < n
                    and bool(x[t0 + 32 * k + lane] > 0.0) != invert) << lane
                for lane in range(32)))
        words.append(0)
        vmask, bmask = [0] * (nw + 1), [0] * (nw + 1)
        # walk
        i = 0
        while i < n:
            if f32(1.0) <= sp < f32(2 ** 23):
                k = int(sp)
                if k > n - i:
                    sp = f32(sp - f32(n - i))
                    break
                sp = f32(sp - f32(k))
                i += k
            else:
                sp = f32(sp - f32(1.0))
                i += 1
                if not sp < f32(1.0):
                    continue
            j = i - 1
            w = [_brev64(_bits64(words, hist_len - 63 - 64 * m + j))
                 & line_mask[m] for m in range(n_words)]
            bit, sp = _symbol(w, geom, sp)
            q, m = j >> 5, 1 << (j & 31)
            vmask[q] |= m
            bmask[q] |= m if bit else 0
        hist = [_bits64(words, n + 64 * m) for m in range(n_words)]
        # write
        head = (4 - (row_offset + t0) % 4) % 4
        valid += _expand(vmask, n, head)
        bits += _expand(bmask, n, head)
    # the new window through the history words: window[i] = bit kHist -
    # W + i
    words = [v for h in hist for v in (h & M32, h >> 32)]
    new_window = [(words[b >> 5] >> (b & 31)) & 1
                  for b in range(hist_len - w_len, hist_len)]
    return (np.array(bits, np.int8), np.array(valid, bool),
            np.array(new_window, np.int8), sp)


def edge_block(geom: BitTimingGeometry, c: int, t: int, seed: int):
    """(x (c, t) float32, window (c, W) int8, sp (c,) float32): square waves
    around the symbol period with noise, so crossings come and go in the
    window; channel 0 all zero, channels 1-4 entering with EDGE_SP, the
    rest at random counters."""
    rng = np.random.default_rng(seed)
    period = rng.uniform(0.7, 1.6, (c, 1)) * 2.0 * geom.sps
    x = np.sign(np.sin(2 * np.pi * np.arange(t)[None, :] / period
                       + rng.uniform(0, 6.28, (c, 1))))
    x = (x + 0.4 * rng.standard_normal((c, t))).astype(np.float32)
    x[0] = 0.0
    window = rng.integers(0, 2, (c, geom.window_len)).astype(np.int8)
    sp = rng.uniform(1.0, 1.5 * geom.sps, c).astype(np.float32)
    sp[1:1 + len(EDGE_SP)] = EDGE_SP
    return x, window, sp


def _hold(geom, x, window, sp, invert, tile):
    """The model, channel by channel, against the plain loop on the block;
    returns the plain loop's outputs."""
    want = bit_timing_plain(geom, torch.as_tensor(x), torch.as_tensor(window),
                            torch.as_tensor(sp), invert)
    t = x.shape[1]
    for ch in range(x.shape[0]):
        got = kernel_model(geom, x[ch], window[ch], sp[ch], invert, tile,
                           ch * t)
        for what, a, b in zip(("bits", "valid", "window"), got,
                              (w[ch].numpy() for w in want)):
            np.testing.assert_array_equal(a, b, err_msg=f"{what} ch {ch}")
        assert f32(got[3]).view(np.int32) == \
            want[3][ch].numpy().view(np.int32), f"sampling point ch {ch}"
    return want


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("geom_name,invert", CASES, ids=CASE_IDS)
def test_walk_model_equals_plain_loop(geom_name, invert, seed):
    geom = GEOMETRIES[geom_name]
    x, window, sp = edge_block(geom, 7, 997, seed)
    bits, valid, _, _ = _hold(geom, x, window, sp, invert, K_TILE)
    assert bool(valid[1, 0]) and bool(valid[2, 0]) and bool(valid[4, 0])
    assert int(valid.sum()) >= 7 * (997 / geom.sps - 3)
    # the all-zero channel, once its random window has passed out of the
    # line: no crossing, a symbol every sps samples, all one bit
    at = valid[0].nonzero().flatten()
    at = at[at >= geom.window_len]
    assert set((at[1:] - at[:-1]).tolist()) <= {int(geom.sps),
                                                int(np.ceil(geom.sps))}
    assert bool((bits[0][at] == int(invert)).all())


@pytest.mark.parametrize("geom_name,invert", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("t,tile", [(1, K_TILE), (K_TILE + 997, K_TILE),
                                    (997, 32), (997, 96)],
                         ids=["T1", "two-tiles", "tile32", "tile96"])
def test_walk_model_across_tiles(geom_name, invert, t, tile):
    geom = GEOMETRIES[geom_name]
    c = 5 if t > K_TILE else 7
    x, window, sp = edge_block(geom, c, t, 21)
    _hold(geom, x, window, sp, invert, tile)


@pytest.mark.parametrize("tile", [K_TILE, 32])
@pytest.mark.parametrize("geom_name,invert", CASES, ids=CASE_IDS)
def test_walk_model_odd_counters(geom_name, invert, tile):
    """Counters on entry where the run-down's steps are not all exact
    subtractions of 1, which the walk takes one step at a time as the loop
    does: at and past 2^23 (2^24 + 2 rounds its first step), huge, +inf
    (never a symbol), -inf (a symbol every sample), NaN (never a symbol,
    NaN carried), and integers, where the run-down ends at exactly 0."""
    geom = GEOMETRIES[geom_name]
    x, window, _ = edge_block(geom, len(ODD_SP), 997, 44)
    bits, valid, _, sp = _hold(geom, x, window, ODD_SP, invert, tile)
    assert not bool(valid[:6].any()) and bool(valid[6].all())
    assert np.isnan(sp[7].item()) and not bool(valid[7].any())
    assert bool(valid[8:, 0].any())


@pytest.mark.parametrize("geom_name,invert", CASES, ids=CASE_IDS)
def test_walk_model_two_calls_carry_state(geom_name, invert):
    geom = GEOMETRIES[geom_name]
    x, window, sp = edge_block(geom, 7, 997, 33)
    want = bit_timing_plain(geom, torch.as_tensor(x), torch.as_tensor(window),
                            torch.as_tensor(sp), invert)
    for ch in range(7):
        b1, v1, w1, s1 = kernel_model(geom, x[ch, :400], window[ch], sp[ch],
                                      invert, K_TILE, ch * 400)
        b2, v2, w2, s2 = kernel_model(geom, x[ch, 400:], w1, s1, invert,
                                      K_TILE, ch * 597)
        np.testing.assert_array_equal(np.concatenate([b1, b2]),
                                      want[0][ch].numpy())
        np.testing.assert_array_equal(np.concatenate([v1, v2]),
                                      want[1][ch].numpy())
        np.testing.assert_array_equal(w2, want[2][ch].numpy())
        assert float(s2) == float(want[3][ch])


def test_wide_geometries_are_the_widths_named():
    assert {w: (g.window_len, _line_words(g))
            for w, g in WIDE_GEOMETRIES.items()} == {
        53: (53, 1), 65: (65, 2), 106: (106, 2), 128: (128, 2), 320: (320, 5)}


@pytest.mark.parametrize("invert", [False, True], ids=["normal", "inverted"])
@pytest.mark.parametrize("tile", [K_TILE, 96], ids=["tile", "tile96"])
@pytest.mark.parametrize("w", list(WIDE))
def test_walk_model_wide_windows(w, tile, invert):
    """The line as L words (votes and crossings carried across the words'
    boundaries, the first and last crossing in any word, the history of 2L
    words behind each tile) against the plain loop at W = 53 to 320: about
    40 symbols a channel, the edge channels, tiles of 96 samples that the
    history outlasts at W > 96, and T = 1."""
    geom = WIDE_GEOMETRIES[w]
    t = int(40 * geom.sps) + 7
    x, window, sp = edge_block(geom, 7, t, 50 + w)
    bits, valid, _, _ = _hold(geom, x, window, sp, invert, tile)
    assert bool(valid[1, 0]) and bool(valid[2, 0]) and bool(valid[4, 0])
    assert int(valid.sum()) >= 7 * (t / geom.sps - 3)
    _hold(geom, x[:, :1], window, sp, invert, tile)


@pytest.mark.parametrize("w", list(WIDE))
def test_walk_model_wide_windows_carry_state_and_odd_counters(w):
    """Two calls with carried state (the new window out of L words) and
    the counters on entry where the run-down is not all exact, at W = 53
    to 320."""
    geom = WIDE_GEOMETRIES[w]
    t = int(12 * geom.sps) + 5
    x, window, sp = edge_block(geom, 7, t, 60 + w)
    want = bit_timing_plain(geom, torch.as_tensor(x), torch.as_tensor(window),
                            torch.as_tensor(sp), False)
    split = t // 3
    for ch in range(7):
        b1, v1, w1, s1 = kernel_model(geom, x[ch, :split], window[ch],
                                      sp[ch], False, 96, ch * split)
        b2, v2, w2, s2 = kernel_model(geom, x[ch, split:], w1, s1, False,
                                      96, ch * (t - split))
        np.testing.assert_array_equal(np.concatenate([b1, b2]),
                                      want[0][ch].numpy())
        np.testing.assert_array_equal(np.concatenate([v1, v2]),
                                      want[1][ch].numpy())
        np.testing.assert_array_equal(w2, want[2][ch].numpy())
        assert float(s2) == float(want[3][ch])
    x, window, _ = edge_block(geom, len(ODD_SP), t, 70 + w)
    _, valid, _, _ = _hold(geom, x, window, ODD_SP, True, K_TILE)
    assert not bool(valid[:6].any()) and bool(valid[6].all())


def test_nibble_expansion():
    """The multiply that spreads four bits over four bytes, little end
    first, for every nibble."""
    for nib in range(16):
        word = (nib * 0x00204081) & 0x01010101
        assert [(word >> (8 * b)) & 0xFF for b in range(4)] == \
            [(nib >> b) & 1 for b in range(4)]
