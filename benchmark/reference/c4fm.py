"""Plain reference of the P25 Phase 1 C4FM chain and its judge.

The chain after the channelizer: the 63-tap equiripple baseband low-pass
(pass 5100 Hz, stop 6500 Hz, ripple 0.01), the 32-sample feed-forward
AGC, and the decision-directed DQPSK symbol loop (Costas PLL, 8-tap
interpolator, timing from the de-rotated quadrature error at gain 0.3;
sdrtrunk's P25P1DecoderC4FM and DQPSKDecisionDirectedSymbolEvaluator),
written here as one NumPy loop over samples, vectorised over lanes. Each
sample yields ``dibit | valid << 2``; dibits 0, 1, 2, 3 are the symbols
+1, +3, -1, -3 (+45, +135, -45, -135 degrees).

The judge unpacks what the program's step produced (the bank tier's flat
transfer, or the per-slot tier's per-sample bytes and PLL frequencies)
and reads its numbers against this chain's.
"""
from __future__ import annotations

import math

import numpy as np

from . import dsp

SQRT_HALF = math.sqrt(0.5)
# P25 Phase 1 frame sync 0x5575F5FF77FF and its three rotation images
SYNC_WORDS = (0x5575F5FF77FF, 0xFFEFAFAAEEAA, 0x001050551155, 0xAA8A0A008800)
SYNC_MAX_BIT_ERRORS = 9


def sync_dibits() -> np.ndarray:
    """(4, 24) dibits of the sync words, most significant first."""
    return np.array([[(w >> (46 - 2 * i)) & 3 for i in range(24)]
                     for w in SYNC_WORDS], np.uint8)


def costas_gains(loop_bandwidth: float) -> tuple[float, float]:
    """(alpha, beta) of sdrtrunk's CostasLoop at damping sqrt(2) / 2."""
    damping = math.sqrt(2.0) / 2.0
    bw = dsp.TWO_PI / loop_bandwidth
    denom = 1.0 + 2.0 * damping * bw + bw * bw
    return 4.0 * damping * bw / denom, 4.0 * bw * bw / denom


class Chain:
    """The decoder's constants from the configuration's ``decoder``
    block."""

    def __init__(self, dec: dict, channel_rate: float):
        self.rate = channel_rate
        self.sps = channel_rate / dec["symbol_rate"]
        self.window = int(math.floor(2.0 * self.sps))
        self.sps_min = self.sps * (1.0 - dec["max_timing_deviation"])
        self.sps_max = self.sps * (1.0 + dec["max_timing_deviation"])
        self.gain = dec["timing_gain"]
        self.dsps_gain = 0.1 * self.gain ** 2
        self.alpha, self.beta = costas_gains(dec["pll_bandwidth_hz"])
        self.max_freq = dsp.TWO_PI * (dec["symbol_rate"] / 2.0) / channel_rate
        self.agc_window = dec["agc_window"]
        self.power_alpha = dec["power_alpha"]
        self.taps = dsp.remez_lowpass(dec["baseband_taps"], dec["pass_hz"],
                                      dec["stop_hz"], channel_rate,
                                      dec["ripple"], dec["ripple"])
        self.bank = dsp.interpolator_bank()

    def bank_cap(self, k: int) -> int:
        """Symbols a slot the bank transfer holds for a chunk of k channel
        samples: k over the fastest timing, plus 8, to a multiple of 64."""
        return int(np.ceil((k / self.sps_min + 8) / 64)) * 64


# each leaf of the chain's carried state and how the check measures its
# gap (``check.leaf_gaps``): the filter's history and the envelopes over
# each slot's own level, the loop's leveled samples, sampling point and
# symbol period (samples) and frequency (radians a sample) as they are
STATE = {"fir": "lane", "agc": "lane", "power": "lane", "window": "abs",
         "sampling_point": "abs", "detected_sps": "abs",
         "pll_phase": "angle", "pll_freq": "abs", "prev_preceding": "near",
         "prev_current": "abs"}
# the symbol loop's leaves: where one side takes a symbol at the chunk's
# edge that the other takes a sample later, in the next chunk (the counts
# differ by one), the two loops end the chunk a symbol apart, and the
# check leaves these leaves of that slot out (``guard``)
GUARDED = ("window", "sampling_point", "detected_sps", "pll_phase", "pll_freq",
        "prev_preceding", "prev_current")


def fresh(chain: Chain, lanes: int) -> dict:
    """The chain's state before its first sample, per lane: empty filter
    and envelope histories, no power, an empty delay line, the nominal
    sampling point and symbol period, the PLL at rest."""
    z = np.zeros(lanes)
    return {"fir": np.zeros((lanes, len(chain.taps) - 1), np.complex128),
            "agc": np.zeros((lanes, chain.agc_window - 1)),
            "power": z.copy(),
            "window": np.zeros((lanes, chain.window), np.complex128),
            "sampling_point": z + np.float32(chain.sps),
            "detected_sps": z + np.float32(chain.sps),
            "pll_phase": z.copy(), "pll_freq": z.copy(),
            "prev_preceding": z.astype(np.complex128),
            "prev_current": z.astype(np.complex128)}


def decode(chain: Chain, streams, state: dict, p: dsp.Precision):
    """(L, k) channel streams of one chunk from ``state`` -> (the chunk's
    symbols: per-sample bytes (L, k) uint8, ``dibit | valid << 2``; the
    state after it)."""
    f = dsp.fir(streams, chain.taps, state["fir"], p)
    power = dsp.one_pole((f.real ** 2 + f.imag ** 2).cpu().numpy(),
                         chain.power_alpha, state["power"], p)
    x, env = dsp.agc(f, state["agc"], chain.agc_window)
    fir_tail = _tail(streams, state["fir"])
    out, loop = symbol_loop(chain, x.cpu().numpy(), state, p)
    return out, {"fir": fir_tail, "agc": env.cpu().numpy(),
                 "power": power[:, -1].astype(np.float64), **loop}


def _tail(streams, history: np.ndarray) -> np.ndarray:
    """The last len(history) samples of history then streams, per row."""
    n = history.shape[1]
    rows = np.concatenate([history, streams.cpu().numpy()], axis=1)
    return rows[:, rows.shape[1] - n:]


def symbol_loop(chain: Chain, x: np.ndarray, state: dict,
                p: dsp.Precision) -> tuple:
    """The DQPSK symbol loop over (L, n) leveled samples from ``state``.
    Returns (per-sample bytes (L, n), the loop's state after them)."""
    real = p.np_real
    cplx = np.complex128 if real == np.float64 else np.complex64
    two_pi = real(dsp.TWO_PI)
    lanes, n = x.shape
    w = chain.window
    x = x.astype(cplx)
    bank = chain.bank.astype(real)
    # the delay line: mixed[:, w + i] is sample i as mixed on arrival;
    # at sample i the window is mixed[:, i + 1: i + 1 + w]
    mixed = np.zeros((lanes, n + w), cplx)
    mixed[:, :w] = state["window"]
    sp = state["sampling_point"].astype(real)
    dsps = state["detected_sps"].astype(real)
    ph = state["pll_phase"].astype(real)
    fr = state["pll_freq"].astype(real)
    prev = np.stack([state["prev_preceding"], state["prev_current"]],
                    1).astype(cplx)
    # the raw samples beside the last symbol's preceding one: an instant
    # within rounding of a sample boundary takes it from either side
    near = np.repeat(prev[:, :1], 3, axis=1)
    out = np.zeros((lanes, n), np.uint8)
    g, dg = real(chain.gain), real(chain.dsps_gain)
    alpha, beta = real(chain.alpha), real(chain.beta)
    lo, hi = real(chain.sps_min), real(chain.sps_max)
    fmax = real(chain.max_freq)

    def wrap(v):
        v = np.where(v > two_pi, v - two_pi, v)
        return np.where(v < -two_pi, v + two_pi, v)

    for i in range(n):
        phase = wrap(ph + fr)
        mixed[:, w + i] = x[:, i] * np.exp(1j * phase).astype(cplx)
        sp1 = sp - real(1.0)
        has = sp1 < 1.0
        if not has.any():
            sp, ph = sp1, phase
            continue
        mu = np.clip(sp1, 0.0, 1.0)
        arm = np.clip((mu * 128.0).astype(np.int64), 0, 128)
        cur = np.einsum("lj,lj->l", bank[arm], mixed[:, i + 1:i + 9])
        pts = np.stack([mixed[:, i + 4], cur], 1)
        z = pts * np.conj(prev)
        mag2 = z.real ** 2 + z.imag ** 2
        zn = np.where(mag2 > 1e-24, z / np.sqrt(np.maximum(mag2, 1e-30)), 0)
        pqn, cin, cqn = zn[:, 0].imag, zn[:, 1].real, zn[:, 1].imag
        i_pos, q_pos = cin > 0.0, cqn > 0.0
        out[:, i] = has * (4 + 2 * ~q_pos + ~i_pos)
        sgn_i = np.where(i_pos, real(1.0), real(-1.0))
        sgn_q = np.where(q_pos, real(1.0), real(-1.0))
        err = np.nan_to_num(np.clip(
            real(SQRT_HALF) * (cqn * sgn_i - cin * sgn_q), -0.3, 0.3))
        polarity = np.where(np.where(i_pos, pqn > cqn, pqn < cqn),
                            real(1.0), real(-1.0))
        te = err * polarity
        detected = np.clip(te * dg + dsps, lo, hi).astype(real)
        sp_new = (te * g + (sp1 + detected)).astype(real)
        perr = np.clip(-err, -0.5, 0.5)
        freq = (perr * beta + fr).astype(real)
        phase2 = wrap((perr * alpha + (phase + freq)).astype(real))
        freq = np.clip(freq, -fmax, fmax)
        sp = np.where(has, sp_new, sp1)
        dsps = np.where(has, detected, dsps)
        ph = np.where(has, phase2, phase)
        fr = np.where(has, freq, fr)
        prev = np.where(has[:, None], pts, prev)
        near = np.where(has[:, None], mixed[:, i + 3:i + 6], near)
    f64 = np.float64
    return out, {"window": mixed[:, n:].astype(np.complex128),
                 "sampling_point": sp.astype(f64),
                 "detected_sps": dsps.astype(f64),
                 "pll_phase": ph.astype(f64), "pll_freq": fr.astype(f64),
                 "prev_preceding": prev[:, 0].astype(np.complex128),
                 "prev_preceding_near": near.astype(np.complex128),
                 "prev_current": prev[:, 1].astype(np.complex128)}


def guard(got: list, want: list) -> np.ndarray:
    """Per checked slot: whether the two sides took as many symbols in
    the chunk, so that their loops end it in step."""
    return np.array([a["count"] == b["count"] for a, b in zip(got, want)])


def compact(row: np.ndarray) -> np.ndarray:
    """The dibits of a row of per-sample bytes that carry a symbol."""
    return (row[row >= 4] & 3).astype(np.uint8)


def sync_hits(dib: np.ndarray, lags: int) -> np.ndarray:
    """Lags 0 .. lags-1 at which some sync image lies within the bit error
    limit of the dibits there (dibits past the row read as 0)."""
    pats = sync_dibits()
    d = np.zeros(lags + 24, np.uint8)
    d[:min(len(dib), lags + 24)] = dib[:lags + 24]
    best = np.full(lags, 255)
    for pat in pats:
        err = np.zeros(lags, np.int64)
        for j in range(24):
            diff = d[j:j + lags] ^ pat[j]
            err += (diff & 1) + (diff >> 1)
        best = np.minimum(best, err)
    return best <= SYNC_MAX_BIT_ERRORS


def unpack_bank(buf: np.ndarray, slots: int, cap: int) -> dict:
    """The bank tier's flat transfer: dib4 (C, cap / 4) | sync hits (C,
    cap / 8), MSB first | counts (C,) int32 LE | slot 0's PLL frequency
    float32 LE."""
    q, h = cap // 4, cap // 8
    dib4 = buf[:slots * q].reshape(slots, q)
    dib = np.stack([(dib4 >> s) & 3 for s in (0, 2, 4, 6)], -1)
    hits = np.unpackbits(buf[slots * q:slots * (q + h)].reshape(slots, h),
                         axis=1).astype(bool)
    at = slots * (q + h)
    counts = buf[at:at + 4 * slots].view("<i4")
    pll = float(buf[-4:].view("<f4")[0])
    return {"dibits": dib.reshape(slots, cap), "hits": hits,
            "counts": counts, "pll0": pll}


def symbols(chain: Chain, tier: str, outputs: dict, slots, k: int) -> list:
    """Per checked slot, what a chunk's outputs say: its dibits in order,
    their count, the sync hits (bank tier) and the PLL frequency the
    outputs carry (bank tier: slot 0 only). ``outputs`` are the program's
    (the step's host outputs, with ``slots``) ."""
    if "bytes" in outputs:
        return outputs["bytes"]
    rows = []
    if tier == "bank":
        cap = chain.bank_cap(k)
        bank = unpack_bank(outputs["packed"], outputs["slots"], cap)
        for s in slots:
            n = int(bank["counts"][s])
            rows.append({"dibits": bank["dibits"][s][:min(n, cap)],
                         "count": n, "hits": bank["hits"][s][:cap - 23],
                         "pll": bank["pll0"] if s == 0 else None})
    else:
        for s in slots:
            d = compact(outputs["sym"][s].astype(np.uint8))
            rows.append({"dibits": d, "count": len(d), "hits": None,
                         "pll": float(outputs["pll_freq"][s])})
    return rows


def expected(chain: Chain, tier: str, per_sample: np.ndarray,
             state: dict, k: int) -> list:
    """A reference run's chunk in ``symbols``' form."""
    cap = chain.bank_cap(k)
    rows = []
    for lane, row in enumerate(per_sample):
        d = compact(row)
        rows.append({"dibits": d[:cap] if tier == "bank" else d,
                     "count": len(d),
                     "hits": sync_hits(d, cap - 23) if tier == "bank" else None,
                     "pll": float(state["pll_freq"][lane])})
    return rows


def _best_shift(a: np.ndarray, b: np.ndarray):
    """(mismatches, compared, shift) of the alignment of dibit rows a and
    b within one symbol that differs least: a symbol the loop times a
    sample earlier or later can cross a chunk's edge."""
    best = None
    for s in (0, -1, 1):
        aa, bb = (a[s:], b) if s >= 0 else (a, b[-s:])
        n = min(len(aa), len(bb))
        bad = int(np.count_nonzero(aa[:n] != bb[:n]))
        if best is None or bad < best[0]:
            best = (bad, n, s)
    return best


def readings(chain: Chain, got: list, want: list, want_state: dict) -> dict:
    """Per-lane readings of one checked chunk's outputs: dibits that
    differ after the best alignment within a symbol, the gap between the
    counts, sync hits that differ over the lags both rows fill, and, where
    the outputs carry a PLL frequency, its gap to the reference's after
    the chunk (``pll_freq_gap``, read with the state's own, in the slots
    whose loops end the chunk in step)."""
    r = {"dibit_errors": [], "count_gap": [], "hit_errors": [],
         "pll_freq_gap": []}
    for lane, (a, b) in enumerate(zip(got, want)):
        bad, _, s = _best_shift(a["dibits"], b["dibits"])
        r["dibit_errors"].append(bad)
        r["count_gap"].append(abs(a["count"] - b["count"]))
        if a["hits"] is not None:
            ha, hb = (a["hits"][s:], b["hits"]) if s >= 0 \
                else (a["hits"], b["hits"][-s:])
            m = max(min(a["count"], b["count"], len(ha), len(hb)) - 24, 0)
            r["hit_errors"].append(int(np.count_nonzero(ha[:m] != hb[:m])))
        if a["pll"] is not None and a["count"] == b["count"]:
            r["pll_freq_gap"].append(
                float(abs(a["pll"] - want_state["pll_freq"][lane])))
    return r


def summarize(r: dict) -> dict:
    """The numbers of the outputs' readings: each one's worst lane."""
    return {key: max(r[key], default=0) for key in
            ("dibit_errors", "count_gap", "hit_errors")}
