"""P25 Phase 2 BANK framer: superframe-fragment ALL channels of a slot
bank in one vectorized pass per chunk — the P25P2 sibling of
protocol/p25p1/bankframer.py (scaling tier of P25P2SuperFrameDetector /
P25P2MessageFramer, module/decode/p25/phase2/P25P2SuperFrameDetector
.java:51).

Vectorized across fragments of a whole chunk:
  * sync verification (device hit mask or host correlation of the
    20-dibit pattern) including the mandatory second-sync confirm at
    +360 bits;
  * ISCH decode: one XOR-distance matmul of every 40-bit word against
    the 128-word codebook;
  * DUID decode: popcount distance of every timeslot's 8-bit code
    against the 6 valid codes in one np.bitwise_count pass;
  * descrambling: per-slot (12, 320) scrambling segments held as one
    (C, 12, 320) tensor, applied as a batched XOR;
  * voice timeslots: batched frame gathers; FACCH/SACCH signaling:
    batched hexbit extraction + one RS(63,35) syndrome screen, scalar
    Berlekamp-Massey only for the error-bearing residue.

Per-slot equivalence with P25P2Framer is asserted in
tests/test_p25p2_bankframer.py: same fragments, same timeslot fields.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from .framer import (FRAGMENT_BITS, MAX_SYNC_BIT_ERRORS, P25P2Fragment,
                     _SYNC_DIBITS, _TS_OFFSETS)
from .isch import ISCH, _codebook
from .mac import parse_mac_pdu
from .scrambler import ScramblingSequence
from .timeslot import (_FACCH_POS, _PARITY_TX, _RS, _SACCH_POS,
                       DUID_POSITIONS, DataUnitID, MacPduType, Timeslot)

__all__ = ["P25P2BankFramer", "P25P2_SYNC_DIBITS"]

P25P2_SYNC_DIBITS = _SYNC_DIBITS                 # (20,) dibit pattern
FRAG_DIBITS = FRAGMENT_BITS // 2                 # 720
_SYNC1_DIBITS = 360                              # sync1 at bit 720
_SYNC2_DIBITS = 540                              # sync2 at bit 1080
_DIFF = np.array([[bin(a ^ b).count("1") for b in range(4)]
                  for a in range(4)], np.uint8)
_PW6 = (1 << (5 - np.arange(6))).astype(np.int64)
_PW6F = _PW6.astype(np.float32)
_PW8 = (1 << (7 - np.arange(8))).astype(np.int64)
_DUID_VALUES = np.array([0x00, 0x39, 0x65, 0x9A, 0xC6, 0xFF], np.int64)
_DUIDS = [DataUnitID(int(v)) for v in _DUID_VALUES]
_SCRAMBLED = np.array([d.is_scrambled for d in _DUIDS], bool)
_FACCH_POSMAT = np.stack(_FACCH_POS)             # (45, 6)
_SACCH_POSMAT = np.stack(_SACCH_POS)             # (49, 6)
_IS_VOICE = np.array([d.is_voice for d in _DUIDS], bool)
_MACPDU_BY_VAL = [MacPduType(v) for v in range(8)]
_V4_ROW = int(np.nonzero(_DUID_VALUES == 0x00)[0][0])
_V2_ROW = int(np.nonzero(_DUID_VALUES == 0x65)[0][0])
# batched voice-frame gather index grids (frame starts x 72 bits)
_V4_IDX = np.array([2, 76, 172, 246])[:, None] + np.arange(72)
_V2_IDX = np.array([2, 76])[:, None] + np.arange(72)


@lru_cache(maxsize=2048)
def _make_isch(value: int, errors: int) -> ISCH:
    """ISCH objects are tiny value types repeated across thousands of
    fragments per chunk — memoize by (codeword index, bit errors)."""
    from ..bits import from_int, to_int
    word = from_int(value, 9)
    return ISCH(channel=to_int(word, 2, 4),
                isch_sequence=to_int(word, 4, 6),
                inbound_free=bool(word[6]),
                superframe_sequence=to_int(word, 7, 9),
                bit_errors=errors)


def _isch_batch(words: np.ndarray, max_errors: int = 8) -> list:
    """(N, 40) -> N (ISCH | None): distance to all 128 codewords via
    one matmul (d = |b| + |c| - 2 b.c for 0/1 vectors)."""
    # float32 BLAS matmul: 0/1 vectors of length 40 are exact in f32,
    # and the int64 matmul fallback was ~17 ms/call at bank scale
    cb = _codebook().astype(np.float32)          # (128, 40)
    b = np.asarray(words, np.float32)
    d = (b.sum(axis=1)[:, None] + cb.sum(axis=1)[None, :]
         - 2.0 * (b @ cb.T)).astype(np.int64)    # (N, 128)
    best = d.argmin(axis=1)
    errs = d[np.arange(len(b)), best]
    return [(_make_isch(int(v), int(e)) if e <= max_errors else None)
            for v, e in zip(best.tolist(), errs.tolist())]


class P25P2BankFramer:
    """Streaming multi-channel superframe framer; feed per-chunk
    compacted dibit blocks for all C slots, receive (slot,
    P25P2Fragment) pairs.

    Scramble parameters are PER SLOT (traffic channels inherit the key
    the control channel learned); set_scramble_parameters(slot, ...)
    rebuilds that slot's (12, 320) segment rows in the bank tensor.
    """

    def __init__(self, channels: int, retain: int = 2048,
                 max_sync_errors: int = MAX_SYNC_BIT_ERRORS,
                 max_hard_rs: int = 256):
        self.c = channels
        self.retain = retain
        self.max_sync_errors = max_sync_errors
        self.tail = np.zeros((channels, retain), np.uint8)
        self.total = np.zeros(channels, np.int64)
        self.consumed = np.full(channels, -1 << 60, np.int64)
        self.pending: list[tuple[int, int]] = []   # (slot, abs_start)
        self.expired_pending = 0
        # one ScramblingSequence per slot + the stacked segment tensor
        self._scram = [ScramblingSequence() for _ in range(channels)]
        self._seg_tensor = np.stack(
            [s.segments for s in self._scram])     # (C, 12, 320)
        self._mac_cache: dict = {}
        # signaling words repeat verbatim across slots and superframes
        # on control/voice channels — memoize decode results by the
        # raw hexbit pattern (pure function; bounded, clear-on-full)
        self._sig_cache: dict = {}
        self.max_hard_rs = max_hard_rs
        self._hard_rs_budget = max_hard_rs
        self.dropped_hard_rs = 0

    def set_scramble_parameters(self, slot: int, wacn: int, system: int,
                                nac: int) -> None:
        self._scram[slot].update(wacn, system, nac)
        self._seg_tensor[slot] = self._scram[slot].segments

    # -- host-side sync correlation (fallback / boundary lags) ---------

    def _sync_errs(self, w: np.ndarray, lags: np.ndarray) -> np.ndarray:
        """Bit errors of the 20-dibit sync at `lags`: (C, len(lags))."""
        err = np.zeros((w.shape[0], len(lags)), np.uint16)
        for k in range(20):
            err += _DIFF[w[:, lags + k], P25P2_SYNC_DIBITS[k]]
        return np.minimum(err, 255).astype(np.uint8)

    def process(self, dib: np.ndarray, counts: np.ndarray,
                device_hits: np.ndarray | None = None
                ) -> list[tuple[int, P25P2Fragment]]:
        dib = np.asarray(dib, np.uint8)
        counts = np.asarray(counts, np.int64)
        self._hard_rs_budget = self.max_hard_rs     # per-chunk budget
        c, cap = dib.shape
        retain = self.retain
        w = np.concatenate([self.tail, dib], axis=1)
        valid_w = retain + counts
        abs0 = self.total - retain

        cand_slot: list[np.ndarray] = []
        cand_pos: list[np.ndarray] = []         # sync1 window position
        if device_hits is not None:
            s_idx, lag = np.nonzero(np.asarray(device_hits, bool))
            keep = lag < counts[s_idx] - 19
            cand_slot.append(s_idx[keep])
            cand_pos.append(lag[keep] + retain)
            blags = np.arange(retain - 19, retain)
            berr = self._sync_errs(w, blags)
            s_idx, li = np.nonzero(berr <= self.max_sync_errors)
            cand_slot.append(s_idx)
            cand_pos.append(blags[li])
        else:
            max_l = int(counts.max()) if len(counts) else 0
            lags = np.arange(retain - 19,
                             retain + max(0, max_l - 19))
            if len(lags):
                errs = self._sync_errs(w, lags)
                s_idx, li = np.nonzero(errs <= self.max_sync_errors)
                keep = lags[li] - retain < counts[s_idx] - 19
                cand_slot.append(s_idx[keep])
                cand_pos.append(lags[li[keep]])

        if self.pending:
            p_slots = np.array([p[0] for p in self.pending])
            p_abs = np.array([p[1] for p in self.pending])
            p_pos = p_abs - abs0[p_slots] + _SYNC1_DIBITS
            keep = p_pos >= 0
            self.expired_pending += int((~keep).sum())
            cand_slot.append(p_slots[keep])
            cand_pos.append(p_pos[keep])
        self.pending = []

        slots = (np.concatenate(cand_slot) if cand_slot
                 else np.zeros(0, np.int64))
        wpos = (np.concatenate(cand_pos) if cand_pos
                else np.zeros(0, np.int64))
        if len(slots) == 0:
            self._advance(w, counts, valid_w)
            return []

        # verify sync1 + the second sync at +180 dibits for every
        # candidate (both must clear max_sync_errors, exactly like the
        # per-slot framer's errs[lag] / errs[start+1080] pair)
        e1 = np.zeros(len(slots), np.uint16)
        pat = P25P2_SYNC_DIBITS
        win1 = w[slots[:, None], wpos[:, None] + np.arange(20)]
        for k in range(20):
            e1 += _DIFF[win1[:, k], pat[k]]
        ok1 = e1 <= self.max_sync_errors
        slots, wpos, e1 = slots[ok1], wpos[ok1], e1[ok1]

        # fragment must fit to check sync2 + frame
        start_pos = wpos - _SYNC1_DIBITS
        abs_start = start_pos + abs0[slots]
        fits = (start_pos >= 0) & \
            (start_pos + FRAG_DIBITS <= valid_w[slots])
        for s, a in zip(slots[~fits], abs_start[~fits]):
            # sync seen but the fragment spans the boundary: revisit
            # when the rest arrives (start may still be in the window)
            self.pending.append((int(s), int(a)))
        slots, start_pos, abs_start, e1 = (slots[fits], start_pos[fits],
                                           abs_start[fits], e1[fits])
        if len(slots):
            e2 = np.zeros(len(slots), np.uint16)
            win2 = w[slots[:, None],
                     (start_pos + _SYNC2_DIBITS)[:, None]
                     + np.arange(20)]
            for k in range(20):
                e2 += _DIFF[win2[:, k], pat[k]]
            ok2 = e2 <= self.max_sync_errors
            slots, start_pos, abs_start = (slots[ok2], start_pos[ok2],
                                           abs_start[ok2])
            serr = (e1[ok2] + e2[ok2]).astype(np.int64)
        else:
            serr = np.zeros(0, np.int64)

        # claim walk per slot: ascending starts, start <= consumed skip
        order = np.lexsort((abs_start, slots))
        keep_rows: list[int] = []
        consumed = self.consumed
        for j in order.tolist():
            s = int(slots[j])
            a = int(abs_start[j])
            if a <= consumed[s]:
                continue
            consumed[s] = a
            keep_rows.append(j)

        out = self._build(w, slots[keep_rows], start_pos[keep_rows],
                          abs_start[keep_rows], serr[keep_rows])
        self._advance(w, counts, valid_w)
        out.sort(key=lambda sf: (sf[0], sf[1].start))
        return out

    # -- batched fragment construction ---------------------------------

    def _build(self, w: np.ndarray, slots: np.ndarray,
               start_pos: np.ndarray, abs_start: np.ndarray,
               serr: np.ndarray) -> list[tuple[int, P25P2Fragment]]:
        m = len(slots)
        if m == 0:
            return []
        # row-copy gather via a sliding-window view: building the
        # (m, 720) int64 index grid + fancy-gathering 2.5M elements was
        # ~110 ms/chunk; indexing the view copies one contiguous
        # 720-byte row per fragment instead
        swv = np.lib.stride_tricks.sliding_window_view(
            w, FRAG_DIBITS, axis=1)
        win = swv[slots, start_pos]                    # (m, 720)
        bits = np.empty((m, FRAGMENT_BITS), np.uint8)
        bits[:, 0::2] = win >> 1
        bits[:, 1::2] = win & 1

        isch0 = _isch_batch(bits[:, 0:40])
        isch1 = _isch_batch(bits[:, 360:400])
        ts_base = np.array(
            [(i0.timeslot_offset if i0 is not None else
              (i1.timeslot_offset if i1 is not None else 0))
             for i0, i1 in zip(isch0, isch1)], np.int64)

        ts_lists: list[list] = [[] for _ in range(m)]
        ts_base_l = ts_base.tolist()
        for unit, (_isch_off, ts_off) in enumerate(_TS_OFFSETS):
            raw = bits[:, ts_off: ts_off + 320]
            codes = raw[:, DUID_POSITIONS] @ _PW8          # (m,)
            dists = np.bitwise_count(
                (codes[:, None] ^ _DUID_VALUES[None, :]).astype(
                    np.uint64))                            # (m, 6)
            which = dists.argmin(axis=1)
            derr = dists[np.arange(m), which]
            has_duid = derr <= 2
            # descramble scrambled DUIDs with each slot's segment for
            # this timeslot index; DUID bits ride unscrambled
            idx = (ts_base + unit) % 12
            seg = self._seg_tensor[slots, idx]             # (m, 320)
            scr = has_duid & _SCRAMBLED[which]
            b2 = np.where(scr[:, None], raw ^ seg, raw)
            b2[:, DUID_POSITIONS] = raw[:, DUID_POSITIONS]

            # vectorized row classification + batched voice-frame
            # gathers (the per-row np.stack was ~28k calls/chunk)
            vmask = has_duid & _IS_VOICE[which]
            sig_rows = np.nonzero(has_duid & ~_IS_VOICE[which]
                                  )[0].tolist()
            sig_info = self._signaling_batch(b2, sig_rows, which)
            which_l = which.tolist()
            ch = unit % 2
            for d_row, grid in ((_V4_ROW, _V4_IDX), (_V2_ROW, _V2_IDX)):
                rows = np.nonzero(vmask & (which == d_row))[0]
                if not len(rows):
                    continue
                duid = _DUIDS[d_row]
                vf = b2[rows][:, grid]                     # (g, n, 72)
                is4 = d_row == _V4_ROW
                for j, i in enumerate(rows.tolist()):
                    b = b2[i]
                    ts = Timeslot(duid=duid,
                                  index=ts_base_l[i] + unit,
                                  channel=ch, bits=b)
                    ts.voice_frames = vf[j]
                    if is4:
                        ts.ess_b = b[148:172]
                    ts_lists[i].append(ts)
            for i in sig_rows:
                duid = _DUIDS[which_l[i]]
                info_bits, nerr = sig_info[i]
                ts = Timeslot(duid=duid, index=ts_base_l[i] + unit,
                              channel=ch, bits=b2[i])
                ts.rs_errors = nerr
                if info_bits is not None:
                    ts.mac_octets = info_bits
                    ts.mac_pdu_type = _MACPDU_BY_VAL[
                        int(info_bits[0]) * 4 + int(info_bits[1]) * 2
                        + int(info_bits[2])]
                    # control MACs repeat across slots/superframes at
                    # bank scale — memoize by raw bits (pure parse,
                    # read-only result)
                    key = info_bits.tobytes()
                    mac = self._mac_cache.get(key)
                    if mac is None:
                        if len(self._mac_cache) >= 4096:
                            self._mac_cache.clear()
                        mac = parse_mac_pdu(info_bits)
                        self._mac_cache[key] = mac
                    ts.mac = mac
                ts_lists[i].append(ts)

        out = []
        for i in range(m):
            out.append((int(slots[i]), P25P2Fragment(
                start=int(abs_start[i]), isch0=isch0[i], isch1=isch1[i],
                timeslots=ts_lists[i], sync_errors=int(serr[i]))))
        return out

    def _signaling_batch(self, b2: np.ndarray, rows: list,
                         which: np.ndarray) -> dict:
        """Batch FACCH/SACCH: hexbit gather + one RS syndrome screen;
        scalar BM decode only for words with nonzero syndromes.
        Returns {row: (info_bits | None, rs_errors | None)}."""
        result: dict[int, tuple] = {}
        for is_sacch in (False, True):
            grp = [i for i in rows
                   if _DUIDS[which[i]].is_sacch == is_sacch]
            if not grp:
                continue
            n_info = 30 if is_sacch else 26
            posmat = _SACCH_POSMAT if is_sacch else _FACCH_POSMAT
            shorten = 35 - n_info
            # 1-D flat gather + f32 BLAS matmul (hexbits < 64 are exact
            # in f32; the 2-D grid gather + int64 matmul was a measured
            # ~60 ms/chunk at bank scale)
            nhex = posmat.shape[0]
            g_bits = b2[grp][:, posmat.reshape(-1)].astype(np.float32)
            hex_all = (g_bits.reshape(-1, nhex, 6) @ _PW6F
                       ).astype(np.int64)                  # (g, nhex)
            hb = hex_all.astype(np.uint8)
            keys = [hb[j].tobytes() for j in range(len(grp))]
            cache = self._sig_cache
            seen: set = set()
            miss = []
            for j, key in enumerate(keys):
                if key not in cache and key not in seen:
                    seen.add(key)
                    miss.append(j)
            if miss:
                if len(cache) >= 8192:
                    cache.clear()
                g = len(miss)
                sub = hex_all[miss]
                wire = np.zeros((g, 63), np.int64)
                wire[:, shorten: 35] = sub[:, :n_info]
                wire[:, 35: 35 + _PARITY_TX] = sub[:, n_info:]
                # encode-check screen: re-encode every word's info in
                # one GF matmul and compare the 19 TRANSMITTED parity
                # symbols (the 9 punctured ones are zero-substituted,
                # so syndromes are nonzero even for clean words —
                # rs.encode_parity)
                expected = _RS.encode_parity(wire[:, :35])
                clean = np.all(expected[:, :_PARITY_TX]
                               == sub[:, n_info:], axis=1)
                info_hex = wire[:, shorten: 35]
                bits6 = ((info_hex[:, :, None] >> (5 - np.arange(6)))
                         & 1).astype(np.uint8).reshape(g, n_info * 6)
                for jj, j in enumerate(miss):
                    if clean[jj]:
                        cache[keys[j]] = (bits6[jj], 0)
                    elif self._hard_rs_budget <= 0:
                        # bounded degradation: error-bearing BM beyond
                        # the per-chunk budget shed + counted (NOT
                        # cached: next chunk's budget may decode it)
                        self.dropped_hard_rs += 1
                        result[grp[j]] = (None, None)
                        continue
                    else:
                        self._hard_rs_budget -= 1
                        cw, nerr = _RS.decode(wire[jj])
                        if nerr is None:
                            cache[keys[j]] = (None, None)
                        else:
                            ih = cw[shorten: 35]
                            ib = ((ih[:, None] >> (5 - np.arange(6)))
                                  & 1).astype(np.uint8).reshape(
                                n_info * 6)
                            cache[keys[j]] = (ib, max(int(nerr) - 9, 1))
            for j, i in enumerate(grp):
                if i not in result:
                    # a key absent from the cache here means its BM
                    # decode was shed this chunk (budget)
                    result[i] = cache.get(keys[j], (None, None))
        return result

    def _advance(self, w: np.ndarray, counts: np.ndarray,
                 valid_w: np.ndarray) -> None:
        # row-copy via sliding-window view: the (C, retain) index-grid
        # gather was ~40 ms/chunk at 1023 slots
        self.tail = np.lib.stride_tricks.sliding_window_view(
            w, self.retain, axis=1)[np.arange(self.c),
                                    valid_w - self.retain]
        self.total += counts
