"""DMR BANK framer: burst-frame ALL channels of a slot bank in one
vectorized pass per chunk — the DMR sibling of
protocol/p25p1/bankframer.py (scaling tier of DMRMessageFramer /
DMRBurstFramer, module/decode/dmr/DMRMessageFramer.java:61).

Vectorized across channels:
  * sync detection (device hit mask, or host correlation of the seven
    48-bit patterns via the dibit-difference LUT) and pattern
    classification at every candidate;
  * rolling per-slot symbol windows carried as one (C, retain) array.

Per burst (a few thousand per second at 1000-channel scale) the proven
per-slot decode path runs unchanged: DMRFramer._frame_burst — CACH,
slot type, EMB, CSBK/LC/voice content — so bank framing and per-slot
framing are byte-identical by construction (asserted in
tests/test_dmr_bankframer.py).

Voice superframes (bursts B..F carry EMB instead of sync) follow frame
A by fixed 144-dibit strides; a superframe that crosses a chunk
boundary continues from per-slot stride state on the next call.
"""
from __future__ import annotations

from operator import itemgetter

import numpy as np

from ..bits import from_int
from .burst import (cach_decode_batch, emb_decode_batch,
                    slot_type_decode_batch)
from .framer import (BURST_BITS, MAX_SYNC_BIT_ERRORS, SYNC_OFFSET,
                     DMRBurstFrame, DMRFramer, VOICE_FRAME_ORDER)
from .sync import CACH_PATTERNS, DATA_PATTERNS, SYNC_VALUES, VOICE_PATTERNS

__all__ = ["DMRBankFramer", "DMR_SYNC_DIBIT_PATTERNS"]

BURST_DIBITS = BURST_BITS // 2          # 144
SYNC_OFFSET_DIBITS = SYNC_OFFSET // 2   # 66

_PATTERNS = list(SYNC_VALUES.keys())
# per-pattern flags (bit0 CACH, bit1 data, bit2 voice) — precomputed so
# the hot descriptor loops index a list instead of hashing enums into
# the pattern sets (~0.5M enum hashes/chunk at 1000-carrier scale)
_FLAG_CACH, _FLAG_DATA, _FLAG_VOICE = 1, 2, 4
_PFLAGS = [(_FLAG_CACH if p in CACH_PATTERNS else 0)
           | (_FLAG_DATA if p in DATA_PATTERNS else 0)
           | (_FLAG_VOICE if p in VOICE_PATTERNS else 0)
           for p in _PATTERNS]
_CONT_FLAGS = _FLAG_CACH | _FLAG_VOICE     # frames B..F (EMB, no sync)
DMR_SYNC_DIBIT_PATTERNS = np.stack(
    [np.asarray(from_int(v, 48).reshape(24, 2) @ np.array([2, 1]),
                np.uint8)
     for v in SYNC_VALUES.values()])     # (7, 24) dibit patterns
_DIFF = np.array([[bin(a ^ b).count("1") for b in range(4)]
                  for a in range(4)], np.uint8)
_DESC_KEY = itemgetter(0, 4)                # (slot, abs start)
# data types whose decoded content is a pure value (safe to share
# between frames via the bank framer's memo); packet-data content
# feeds the stateful sequence assembler and is never cached
_CACHEABLE_DT = frozenset((1, 2, 3, 9))     # VH, TLC, CSBK, IDLE


class DMRBankFramer:
    """Streaming multi-channel DMR burst framer; feed per-chunk
    compacted dibit blocks for all C slots, receive (slot, burst) pairs.

    retain: symbols of history per slot — must cover a full voice
    superframe anchored by frame A's sync (6 x 144 dibits) plus the
    pre-sync half of a burst."""

    def __init__(self, channels: int, retain: int = 1024,
                 max_sync_errors: int = MAX_SYNC_BIT_ERRORS):
        self.c = channels
        self.retain = retain
        self.max_sync_errors = max_sync_errors
        self.tail = np.zeros((channels, retain), np.uint8)
        self.total = np.zeros(channels, np.int64)
        self.emitted_until = np.full(channels, -1 << 60, np.int64)
        # per-slot voice superframe continuation: next expected
        # continuation burst (abs dibit start, index into B..F order)
        self.voice_next: dict[int, tuple[int, int]] = {}
        # (slot, abs, pattern, sync_errs) — sync error measured at
        # detection time rides along so a boundary-crossing burst
        # reinjected next chunk reports its true error count
        self.pending: list[tuple[int, int, int, int]] = []
        self._helper = DMRFramer(max_sync_errors)
        # control/LC data-burst content repeats verbatim across slots
        # and superframes at bank scale (a voice header / terminator is
        # re-sent every call cycle with identical LC bits) — memoize
        # the BPTC+parse by info-bit pattern. Only value-type contents
        # are cached (CSBK / full LC / idle); packet-data bursts flow
        # through the stateful assembler uncached. Bounded,
        # clear-on-full like the P25P2 framer's _sig_cache.
        self._data_cache: dict = {}

    def _sync_errs(self, w: np.ndarray, lags: np.ndarray) -> tuple:
        """(C, L) min error + argmin pattern over the 7 sync patterns."""
        if len(lags) <= 64:
            # small lag sets (the per-chunk boundary re-check): one
            # sliding-window gather + per-pattern LUT sum beats 7x24
            # strided adds (~24 ms -> ~4 ms per chunk at 1023 slots)
            win = np.lib.stride_tricks.sliding_window_view(
                w, 24, axis=1)[:, lags]               # (C, L, 24)
            errs = np.stack([_DIFF[win, pat[None, None, :]].sum(
                axis=-1, dtype=np.uint16)
                for pat in DMR_SYNC_DIBIT_PATTERNS])  # (7, C, L)
            which = errs.argmin(axis=0).astype(np.uint8)
            best = np.minimum(
                errs.min(axis=0), 255).astype(np.uint8)
            return best, which
        best = np.full((w.shape[0], len(lags)), 255, np.uint8)
        which = np.zeros((w.shape[0], len(lags)), np.uint8)
        for p in range(len(_PATTERNS)):
            pat = DMR_SYNC_DIBIT_PATTERNS[p]
            err = np.zeros((w.shape[0], len(lags)), np.uint16)
            for k in range(24):
                err += _DIFF[w[:, lags + k], pat[k]]
            err8 = np.minimum(err, 255).astype(np.uint8)
            upd = err8 < best
            which[upd] = p
            best[upd] = err8[upd]
        return best, which

    def process(self, dib: np.ndarray, counts: np.ndarray,
                device_hits: np.ndarray | None = None
                ) -> list[tuple[int, DMRBurstFrame]]:
        dib = np.asarray(dib, np.uint8)
        counts = np.asarray(counts, np.int64)
        c, cap = dib.shape
        retain = self.retain
        w = np.concatenate([self.tail, dib], axis=1)
        valid_w = retain + counts
        abs0 = self.total - retain

        cand_slot, cand_pos = [], []
        if device_hits is not None:
            s_idx, lag = np.nonzero(np.asarray(device_hits, bool))
            keep = lag < counts[s_idx] - 23
            cand_slot.append(s_idx[keep])
            cand_pos.append(lag[keep] + retain)
            blags = np.arange(retain - 23, retain)
            berr, _ = self._sync_errs(w, blags)
            s_idx, li = np.nonzero(berr <= self.max_sync_errors)
            cand_slot.append(s_idx)
            cand_pos.append(blags[li])
        else:
            max_l = int(counts.max()) if len(counts) else 0
            lags = np.arange(retain - 23,
                             retain + max(0, max_l - 23))
            if len(lags):
                errs, _ = self._sync_errs(w, lags)
                s_idx, li = np.nonzero(errs <= self.max_sync_errors)
                keep = lags[li] - retain < counts[s_idx] - 23
                cand_slot.append(s_idx[keep])
                cand_pos.append(lags[li[keep]])

        pend = self.pending
        self.pending = []
        out: list[tuple[int, DMRBurstFrame]] = []

        slots = (np.concatenate(cand_slot) if cand_slot
                 else np.zeros(0, np.int64))
        wpos = (np.concatenate(cand_pos) if cand_pos
                else np.zeros(0, np.int64))
        if len(slots):
            # verify + classify patterns at every candidate
            win = w[slots[:, None], wpos[:, None] + np.arange(24)]
            errs = np.stack(
                [_DIFF[win, DMR_SYNC_DIBIT_PATTERNS[p][None, :]
                       ].sum(axis=1) for p in range(len(_PATTERNS))],
                axis=1)                            # (N, 7)
            which = errs.argmin(axis=1)
            serr = errs.min(axis=1)
            ok = serr <= self.max_sync_errors
            slots, wpos, which, serr = (slots[ok], wpos[ok],
                                        which[ok], serr[ok])

        # merge sync candidates + pendings into per-slot worklists
        # (plain-int lists: np scalar extraction is ~10x a list index
        # at ~14k candidates/chunk)
        per_slot: dict[int, list] = {}
        if len(slots):
            abs_l = (wpos - SYNC_OFFSET_DIBITS + abs0[slots]).tolist()
            which_l = which.tolist()
            serr_l = serr.tolist()
            setdefault = per_slot.setdefault
            for s, a, p, e in zip(slots.tolist(), abs_l, which_l,
                                  serr_l):
                setdefault(s, []).append((a, p, e))
        for s, a, p, e in pend:
            per_slot.setdefault(s, []).append((a, p, e))

        # batched EMB pre-decode at every possible voice-continuation
        # position: frames B..F carry EMB instead of sync, and the walk
        # below needs emb.valid to decide whether a superframe survives.
        # All such positions are deterministic (frame A's start + fixed
        # 144-dibit strides), so ONE batched Hamming pass replaces the
        # per-burst scalar decodes that capped the host layer at ~300
        # carriers (DMRMessageFramer.java:61 uniform-scale bar)
        emb_lut = self._emb_lut(w, abs0, per_slot)

        # per-slot positional walk merging sync-anchored bursts with
        # pending voice superframe continuations — events must be
        # consumed in stream order or a later burst's claim watermark
        # suppresses an earlier continuation (the per-slot framer gets
        # this for free by re-scanning its whole carry window). The
        # walk is purely positional: burst CONTENT is built afterwards
        # in one batched pass over the descriptor list.
        descs: list[tuple] = []  # (slot, pos, pattern, err, abs, emb,
        #                           flags)
        valid_l = valid_w.tolist()
        abs0_l = abs0.tolist()
        # hot-walk locals (~28k iterations/chunk at bank scale)
        emb_get = emb_lut.get
        descs_append = descs.append
        pending_append = self.pending.append
        vfo = VOICE_FRAME_ORDER
        n_vfo = len(vfo)
        half_burst = BURST_DIBITS // 2
        for s in set(per_slot) | set(self.voice_next):
            items = sorted(per_slot.get(s, []))
            vw = valid_l[s]
            a0 = abs0_l[s]
            claimed = int(self.emitted_until[s])
            vn = self.voice_next.pop(s, None)
            i = 0
            while True:
                nxt = items[i] if i < len(items) else None
                if vn is not None and (nxt is None or vn[0] <= nxt[0]):
                    a, idx = vn
                    pos = a - a0
                    if pos < 0:
                        vn = None               # slid out of the window
                        continue
                    if pos + BURST_DIBITS > vw:
                        break                   # nothing later fits either
                    if a >= claimed + half_burst:
                        emb = emb_get((s, a))
                        if emb is None:         # defensive scalar path
                            emb = self._emb_scalar(w[s], pos)
                        if not emb.valid:
                            vn = None           # superframe lost
                            continue
                        descs_append((s, pos, vfo[idx],
                                      0, a, emb, _CONT_FLAGS))
                        claimed = a
                    vn = ((a + BURST_DIBITS, idx + 1)
                          if idx + 1 < n_vfo else None)
                elif nxt is not None:
                    a, p_idx, err = nxt
                    i += 1
                    pos = a - a0
                    if a < claimed + half_burst or pos < 0:
                        continue
                    if pos + BURST_DIBITS > vw:
                        i -= 1
                        break                   # keep for next chunk
                    flags = _PFLAGS[p_idx]
                    descs_append((s, pos, _PATTERNS[p_idx], err, a,
                                  None, flags))
                    claimed = a
                    if flags & _FLAG_VOICE:
                        vn = (a + BURST_DIBITS, 0)
                else:
                    break
            self.emitted_until[s] = claimed
            if vn is not None:
                self.voice_next[s] = vn
            for a, p_idx, err in items[i:]:     # incomplete tail bursts
                pending_append((s, a, p_idx, err))

        # sorting the compact descriptors replaces the old per-frame
        # sort (one tuple key per burst was ~0.1 s/chunk at bank scale);
        # itemgetter keeps the key extraction in C (~60k calls/chunk)
        descs.sort(key=_DESC_KEY)
        out.extend(self._build_frames(w, descs))

        # advance rolling windows (row-copy via sliding-window view)
        self.tail = np.lib.stride_tricks.sliding_window_view(
            w, retain, axis=1)[np.arange(self.c), valid_w - retain]
        self.total += counts
        return out

    # EMB word = burst bits [132:140) + [172:180) = dibits 66..69, 86..89
    _EMB_DIBITS = np.array([66, 67, 68, 69, 86, 87, 88, 89])

    def _emb_lut(self, w: np.ndarray, abs0: np.ndarray,
                 per_slot: dict) -> dict:
        """Batch-decode the EMB at every position a voice superframe
        walk could visit this chunk: {(slot, abs_pos): EMB}."""
        es, ea = [], []
        for s, items in per_slot.items():
            for a, p_idx, _ in items:
                if _PFLAGS[p_idx] & _FLAG_VOICE:
                    for k in range(1, len(VOICE_FRAME_ORDER) + 1):
                        es.append(s)
                        ea.append(a + k * BURST_DIBITS)
        for s, (a, idx) in self.voice_next.items():
            for j in range(len(VOICE_FRAME_ORDER) - idx):
                es.append(s)
                ea.append(a + j * BURST_DIBITS)
        if not es:
            return {}
        es = np.asarray(es)
        ea = np.asarray(ea)
        pos = ea - abs0[es]
        keep = (pos >= 0) & (pos + 90 <= w.shape[1])
        es, ea, pos = es[keep], ea[keep], pos[keep]
        if not len(es):
            return {}
        dib = w[es[:, None], pos[:, None] + self._EMB_DIBITS]  # (N, 8)
        bits = np.empty((len(es), 16), np.uint8)
        bits[:, 0::2] = dib >> 1
        bits[:, 1::2] = dib & 1
        embs = emb_decode_batch(bits)
        return dict(zip(zip(es.tolist(), ea.tolist()), embs))

    def _emb_scalar(self, row: np.ndarray, pos: int):
        from .burst import EMB
        dib = row[pos + self._EMB_DIBITS]
        bits = np.empty(16, np.uint8)
        bits[0::2] = dib >> 1
        bits[1::2] = dib & 1
        return EMB.decode(bits)

    def _build_frames(self, w: np.ndarray, descs: list
                      ) -> list[tuple[int, DMRBurstFrame]]:
        """Batched burst construction for the walk's descriptor list:
        one gather for all burst windows, one batched TACT pass for all
        CACHs, one batched Golay pass for all slot types; only data-
        burst CONTENT (CSBK/BPTC/packet — control-channel traffic, a
        tiny fraction of a voice-dominated bank) stays scalar via the
        proven per-slot path (DMRFramer._decode_data)."""
        if not descs:
            return []
        s_arr = np.array([d[0] for d in descs])
        p_arr = np.array([d[1] for d in descs])
        # row-copy gather via sliding-window view (one contiguous
        # 144-byte copy per burst; the (N, 144) index-grid fancy gather
        # was a measured hot spot at ~14k bursts/chunk)
        win = np.lib.stride_tricks.sliding_window_view(
            w, BURST_DIBITS, axis=1)[s_arr, p_arr]
        bits = np.empty((len(descs), BURST_BITS), np.uint8)
        bits[:, 0::2] = win >> 1
        bits[:, 1::2] = win & 1

        flags = [d[6] for d in descs]
        cach_rows = [i for i, f in enumerate(flags) if f & _FLAG_CACH]
        cachs = (cach_decode_batch(bits[cach_rows, :24])
                 if cach_rows else [])
        data_rows = [i for i, f in enumerate(flags) if f & _FLAG_DATA]
        sts = (slot_type_decode_batch(np.concatenate(
            [bits[data_rows, 122:132], bits[data_rows, 180:190]],
            axis=1)) if data_rows else [])
        voice_rows = [i for i, f in enumerate(flags) if f & _FLAG_VOICE]
        if voice_rows:
            vb = bits[voice_rows]
            vframes = np.stack(
                [vb[:, 24:96],
                 np.concatenate([vb[:, 96:132], vb[:, 180:216]], axis=1),
                 vb[:, 216:288]], axis=1)               # (Nv, 3, 72)

        out = []
        ci = di = vi = 0
        decode_data = DMRFramer._decode_data
        append = out.append
        for i, (s, pos, pattern, err, a, emb, f) in enumerate(descs):
            # positional construction (field order of DMRBurstFrame):
            # pattern, start, bits, cach, slot_type, emb, timeslot,
            # content, content_kind, sync_errors
            if f & _FLAG_CACH:
                cach = cachs[ci]
                ci += 1
                ts = cach.timeslot if cach.valid else 1
            else:
                cach = None
                ts = 1
            if f & _FLAG_DATA:
                st = sts[di]
                frame = DMRBurstFrame(pattern, a, bits[i], cach,
                                      st, None, ts, None, "", err)
                di += 1
                if st.valid and st.data_type in _CACHEABLE_DT:
                    b = bits[i]
                    key = (st.data_type, b[24:122].tobytes(),
                           b[190:288].tobytes())
                    hit = self._data_cache.get(key)
                    if hit is None:
                        if len(self._data_cache) >= 4096:
                            self._data_cache.clear()
                        decode_data(frame)
                        self._data_cache[key] = (frame.content,
                                                 frame.content_kind)
                    else:
                        frame.content, frame.content_kind = hit
                else:
                    decode_data(frame)
            elif f & _FLAG_VOICE:
                frame = DMRBurstFrame(
                    pattern, a, bits[i], cach, None, emb, ts,
                    {"ambe_frames": vframes[vi]}, "voice", err)
                vi += 1
            else:
                frame = DMRBurstFrame(pattern, a, bits[i], cach, None,
                                      None, ts, None, "", err)
            append((s, frame))
        return out
