"""Trellis-coded modulation Viterbi decoders: P25 1/2-rate, P25 & DMR
3/4-rate (role of edac/trellis/ViterbiDecoder.java:28 and its nodes).

The code is a finite-state machine whose state is the previous input symbol
(dibit for 1/2, tribit for 3/4); each input emits a 4-bit constellation
nibble from a transition table (P25_1_2_Node.java:?? / DMR_3_4_Node.java:??
— the tables come from TIA-102.BAAA / ETSI TS 102 361-1). The encoder
starts in state 0 and appends a flushing 0 input. Decoding is exact
Viterbi with Hamming branch metrics, vectorized over states with NumPy.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Trellis", "TRELLIS_1_2_P25", "TRELLIS_3_4_P25", "TRELLIS_3_4_DMR",
           "P25_DEINTERLEAVE", "deinterleave_p25", "interleave_p25"]

_T_1_2 = np.array([
    [2, 12, 1, 15],
    [14, 0, 13, 3],
    [9, 7, 10, 4],
    [5, 11, 6, 8],
], dtype=np.int64)

_T_3_4 = np.array([
    [2, 13, 14, 1, 7, 8, 11, 4],
    [14, 1, 7, 8, 11, 4, 2, 13],
    [10, 5, 6, 9, 15, 0, 3, 12],
    [6, 9, 15, 0, 3, 12, 10, 5],
    [15, 0, 3, 12, 10, 5, 6, 9],
    [3, 12, 10, 5, 6, 9, 15, 0],
    [7, 8, 11, 4, 2, 13, 14, 1],
    [11, 4, 2, 13, 14, 1, 7, 8],
], dtype=np.int64)

_POPCOUNT4 = np.array([bin(i).count("1") for i in range(16)], dtype=np.int64)


class Trellis:
    """states = 2^input_bits; output symbols are 4-bit nibbles."""

    def __init__(self, transitions: np.ndarray, input_bits: int):
        self.transitions = transitions
        self.n_states = transitions.shape[0]
        self.input_bits = input_bits
        assert self.n_states == 1 << input_bits

    def encode(self, bits: np.ndarray) -> np.ndarray:
        """Data bits -> transmitted bits (4 per input symbol, + flush)."""
        b = np.asarray(bits, np.uint8)
        if len(b) % self.input_bits:
            raise ValueError("bit count must be a multiple of input size")
        vals = b.reshape(-1, self.input_bits)
        weights = 1 << np.arange(self.input_bits - 1, -1, -1)
        inputs = (vals * weights).sum(axis=1)
        inputs = np.concatenate([inputs, [0]])  # flushing symbol
        out = np.empty((len(inputs), 4), dtype=np.uint8)
        state = 0
        for i, v in enumerate(inputs):
            nib = int(self.transitions[state, v])
            out[i] = [(nib >> 3) & 1, (nib >> 2) & 1, (nib >> 1) & 1, nib & 1]
            state = int(v)
        return out.reshape(-1)

    def decode(self, bits: np.ndarray):
        """Transmitted bits -> (data bits, corrected_bit_count).

        Input length must be 4 * (n_symbols); the last symbol is the flush.
        """
        b = np.asarray(bits, np.uint8)
        if len(b) % 4:
            raise ValueError("encoded length must be a multiple of 4")
        nibbles = (b.reshape(-1, 4) *
                   np.array([8, 4, 2, 1], np.uint8)).sum(axis=1)
        n_sym = len(nibbles)
        S = self.n_states
        T = self.transitions

        # path metrics: start state 0
        INF = 1 << 30
        pm = np.full(S, INF, dtype=np.int64)
        pm[0] = 0
        backptr = np.empty((n_sym, S), dtype=np.int64)
        for t, r in enumerate(nibbles):
            # branch[s_prev, input] = popcount(T[s_prev, input] ^ r)
            branch = _POPCOUNT4[T ^ int(r)]
            cand = pm[:, None] + branch          # (S_prev, S_next=input)
            backptr[t] = np.argmin(cand, axis=0)
            pm = cand[backptr[t], np.arange(S)]
        # final state must be 0 (flushing input 0)
        final = 0
        inputs = np.empty(n_sym, dtype=np.int64)
        s = final
        for t in range(n_sym - 1, -1, -1):
            inputs[t] = s
            s = backptr[t, s]
        errors = int(pm[final])
        data_inputs = inputs[:-1]  # drop flush symbol
        shifts = np.arange(self.input_bits - 1, -1, -1)
        out = ((data_inputs[:, None] >> shifts[None, :]) & 1).astype(np.uint8)
        return out.reshape(-1), errors


TRELLIS_1_2_P25 = Trellis(_T_1_2, 2)
TRELLIS_3_4_P25 = Trellis(_T_3_4, 3)
TRELLIS_3_4_DMR = Trellis(_T_3_4, 3)  # same table (ETSI uses the P25 TCM)


def _p25_deinterleave_table() -> np.ndarray:
    """P25 196-bit data-unit interleave (TIA-102.BAAA; matches the
    reference's DATA_DEINTERLEAVE, P25P1Interleave.java).

    The 49 nibbles are scheduled in 4 wire blocks of [13,12,12,12]:
    encoder nibble 4q+r appears at wire nibble offset[r]+q, with
    offset = [0,13,25,37]. Returned table maps wire bit -> encoder bit.
    """
    offset = [0, 13, 25, 37]
    nib_map = np.zeros(49, dtype=np.int64)  # wire nibble -> encoder nibble
    for r, off in enumerate(offset):
        count = 13 if r == 0 else 12
        for q in range(count):
            nib_map[off + q] = 4 * q + r
    idx = np.arange(196)
    return nib_map[idx // 4] * 4 + idx % 4


P25_DEINTERLEAVE = _p25_deinterleave_table()


def deinterleave_p25(bits196: np.ndarray) -> np.ndarray:
    """Wire-order 196 bits -> encoder-order bits."""
    b = np.asarray(bits196, np.uint8)
    if len(b) != 196:
        raise ValueError("expected 196 bits")
    out = np.zeros(196, dtype=np.uint8)
    out[P25_DEINTERLEAVE] = b
    return out


def interleave_p25(bits196: np.ndarray) -> np.ndarray:
    b = np.asarray(bits196, np.uint8)
    if len(b) != 196:
        raise ValueError("expected 196 bits")
    return b[P25_DEINTERLEAVE]
