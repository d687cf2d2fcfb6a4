"""Error detection and correction codes (bit-exact, host-side NumPy).

Covers the codes the reference implements in edac/ (SURVEY.md section 2.2):
BCH(63,16,11), Golay(24/23/18), Hamming(10/13/15/16/17), Reed-Solomon over
GF(64) (P25) and GF(256) (DMR), BPTC(196,96) and (17,12,3) product codes,
trellis 1/2 & 3/4 Viterbi, and the per-protocol CRC families.

All decoders are written from the underlying standards/coding theory —
the only thing shared with the reference is the code parameters.
"""
from .galois import GF
from .rs import ReedSolomon
from .bch import BCH_63_16_11
