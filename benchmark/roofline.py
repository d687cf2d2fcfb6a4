"""The yardstick of the roofline shares: the card's published peaks and
the operations and bytes each measured layer needs, from its shapes.

Peaks: NVIDIA's H100 SXM data sheet, at its 700 W limit: 3.35 TB/s of
HBM3, 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the tensor
cores. A bound counts each input byte read once and each output byte
written once; the least time is the larger of bytes over the memory rate
and operations over the arithmetic rate.
"""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12

# the DQPSK kernel's work, as its source counts it: the mix and delay
# line a sample, the interpolation, decision and loop updates a symbol
DQPSK_OPS_PER_SAMPLE = 13
DQPSK_OPS_PER_SYMBOL = 70
# the Gardner kernel's (csrc/gardner.cu, psk_common.cuh), counted as: a
# product, sum or compare one, a fused multiply-add two, cos, sin and a
# reciprocal square root one each; selects, negations, conversions and the
# phase wrap's rare subtraction none. A sample, 13: the same symbol_loop as
# the DQPSK kernel's (the PLL mix 8: cos, sin, two products, two
# multiply-adds; the phase sum and its wrap's two compares 3; sp - 1 and
# the due compare 2). A symbol, 144: the mid point 41 (the clip of sp 2,
# floor and fraction 2, the arm's product and clip 3, the base's clip 2,
# two 8-tap interpolations of a product and seven multiply-adds 30, the
# base-set compares 2); the current point 40 (dsps / 2, then as the mid
# point's but the clip of sp); two differential normalisations 28 (each:
# the product's parts 6, the squared magnitude 3, two compares, the
# reciprocal square root, two products); the timing error 8 (two
# differences, a product and a multiply-add, the NaN test, a clip 2); the
# quadrant decision 9 (two sign compares, three products and a difference,
# a clip 2, the NaN test); the timing and PLL updates 18
GARDNER_OPS_PER_SAMPLE = 13
GARDNER_OPS_PER_SYMBOL = 144


def least_ms(nbytes: float, ops: float, ops_per_s: float) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def channelize_ms(n: int, m: int, taps: int) -> float:
    """ingest + channelizer over n int8 I/Q samples into M bins: reads
    the int8 pairs, the T M complex64 history and the (T, M) float32
    branches, writes the (K, M) complex64 output (K = 2 n / M); T
    multiply-adds of both planes an output, an M-point complex FFT
    (5 M log2 M operations) a block, and the int8 scaling."""
    k = 2 * n // m
    nbytes = 2 * n + 8 * taps * m + 4 * taps * m + 8 * k * m
    ops = 4 * taps * k * m + 5 * m * math.log2(m) * k + 2 * n
    return least_ms(nbytes, ops, FP32_OPS_PER_S)


def dqpsk_ms(c: int, t: int, window: int, sps: float) -> float:
    """The DQPSK kernel over (C, T) complex64 samples: reads them, the
    (129, 8) interpolator bank and the state (a W-sample delay line,
    four float32 and two complex64 leaves a channel), writes one byte a
    sample and the new state; its operations at the float64 rate, for
    the symbols T / sps a channel."""
    return _symbol_loop_ms(c, t, window * 8 + 4 * 4 + 2 * 8, sps,
                           DQPSK_OPS_PER_SAMPLE, DQPSK_OPS_PER_SYMBOL)


def gardner_ms(c: int, t: int, window: int, sps: float) -> float:
    """The Gardner kernel, as ``dqpsk_ms`` counts it: its state a W-sample
    complex64 window, four float32 and three complex64 leaves a
    channel."""
    return _symbol_loop_ms(c, t, window * 8 + 4 * 4 + 3 * 8, sps,
                           GARDNER_OPS_PER_SAMPLE, GARDNER_OPS_PER_SYMBOL)


def _symbol_loop_ms(c: int, t: int, state: int, sps: float,
                    per_sample: int, per_symbol: int) -> float:
    nbytes = 8 * c * t + t * c + 129 * 8 * 4 + 2 * c * state
    ops = c * t * per_sample + c * (t / sps) * per_symbol
    return least_ms(nbytes, ops, FP64_OPS_PER_S)
