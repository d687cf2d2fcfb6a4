"""The kernel wrappers refuse a count their C entry points cannot hold.

Every kernel's entry point (csrc/*.cu, loaded with ctypes) takes its
counts as C ints, and ctypes wraps a larger Python int without a word: a
float32 row of 2**32 + 5 samples would be filtered for 5. Each wrapper
raises ValueError naming the limit before it builds or launches, and
before its device check, so the tests run here on meta tensors (nothing
is allocated). No JAX here.
"""
import ctypes

import pytest
import torch

from sdrtrunk_tpu_torch.dsp import (biquad_cuda, bit_timing_cuda,
                                    channelize_cuda, cma_cuda, dqpsk_cuda,
                                    gardner_cuda, nvcc)
from sdrtrunk_tpu_torch.dsp.fsk import LTRFSKDemodulator
from sdrtrunk_tpu_torch.dsp.psk import (DQPSKDemodulator, DQPSKState,
                                        GardnerDQPSKDemodulator, GardnerState)

BIG = 2**31 + 5


def test_ctypes_wraps_an_int_past_32_bits():
    """What the check guards against: an int argument of a C function
    arrives wrapped modulo 2**32."""
    got = []
    fn = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int)(
        lambda v: got.append(v) or 0)
    fn(BIG)
    fn(2**32 + 5)
    assert got == [-2147483643, 5]


@pytest.mark.parametrize("value,limit,ok", [
    (0, nvcc.INT_MAX, True), (nvcc.INT_MAX, nvcc.INT_MAX, True),
    (nvcc.INT_MAX + 1, nvcc.INT_MAX, False), (-1, nvcc.INT_MAX, False),
    (nvcc.SYMBOL_LOOP_MAX_T, nvcc.SYMBOL_LOOP_MAX_T, True),
    (nvcc.SYMBOL_LOOP_MAX_T + 1, nvcc.SYMBOL_LOOP_MAX_T, False)])
def test_check_count_takes_what_the_limit_holds(value, limit, ok):
    if ok:
        nvcc.check_count("k", "N", value, limit)
    else:
        with pytest.raises(ValueError, match=f"k: N = {value} is above the "
                                             f"kernel's limit of {limit}"):
            nvcc.check_count("k", "N", value, limit)


def _no_build(monkeypatch):
    def fail():
        raise AssertionError("built before refusing")
    for mod in (biquad_cuda, cma_cuda, bit_timing_cuda, dqpsk_cuda,
                gardner_cuda, channelize_cuda):
        monkeypatch.setattr(mod, "build", fail)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


_B, _A = [0.2, 0.4, 0.2], [1.0, -0.5, 0.25]


def _symbol(cls, state_cls, c, t):
    demod = cls(25000.0, device="cpu")
    state = state_cls(*[a.expand((1,) + a.shape).clone()
                        for a in demod.init_state()])
    return demod, _meta((c, t), torch.complex64), state


@pytest.mark.parametrize("case,match", [
    ("biquad_n", f"biquad_cuda: N = {BIG} "),
    ("biquad_n_complex", f"biquad_cuda: N = {BIG} "),
    ("biquad_rows", f"biquad_cuda: rows = {BIG} "),
    ("biquad_rows_product", f"biquad_cuda: rows = {2**16 * 2**16} "),
    ("cma_n", f"cma_cuda: N = {BIG} "),
    ("dqpsk_t", f"dqpsk_cuda: T = {nvcc.SYMBOL_LOOP_MAX_T + 1} "),
    ("dqpsk_c", f"dqpsk_cuda: C = {BIG} "),
    ("gardner_t", f"gardner_cuda: T = {2**32 + 5} "),
    ("gardner_c", f"gardner_cuda: C = {nvcc.SYMBOL_LOOP_MAX_C + 1} "),
    ("bit_timing_t", f"bit_timing_cuda: T = {bit_timing_cuda.MAX_T + 1} "),
    ("bit_timing_c", f"bit_timing_cuda: C = {BIG} "),
    ("channelize_km", f"channelize_cuda: K M = {2**31} "),
    ("channelize_len", f"channelize_cuda: T M \\+ N = {2**31 + 1024} ")])
def test_wrappers_refuse_a_count_past_their_limit(monkeypatch, case, match):
    """Each wrapper refuses, with ValueError naming the count and the limit
    and before it builds, a count its C entry's int or its kernel's index
    cannot hold: the biquad's rows (the product of the leading axes) and
    samples a row (a complex row's 2 N floats are indexed in 64 bits), the
    CMA's samples, the symbol loops' channels and samples (a pass reads 63
    past its start), the bit timing's (a tile ends 8192 past its start)
    and the channelizer's output K M and input T M + N."""
    _no_build(monkeypatch)
    geom = LTRFSKDemodulator(device="cpu").geometry
    win, sp = torch.zeros((1, geom.window_len), dtype=torch.int8), \
        torch.zeros(1)
    call = {
        "biquad_n": lambda: biquad_cuda.biquad_cuda(_meta((2, BIG)), _B, _A),
        "biquad_n_complex": lambda: biquad_cuda.biquad_cuda(
            _meta((BIG,), torch.complex64), _B, _A),
        "biquad_rows": lambda: biquad_cuda.biquad_cuda(_meta((BIG, 4)), _B,
                                                       _A),
        "biquad_rows_product": lambda: biquad_cuda.biquad_cuda(
            _meta((2**16, 2**16, 3)), _B, _A),
        "cma_n": lambda: cma_cuda.cma_cuda(_meta((BIG,), torch.complex64),
                                           _meta((11,), torch.complex64)),
        "dqpsk_t": lambda: dqpsk_cuda.dqpsk_cuda(*_symbol(
            DQPSKDemodulator, DQPSKState, 1, nvcc.SYMBOL_LOOP_MAX_T + 1)),
        "dqpsk_c": lambda: dqpsk_cuda.dqpsk_cuda(*_symbol(
            DQPSKDemodulator, DQPSKState, BIG, 8)),
        "gardner_t": lambda: gardner_cuda.gardner_cuda(*_symbol(
            GardnerDQPSKDemodulator, GardnerState, 1, 2**32 + 5)),
        "gardner_c": lambda: gardner_cuda.gardner_cuda(*_symbol(
            GardnerDQPSKDemodulator, GardnerState,
            nvcc.SYMBOL_LOOP_MAX_C + 1, 8)),
        "bit_timing_t": lambda: bit_timing_cuda.bit_timing_cuda(
            geom, _meta((1, bit_timing_cuda.MAX_T + 1)), win, sp),
        "bit_timing_c": lambda: bit_timing_cuda.bit_timing_cuda(
            geom, _meta((BIG, 8)), win, sp),
        # K M = 2 N: N = 2**30 at M = 1024; T M alone past a C int
        "channelize_km": lambda: channelize_cuda.channelize_cuda(
            _meta((9 * 1024 + 2**30,), torch.complex64), _meta((9, 1024))),
        "channelize_len": lambda: channelize_cuda.channelize_cuda(
            _meta((2**31 + 1024,), torch.complex64), _meta((2**21, 1024))),
    }[case]
    with pytest.raises(ValueError, match=match + "is above the kernel's "
                                                 "limit"):
        call()


@pytest.mark.parametrize("case", ["biquad", "biquad_complex", "cma",
                                  "dqpsk_c", "dqpsk_t", "bit_timing_c",
                                  "bit_timing_t", "channelize"])
def test_wrappers_pass_the_largest_count_on_to_the_device_check(monkeypatch,
                                                               case):
    """At the limit itself the count check passes and the wrapper goes on
    to refuse the meta tensor as not on a CUDA device."""
    _no_build(monkeypatch)
    geom = LTRFSKDemodulator(device="cpu").geometry
    win, sp = torch.zeros((1, geom.window_len), dtype=torch.int8), \
        torch.zeros(1)
    call = {
        "biquad": lambda: biquad_cuda.biquad_cuda(
            _meta((1, nvcc.INT_MAX)), _B, _A),
        "biquad_complex": lambda: biquad_cuda.biquad_cuda(
            _meta((2**20, nvcc.INT_MAX), torch.complex64), _B, _A),
        "cma": lambda: cma_cuda.cma_cuda(
            _meta((nvcc.INT_MAX,), torch.complex64),
            _meta((32,), torch.complex64)),
        "dqpsk_c": lambda: dqpsk_cuda.dqpsk_cuda(*_symbol(
            DQPSKDemodulator, DQPSKState, nvcc.SYMBOL_LOOP_MAX_C, 8)),
        "dqpsk_t": lambda: dqpsk_cuda.dqpsk_cuda(*_symbol(
            DQPSKDemodulator, DQPSKState, 1, nvcc.SYMBOL_LOOP_MAX_T)),
        "bit_timing_c": lambda: bit_timing_cuda.bit_timing_cuda(
            geom, _meta((bit_timing_cuda.MAX_C, 8)), win, sp),
        "bit_timing_t": lambda: bit_timing_cuda.bit_timing_cuda(
            geom, _meta((1, bit_timing_cuda.MAX_T)), win, sp),
        # K M = 2 N = 2**31 - 4 at M = 2 (N = 2**30 - 2), T = 3
        "channelize": lambda: channelize_cuda.channelize_cuda(
            _meta((6 + 2**30 - 2,), torch.complex64), _meta((3, 2))),
    }[case]
    monkeypatch.setattr(dqpsk_cuda, "build", lambda: None)
    monkeypatch.setattr(bit_timing_cuda, "build", lambda: None)
    with pytest.raises(ValueError, match="CUDA"):
        call()
