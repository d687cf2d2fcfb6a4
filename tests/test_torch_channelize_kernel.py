"""The channelizer's branch sums without a card.

The kernel itself (csrc/channelize.cu) runs only on a card, where
tests/test_torch_cuda.py holds it bit for bit against ``branch_sums_plain``.
Here: the plain sums against the formula the kernel computes, the plain
core against its parts, a CPU tensor never reaching the wrapper, and the
wrapper refusing what the kernel does not take before it builds. No JAX
here.
"""
import numpy as np
import pytest
import torch

from sdrtrunk_tpu_torch.dsp import channelize_cuda
from sdrtrunk_tpu_torch.dsp.channelizer import (Channelizer,
                                                branch_sums_plain, channelize,
                                                channelize_core,
                                                channelize_core_plain,
                                                polyphase_branch_filters)

torch.set_num_threads(1)


def _inputs(m: int, t: int, k: int, seed: int, taps: int | None = None):
    """xp ((T M + N,) complex64) and hmat ((T, M) float32): a prototype of
    ``taps`` (T M when None) random taps with one branch all zero, samples
    with negative real parts (so that branch's real sums are -0 where no
    sample is an exact zero), imaginary parts of both signs, and a few
    exact zeros."""
    rng = np.random.default_rng(seed)
    proto = rng.standard_normal(taps or t * m) / m
    hmat = polyphase_branch_filters(proto, m).astype(np.float32)
    assert hmat.shape == (t, m)
    hmat[:, m // 3] = 0.0
    n = k * m // 2
    xp = (-np.abs(rng.standard_normal(t * m + n))
          + 1j * rng.standard_normal(t * m + n)).astype(np.complex64)
    xp[::97] = 0.0
    return xp, hmat


# (M, T, K, prototype taps): power-of-two M at 9 taps (the cells' T), an M
# that is not a power of two, the smallest K and M, T = 1, a prototype whose
# length is not a multiple of M, an odd count of block pairs, and the bank
# cells' M and T
SHAPES = [(64, 9, 40, None), (192, 9, 34, None), (64, 9, 2, None),
          (2, 3, 6, None), (32, 1, 22, None), (48, 4, 10, 150),
          (256, 2, 70, None), (1024, 9, 4, None)]


@pytest.mark.parametrize("m,t,k,taps", SHAPES)
def test_plain_sums_are_the_kernels_formula(m, t, k, taps):
    """branch_sums_plain is, to float32 rounding, the sums the kernel takes:
    u[b, r] = sum_q h[q, r] xp[(b + 2 (T - q)) M/2 - r], here in float64."""
    xp, hmat = _inputs(m, t, k, seed=m * 1000 + t * 10 + k, taps=taps)
    got = branch_sums_plain(torch.as_tensor(xp), torch.as_tensor(hmat))
    b, r = np.meshgrid(np.arange(k), np.arange(m), indexing="ij")
    want = sum(hmat[q, r].astype(np.float64)
               * xp[(b + 2 * (t - q)) * (m // 2) - r].astype(np.complex128)
               for q in range(t))
    assert got.shape == (k, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("m,t,k,taps", SHAPES)
def test_plain_core_is_the_sums_the_ifft_and_the_flip(m, t, k, taps):
    """channelize_core_plain is branch_sums_plain, ifft(u) * M and the odd
    blocks' odd bins negated."""
    xp, hmat = _inputs(m, t, k, seed=k, taps=taps)
    xp, hmat = torch.as_tensor(xp), torch.as_tensor(hmat)
    y = torch.fft.ifft(branch_sums_plain(xp, hmat), dim=-1) * m
    sign = torch.ones(k, m)
    sign[1::2, 1::2] = -1
    assert torch.equal(channelize_core_plain(xp, hmat), y * sign)


def _no_build(monkeypatch):
    def fail():
        raise AssertionError("the CPU path built the kernel")
    monkeypatch.setattr(channelize_cuda, "build", fail)


@pytest.mark.parametrize("m,t,k,taps", SHAPES)
def test_cpu_tensors_take_the_plain_code(monkeypatch, m, t, k, taps):
    """channelize_core, Channelizer.forward and channelize() on CPU tensors
    run the plain version: no build, no launch, the plain output."""
    _no_build(monkeypatch)
    before = channelize_cuda.channelize_cuda.launches
    xp, hmat = _inputs(m, t, k, seed=7 + k, taps=taps)
    xp, hmat = torch.as_tensor(xp), torch.as_tensor(hmat)
    assert torch.equal(channelize_core(xp, hmat),
                       channelize_core_plain(xp, hmat))
    ch = Channelizer(hmat.numpy(), 800000.0, device="cpu")
    x = xp[t * m:]
    y, _ = ch(x)
    assert torch.equal(y, channelize_core_plain(
        torch.cat([torch.zeros(t * m, dtype=torch.complex64), x]), hmat))
    rng = np.random.default_rng(8)
    y1 = channelize(x, rng.standard_normal(taps or 150), m)
    assert y1.shape == (k, m)
    assert channelize_cuda.channelize_cuda.launches == before


def test_the_wrapper_refuses_a_cpu_tensor_before_it_builds(monkeypatch):
    _no_build(monkeypatch)
    xp, hmat = _inputs(64, 9, 4, seed=9)
    with pytest.raises(ValueError, match="must be on a CUDA device"):
        channelize_cuda.channelize_cuda(torch.as_tensor(xp),
                                        torch.as_tensor(hmat))


@pytest.mark.parametrize("case,match", [
    ("odd_m", "even M"), ("t0", "T >= 1"), ("n_not_multiple", "multiple of M"),
    ("xp_2d", r"xp must be \(T M \+ N,\)")])
def test_the_wrapper_refuses_shapes_before_it_builds(monkeypatch, case,
                                                     match):
    """Odd M, no taps, N off a multiple of M and a 2-D input are refused
    with ValueError before any build (meta tensors: nothing allocated)."""
    _no_build(monkeypatch)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    xp, hmat = {
        "odd_m": (meta((9 * 63 + 63,), torch.complex64),
                  meta((9, 63), torch.float32)),
        "t0": (meta((64,), torch.complex64), meta((0, 64), torch.float32)),
        "n_not_multiple": (meta((9 * 64 + 65,), torch.complex64),
                           meta((9, 64), torch.float32)),
        "xp_2d": (meta((9 * 64 + 64, 1), torch.complex64),
                  meta((9, 64), torch.float32)),
    }[case]
    with pytest.raises(ValueError, match=match):
        channelize_cuda.channelize_cuda(xp, hmat)
