"""The port's plain DSP modules against the JAX reference on the CPU.

Each test feeds the same NumPy inputs, made from a seed, to the JAX
function and to its counterpart in sdrtrunk_tpu_torch (device="cpu") and
compares within the stated tolerance. The tolerances are float32
rounding budgets: the two frameworks sum and transform in other orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrtrunk_tpu.dsp import agc as jagc
from sdrtrunk_tpu.dsp import demod as jdemod
from sdrtrunk_tpu.dsp import fir as jfir
from sdrtrunk_tpu.dsp import iir as jiir
from sdrtrunk_tpu.dsp.channelizer import Channelizer as JChannelizer
from sdrtrunk_tpu.dsp.channelizer import _channelize_core
from sdrtrunk_tpu.dsp.synthesizer import synthesize_bank as jsynthesize_bank
from sdrtrunk_tpu_torch.dsp import agc, demod, fir, iir
from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer, channelize_core
from sdrtrunk_tpu_torch.dsp.synthesizer import synthesize_bank

torch.set_num_threads(1)


def _cplx(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("m", [32, 64])
def test_channelize_core_matches_reference(m):
    rng = np.random.default_rng(m)
    ch = JChannelizer.design(m * 12500.0, 12500.0, taps_per_channel=9)
    assert ch.hmat.shape[0] == 9
    xp = _cplx(rng, ch.hmat.size + 6 * m)
    want = np.asarray(_channelize_core(jnp.asarray(xp),
                                       jnp.asarray(ch.hmat), m))
    got = channelize_core(torch.as_tensor(xp), torch.as_tensor(ch.hmat))
    assert got.shape == want.shape == (12, m)
    tol = 1e-5 * np.max(np.abs(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("m", [32, 64])
def test_channelizer_chunked_equals_one_shot(m):
    rng = np.random.default_rng(100 + m)
    ch = Channelizer.design(m * 12500.0, 12500.0, device="cpu")
    x = torch.as_tensor(_cplx(rng, 10 * m))
    y_all, s_all = ch(x)
    y1, s1 = ch(x[:4 * m])
    y2, s2 = ch(x[4 * m:], s1)
    torch.testing.assert_close(torch.cat([y1, y2]), y_all, rtol=0, atol=0)
    torch.testing.assert_close(s2, s_all, rtol=0, atol=0)


def test_channelizer_design_matches_reference():
    j = JChannelizer.design(64 * 12500.0, 12500.0)
    t = Channelizer.design(64 * 12500.0, 12500.0, device="cpu")
    np.testing.assert_array_equal(t.hmat.numpy(), j.hmat)
    assert t.channel_sample_rate == j.channel_sample_rate
    for f in (-40000.0, 0.0, 12500.0, 31000.0):
        assert t.channel_for_frequency(f) == j.channel_for_frequency(f)
    for b in (0, 5, 33, 63):
        assert t.center_frequency(b) == j.center_frequency(b)


def test_fir_apply_matches_reference():
    rng = np.random.default_rng(1)
    taps = rng.standard_normal(63).astype(np.float32) / 8
    x = _cplx(rng, 3, 500)
    st = _cplx(rng, 3, 62)
    want = [jfir.fir_apply(jnp.asarray(x[c]), jnp.asarray(taps),
                           jnp.asarray(st[c])) for c in range(3)]
    y, s = fir.fir_apply(torch.as_tensor(x), torch.as_tensor(taps),
                         torch.as_tensor(st))
    np.testing.assert_allclose(y.numpy(), np.stack([np.asarray(w[0])
                                                    for w in want]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(s.numpy(), np.stack([np.asarray(w[1])
                                                       for w in want]))


def test_single_pole_apply_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.random((3, 700)).astype(np.float32)
    y0 = rng.random(3).astype(np.float32)
    want = [jiir.single_pole_apply(jnp.asarray(x[c]), 0.0004,
                                   jnp.asarray(y0[c])) for c in range(3)]
    y, s = iir.single_pole_apply(torch.as_tensor(x), 0.0004,
                                 torch.as_tensor(y0))
    np.testing.assert_allclose(y.numpy(), np.stack([np.asarray(w[0])
                                                    for w in want]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), [float(w[1]) for w in want],
                               rtol=1e-5, atol=1e-5)


def test_power_db_matches_reference():
    rng = np.random.default_rng(3)
    x = _cplx(rng, 3, 700) * 0.3
    p0 = rng.random(3).astype(np.float32) * 0.1
    want = [jdemod.power_db(jnp.asarray(x[c]), 0.0004, jnp.asarray(p0[c]))
            for c in range(3)]
    pdb, s = demod.power_db(torch.as_tensor(x), 0.0004, torch.as_tensor(p0))
    np.testing.assert_allclose(pdb.numpy(), np.stack([np.asarray(w[0])
                                                      for w in want]),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(s.numpy(), [float(w[1]) for w in want],
                               rtol=1e-5, atol=1e-5)


def test_feed_forward_agc_matches_reference():
    rng = np.random.default_rng(4)
    x = _cplx(rng, 3, 400) * np.linspace(0.01, 2.0, 400).astype(np.float32)
    st = rng.random((3, 31)).astype(np.float32)
    want = [jagc.feed_forward_agc(jnp.asarray(x[c]), jnp.asarray(st[c]), 32)
            for c in range(3)]
    y, s = agc.feed_forward_agc(torch.as_tensor(x), torch.as_tensor(st), 32)
    np.testing.assert_allclose(y.numpy(), np.stack([np.asarray(w[0])
                                                    for w in want]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.stack([np.asarray(w[1])
                                                    for w in want]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [16, 64])
def test_synthesize_bank_matches_reference(m):
    rng = np.random.default_rng(5 + m)
    ch = JChannelizer.design(m * 12500.0, 12500.0)
    u = _cplx(rng, 21, m)
    want = jsynthesize_bank(u, ch.hmat)
    got = synthesize_bank(torch.as_tensor(u), torch.as_tensor(ch.hmat))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    tol = 1e-5 * np.max(np.abs(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)

