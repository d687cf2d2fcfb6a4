"""The port's Gardner DQPSK symbol recovery against the JAX reference on the
CPU.

The plain PyTorch loop (GardnerDQPSKDemodulator.scan_batched, what
batched() runs for a CPU tensor) is held against the reference's XLA scan
(_scan_batched) and its Pallas kernel in interpret mode, on the signals and
shapes of tests/test_pallas_gardner.py: pi/4-DQPSK at 30 dB, T = 1024, for
LSM at 25 kHz (W = 11), P25 Phase 2 at 50 kHz (W = 16) and 6000 Bd at
25 kHz (W = 11). Valid masks and dibits must agree exactly; the carried
state within rtol = atol = 1e-5 on seed 7.

As for the decision-directed loop (tests/test_torch_psk.py), the state
comparison depends on the signal: the loop integrates float32 rounding,
and XLA:CPU's rsqrt and cos/sin differ from the port's by an ulp now and
then (and its contraction of the mix's a*b+c differs between compiles), so
on some LSM seeds the sampling point drifts a few 1e-5 over 1024 samples.
Dibits and valid are held exact on every seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrtrunk_tpu.dsp.pallas_gardner import gardner_pallas_batched
from sdrtrunk_tpu.dsp.psk import GardnerDQPSKDemodulator as JGardner
from sdrtrunk_tpu.signal.generators import awgn, lsm_modulate, random_dibits
from sdrtrunk_tpu_torch.dsp import gardner_cuda
from sdrtrunk_tpu_torch.dsp.psk import GardnerDQPSKDemodulator, GardnerState

torch.set_num_threads(1)

STATE_SEED = 7
# (sample rate, baud, gain): LSM, P25P2 at 50 kHz, 6000 Bd at 25 kHz
SHAPES = {"lsm": (25000.0, 4800.0, 0.3), "p25p2": (50000.0, 6000.0, 0.1),
          "6000bd_25k": (25000.0, 6000.0, 0.1)}


def _lsm_block(channels: int, t: int, seed: int, rate: float,
               baud: float) -> np.ndarray:
    """(C, T) complex64 pi/4-DQPSK at 30 dB (tests/test_pallas_gardner.py)."""
    rows = []
    for c in range(channels):
        dib = random_dibits(int(t * baud / rate) + 16, seed=seed + c)
        x = lsm_modulate(dib, sample_rate=rate, symbol_rate=baud)
        x = awgn(x[:t], snr_db=30.0,
                 rng=np.random.default_rng(seed + 100 + c))
        rows.append(x[:t])
    return np.stack(rows).astype(np.complex64)


def _pair(shape):
    rate, baud, gain = SHAPES[shape]
    return (JGardner(sample_rate=rate, symbol_rate=baud,
                     sample_counter_gain=gain, impl="xla"),
            GardnerDQPSKDemodulator(rate, baud, gain, device="cpu"))


def _jax_state(demod, c):
    return jax.tree.map(lambda a: jnp.broadcast_to(a, (c,) + a.shape),
                        demod.init_state())


def _port_state(jstate) -> GardnerState:
    return GardnerState(*[torch.as_tensor(np.array(a)) for a in jstate])


def _assert_agree(got, want, state_tol=True):
    d, v, s = got
    v_ref = np.asarray(want[1])
    np.testing.assert_array_equal(v.numpy(), v_ref)
    np.testing.assert_array_equal(d.numpy()[v_ref], np.asarray(want[0])[v_ref])
    if state_tol:
        for name, a, b in zip(GardnerState._fields, s, want[2]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("reference", ["scan", "pallas"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_loop_matches_reference(reference, shape):
    c, t = (3, 1024) if shape == "lsm" else (2, 1024)
    jd, td = _pair(shape)
    x = _lsm_block(c, t, STATE_SEED, *SHAPES[shape][:2])
    s0 = _jax_state(jd, c)
    if reference == "scan":
        want = jd._scan_batched(jnp.asarray(x), s0)
    else:
        want = gardner_pallas_batched(jd, jnp.asarray(x), s0, interpret=True)
    got = td.scan_batched(torch.as_tensor(x), _port_state(s0))
    _assert_agree(got, want)
    assert float(np.asarray(want[1]).mean()) > 0.1      # symbols flowed


@pytest.mark.parametrize("seed", [13, 21, 31])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_dibits_exact_across_seeds(seed, shape):
    c, t = 2, 1024
    jd, td = _pair(shape)
    x = _lsm_block(c, t, seed, *SHAPES[shape][:2])
    s0 = _jax_state(jd, c)
    want = jd._scan_batched(jnp.asarray(x), s0)
    got = td.batched(torch.as_tensor(x), _port_state(s0))
    _assert_agree(got, want, state_tol=False)


@pytest.mark.parametrize("shape", ["lsm", "p25p2"])
def test_state_handoff_two_calls_equal_one(shape):
    c, t = 2, 1024
    _, td = _pair(shape)
    x = torch.as_tensor(_lsm_block(c, t, 21, *SHAPES[shape][:2]))
    s0 = GardnerState(*[a.expand((c,) + a.shape).clone()
                        for a in td.init_state()])
    d_all, v_all, s_all = td.batched(x, s0)
    d1, v1, s1 = td.batched(x[:, :400], s0)
    d2, v2, s2 = td.batched(x[:, 400:], s1)
    assert torch.equal(torch.cat([v1, v2], 1), v_all)
    assert torch.equal(torch.cat([d1, d2], 1), d_all)
    for a, b in zip(s2, s_all):
        assert torch.equal(a, b)


def test_all_zero_channel():
    """A silent channel: no NaN, symbols tick at the nominal rate, and the
    loop agrees with the reference."""
    c, t = 2, 600
    x = np.zeros((c, t), np.complex64)
    x[1] = _lsm_block(1, t, 5, 50000.0, 6000.0)[0]
    jd, td = _pair("p25p2")
    s0 = _jax_state(jd, c)
    want = jd._scan_batched(jnp.asarray(x), s0)
    got = td.batched(torch.as_tensor(x), _port_state(s0))
    _assert_agree(got, want)
    for leaf in got[2]:
        assert torch.isfinite(torch.view_as_real(leaf) if leaf.is_complex()
                              else leaf).all()


def test_cpu_batched_does_not_launch_the_kernel():
    before = gardner_cuda.gardner_cuda.launches
    _, td = _pair("lsm")
    s0 = GardnerState(*[a.expand((1,) + a.shape).clone()
                        for a in td.init_state()])
    td.batched(torch.as_tensor(_lsm_block(1, 64, 3, 25000.0, 4800.0)), s0)
    assert gardner_cuda.gardner_cuda.launches == before


@pytest.mark.parametrize("shape", list(SHAPES))
def test_constants_and_init_state_match_reference(shape):
    jd, td = _pair(shape)
    for name in ("samples_per_symbol", "window_len", "alpha", "beta",
                 "max_pll_freq", "dsps_gain", "mid_bases", "cur_bases"):
        assert getattr(td, name) == getattr(jd, name), name
    np.testing.assert_array_equal(td.bank.numpy(), jd.bank)
    for a, b in zip(td.init_state(), jd.init_state()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert td.window_len in gardner_cuda.WINDOWS


def test_base_outside_its_set_reads_zero():
    """A detected sps pushed outside the tracked range puts the symbol
    point's base outside cur_bases: the point reads 0 there, as in the
    reference, instead of an unrestricted gather."""
    c, t = 1, 64
    jd, td = _pair("p25p2")
    x = _lsm_block(c, t, 9, 50000.0, 6000.0)
    s0 = _jax_state(jd, c)._replace(
        detected_sps=jnp.full((c,), 2.0 * (jd.cur_bases[-1] + 2), jnp.float32))
    want = jd._scan_batched(jnp.asarray(x), s0)
    got = td.scan_batched(torch.as_tensor(x), _port_state(s0))
    _assert_agree(got, want)
