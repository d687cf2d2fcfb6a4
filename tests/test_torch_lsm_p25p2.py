"""The port's LSM and P25 Phase 2 decoder chains against the JAX reference on
the CPU.

Each chain (baseband FIR -> power monitor -> AGC -> Gardner DQPSK) runs on
the same (3, T) block of pi/4-DQPSK: LSM at 25 kHz, P25 Phase 2 at the
channelizer's 25 kHz (zero-stuffed x2 to 50 kHz before the FIR) and at
50 kHz (no stuffing). The taps and the stuffing factor must be equal; the
AGC's ``leveled`` stream, the FIR, AGC and power state within 1e-5 (the
power trace within 1e-3 dB), dibits and valid exact, and the Gardner state
within 1e-5, as in test_torch_c4fm.py. Seed 7, on which the loop's float32
rounding does not drift past 1e-5 (tests/test_torch_gardner.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrtrunk_tpu.decoders.lsm import LSMConfig as JLSMConfig
from sdrtrunk_tpu.decoders.lsm import LSMDecoder as JLSMDecoder
from sdrtrunk_tpu.decoders.p25p2 import P25P2Config as JP25P2Config
from sdrtrunk_tpu.decoders.p25p2 import P25P2Decoder as JP25P2Decoder
from sdrtrunk_tpu.signal.generators import awgn, lsm_modulate, random_dibits
from sdrtrunk_tpu_torch.convert import tree_map
from sdrtrunk_tpu_torch.decoders.lsm import LSMConfig, LSMDecoder
from sdrtrunk_tpu_torch.decoders.p25p2 import P25P2Config, P25P2Decoder
from sdrtrunk_tpu_torch.dsp.psk import GardnerDQPSKDemodulator, GardnerState

torch.set_num_threads(1)

SEED = 7
# kind, channel rate, baud, T
CHAINS = {"lsm": (25000.0, 4800.0, 1024), "p25p2_25k": (25000.0, 6000.0, 600),
          "p25p2_50k": (50000.0, 6000.0, 1024)}


def _decoders(kind):
    rate = CHAINS[kind][0]
    if kind == "lsm":
        return (JLSMDecoder(JLSMConfig(sample_rate=rate)),
                LSMDecoder(LSMConfig(sample_rate=rate), device="cpu"))
    return (JP25P2Decoder(JP25P2Config(sample_rate=rate)),
            P25P2Decoder(P25P2Config(sample_rate=rate), device="cpu"))


def _block(c, t, seed, rate, baud):
    rows = []
    for i in range(c):
        dib = random_dibits(int(t * baud / rate) + 16, seed=seed + i)
        x = lsm_modulate(dib, sample_rate=rate, symbol_rate=baud)[:t]
        x = awgn(x * np.exp(1j * 0.3 * i), snr_db=30.0,
                 rng=np.random.default_rng(seed + 50 + i))
        rows.append(x[:t] * (0.2 + 0.4 * i))
    return np.stack(rows).astype(np.complex64)


def _jax_state(dec, c):
    return jax.tree.map(lambda a: jnp.broadcast_to(a, (c,) + a.shape),
                        dec.init_state())


def _port_state(jstate):
    out = {k: torch.as_tensor(np.array(jstate[k]))
           for k in ("fir", "agc", "power")}
    out["psk"] = GardnerState(*[torch.as_tensor(np.array(a))
                                for a in jstate["psk"]])
    return out


def _flat(state):
    out = {k: v for k, v in state.items() if k != "psk"}
    out.update({f"psk.{k}": v for k, v in state["psk"]._asdict().items()})
    return out


@pytest.mark.parametrize("kind", list(CHAINS))
def test_taps_and_config_match_reference(kind):
    j, t = _decoders(kind)
    np.testing.assert_array_equal(t.baseband_taps.numpy(), j.baseband_taps)
    assert t.upsample == getattr(j, "upsample", 1)
    assert t.config.agc_window == j.config.agc_window
    assert isinstance(t.demod, GardnerDQPSKDemodulator)
    for name in ("sample_rate", "samples_per_symbol", "window_len",
                 "sample_counter_gain", "cur_bases"):
        assert getattr(t.demod, name) == getattr(j.demod, name), name


@pytest.mark.parametrize("kind", list(CHAINS))
def test_batched_call_matches_reference(kind):
    rate, baud, t = CHAINS[kind]
    c = 3
    x = _block(c, t, SEED, rate, baud)
    jdec, tdec = _decoders(kind)
    s0 = _jax_state(jdec, c)
    front0 = {k: s0[k] for k in ("fir", "agc", "power")}
    (j_leveled, _), _ = jax.vmap(jdec._front)(jnp.asarray(x), front0)
    j_out, j_state = jdec.batched_call(jnp.asarray(x), s0)

    ts0 = _port_state(s0)
    (t_leveled, _), _ = tdec._front(torch.as_tensor(x), ts0)
    t_out, t_state = tdec.batched_call(torch.as_tensor(x), ts0)

    assert t_leveled.shape == (c, t * tdec.upsample)
    np.testing.assert_allclose(t_leveled.numpy(), np.asarray(j_leveled),
                               rtol=1e-5, atol=1e-5)
    valid = np.asarray(j_out["valid"])
    assert valid.mean() > 0.1
    np.testing.assert_array_equal(t_out["valid"].numpy(), valid)
    np.testing.assert_array_equal(t_out["dibits"].numpy()[valid],
                                  np.asarray(j_out["dibits"])[valid])
    np.testing.assert_allclose(t_out["power_db"].numpy(),
                               np.asarray(j_out["power_db"]), rtol=0,
                               atol=1e-3)
    want = _flat(jax.tree.map(np.asarray, j_state))
    got = _flat(tree_map(lambda a: a.numpy(), t_state))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-5, err_msg=name)

