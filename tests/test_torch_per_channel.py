"""The port's per-channel call, ``dec(x, state)`` on one channel's 1-D
block, against the JAX package's on the CPU.

Every decoder and demodulator of the port takes the reference's
single-stream call: a 1-D block and a state in ``init_state()``'s layout
(no channel axis), returning the reference's outputs and state layout.
The port runs it as its batched call at C = 1 (on the card: the kernel at
C = 1); the reference runs its XLA scan. Each case feeds the same numpy
input, made from a seed, through both in two chunks with the state
carried between them, so a second chunk would break on a state that came
back in the wrong layout.

Held: valid, audio_gate and the state's integer leaves exact; dibits and
bits exact where valid (the port writes 0 elsewhere, every caller reads
them where valid only); float outputs and state within the tolerances the
batched tests use: audio within 1e-4 and the power trace within 1e-3 dB
(tests/test_torch_analog.py, test_torch_c4fm.py), the symbol loops' state
within 1e-5 on the seeds those tests hold at 1e-5 (13 for the DQPSK loop,
7 for the Gardner loop: tests/test_torch_psk.py, test_torch_gardner.py),
the bit slicers' float state within 1e-5 (tests/test_torch_ltr.py), the
analog chains' state within 1e-4 (the de-emphasis and resampler histories
carry the audio's rounding). The state leaves are compared in
``jax.tree_util``'s order against the port's ``tree_leaves``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrtrunk_tpu.decoders import am as jam, c4fm as jc4fm, dmr as jdmr
from sdrtrunk_tpu.decoders import lsm as jlsm, ltr as jltr, nbfm as jnbfm
from sdrtrunk_tpu.decoders import p25p2 as jp25p2
from sdrtrunk_tpu.dsp.afsk import AFSK1200Demodulator as JAFSK
from sdrtrunk_tpu.dsp.fsk import LTRFSKDemodulator as JFSK
from sdrtrunk_tpu.dsp.psk import DQPSKDemodulator as JDQPSK
from sdrtrunk_tpu.dsp.psk import GardnerDQPSKDemodulator as JGardner
from sdrtrunk_tpu.signal.generators import (awgn, c4fm_modulate,
                                            lsm_modulate, nbfm_modulate,
                                            random_dibits)
from sdrtrunk_tpu_torch.decoders import am, c4fm, dmr, lsm, ltr, nbfm, p25p2
from sdrtrunk_tpu_torch.dsp.afsk import AFSK1200Demodulator
from sdrtrunk_tpu_torch.dsp.fsk import LTRFSKDemodulator
from sdrtrunk_tpu_torch.dsp.psk import (DQPSKDemodulator,
                                        GardnerDQPSKDemodulator)
from sdrtrunk_tpu_torch.tree import tree_leaves
from test_ltr import _fsk_modulate
from test_mpt1327 import _afsk_modulate

torch.set_num_threads(1)

FS = 25000.0
AUDIO_TOL = 1e-4
POWER_TOL = 1e-3
LOOP_TOL = 1e-5
ANALOG_STATE_TOL = 1e-4


def _psk_iq(modulate, t, seed, rate=FS, baud=4800.0):
    dib = random_dibits(int(t * baud / rate) + 16, seed=seed)
    x = modulate(dib, rate, baud)[:t]
    x = awgn(x, snr_db=30.0, rng=np.random.default_rng(seed + 100))
    return x[:t].astype(np.complex64)


def _c4fm_iq(t, seed):
    return _psk_iq(lambda d, r, b: c4fm_modulate(d, sample_rate=r), t, seed)


def _lsm_iq(t, seed, baud=4800.0):
    return _psk_iq(lambda d, r, b: lsm_modulate(d, sample_rate=r,
                                                symbol_rate=b),
                   t, seed, baud=baud)


def _fsk_audio(seed):
    """Sub-audible FSK under an 800 Hz voice tone, with a DC offset and
    noise (tests/test_torch_fsk.py's signal)."""
    rng = np.random.default_rng(seed)
    audio = _fsk_modulate(rng.integers(0, 2, 80).astype(np.uint8))
    n = np.arange(len(audio))
    audio = audio + 0.05 + 0.3 * np.sin(2 * np.pi * 800.0 * n / 8000.0)
    return (audio + 0.05 * rng.standard_normal(len(audio))).astype(np.float32)


def _afsk_audio(seed):
    rng = np.random.default_rng(100 + seed)
    audio = _afsk_modulate(rng.integers(0, 2, 200).astype(np.uint8))
    audio = audio[:len(audio) // 10 * 10]
    return (audio + 0.05 * rng.standard_normal(len(audio))).astype(np.float32)


def _fm(audio, t):
    return nbfm_modulate(audio, 8000.0, FS)[:t].astype(np.complex64)


def _am_iq(t, seed):
    n = np.arange(t)
    env = 1.0 + 0.5 * np.sin(2 * np.pi * 1000.0 * n / FS)
    rng = np.random.default_rng(seed)
    noise = 0.01 * (rng.standard_normal(t) + 1j * rng.standard_normal(t))
    return (env * np.exp(1j * 0.7) + noise).astype(np.complex64)


# name -> (JAX decoder, port decoder on the CPU, input, split). A split
# keeps each chunk a whole number of the 25 kHz -> 8 kHz resampler's 25
# samples and, for MPT1327, of the AFSK demodulator's 10 audio samples.
DECODERS = {
    "c4fm": lambda: (jc4fm.C4FMDecoder(), c4fm.C4FMDecoder(device="cpu"),
                     _c4fm_iq(1024, 13), 400),
    "dmr": lambda: (jdmr.DMRDecoder(), dmr.DMRDecoder(device="cpu"),
                    _c4fm_iq(1024, 13), 400),
    "lsm": lambda: (jlsm.LSMDecoder(), lsm.LSMDecoder(device="cpu"),
                    _lsm_iq(1024, 7), 400),
    "p25p2": lambda: (jp25p2.P25P2Decoder(jp25p2.P25P2Config(sample_rate=FS)),
                      p25p2.P25P2Decoder(p25p2.P25P2Config(sample_rate=FS),
                                         device="cpu"),
                      _lsm_iq(600, 7, 6000.0), 250),
    "nbfm": lambda: (jnbfm.NBFMDecoder(), nbfm.NBFMDecoder(device="cpu"),
                     _fm(0.5 * np.sin(2 * np.pi * 700.0 * np.arange(800)
                                      / 8000.0), 2500), 1250),
    "am": lambda: (jam.AMDecoder(), am.AMDecoder(device="cpu"),
                   _am_iq(2500, 3), 1000),
    "ltr_live": lambda: (jltr.LTRLiveDecoder(),
                         ltr.LTRLiveDecoder(device="cpu"),
                         _fm(_fsk_audio(4), 6000), 2500),
    "mpt1327_live": lambda: (jltr.MPT1327LiveDecoder(),
                             ltr.MPT1327LiveDecoder(device="cpu"),
                             _fm(_afsk_audio(5), 5000), 2500),
    "ltr": lambda: (jltr.LTRDecoder(), ltr.LTRDecoder(device="cpu"),
                    _fsk_audio(6), 900),
}

# name -> (JAX demodulator, port demodulator, input, split, kind of state)
DEMODS = {
    "dqpsk_c4fm": lambda: (JDQPSK(FS, 4800.0, 0.3),
                           DQPSKDemodulator(FS, 4800.0, 0.3, device="cpu"),
                           _c4fm_iq(1024, 13), 400),
    "dqpsk_dmr": lambda: (JDQPSK(FS, 4800.0, 0.4),
                          DQPSKDemodulator(FS, 4800.0, 0.4, device="cpu"),
                          _c4fm_iq(1024, 13), 400),
    "gardner_lsm": lambda: (JGardner(FS, 4800.0, 0.3),
                            GardnerDQPSKDemodulator(FS, 4800.0, 0.3,
                                                    device="cpu"),
                            _lsm_iq(1024, 7), 400),
    "gardner_p25p2": lambda: (JGardner(50000.0, 6000.0, 0.1),
                              GardnerDQPSKDemodulator(50000.0, 6000.0, 0.1,
                                                      device="cpu"),
                              _psk_iq(lambda d, r, b: lsm_modulate(
                                  d, sample_rate=r, symbol_rate=b),
                                  1024, 7, 50000.0, 6000.0), 400),
    "fsk": lambda: (JFSK(), LTRFSKDemodulator(device="cpu"),
                    _fsk_audio(1), 900),
    "afsk": lambda: (JAFSK(), AFSK1200Demodulator(device="cpu"),
                     _afsk_audio(2), 600),
    "afsk_inverted": lambda: (JAFSK(invert=True),
                              AFSK1200Demodulator(invert=True, device="cpu"),
                              _afsk_audio(3), 600),
}


def _state_tol(name: str) -> float:
    return ANALOG_STATE_TOL if name in ("nbfm", "am", "ltr_live",
                                        "mpt1327_live") else LOOP_TOL


def _check_state(name, jstate, tstate):
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate)]
    got = [a.numpy() for a in tree_leaves(tstate)]
    assert len(got) == len(want)
    tol = _state_tol(name)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (name, i)
        if np.issubdtype(w.dtype, np.integer) or w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=f"{name} leaf {i}")
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=f"{name} leaf {i}")


def _check_outputs(jout, tout):
    assert set(tout) == set(jout)
    valid = np.asarray(jout["valid"]) if "valid" in jout else None
    for key, j in jout.items():
        j, t = np.asarray(j), tout[key].numpy()
        assert t.shape == j.shape, key
        if key in ("dibits", "bits"):
            np.testing.assert_array_equal(t[valid], j[valid], err_msg=key)
        elif key in ("valid", "audio_gate"):
            np.testing.assert_array_equal(t, j, err_msg=key)
        elif key == "power_db":
            np.testing.assert_allclose(t, j, rtol=0, atol=POWER_TOL)
        elif key == "pll_freq":
            np.testing.assert_allclose(t, j, rtol=LOOP_TOL, atol=LOOP_TOL)
        else:
            assert key == "audio"
            np.testing.assert_allclose(t, j, rtol=0, atol=AUDIO_TOL)


@pytest.mark.parametrize("name", sorted(DECODERS))
def test_decoder_per_channel_matches_reference(name):
    jdec, tdec, x, split = DECODERS[name]()
    jstate, tstate = jdec.init_state(), tdec.init_state()
    symbols = 0
    for part in (x[:split], x[split:]):
        jout, jstate = jdec(jnp.asarray(part), jstate)
        tout, tstate = tdec(torch.as_tensor(part), tstate)
        _check_outputs(jout, tout)
        _check_state(name, jstate, tstate)
        if "valid" in tout:
            symbols += int(tout["valid"].sum())
    assert "valid" not in tout or symbols > 20


@pytest.mark.parametrize("name", sorted(DEMODS))
def test_demodulator_per_channel_matches_reference(name):
    jdem, tdem, x, split = DEMODS[name]()
    jstate = tstate = None                 # both start from init_state()
    symbols = 0
    for part in (x[:split], x[split:]):
        jsym, jvalid, jstate = jdem(jnp.asarray(part), jstate)
        tsym, tvalid, tstate = tdem(torch.as_tensor(part), tstate)
        jvalid = np.asarray(jvalid)
        np.testing.assert_array_equal(tvalid.numpy(), jvalid)
        np.testing.assert_array_equal(tsym.numpy()[jvalid],
                                      np.asarray(jsym)[jvalid])
        _check_state(name, jstate, tstate)
        symbols += int(jvalid.sum())
    assert symbols > 20


def test_per_channel_is_the_batched_call_at_one_channel():
    """The per-channel call returns what ``batched_call`` gives a (1, T)
    block with a state of one row, without the channel axis."""
    dec = c4fm.C4FMDecoder(device="cpu")
    x = torch.as_tensor(_c4fm_iq(600, 2))
    out, state = dec(x, dec.init_state())
    bstate = {k: (type(v)(*[a[None] for a in v]) if isinstance(v, tuple)
                  else v[None]) for k, v in dec.init_state().items()}
    bout, bstate = dec.batched_call(x[None], bstate)
    for key in out:
        assert torch.equal(out[key], bout[key][0]), key
    for got, want in zip(tree_leaves(state), tree_leaves(bstate)):
        assert got.shape == want.shape[1:] and torch.equal(got, want[0])
