"""The analog-trunking decoders against the JAX package on the CPU.

* ``LTRDecoder`` on the reference tests' FSK audio: valid exact, bits
  exact where valid, and the LTR and Passport framers give the same
  messages from both.
* ``LTRLiveDecoder`` (ltr, ltrnet, passport) and ``MPT1327LiveDecoder``
  through ``make_channel_decoder`` and ``WidebandReceiver.build_dynamic``:
  a 64-bin capture with three slots (a carrier with the kind's signalling,
  a second one a quarter of a bin off its center, and an empty bin), two
  chunks with the state carried across from the JAX receiver by
  convert.py. On the signal-bearing slots: audio within 1e-4 (as
  test_torch_analog), the gate exact, valid exact and bits exact where
  valid; on every slot the state within 1e-4 (float leaves; the timing
  loop's window exact and its sampling point within 1e-5 on the
  signal-bearing slots). The empty slot's audio is the discriminator's
  output on quantisation noise, where an ulp in the mix can flip atan2
  near +/-pi; it is held by its gate (equal in both).
* ``reset_slot`` writes a fresh nested state into one slot.
* ``AuxDecoder`` on all four protocols (Fleetsync II in two blocks with
  carried state; MDC-1200 through the inverted slicer): the same messages
  as the JAX decoder, field by field.
"""
import enum

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_auxdec as ta
from sdrtrunk_tpu.decoders.auxdec import AuxDecoder as JAuxDecoder
from sdrtrunk_tpu.decoders.ltr import LTRDecoder as JLTRDecoder
from sdrtrunk_tpu.protocol.auxdec import lj1200 as lj
from sdrtrunk_tpu.protocol.auxdec import mdc1200 as mdc
from sdrtrunk_tpu.protocol.ltr import LTRFramer
from sdrtrunk_tpu.protocol.ltr.ltrnet import ltrnet_encode_word
from sdrtrunk_tpu.protocol.ltr.messages import ltr_encode_word
from sdrtrunk_tpu.protocol.mpt1327 import SYNC_CONTROL, mpt_encode_codeword
from sdrtrunk_tpu.protocol.passport import (PassportFramer,
                                            passport_encode_word)
from sdrtrunk_tpu.receiver import WidebandReceiver as JWidebandReceiver
from sdrtrunk_tpu.signal.generators import nbfm_modulate
from sdrtrunk_tpu_torch.convert import (receiver_state_from_numpy,
                                        receiver_state_to_numpy, tree_map)
from sdrtrunk_tpu_torch.decoders.auxdec import AUX_PROTOCOLS, AuxDecoder
from sdrtrunk_tpu_torch.decoders.ltr import (LTRConfig, LTRDecoder,
                                             LTRLiveDecoder,
                                             MPT1327LiveDecoder)
from sdrtrunk_tpu_torch.receiver import WidebandReceiver, make_channel_decoder
from test_ltr import _fsk_modulate
from test_mpt1327 import _afsk_modulate, _alh_data
from test_torch_mixed_banks import _mixed_design_arrays, _plain
from test_torch_receiver import _flat

torch.set_num_threads(1)

M = 64
FS = M * 12500.0
CHUNK = M * 125 * 8                 # K = 2000 channel samples, Ka = 640
BINS = np.array([[2, 2], [60, 60], [20, 20]], np.int32)
RESIDUAL_HZ = np.array([0.0, 3125.0, 0.0])
CARRIERS_HZ = [25000.0, -4 * 12500.0 + 3125.0]
SIGNAL_SLOTS = [0, 1]


@pytest.mark.parametrize("words,framer", [
    ([ltr_encode_word(0, 5, 5, 77, 5)] * 2
     + [ltr_encode_word(0, 7, 7, 255, 7)], lambda: LTRFramer("OSW")),
    ([passport_encode_word(0, 55, 3, 999, 0, 20)] * 2, PassportFramer)],
    ids=["ltr", "passport"])
def test_ltr_decoder_matches_reference(words, framer):
    rng = np.random.default_rng(1)
    tx = np.concatenate([rng.integers(0, 2, 25).astype(np.uint8)] + words
                        + [rng.integers(0, 2, 30).astype(np.uint8)])
    audio = _fsk_modulate(tx)
    jdec = JLTRDecoder()
    jout, _ = jdec(jnp.asarray(audio), jdec.init_state())
    dec = LTRDecoder(LTRConfig(), device="cpu")
    out, state = dec.batched_call(
        torch.as_tensor(audio)[None],
        tree_map(lambda a: a[None].clone(), dec.init_state()))
    valid = np.asarray(jout["valid"])
    np.testing.assert_array_equal(out["valid"][0].numpy(), valid)
    rx = out["bits"][0].numpy()[valid]
    np.testing.assert_array_equal(rx, np.asarray(jout["bits"])[valid])
    msgs = [_plain(m) for m in framer().process(rx)]
    assert msgs == [_plain(m) for m in framer().process(
        np.asarray(jout["bits"])[valid])]
    assert len(msgs) >= 2
    assert state.window.shape == (1, 53)


def _signalling(kind, need, rng):
    """8 kHz audio of a channel of the kind: an 800 Hz voice tone over
    sub-audible FSK words, or AFSK ALH codewords."""
    if kind == "mpt1327":
        frame = np.concatenate([rng.integers(0, 2, 24).astype(np.uint8),
                                SYNC_CONTROL,
                                mpt_encode_codeword(_alh_data())])
        audio = 0.7 * _afsk_modulate(np.tile(frame, 12))
    else:
        word = {"ltr": lambda: ltr_encode_word(0, 5, 5, 77, 5),
                "ltrnet": lambda: ltrnet_encode_word(0, 5, 3, 42, 7),
                "passport": lambda: passport_encode_word(0, 55, 3, 999, 0,
                                                         20)}[kind]()
        data = _fsk_modulate(np.concatenate(
            [rng.integers(0, 2, 25).astype(np.uint8)] + [word] * 6),
            amplitude=0.35)
        audio = data + 0.5 * np.sin(2 * np.pi * 800.0
                                    * np.arange(len(data)) / 8000.0)
    return np.tile(audio, need // len(audio) + 1)[:need]


def _capture(kind):
    n = 2 * CHUNK
    t = np.arange(n) / FS
    rng = np.random.default_rng(21)
    wide = np.zeros(n, np.complex64)
    for f in CARRIERS_HZ:
        audio = _signalling(kind, int(n / FS * 8000.0) + 100, rng)
        iq = nbfm_modulate(audio, 8000.0, FS)[:n]
        wide += (0.3 * iq * np.exp(2j * np.pi * f * t)).astype(np.complex64)
    scale = float(np.max(np.abs(np.stack([wide.real, wide.imag]))))
    return np.clip(np.stack([wide.real, wide.imag], -1) / scale * 120.0,
                   -127, 127).astype(np.int8)


@pytest.mark.parametrize("kind", ["ltr", "ltrnet", "passport", "mpt1327"])
def test_live_decoder_step_matches_reference(kind):
    dec = make_channel_decoder(kind, 25000.0, device="cpu")
    assert isinstance(dec, MPT1327LiveDecoder if kind == "mpt1327"
                      else LTRLiveDecoder)
    assert (dec.up, dec.down) == (8, 25)
    jrx = JWidebandReceiver(FS, [0.0] * 3, decoder=kind)
    trx = WidebandReceiver(FS, [0.0] * 3, decoder=kind, device="cpu")
    trx.load_state_dict(_mixed_design_arrays(jrx))
    rate = jrx.channelizer.channel_sample_rate
    jstep, tstep = jax.jit(jrx.build_dynamic()), trx.build_dynamic()
    jstate = jrx.init_state()
    tstate = receiver_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                       device="cpu")
    slicer = "afsk" if kind == "mpt1327" else "fsk"
    assert type(tstate["dec"][slicer]) is type(trx.init_state()["dec"][slicer])
    steps = (2.0 * np.pi * RESIDUAL_HZ / rate).astype(np.float32)
    x = _capture(kind).astype(np.float32) / 127.0
    symbols = 0
    for j in range(2):
        chunk = x[j * CHUNK:(j + 1) * CHUNK]
        jout, jstate = jstep(jnp.asarray(chunk), jstate, jnp.asarray(BINS),
                             jnp.asarray(steps))
        tout, tstate = tstep(torch.as_tensor(chunk), tstate,
                             torch.as_tensor(BINS, dtype=torch.long),
                             torch.as_tensor(steps))
        assert tout["audio"].shape == (3, 640)
        assert tout["bits"].shape == (3, 576 if kind == "mpt1327" else 640)
        np.testing.assert_array_equal(tout["audio_gate"].numpy(),
                                      np.asarray(jout["audio_gate"]))
        np.testing.assert_allclose(
            tout["audio"].numpy()[SIGNAL_SLOTS],
            np.asarray(jout["audio"])[SIGNAL_SLOTS], atol=1e-4, rtol=0)
        valid = np.asarray(jout["valid"])[SIGNAL_SLOTS]
        np.testing.assert_array_equal(
            tout["valid"].numpy()[SIGNAL_SLOTS], valid)
        np.testing.assert_array_equal(
            tout["bits"].numpy()[SIGNAL_SLOTS][valid],
            np.asarray(jout["bits"])[SIGNAL_SLOTS][valid])
        symbols += int(valid.sum())
    baud = 1200.0 if kind == "mpt1327" else 300.0
    assert abs(symbols - 2 * 2 * 640 / 8000.0 * baud) <= 6
    want = _flat(jax.tree.map(np.asarray, jstate))
    got = _flat(receiver_state_to_numpy(tstate))
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        if name.startswith("dec."):
            g, w = g[SIGNAL_SLOTS], w[SIGNAL_SLOTS]
        if name.endswith(".window"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            tol = 1e-5 if name.endswith(".sampling_point") else 1e-4
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=name)


@pytest.mark.parametrize("kind", ["ltr", "mpt1327"])
def test_reset_slot_restores_nested_init_state(kind):
    trx = WidebandReceiver(FS, [0.0] * 3, decoder=kind, device="cpu")
    step = trx.build_dynamic()
    state = trx.init_state()
    rate = trx.channelizer.channel_sample_rate
    _, state = step(torch.as_tensor(_capture(kind)[:CHUNK]), state,
                    torch.as_tensor(BINS, dtype=torch.long),
                    torch.as_tensor((2.0 * np.pi * RESIDUAL_HZ / rate)
                                    .astype(np.float32)))
    state = trx.reset_slot(state, 1)
    fresh = _flat(receiver_state_to_numpy(trx.init_state()))
    now = _flat(receiver_state_to_numpy(state))
    slicer = "afsk" if kind == "mpt1327" else "fsk"
    assert f"dec.{slicer}.window" in fresh and "dec.nbfm.fir" in fresh
    for name, v in fresh.items():
        if name.startswith("dec.") or name == "mixer_phase":
            np.testing.assert_array_equal(now[name][1], v[1], err_msg=name)
    assert not np.array_equal(now["dec.nbfm.fir"][0], fresh["dec.nbfm.fir"][0])
    assert not np.array_equal(now[f"dec.{slicer}.sampling_point"][0],
                              fresh[f"dec.{slicer}.sampling_point"][0])


def _aux_audio(protocol):
    """(8 kHz audio, a multiple of 10 samples, what the message must
    hold): the reference tests' closed-loop signals, and a Tait-1200 ANI
    message built alike."""
    one_zero = np.array([1, 0], np.uint8)
    if protocol == "lj1200":
        bits = np.concatenate([np.tile(one_zero, 20),
                               lj.encode_word(function=0x5,
                                              address=0x0ABCDEF),
                               np.zeros(24, np.uint8)])
        return bits, lambda m: m["valid"] and m["address"] == 0x0ABCDEF
    if protocol == "fleetsync2":
        msg = ta._fleetsync_message(ta.fs2.encode_block(
            ta._fleetsync_block1(fleet=55, ident1=321)))
        bits = np.concatenate([np.tile(one_zero, 16), msg,
                               np.zeros(30, np.uint8)])
        return bits, lambda m: (m["valid"] and m["fleet_from"] == 55
                                and m["ident_from"] == 321)
    if protocol == "mdc1200":
        decoded = np.concatenate([np.zeros(16, np.uint8),
                                  ta._mdc_decoded_message(0x0042),
                                  np.zeros(8, np.uint8)])
        raw = mdc.nrz_encode(decoded, previous=0, inverted=True)
        bits = 1 - np.concatenate([np.zeros(24, np.uint8), raw])
        return bits, lambda m: m["unit_id"] == 0x0042
    bits = np.concatenate([np.tile(one_zero, 16), ta._tait_ani_message(),
                           np.zeros(30, np.uint8)])
    return bits, lambda m: m.get("from_id") == "TRUCK12"


def _message(m):
    """A message as plain data: its own fields and what its properties
    derive (the two packages' classes are separate copies)."""
    out = {"type": type(m).__name__, **_plain(m)}
    for name in dir(type(m)):
        if isinstance(getattr(type(m), name), property):
            value = getattr(m, name)
            out[name] = value.name if isinstance(value, enum.Enum) else value
    return out


@pytest.mark.parametrize("protocol", AUX_PROTOCOLS)
def test_aux_decoder_gives_the_reference_messages(protocol):
    bits, wanted = _aux_audio(protocol)
    audio = ta._pad10(ta.afsk1200_modulate(bits))
    cut = (len(audio) // 20) * 10
    jdec, dec = JAuxDecoder(protocol), AuxDecoder(protocol, device="cpu")
    assert dec.demod.invert == (protocol == "mdc1200")
    jmsgs = jdec.process(audio[:cut]) + jdec.process(audio[cut:])
    msgs = dec.process(audio[:cut]) + dec.process(audio[cut:])
    got = [_message(m) for m in msgs]
    assert got == [_message(m) for m in jmsgs]
    assert any(wanted(m) for m in got), got
    dec.reset()
    assert [_message(m) for m in dec.process(audio)] == got


def test_aux_decoder_refuses_an_unknown_protocol():
    with pytest.raises(ValueError, match="unknown aux protocol"):
        AuxDecoder("pocsag", device="cpu")
