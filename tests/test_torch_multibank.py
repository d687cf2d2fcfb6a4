"""Heterogeneous banks (``banks=``) on the CPU: the port's Orchestrator
over its MultibankReceiver against the JAX one.

Scenes, from tests/test_multibank.py:

* the P25 + DMR + LTR mix, banks [("c4fm", 3), ("dmr", 1), ("ltr", 1)]
  behind one 64-bin channelizer (800 kHz, chunks of 125 * M): a P25
  control channel grants a C4FM traffic channel carrying HDU + 2 LDU1 +
  TDULC, a DMR slot and an LTR slot are activated directly. The grant
  must be followed, the DMR voice superframe become an AudioSegment, the
  LTR slot decode CALL words of group 77 and make audio, all three at
  once. Cut to size for the CPU: 1.4 s of capture (2.6 s there); the
  call on the traffic channel is over by 1.2 s.
* test_mpt1327_live_trunking: banks [("mpt1327", 3)] with a channel map;
  the control slot's AFSK GTC codewords grant channel 77, which must be
  activated mid-run and give the FM voice as audio; cut from 2.2 s to
  1.5 s.

Both orchestrators start from one state: the JAX design arrays of every
bank (multibank_params_from_numpy) and its multibank receiver state
(per-bank keys beside chan, mixer_phase and rot), carried across with
convert.py. They must give the same events, per-slot messages and frame
counts, AudioSegments (start, duration, identifiers; PCM within 1e-4) and
metrics trace.
"""
import types

import numpy as np
import pytest
import torch

import test_multibank as tm
import test_orchestrator as to
from sdrtrunk_tpu.runtime.identifiers import IdentifierCollection as JIds
from sdrtrunk_tpu.runtime.traffic import FrequencyBand as JFrequencyBand
from sdrtrunk_tpu.signal import generators
from sdrtrunk_tpu_torch.convert import multibank_params_from_numpy
from sdrtrunk_tpu_torch.receiver import MultibankReceiver
from sdrtrunk_tpu_torch.runtime.identifiers import IdentifierCollection
from sdrtrunk_tpu_torch.runtime.traffic import FrequencyBand
from test_torch_gardner_banks import _design_arrays
from test_torch_mixed_banks import _mixed_design_arrays, _mpt_capture
from test_torch_mixed_banks import (MPT_BASE_HZ, MPT_CHANNEL,
                                    MPT_CONTROL_OFF, MPT_FS, MPT_GRANTED_OFF)
from test_torch_mixed_banks import _plain
from test_torch_orchestrator_slots import (events, flush_open, frames,
                                           run_pair, segments, trace)

torch.set_num_threads(1)

MIX_SECONDS = 1.4
MIX_BANKS = [("c4fm", 3), ("dmr", 1), ("ltr", 1)]


def multibank_arrays(jrx) -> dict:
    """Every bank's design arrays of a JAX MultibankReceiver as the port's
    state dict."""
    banks = {}
    for key, kind, _, dec in jrx.banks:
        one = types.SimpleNamespace(channelizer=jrx.channelizer, decoder=dec)
        mixed = kind in ("ltr", "ltrnet", "passport", "mpt1327")
        banks[key] = (_mixed_design_arrays if mixed else _design_arrays)(one)
    return multibank_params_from_numpy(jrx.channelizer.hmat, banks)


def _mix_capture() -> np.ndarray:
    """tests/test_multibank.py's capture, cut to MIX_SECONDS."""
    total = int(2.6 * to.BAUD)
    rng = np.random.default_rng(7)
    voice = [rng.integers(0, 2, (9, 144)).astype(np.uint8) for _ in range(2)]
    chunk = 64 * 125
    n = int(MIX_SECONDS * to.FS) // chunk * chunk
    t = np.arange(n) / to.FS
    legs = [(to.CONTROL_OFF, to._control_stream(total)),
            (to.TRAFFIC_OFF, to._traffic_stream(total, voice)),
            (tm.DMR_OFF, tm._dmr_voice_stream(total))]
    wide = np.zeros(n, np.complex64)
    for off, dibits in legs:
        iq = generators.c4fm_modulate(dibits, to.FS)[:n]
        wide += (iq * np.exp(2j * np.pi * off * t)).astype(np.complex64)
    wide += (tm._ltr_iq(n, to.FS) * np.exp(2j * np.pi * tm.LTR_OFF * t)
             ).astype(np.complex64)
    return wide


def _activate_dmr_and_ltr(orch):
    ids = JIds if type(orch).__module__.startswith("sdrtrunk_tpu.") \
        else IdentifierCollection
    orch._activate(to.CENTER_HZ + tm.DMR_OFF, ids(), kind="dmr")
    orch._activate(to.CENTER_HZ + tm.LTR_OFF, ids(), kind="ltr")


@pytest.fixture(scope="module")
def mix():
    out = run_pair(_mix_capture(), to.FS, to.CENTER_HZ, [to.CONTROL_OFF],
                   params=multibank_arrays, prepare=_activate_dmr_and_ltr,
                   banks=MIX_BANKS, idle_teardown_seconds=0.6)
    for o in (out[0], out[2]):
        flush_open(o)
    return out


def _slot(orch, kind, freq=None):
    return next(s for s in orch.slots if s.kind == kind
                and (freq is None or s.frequency_hz == freq))


def _messages(orch):
    return [[_plain(m) for m in getattr(s.processor, "messages", [])]
            for s in orch.slots]


def test_mix_slots_and_banks(mix):
    jorch, _, orch, _ = mix
    assert isinstance(orch.rx, MultibankReceiver)
    assert [(s.kind, s.bank_key, s.local) for s in orch.slots] == \
        [(s.kind, s.bank_key, s.local) for s in jorch.slots] == [
            ("c4fm", "b0_c4fm", 0), ("c4fm", "b0_c4fm", 1),
            ("c4fm", "b0_c4fm", 2), ("dmr", "b1_dmr", 0),
            ("ltr", "b2_ltr", 0)]
    assert not orch.bank_mode and orch.chunk_samples == 64 * 125
    assert orch.banks == jorch.banks == MIX_BANKS


def test_mix_p25_grant_followed(mix):
    jorch, _, orch, _ = mix
    freq = to.CENTER_HZ + to.TRAFFIC_OFF
    assert not orch.skipped_grants
    assert [e for e in orch.events if e.frequency_hz == pytest.approx(freq)]
    assert events(orch) == events(jorch)
    slot = _slot(orch, "c4fm", freq)
    assert slot.processor.frame_count >= 4
    duids = [m.duid.name for m in slot.processor.messages if m.valid]
    assert duids.count("LDU1") == 2


def test_mix_dmr_voice_decoded(mix):
    _, _, orch, _ = mix
    slot = _slot(orch, "dmr")
    assert slot.active and slot.processor.frame_count >= 6
    assert [s for s in orch.audio_segments if s.duration > 0 and any(
        i.value == tm.DMR_GROUP and i.role.name == "TO"
        for i in s.identifiers.all())]


def test_mix_ltr_call_and_audio(mix):
    _, _, orch, _ = mix
    slot = _slot(orch, "ltr")
    calls = [m for m in slot.processor.messages
             if m.message_type.name == "CALL"]
    assert calls and calls[0].group == 77
    evs = [e for e in slot.processor.events
           if e.event_type.name == "CALL_GROUP"]
    assert evs and evs[0].protocol == "LTR"
    assert [s for s in orch.audio_segments if s.duration > 0.5]


def test_mix_three_protocols_concurrent_and_match_reference(mix):
    jorch, j_lines, orch, t_lines = mix
    assert {s.kind for s in orch.slots if s.processor is not None
            and s.processor.frame_count > 0} == {"c4fm", "dmr", "ltr"}
    assert frames(orch) == frames(jorch)
    assert _messages(orch) == _messages(jorch)
    assert segments(orch) == segments(jorch)
    for got, want in zip(orch.audio_segments, jorch.audio_segments):
        np.testing.assert_allclose(got.samples, want.samples, atol=1e-4)
    assert trace(t_lines) == trace(j_lines)


# --------------------------------------------------------------- MPT1327

@pytest.fixture(scope="module")
def mpt():
    band = dict(identifier=0, base_frequency_hz=MPT_BASE_HZ,
                channel_spacing_hz=12500.0)
    out = run_pair(_mpt_capture(), MPT_FS, to.CENTER_HZ, [MPT_CONTROL_OFF],
                   params=multibank_arrays, banks=[("mpt1327", 3)],
                   idle_teardown_seconds=5.0, ppm_correction=False,
                   jax_kw={"channel_map": JFrequencyBand(**band)},
                   port_kw={"channel_map": FrequencyBand(**band)})
    for o in (out[0], out[2]):
        flush_open(o)
    return out


def test_mpt1327_live_trunking(mpt):
    jorch, j_lines, orch, t_lines = mpt
    gtcs = [m for m in orch.slots[0].processor.messages
            if m.message_type.name == "GTC"]
    assert gtcs and gtcs[0].fields["channel"] == MPT_CHANNEL
    freq = to.CENTER_HZ + MPT_GRANTED_OFF
    assert [e for e in orch.traffic.events
            if e.frequency_hz == pytest.approx(freq)]
    granted = [s for s in orch.slots
               if not s.is_control and s.frequency_hz == freq]
    assert granted and granted[0].active
    segs = [s for s in orch.audio_segments if s.duration > 0.3]
    peaks = []
    for seg in segs:
        spec = np.abs(np.fft.rfft(seg.samples[400:]))
        peaks.append(float(np.fft.rfftfreq(len(seg.samples) - 400,
                                           1 / 8000.0)[int(np.argmax(spec))]))
    assert any(700.0 < p < 900.0 for p in peaks), peaks
    assert events(orch) == events(jorch)
    assert _messages(orch) == _messages(jorch)
    assert segments(orch) == segments(jorch)
    assert trace(t_lines) == trace(j_lines)
