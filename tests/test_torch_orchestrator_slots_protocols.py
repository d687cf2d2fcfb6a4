"""The per-slot Orchestrator path for DMR and P25 Phase 2 on the CPU
(slots=4, the default ``bank_mode``): the port against the JAX one, the
scenes of tests/test_orchestrator_protocols.py as the bank tests cut them
to size (that file is marked slow).

* DMR (tests/test_torch_dmr.py's capture, 1.3 s): a TSCC sends Tier III
  group-voice grants for channel 4 of a band plan set with
  traffic.update_band; the grant must be followed and the voice call on
  the granted slot must become an AudioSegment.
* P25 Phase 2 (tests/test_torch_gardner_banks.py's capture, 1.4 s): the
  control channel's unscrambled network status MAC teaches the scramble
  key; a MAC grant activates a traffic slot whose processor must be built
  with the key its control slot learned before the grant, and the
  scrambled VOICE_4 timeslots must become an AudioSegment.

Both orchestrators start from one state, carried across with convert.py,
and must give the same events, per-slot frame counts, AudioSegments and
metrics trace.
"""
import numpy as np
import pytest
import torch

import test_orchestrator as to
import test_orchestrator_protocols as tp
import test_torch_dmr as td
import test_torch_gardner_banks as tg
from sdrtrunk_tpu.runtime.identifiers import IdentifierRole
from test_torch_orchestrator_slots import (events, flush_open, frames,
                                           run_pair, segments, trace)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dmr():
    out = run_pair(td._capture(), to.FS, to.CENTER_HZ, [to.CONTROL_OFF],
                   prepare=td._load_band, slots=4, decoder="dmr",
                   chunk_samples=td.CHUNK,
                   idle_teardown_seconds=td.IDLE_TEARDOWN_S)
    for o in (out[0], out[2]):
        flush_open(o)
    return out


def test_dmr_grant_followed_with_same_events(dmr):
    jorch, _, orch, _ = dmr
    freq = to.BASE_HZ + to.CHAN_NUM * 12500.0
    assert not orch.bank_mode and orch.traffic.protocol == "DMR"
    assert not orch.skipped_grants
    assert [e for e in orch.events if e.frequency_hz == pytest.approx(freq)]
    assert events(orch) == events(jorch)
    got = frames(orch)
    assert got == frames(jorch)
    traffic = [s for s in orch.channel_status()
               if not s["control"] and s["frequency_hz"] == freq]
    assert traffic and traffic[0]["frames"] >= 6


def test_dmr_voice_becomes_audio_segment(dmr):
    jorch, j_lines, orch, t_lines = dmr
    assert segments(orch) == segments(jorch)
    segs = [s for s in orch.audio_segments if s.duration > 0]
    assert segs
    assert any(i.value == td.DMR_GROUP and i.role.name == "TO"
               for i in segs[0].identifiers.all())
    assert trace(t_lines) == trace(j_lines)
    assert max(m["active_channels"] for m in trace(t_lines)) == 2


@pytest.fixture(scope="module")
def p25p2():
    return run_pair(tg._capture(), tp.FS, tp.CENTER_HZ, [tp.CONTROL_OFF],
                    slots=4, decoder="p25p2", chunk_samples=tg.CHUNK,
                    idle_teardown_seconds=tg.IDLE_TEARDOWN_S)


def test_p25p2_scramble_key_learned_and_handed_over(p25p2):
    jorch, _, orch, _ = p25p2
    control = next(s for s in orch.slots if s.is_control)
    assert control.processor.state.scramble_key == tg.KEY
    freq = tp.CENTER_HZ + tp.TRAFFIC_OFF
    slot = next(s for s in orch.slots
                if not s.is_control and s.frequency_hz == freq)
    # the traffic slot's processor was built with the key the control
    # slot had learned before the grant arrived
    assert slot.processor.state.scramble_key == tg.KEY
    assert slot.processor.frame_count >= 1
    assert orch.traffic.protocol == jorch.traffic.protocol == "APCO25-P2"


def test_p25p2_grant_and_voice_match_reference(p25p2):
    jorch, j_lines, orch, t_lines = p25p2
    freq = tp.CENTER_HZ + tp.TRAFFIC_OFF
    assert [e for e in orch.events if e.frequency_hz == pytest.approx(freq)]
    assert events(orch) == events(jorch)
    assert frames(orch) == frames(jorch)
    assert segments(orch) == segments(jorch)
    segs = [s for s in orch.audio_segments if s.duration > 0]
    assert len(segs) == 1 and segs[0].duration >= 4 * 0.020
    assert tp.GROUP in [i.value for i in segs[0].identifiers.all()
                        if i.role.name == IdentifierRole.TO.name]
    assert trace(t_lines) == trace(j_lines)
    active = [m["active_channels"] for m in trace(t_lines)]
    assert max(active) == 2 and active[-1] == 1


def test_p25p2_control_slot_tuned_as_a_two_bin_channel(p25p2):
    jorch, _, orch, _ = p25p2
    assert np.array_equal(orch.bins, jorch.bins)
    assert orch.bins[0][1] == (orch.bins[0][0] + 1) % 64
