"""The port's Orchestrator surface that the reference's callers use
(sdrtrunk_tpu/monitor.py, cli.py), against the JAX Orchestrator on the
C4FM bank scene of tests/test_torch_orchestrator.py (a P25 control
channel granting a traffic channel that carries one voice call; 4 slots,
bank mode, one CPU thread):

* ``run(pipelined=False)``: each chunk through ``run_chunk`` in turn; the
  same events, frame counts, AudioSegments and metrics trace as the
  reference's un-pipelined run, final line included;
* ``close()``, twice, after a run;
* ``control_offsets_hz`` entries given as ``(offset_hz, kind)`` pairs;
* the ``channel_bandwidth``, ``banks`` and ``ingest_format`` attributes;
* the names ``sdrtrunk_tpu.decoders`` exports.
"""
import json

import numpy as np
import pytest
import torch

import sdrtrunk_tpu.decoders as jdecoders
import sdrtrunk_tpu_torch.decoders as decoders
import test_orchestrator as to
from sdrtrunk_tpu.runtime.orchestrator import Orchestrator as JOrchestrator
from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator
from test_torch_orchestrator import _capture, _events, pair

torch.set_num_threads(1)

# the metrics keys that are not host timings (upload_ms, upload_mbps); the
# last two are the frequency-error monitor's
_KEYS = ("t", "samples", "active_channels", "frames", "events",
         "audio_segments", "pll_error_hz", "correction_ppm")


@pytest.fixture(scope="module")
def iq8():
    return _capture()


@pytest.fixture(scope="module")
def unpipelined(iq8):
    jorch, j_lines, orch, t_lines = pair(iq8)
    j_final = jorch.run(pipelined=False)
    t_final = orch.run(pipelined=False)
    return jorch, j_lines, j_final, orch, t_lines, t_final


def _segments(orch):
    return [(round(s.duration, 6), sorted(
        (i.role.name, i.value) for i in s.identifiers.all()))
        for s in orch.audio_segments]


def test_unpipelined_run_matches_reference(unpipelined):
    jorch, j_lines, j_final, orch, t_lines, t_final = unpipelined
    assert _events(orch) == _events(jorch)
    assert [e for e in orch.events
            if e.frequency_hz == pytest.approx(to.CENTER_HZ + to.TRAFFIC_OFF)]
    assert [s["frames"] for s in orch.channel_status()] == \
        [s["frames"] for s in jorch.channel_status()]
    assert sum(s["frames"] for s in orch.channel_status()) == \
        sum(json.loads(line)["frames"] for line in t_lines)
    assert _segments(orch) == _segments(jorch)
    assert [s.duration for s in orch.audio_segments if s.duration > 0] == \
        pytest.approx([18 * 0.020])
    # every line alike but the PLL's error, which may round to the next
    # 0.1 Hz: the port's loop state drifts from the reference's by float
    # rounding (tests/test_torch_c4fm.py), and it did on one of 127 lines
    trace = [json.loads(line) for line in t_lines]
    want = [json.loads(line) for line in j_lines]
    assert len(trace) == orch.samples_processed // orch.chunk_samples
    assert [{k: m.get(k) for k in _KEYS[:-2]} for m in trace] == \
        [{k: m.get(k) for k in _KEYS[:-2]} for m in want]
    assert [m["correction_ppm"] for m in trace] == \
        [m["correction_ppm"] for m in want]
    assert np.abs(np.subtract([m["pll_error_hz"] for m in trace],
                              [m["pll_error_hz"] for m in want])).max() \
        <= 0.1 + 1e-9
    assert {k: t_final.get(k) for k in _KEYS} == \
        {k: j_final.get(k) for k in _KEYS}
    assert json.loads(t_lines[-1]) == t_final


def test_unpipelined_run_stops_at_max_chunks_and_on_error():
    reads = []

    def source(num):
        reads.append(num)
        return np.zeros((num, 2), np.int8)

    orch = Orchestrator(source, to.FS, to.CENTER_HZ, [to.CONTROL_OFF],
                        slots=4, chunk_samples=64 * 64, bank_mode=True,
                        ppm_correction=False, device="cpu")
    metrics = orch.run(max_chunks=3, pipelined=False)
    assert len(reads) == 3 and metrics["samples"] == 3 * 64 * 64
    orch.error_state = "source lost"
    assert orch.run(max_chunks=3, pipelined=False) == {}
    assert len(reads) == 3


def test_close_after_run_twice(iq8):
    for orch in (JOrchestrator(lambda n: iq8[:n], to.FS, to.CENTER_HZ,
                               [to.CONTROL_OFF], slots=4,
                               chunk_samples=64 * 256, bank_mode=True),
                 Orchestrator(lambda n: iq8[:n], to.FS, to.CENTER_HZ,
                              [to.CONTROL_OFF], slots=4,
                              chunk_samples=64 * 256, bank_mode=True,
                              device="cpu")):
        metrics = orch.run(max_chunks=2)
        assert metrics["samples"] == 2 * 64 * 256
        orch.close()
        orch.close()
        assert orch.channel_status()[0]["control"]


def test_control_offset_with_kind(iq8):
    """A (offset_hz, kind) pair pins the control slot as the bare offset
    does; the first 12 chunks hold the control channel's call event."""
    jorch, _, orch, _ = pair(iq8, [(to.CONTROL_OFF, "p25p1")])
    _, _, bare, _ = pair(iq8)
    for o in (jorch, orch, bare):
        o.run(max_chunks=12, pipelined=False)
    assert [s.frequency_hz for s in orch.slots if s.is_control] == \
        [s.frequency_hz for s in jorch.slots if s.is_control] == \
        [to.CENTER_HZ + to.CONTROL_OFF]
    assert _events(orch) == _events(jorch) == _events(bare)
    assert [e[0] for e in _events(orch)] == ["CALL_GROUP"]


@pytest.mark.parametrize("kwargs", [
    {}, {"channel_bandwidth": 25000.0}, {"decoder": "nbfm"},
    {"decoder": "ltr", "channel_bandwidth": 25000}],
    ids=["c4fm", "c4fm-25k", "nbfm", "ltr-25k"])
def test_surface_attributes_match_reference(kwargs):
    args = dict(slots=4, bank_mode=True, ppm_correction=False)
    args.update(kwargs)
    jorch = JOrchestrator(lambda n: None, to.FS, to.CENTER_HZ,
                          [to.CONTROL_OFF], **args)
    orch = Orchestrator(lambda n: None, to.FS, to.CENTER_HZ,
                        [to.CONTROL_OFF], device="cpu", **args)
    for name in ("channel_bandwidth", "banks", "ingest_format"):
        got, want = getattr(orch, name), getattr(jorch, name)
        assert got == want and type(got) is type(want), name
    assert isinstance(orch.channel_bandwidth, float)


def test_decoders_export_the_reference_names():
    names = sorted(n for n, v in vars(jdecoders).items()
                   if isinstance(v, type))
    assert names == ["AMConfig", "AMDecoder", "NBFMConfig", "NBFMDecoder"]
    for name in names:
        assert getattr(decoders, name).__name__ == name
        assert getattr(decoders, name).__module__.startswith(
            "sdrtrunk_tpu_torch.decoders.")
