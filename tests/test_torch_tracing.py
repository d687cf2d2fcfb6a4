"""The port's tracer (``sdrtrunk_tpu_torch.runtime.tracing``) and the
benchmark's readers of it, on the CPU at the cut sizes of
``benchmark/tests/tiny.py`` (M = 64 at 800 kS/s, 40 slots: the bank tier).

* Off, it records nothing and the metrics line keeps its keys.
* On, each chunk of a C4FM bank and of an NBFM bank records its stages and
  the cell's layers under their parents with one chunk number, and the
  metrics line gives ``stages_ms``, ``h2d_copies`` and ``h2d_cached``.
* The step's host-built constants (5 a C4FM bank step: the power
  monitor's recurrence and the sync patterns; 8 an NBFM one: the
  squelch's and the de-emphasis's) are copied through ``tracing.h2d`` on
  the first chunk only, with the slots' plan; a warm step takes them from
  the device (``h2d.cached``), copies no host array (``torch.as_tensor``,
  wrapped, sees none) and counts no ``h2d``. On the CPU the symbol loop's
  plain version also makes two constants with ``torch.tensor``; on the
  card its kernel runs instead.
* A synthetic profiler trace: the program spans' device-side mirrors add
  nothing to the busy intervals, ``step_ms`` is the busy time within a
  layer's mirrors, and ``device_idle``, ``upload_ms`` and
  ``kernel_ms.dqpsk`` read the same with and without them.
* The benchmark's new readers return None against a program without the
  tracer (an older commit), and the traced run still comes out correct.

The upload ring's spans (``upload.ring_wait``, ``.stage``, ``.copy``) and
the copy's device time exist on CUDA only: tests/test_torch_cuda.py.
"""
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import sdrtrunk_tpu_torch as st  # noqa: E402
from benchmark import run as bench_run  # noqa: E402
from benchmark import spans  # noqa: E402
from benchmark import trace as tr  # noqa: E402
from benchmark import window as win  # noqa: E402
from benchmark.tests import tiny  # noqa: E402
from sdrtrunk_tpu_torch.runtime import tracing  # noqa: E402

torch.set_num_threads(1)

# each cell's layers, and the host-built constants its step copies on the
# first chunk and takes from the device after
CELLS = {
    "c4fm_bank_1023": (("step.channelize", "step.select_mix",
                        "step.c4fm_front", "step.dqpsk", "step.compact"), 5),
    "nbfm_bank_1023": (("step.channelize", "step.select_mix",
                        "step.nbfm_chain", "step.pack_audio"), 8),
}
# the metrics line's keys with the tracer off, as before the tracer
_LINE_KEYS = {"t", "samples", "active_channels", "frames", "events",
              "audio_segments", "upload_ms", "upload_mbps"}
_LINE_OPTIONAL = {"pending_frames", "deferred_hard_bch", "expired_pending",
                  "dropped_hard_rs", "unknown_opcodes", "pll_error_hz",
                  "correction_ppm"}


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.enable(False)
    tracing.drain()
    tracing.forget_constants()
    yield
    tracing.enable(False)
    tracing.drain()


def _bank(workload: str):
    """(an Orchestrator on the cut cell's bank, its replay chunks)."""
    from benchmark.adapter import System
    from benchmark.traffic import generator

    s = tiny.spec(workload, slots=40, blocks=400)
    dev = torch.device("cpu")
    replay = generator.build(s.config, s.mix, 2**31 + 3, dev)
    return System(s.config, replay, dev).orch, replay.chunks


def _run(orch, chunks, n: int) -> list:
    """n chunks through ``run()``, pipelined; the metrics lines."""
    it = iter(chunks * (n // len(chunks) + 1))
    lines = []
    orch.source = lambda _n: next(it)
    orch.metrics_sink = lambda line: lines.append(json.loads(line))
    orch.run(max_chunks=n)
    return lines


def test_span_off_is_one_null_context():
    assert tracing.span("dispatch", 3) is tracing.span("step.dqpsk")
    tracing.count("h2d")
    assert tracing.drain() == ([], {})


def test_span_records_parent_chunk_and_sums():
    tracing.enable(True)
    with tracing.span("dispatch", 7):
        with tracing.span("step.compact"):
            with tracing.span("h2d"):
                pass
            with tracing.span("h2d"):
                pass
        tracing.count("h2d", 2)
    sums = tracing.take_chunk(7)
    records, counts = tracing.drain()
    assert [r.name for r in records] == ["h2d", "h2d", "step.compact",
                                         "dispatch"]
    assert all(r.chunk == 7 for r in records)
    assert records[0].parent is records[2] and records[2].parent is records[3]
    assert records[3].parent is None
    assert all(r.end >= r.start for r in records)
    assert counts == {"h2d": 2}
    assert sums["h2d"][1] == 2 and sums["dispatch"][1] == 1
    assert sums["dispatch"][0] >= sums["step.compact"][0]


def test_tracer_off_records_nothing_and_keeps_the_line():
    with st.use_device("cpu"):
        orch, chunks = _bank("nbfm_bank_1023")
        lines = _run(orch, chunks, 2)
    assert tracing.drain() == ([], {})
    assert len(lines) == 2
    for line in lines:
        assert _LINE_KEYS <= set(line) <= _LINE_KEYS | _LINE_OPTIONAL


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_tracer_on_records_each_chunk(workload):
    layers, syncs = CELLS[workload]
    tracing.enable(True)
    with st.use_device("cpu"):
        orch, chunks = _bank(workload)
        lines = _run(orch, chunks, 3)
    records, counts = tracing.drain()
    by = {}
    for r in records:
        by.setdefault((r.name, r.chunk), []).append(r)
    for g in range(3):
        for stage in ("prepare", "upload", "dispatch", "pull", "process"):
            (rec,) = by[(stage, g)]
            assert rec.parent is None, stage
        for layer in layers:
            for rec in by[(layer, g)]:
                assert rec.parent.name == "dispatch"
                assert rec.parent.chunk == g
        assert len(by[("step.channelize", g)]) == 2     # ingest, channelizer
        for part in ("pull.download", "pull.frame"):
            (rec,) = by[(part, g)]
            assert rec.parent.name == "pull"
        # the first chunk copies the constants and the slots' plan (bins,
        # steps); a warm one copies nothing
        h2d = [r for r in by.get(("h2d", g), [])
               if r.parent.name != "dispatch"]
        assert len(h2d) == (syncs if g == 0 else 0)
        assert all(r.parent.name.startswith("step.") for r in h2d)
        assert len(by.get(("h2d", g), [])) == (syncs + 2 if g == 0 else 0)
    assert not any(r.name.startswith("upload.") for r in records)   # CUDA
    assert counts["h2d"] == syncs + 2
    assert counts["h2d.cached"] == 2 * syncs
    assert [line["t"] for line in lines] == \
        [round((g + 1) * len(chunks[0]) / orch.sample_rate, 6)
         for g in range(3)]
    for g, line in enumerate(lines):
        assert set(line["stages_ms"]) == {"prepare", "dispatch",
                                          "pull.download", "pull.frame",
                                          "process"} | ({"h2d"} if g == 0
                                                        else set())
        assert all(v >= 0 for v in line["stages_ms"].values())
        assert line["stages_ms"]["dispatch"] >= \
            line["stages_ms"].get("h2d", 0.0)
        assert line["h2d_copies"] == (syncs + 2 if g == 0 else 0)
        assert line["h2d_cached"] == (0 if g == 0 else syncs)
        assert line["upload_ms"] >= 0


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_every_host_array_of_a_warm_step_goes_through_h2d(workload,
                                                          monkeypatch):
    _, syncs = CELLS[workload]
    with st.use_device("cpu"):
        orch, chunks = _bank(workload)
        orch._dispatch(orch._upload(orch._prepare(chunks[0])))   # warm
        seen = []
        as_tensor = torch.as_tensor

        def counting(data, *args, **kw):
            if not isinstance(data, torch.Tensor):
                seen.append(type(data).__name__)
            return as_tensor(data, *args, **kw)
        dev = [orch._upload(orch._prepare(c)) for c in chunks[1:3]]
        monkeypatch.setattr(torch, "as_tensor", counting)
        tracing.enable(True)
        for d in dev:
            orch._dispatch(d)
        tracing.enable(False)
        monkeypatch.undo()
    _, counts = tracing.drain()
    # every constant comes from the device: no host array is copied
    assert counts == {"h2d.cached": 2 * syncs}
    assert seen == []


class _Event:
    def __init__(self, name, start_ms, end_ms, cuda):
        self._n, self._s, self._e, self._c = name, start_ms, end_ms, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._s * 1e6)

    def end_ns(self):
        return int(self._e * 1e6)

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._c else DeviceType.CPU


def _profile(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


# two chunks of a loop: the loop's labels and the program's spans on the
# host, kernels, the ring's copy landing inside the second step, and the
# program spans' device-side mirrors, which reach over idle stretches
_LOOP = [
    _Event("bench.dispatch", 0.0, 2.0, False),
    _Event("bench.wait_upload", 2.0, 9.0, False),
    _Event("bench.dispatch", 9.0, 11.0, False),
    _Event("bench.download", 11.0, 20.0, False),
    _Event("void dqpsk_kernel<8, 1>", 1.0, 3.0, True),
    _Event("elementwise_kernel", 4.0, 5.0, True),
    _Event("elementwise_kernel", 10.0, 12.0, True),
    _Event("Memcpy HtoD (Pinned -> Device)", 12.0, 12.5, True),
    _Event("Memcpy HtoD (Pageable -> Device)", 12.5, 12.6, True),
    _Event("void dqpsk_kernel<8, 1>", 13.0, 15.0, True),
    _Event("Memcpy DtoH (Device -> Pageable)", 15.0, 15.5, True),
]
_PROGRAM = [
    _Event("sdr.dispatch", 0.1, 1.9, False),
    _Event("sdr.step.channelize", 0.2, 0.9, False),
    _Event("sdr.dispatch", 9.1, 10.9, False),
    _Event("sdr.step.channelize", 0.5, 5.0, True),      # mirrors
    _Event("sdr.step.channelize", 9.5, 13.0, True),
    _Event("sdr.step.dqpsk", 13.0, 16.0, True),
]


def test_program_spans_are_not_device_work():
    plain = tr.reduce(_profile(_LOOP))
    traced, mirrors, host = spans.reduce(_profile(_LOOP + _PROGRAM), "sdr.")
    assert traced.device == plain.device and traced.spans == plain.spans
    assert traced.busy() == plain.busy() and traced.window == plain.window
    # the benchmark's own reduction would count the mirrors as work
    assert tr.reduce(_profile(_LOOP + _PROGRAM)).busy_s() > plain.busy_s()
    assert len(mirrors) == 3 and len(host) == 3
    assert {n for _, _, n in mirrors} == {"step.channelize", "step.dqpsk"}

    window = win.Window(chunks=2, start=0.0, end=0.02)
    run_of = {}
    for name, t in (("plain", plain), ("traced", traced)):
        run_of[name] = bench_run.Run({}, None, window, window, t, {})
    for metric in ("device_idle", "upload_ms", "kernel_ms.dqpsk"):
        read = bench_run.reader(metric)
        assert read(run_of["plain"]) == read(run_of["traced"]), metric

    r = run_of["traced"]
    spans._SESSIONS[r] = spans.Session(
        counted=window, records=[], counts={}, profiled=window,
        trace=traced, mirrors=mirrors, host=host, profiled_records=[])
    # channelize: busy within [0.5, 5] and [9.5, 13], the ring's copy left
    # out and the step's pageable copy kept: 2 + 1 + 2 + 0.1 ms
    assert spans.step_ms(r, "channelize") == pytest.approx(5.1 / 2)
    # dqpsk: [13, 15] within [13, 16], the download left out
    assert spans.step_ms(r, "dqpsk") == pytest.approx(2.0 / 2)
    assert spans.step_ms(r, "compact") is None


def test_readers_without_the_programs_tracer(monkeypatch):
    monkeypatch.setitem(sys.modules, spans.TRACER, None)
    assert spans.tracer() is None
    s = tiny.spec("nbfm_bank_1023", slots=40, blocks=400)
    res = tiny.measure(s, seed=2**31 + 29, seconds=0.5, trace=1)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"dispatch_ms"}


def test_readers_of_the_programs_tracer():
    s = tiny.spec("nbfm_bank_1023", slots=40, blocks=400)
    res = tiny.measure(s, seed=2**31 + 31, seconds=0.5, trace=1)
    assert res["correct"], res["checks"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    # the CPU has no ring and no device trace: the host's readings only
    assert set(got) == {"dispatch_ms", "dispatch_sync_ms", "dispatch_syncs",
                        "launch_ms"}
    # a warm step copies no host array
    assert got["dispatch_syncs"] == 0.0
    assert got["dispatch_sync_ms"] == 0.0 < got["launch_ms"]
    assert not tracing.enabled()
    assert np.isfinite(list(got.values())).all()
