"""The program's own spans and counters in a traced run: what the metrics
that read the program's tracer (``sdrtrunk_tpu_torch.runtime.tracing``)
read.

run.py's windows never turn the program's tracer on, so its trace and its
host-clock readings hold none of the program's spans and read as they
would without them. The first of these readers in a traced run builds a
second System from the run's configuration and replay set, warms it (3
chunks), and drives the same loop twice more with the tracer on:
``counted``, untraced and as long as the run's untraced window, whose
spans and counters give the host-clock metrics; then ``profiled``, under
the profiler for PROFILED_SECONDS, whose ``sdr.`` spans' device-side
mirrors (the profiler draws each over the work launched under it) give
each layer's device time inside the running step. The System is closed
before the run's check. Where the program has no tracer (an older commit),
nothing is built and every reader returns None.

The program's names read here: the tracer's ``enable``, ``drain`` and
``PREFIX``, its records' ``name``, ``parent``, ``start``, ``end`` and
``seconds``; the spans ``dispatch``, ``h2d``, ``upload.stage``,
``upload.ring_wait`` and ``step.<layer>``; the counter ``h2d``.
"""
from __future__ import annotations

import importlib
import types
import weakref
from dataclasses import dataclass

from benchmark import trace as tr

TRACER = "sdrtrunk_tpu_torch.runtime.tracing"
WARM_CHUNKS = 3
# the profiled window: its reduction takes some six seconds a second of
# window, and the run has to end within six minutes
PROFILED_SECONDS = 3.0

_SESSIONS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        return importlib.import_module(TRACER)
    except ModuleNotFoundError:
        return None


@dataclass
class Session:
    """The two windows driven with the program's tracer on."""
    counted: object          # benchmark.window.Window, untraced
    records: list            # its spans, the tracer's records
    counts: dict             # its counters
    profiled: object         # Window under the profiler
    trace: tr.Trace          # the profiled window without the program's events
    mirrors: list            # (start, end, name): the spans' device mirrors
    host: list               # (start, end, name): the spans the profiler saw
    profiled_records: list   # the tracer's records of the profiled window


def session(run) -> Session | None:
    """The run's Session, driven at the first call (None: no tracer, or a
    run without an untraced window or kept chunks)."""
    if run not in _SESSIONS:
        _SESSIONS[run] = _observe(run)
    return _SESSIONS[run]


def _observe(run) -> Session | None:
    tracing = tracer()
    if tracing is None or run.plain is None or not run.window.kept:
        return None
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import window as win
    from benchmark.adapter import System
    from benchmark.run import _sync

    device = next(iter(run.window.kept[0].before.values())).device
    chunks = run.replay.chunks
    seconds = run.plain.end - run.plain.start
    g = run.window.first + run.window.chunks
    system = System(run.config, run.replay, device)
    try:
        win.drive(system, chunks, g, count=WARM_CHUNKS)
        _sync(device)
        g += WARM_CHUNKS
        tracing.drain()
        tracing.enable(True)
        try:
            counted = win.drive(system, chunks, g, seconds=seconds)
            _sync(device)
            records, counts = tracing.drain()
            g += counted.chunks
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            with profile(activities=acts) as prof:
                profiled = win.drive(
                    system, chunks, g, seconds=min(seconds, PROFILED_SECONDS),
                    span=lambda n: record_function(tr.SPAN_PREFIX + n))
                _sync(device)
            profiled_records, _ = tracing.drain()
        finally:
            tracing.enable(False)
    finally:
        system.close()
    trace, mirrors, host = reduce(prof, tracing.PREFIX)
    return Session(counted, records, counts, profiled, trace, mirrors, host,
                   profiled_records)


def reduce(prof, prefix: str) -> tuple:
    """(the Trace ``trace.reduce`` makes of the profile with the program's
    events left out, the program spans' device-side mirrors, the program
    spans on the host), each span as (start, end, name without the
    prefix). The mirrors are the layers' intervals, never device work."""
    from torch.autograd import DeviceType

    rest, mirrors, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if not name.startswith(prefix):
            rest.append(e)
            continue
        item = (e.start_ns() * 1e-9, e.end_ns() * 1e-9, name[len(prefix):])
        (mirrors if e.device_type() == DeviceType.CUDA else host).append(item)
    view = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: rest)))
    return tr.reduce(view), mirrors, host


def link(name: str) -> bool:
    """The upload ring's copy from pinned memory, and the downloads: the
    link's work, which the other threads queue between a step's launches
    on the one stream."""
    name = name.lower()
    return "memcpy" in name and ("pinned" in name or "dtoh" in name)


def _union(intervals) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a: list, b: list) -> float:
    """Seconds in both of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def step_ms(run, layer: str) -> float | None:
    """Device ms a chunk of the step's layer inside the running loop: the
    device's busy intervals (the link's copies left out) within the
    mirrors of the layer's ``step.<layer>`` spans, over the profiled
    window's chunks."""
    s = session(run)
    if s is None or not s.profiled.chunks:
        return None
    work = tr.Trace(window=s.trace.window,
                    device=[d for d in s.trace.device if not link(d[2])])
    mirrors = _union((a, b) for a, b, name in s.mirrors
                     if name == f"step.{layer}")
    seconds = _overlap(work.busy(), mirrors)
    return 1e3 * seconds / s.profiled.chunks if seconds > 0 else None


def _within(record, name: str) -> bool:
    while record.parent is not None:
        record = record.parent
        if record.name == name:
            return True
    return False


def host_ms(run, name: str, less: str | None = None,
            absent: float | None = None) -> float | None:
    """Host ms a chunk of the counted window's ``name`` spans, less the
    time of their ``less`` spans inside them; ``absent`` where it has
    none."""
    s = session(run)
    if s is None or not s.counted.chunks:
        return None
    spans = [r for r in s.records if r.name == name]
    if not spans:
        return absent
    total = sum(r.seconds for r in spans)
    if less is not None:
        total -= sum(r.seconds for r in s.records
                     if r.name == less and _within(r, name))
    return 1e3 * total / s.counted.chunks


def per_chunk(run, counter: str) -> float | None:
    """The counted window's counter a chunk (0 where it never counted)."""
    s = session(run)
    if s is None or not s.counted.chunks:
        return None
    return s.counts.get(counter, 0) / s.counted.chunks
