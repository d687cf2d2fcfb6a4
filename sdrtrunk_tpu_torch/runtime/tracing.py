"""Spans and counters at the layer boundaries of the live device step, kept
in memory; off by default.

``enable(True)`` turns the tracer on for the whole process: every
Orchestrator and every thread. ``span(name, chunk=None)`` is a context
around a stage or a layer, ``count(name, n)`` adds to a counter, and
``drain()`` returns the records and the counters and clears them. Off,
``span`` returns one shared null context after one flag read and
``count`` returns at once: nothing is allocated.

On, each span keeps a record (``Span``): its name, its parent (the span
open on the same thread when it began), its chunk, its thread, and its
start and end on ``time.perf_counter``. A span given no chunk takes its
parent's. While a ``torch.profiler`` session records the span's thread,
the span also opens ``record_function("sdr." + name)``, so that it lands
on the profiler's clock, whose device side mirrors it over the work
launched under it.

Chunks: the Orchestrator numbers the calls of each of its stages
(``prepare``, ``upload``, ``dispatch``, ``pull``, ``process``) itself.
Each stage takes every chunk once, in chunk order, so equal numbers are
one chunk's. The tracer is process-wide: trace one Orchestrator at a
time. Names below a stage or a layer take a dot (``upload.stage``).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import nullcontext

import torch

__all__ = ["PREFIX", "Span", "count", "drain", "enable", "enabled", "h2d",
           "span", "take_chunk"]

PREFIX = "sdr."
# records kept between drains (the oldest go first) and chunks whose sums
# wait for the metrics line
_MAX_RECORDS = 1 << 17
_MAX_CHUNKS = 64

_NULL = nullcontext()
_on = False
_lock = threading.Lock()
_local = threading.local()
_records: deque = deque(maxlen=_MAX_RECORDS)
_counts: dict = {}
_chunks: dict = {}           # chunk -> {name: [seconds, calls]}


def enable(on: bool = True) -> None:
    """Turn the tracer on or off (process-wide)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


class Span:
    """A span's record: ``name``, ``parent`` (a Span or None), ``chunk``,
    ``thread`` (``threading.get_ident()``), ``start`` and ``end``
    (``time.perf_counter()`` seconds)."""

    __slots__ = ("name", "parent", "chunk", "thread", "start", "end", "_rf")

    def __init__(self, name: str, chunk):
        self.name, self.chunk = name, chunk

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        if self.chunk is None and self.parent is not None:
            self.chunk = self.parent.chunk
        self.thread = threading.get_ident()
        self._rf = None
        # true only on a thread the profiler records
        if torch._C._autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        _stack().pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        with _lock:
            _records.append(self)
            if self.chunk is not None:
                sums = _chunks.get(self.chunk)
                if sums is None:
                    sums = _chunks[self.chunk] = {}
                    if len(_chunks) > _MAX_CHUNKS:
                        del _chunks[next(iter(_chunks))]
                acc = sums.setdefault(self.name, [0.0, 0])
                acc[0] += self.end - self.start
                acc[1] += 1
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, chunk=None):
    """A context around a stage or a layer of the step (see the module)."""
    if not _on:
        return _NULL
    return Span(name, chunk)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (nothing while off)."""
    if not _on:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def drain() -> tuple[list, dict]:
    """(records in the order they ended, {counter: total}) since the last
    drain; both are cleared."""
    with _lock:
        records, counts = list(_records), dict(_counts)
        _records.clear()
        _counts.clear()
        _chunks.clear()
    return records, counts


def take_chunk(chunk) -> dict:
    """{name: (seconds, calls)} of the spans of ``chunk`` that have ended,
    taken out (the metrics line's ``stages_ms``); the sums of the last
    64 chunks are kept."""
    with _lock:
        sums = _chunks.pop(chunk, {})
    return {name: tuple(acc) for name, acc in sums.items()}


def h2d(array, dtype=None, device=None) -> torch.Tensor:
    """``torch.as_tensor(array, dtype=dtype, device=device)``: the one way
    the live step copies a host array to the device. On CUDA the copy is
    from pageable memory and ends in a stream synchronise; traced, each is
    an ``h2d`` span and counts under ``h2d``."""
    if not _on:
        return torch.as_tensor(array, dtype=dtype, device=device)
    count("h2d")
    with span("h2d"):
        return torch.as_tensor(array, dtype=dtype, device=device)
