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

Host arrays reach the device through ``h2d`` (a copy, and on CUDA a
synchronise, each call) or, for the step's constants, ``h2d_once`` (a copy
on first use, then the kept device tensor).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import nullcontext

import torch

__all__ = ["PREFIX", "Span", "count", "drain", "enable", "enabled",
           "forget_constants", "h2d", "h2d_once", "span", "take_chunk"]

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
# h2d_once's device copies, emptied whole past this many
_MAX_CONSTANTS = 256
_constants: dict = {}        # (key, dtype, device) -> torch.Tensor


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
                _add(self.chunk, self.name, self.end - self.start)
        return False


def _add(chunk, name: str, seconds: float) -> None:
    """One call of ``seconds`` to ``name`` in ``chunk``'s sums (under
    _lock)."""
    sums = _chunks.get(chunk)
    if sums is None:
        sums = _chunks[chunk] = {}
        if len(_chunks) > _MAX_CHUNKS:
            del _chunks[next(iter(_chunks))]
    acc = sums.setdefault(name, [0.0, 0])
    acc[0] += seconds
    acc[1] += 1


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
    an ``h2d`` span and counts under ``h2d``. A constant the step needs on
    every call goes through ``h2d_once`` instead, which copies it here on
    first use only."""
    if not _on:
        return torch.as_tensor(array, dtype=dtype, device=device)
    count("h2d")
    with span("h2d"):
        return torch.as_tensor(array, dtype=dtype, device=device)


def h2d_once(key, build, dtype=None, device=None) -> torch.Tensor:
    """The device copy of the host array ``build()``, made through ``h2d``
    the first time (``key``, ``dtype``, ``device``) is asked for and kept:
    a later call builds nothing, copies nothing and never synchronises.
    ``key`` holds exactly what the array's values depend on. The tensor is
    shared by every caller of the key, so it is only read, never written
    in place. Traced, each call served from the kept copies counts under
    ``h2d.cached``, and in the chunk of the span open on its thread (the
    metrics line's ``h2d_cached``). Past 256 keys the kept copies are
    dropped and made again on use."""
    k = (key, dtype, device)
    t = _constants.get(k)
    if t is None:
        if len(_constants) >= _MAX_CONSTANTS:
            _constants.clear()
        t = _constants[k] = h2d(build(), dtype=dtype, device=device)
    elif _on:
        stack = _stack()
        with _lock:
            _counts["h2d.cached"] = _counts.get("h2d.cached", 0) + 1
            if stack and stack[-1].chunk is not None:
                _add(stack[-1].chunk, "h2d.cached", 0.0)
    return t


def forget_constants() -> None:
    """Drop ``h2d_once``'s kept copies: each key is built and copied anew
    on its next use."""
    _constants.clear()
