"""The measured loop: the program's live device step pipelined as
``Orchestrator.run()`` pipelines it, over the replay set, closed-loop.

The main thread hands chunk g to ``prepare``, queues the step of chunk g
(``dispatch``) as soon as its upload (on the upload thread, one chunk
ahead) is done, hands chunk g + 1 over, and sends chunk g's outputs to
the download thread, which brings them to the host one chunk behind; the
main thread then waits for chunk g - 1's download, as ``run()`` waits
for it before its host layer. The host layer itself (framing, audio
routing) is not run. A chunk's latency runs from its hand-off to
``prepare`` to its outputs on the host.

A sample of the chunks, drawn from the seed over the chunks the loop
drives (reservoir sampling), is kept for the check: the carried state
before and after the chunk (device copies taken when it is queued and
when the next one is) and the chunk's host outputs. A chunk right after
the replay set wraps around is not drawn: the wrap splices two points of
the capture, and the symbol loops reacquire there.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Kept:
    """A checked chunk: its global index, the state before and after it
    (device copies) and its host outputs."""
    g: int
    before: dict
    after: dict | None = None
    outputs: dict | None = None


@dataclass
class Window:
    """What one pass of the loop measured."""
    first: int = 0                   # global index of its first chunk
    chunks: int = 0
    start: float = 0.0               # perf_counter of the first hand-off
    end: float = 0.0                 # perf_counter of the last download
    latency_s: list = field(default_factory=list)
    upload_s: list = field(default_factory=list)
    dispatch_s: list = field(default_factory=list)
    kept: list = field(default_factory=list)


class Sampler:
    """Reservoir sampling of ``size`` chunks from a seeded stream."""

    def __init__(self, size: int, seed: int, wrap: int):
        self.size = size
        self.rng = np.random.default_rng([seed, 0x5EED])
        self.wrap = wrap
        self.seen = 0

    def slot(self, g: int, kept: list) -> int | None:
        """Where chunk g goes in ``kept`` (None: not kept)."""
        if g % self.wrap == 0 or self.size == 0:
            return None
        self.seen += 1
        if len(kept) < self.size:
            return len(kept)
        j = int(self.rng.integers(0, self.seen))
        return j if j < self.size else None


def drive(system, chunks: list, first: int, *, count: int | None = None,
          seconds: float | None = None, sampler: Sampler | None = None,
          span=None) -> Window:
    """Run the pipelined loop from global chunk ``first`` for ``count``
    chunks or until ``seconds`` have passed since the first hand-off, and
    wait for the last download. ``span(name)`` gives a context around
    each stage and around the main thread's waits for an upload and for
    the download one chunk behind (the traced run's labels)."""
    span = span or (lambda name: nullcontext())
    r = len(chunks)
    w = Window(first=first)
    handed: dict = {}
    waiting: list = []               # kept chunks that want their after-state

    def stage(g: int):
        handed[g] = time.perf_counter()
        with span("prepare"):
            return system.prepare(chunks[g % r])

    def upload(prep):
        t0 = time.perf_counter()
        with span("upload"):
            dev = system.upload(prep)
        w.upload_s.append(time.perf_counter() - t0)
        return dev

    def pull(g: int, out: dict, keep: Kept | None):
        with span("download"):
            host = system.download(out)
        done = time.perf_counter()
        w.latency_s.append(done - handed.pop(g))
        w.end = done
        if keep is not None and keep.g == g:
            keep.outputs = host

    with ThreadPoolExecutor(1) as up, ThreadPoolExecutor(1) as down:
        g = first
        w.start = time.perf_counter()
        fut = up.submit(upload, stage(g))
        pending = None
        while fut is not None:
            with span("wait_upload"):
                dev = fut.result()
            if waiting:
                after = system.snapshot()
                for k in waiting:
                    k.after = after
                waiting = []
            keep = None
            if sampler is not None:
                at = sampler.slot(g, w.kept)
                if at is not None:
                    keep = Kept(g, system.snapshot())
                    if at == len(w.kept):
                        w.kept.append(keep)
                    else:
                        w.kept[at] = keep
                    waiting.append(keep)
            t0 = time.perf_counter()
            with span("dispatch"):
                out = system.dispatch(dev)
            w.dispatch_s.append(time.perf_counter() - t0)
            w.chunks += 1
            more = (count is not None and w.chunks < count) or \
                (seconds is not None and time.perf_counter() - w.start
                 < seconds)
            fut = up.submit(upload, stage(g + 1)) if more else None
            cur = down.submit(pull, g, out, keep)
            g += 1
            if pending is not None:
                with span("wait_download"):
                    pending.result()
            pending = cur
        if pending is not None:
            pending.result()
    if waiting:
        after = system.snapshot()
        for k in waiting:
            k.after = after
    return w
