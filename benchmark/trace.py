"""Reduction of the traced run's profiler trace: the device intervals of
every kernel, copy and memset, the host spans the loop labels
(``bench.prepare``, ``bench.upload``, ``bench.dispatch``,
``bench.download``, the main thread's ``bench.wait_upload`` and
``bench.wait_download``), and from them the busy time (the union of the
device intervals, so nothing counts twice), each kernel's device time, the
host-to-device copies' time and the idle gaps, each named by the host
spans open at its middle. All times in seconds on the profiler's clock.
"""
from __future__ import annotations

from dataclasses import dataclass, field

SPAN_PREFIX = "bench."


@dataclass
class Trace:
    window: tuple = (0.0, 0.0)
    device: list = field(default_factory=list)     # (start, end, name)
    spans: list = field(default_factory=list)      # (start, end, label)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> list:
        """The union of the device intervals inside the window, sorted."""
        lo, hi = self.window
        out: list = []
        for s, e, _ in sorted(self.device):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def by_name(self) -> dict:
        """Device seconds by operation name, over the window."""
        lo, hi = self.window
        tot: dict = {}
        for s, e, name in self.device:
            d = min(e, hi) - max(s, lo)
            if d > 0:
                tot[name] = tot.get(name, 0.0) + d
        return tot

    def seconds_matching(self, *words: str) -> float:
        """Device seconds of the operations whose name holds every word
        (case folded)."""
        return sum(v for k, v in self.by_name().items()
                   if all(w.lower() in k.lower() for w in words))

    def gaps(self) -> list:
        """(name, seconds) of each idle stretch in the window, longest
        first; a stretch is named by the host spans open at its middle."""
        lo, hi = self.window
        edges = [lo]
        for s, e in self.busy():
            edges += [s, e]
        edges.append(hi)
        out = []
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                mid = 0.5 * (a + b)
                open_ = sorted({label for s, e, label in self.spans
                                if s <= mid <= e})
                out.append(("+".join(open_) or "no host span", b - a))
        return sorted(out, key=lambda t: -t[1])


def reduce(prof, window: tuple | None = None) -> Trace:
    """A Trace of a finished ``torch.profiler.profile``. The window runs
    from the first labelled host span's start to the last one's end
    unless given."""
    from torch.autograd import DeviceType

    t = Trace()
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        name = e.name()
        if name.startswith(SPAN_PREFIX):
            # the profiler mirrors a host label on the device's timeline
            # over the work launched under it: a label, not device work
            if e.device_type() != DeviceType.CUDA:
                t.spans.append((start, end, name[len(SPAN_PREFIX):]))
        elif e.device_type() == DeviceType.CUDA:
            t.device.append((start, end, name))
    if window is None:
        if not t.spans:
            raise RuntimeError("the trace holds none of the loop's spans")
        window = (min(s for s, _, _ in t.spans),
                  max(e for _, e, _ in t.spans))
    t.window = window
    return t


def breakdown(t: Trace, limit: int = 10) -> dict:
    """The ``breakdown`` of a result line: the device operations that took
    most time and the longest idle gaps, each as [name, seconds]."""
    ops = sorted(t.by_name().items(), key=lambda kv: -kv[1])[:limit]
    return {"device_ops": [[_short(n), s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in t.gaps()[:limit]]}


def _short(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."
