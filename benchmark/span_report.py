"""A traced run of one cell that prints, beside its per-layer metrics, what
the program's own spans show (``spans.py``): host self ms a chunk by span
over the counted window, the profiled window's longest idle gaps named by
the loop's label and the innermost program span open there, the tracer's
cost, and the sums that account for the chunk's host and device time.
The tracer's cost: the counted window's chunk period against the run's
untraced window's, and, on a third System, windows of WINDOW_S seconds
with the tracer off and on in turns (off, on, on, off).

    python3 benchmark/span_report.py --workload <name> --seed <n> \
        [--seconds <s>]

Needs a CUDA card; prints one JSON line. No check is made.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WINDOW_S = 3.0


def on_off_periods(r, device) -> dict:
    """{"off": [...], "on": [...]}: seconds a chunk of the loop with the
    program's tracer off and on, in turns, on a fresh System."""
    from benchmark import run, spans
    from benchmark import window as win
    from benchmark.adapter import System

    tracing = spans.tracer()
    system = System(r.config, r.replay, device)
    chunks, g = r.replay.chunks, 0
    win.drive(system, chunks, g, count=spans.WARM_CHUNKS)
    g += spans.WARM_CHUNKS
    out = {"off": [], "on": []}
    try:
        for mode in ("off", "on", "on", "off"):
            tracing.enable(mode == "on")
            w = win.drive(system, chunks, g, seconds=WINDOW_S)
            run._sync(device)
            tracing.enable(False)
            tracing.drain()
            g += w.chunks
            out[mode].append((w.end - w.start) / w.chunks)
    finally:
        tracing.enable(False)
        system.close()
    return out


def self_ms(s) -> dict:
    """Host self ms a chunk by span name over the counted window: each
    span's time less its children's."""
    own: dict = {}
    for r in s.records:
        own[id(r)] = [r.name, r.seconds]
    for r in s.records:
        if r.parent is not None and id(r.parent) in own:
            own[id(r.parent)][1] -= r.seconds
    out: dict = {}
    for name, sec in own.values():
        out[name] = out.get(name, 0.0) + sec
    return {k: 1e3 * v / s.counted.chunks for k, v in sorted(out.items())}


def _depth(record) -> int:
    d = 0
    while record.parent is not None:
        record, d = record.parent, d + 1
    return d


def named_gaps(s, limit: int = 10) -> list:
    """[name, seconds] of the profiled window's longest idle gaps, each
    named by the loop's labels open at its middle and, after a slash, the
    innermost program span open there on any thread (the tracer's records
    put on the profiler's clock by the main thread's ``dispatch`` spans,
    which both clocks hold)."""
    host = sorted(a for a, _, name in s.host if name == "dispatch")
    mine = sorted(r.start for r in s.profiled_records if r.name == "dispatch")
    offset = (statistics.median(a - b for a, b in zip(host, mine))
              if host and len(host) == len(mine) else None)
    lo, hi = s.trace.window
    edges = [lo]
    for a, b in s.trace.busy():
        edges += [a, b]
    edges.append(hi)
    out = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = "+".join(sorted({label for x, y, label in s.trace.spans
                                if x <= mid <= y})) or "no host span"
        if offset is not None:
            inner = [r for r in s.profiled_records
                     if r.start + offset <= mid <= r.end + offset]
            if inner:
                name += "/" + max(inner, key=lambda r: (_depth(r),
                                                        r.start)).name
        out.append([name, b - a])
    return sorted(out, key=lambda t: -t[1])[:limit]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import run, spans
    from benchmark import trace as tr

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    spec = run.Spec(args.workload)
    replay, system, _ = run.set_up(spec, args.seed, device)
    w, plain, trace = run.observe(spec, system, replay, args.seed,
                                  args.seconds, True)
    last = replay.chunks[(w.first + w.chunks - 1) % len(replay.chunks)]
    r = run.Run(spec.config, replay, w, plain, trace,
                run.layer_times(system, last))
    t0 = time.perf_counter()
    metrics = {m["name"]: run.reader(m["name"])(r) for m in spec.per_layer}
    readers_s = time.perf_counter() - t0
    system.close()
    s = spans.session(r)
    if s is None:
        print("the program has no tracer", file=sys.stderr)
        return 1

    def per_chunk_ms(t, win, keep=lambda name: True):
        busy = tr.Trace(window=t.window,
                        device=[d for d in t.device if keep(d[2])]).busy()
        return 1e3 * sum(b - a for a, b in busy) / win.chunks

    link = spans.link
    period = (plain.end - plain.start) / plain.chunks
    counted = (s.counted.end - s.counted.start) / s.counted.chunks
    host = {k: metrics.get(k) for k in ("stage_ms", "upload_wait_ms",
                                        "dispatch_sync_ms", "launch_ms")}
    steps = {k: v for k, v in metrics.items()
             if k.startswith("step_ms.") and v is not None}
    own = self_ms(s)
    turns = on_off_periods(r, device)
    out = {
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(0),
        "metrics": metrics,
        "readers_s": readers_s,
        "chunks": {"plain": plain.chunks, "traced": w.chunks,
                   "counted": s.counted.chunks, "profiled": s.profiled.chunks},
        "period_ms": {"plain": 1e3 * period, "counted": 1e3 * counted},
        "counted_over_plain_pct": 100.0 * (counted / period - 1.0),
        "turns_period_ms": {k: [1e3 * x for x in v]
                            for k, v in turns.items()},
        "tracer_on_cost_pct": 100.0 * (sum(turns["on"])
                                       / sum(turns["off"]) - 1.0),
        "self_ms": own,
        "counters_per_chunk": {k: v / s.counted.chunks
                               for k, v in s.counts.items()},
        "busy_ms": {"traced": per_chunk_ms(trace, w),
                    "traced_less_link": per_chunk_ms(
                        trace, w, lambda n: not link(n)),
                    "profiled": per_chunk_ms(s.trace, s.profiled),
                    "profiled_less_link": per_chunk_ms(
                        s.trace, s.profiled, lambda n: not link(n))},
        "sum_step_ms": sum(steps.values()),
        "sum_host_ms": sum(v for v in host.values() if v is not None),
        "upload_copy_launch_ms": own.get("upload.copy"),
        "upload_self_ms": own.get("upload"),
        "named_gaps": named_gaps(s),
        "gaps": tr.breakdown(trace)["idle_gaps"],
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
