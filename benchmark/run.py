"""Benchmark of sdrtrunk_tpu_torch's live device step, one cell a run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``workloads`` in BENCHMARK.json at the checkout's root) names a
configuration (its ``file``), a traffic mix (``traffic/<traffic>.json``)
and, in ``checks/<workload>.json``, the sample the check takes and the
limit of each number it compares. A run makes the replay set from the
seed, builds the program's Orchestrator, warms up every shape, measures
``--seconds`` of the pipelined device step (``window.py``), checks the
kept chunks against the plain reference (``check.py``) and prints one
JSON line last on standard output. ``--trace 0`` reports the cell's
end-to-end metrics; ``--trace 1`` runs the same loop untraced and then
under the profiler, each for ``--seconds`` or TRACE_SECONDS, the
shorter, and reports its per-layer metrics, each read by
``metrics/<name>.py`` (what the host clock reads from the untraced
window), with the traced window's busy and window seconds and a
breakdown.

Exits 1 with no result when CUDA is absent or has fewer devices than the
cell asks for, and when a module of JAX or of the JAX package
(``sdrtrunk_tpu``, the top-level name whole) is loaded once the window
has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the traced run's window: its trace's reduction takes some six seconds a
# second of window, and the run has to end within six minutes
TRACE_SECONDS = 6.0
FORBIDDEN = ("jax", "jaxlib", "flax", "sdrtrunk_tpu", "bench", "bench_torch",
             "chip_smoke")


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (or its benchmark scripts')."""
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


class Spec:
    """A cell of BENCHMARK.json with its configuration, mix and checks; or
    ``cell``, an entry of the same form that the file does not list (the
    tests' held cells)."""

    def __init__(self, workload: str, cell: dict | None = None):
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if cell is None and workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}")
        self.cell = cell or cells[workload]
        entry = {c["name"]: c for c in bench["configs"]}[self.cell["config"]]
        self.config = json.loads((ROOT / entry["file"]).read_text())
        self.mix = json.loads(
            (HERE / "traffic" / f"{self.cell['traffic']}.json").read_text())
        self.checks = json.loads(
            (HERE / "checks" / f"{workload}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])]


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What the readers see: the configuration, the replay set, the
    traced window, the untraced window before it (``plain``), the trace
    and the layers' device ms."""

    def __init__(self, config, replay, window, plain, trace, layer_ms):
        self.config, self.replay = config, replay
        self.window, self.plain = window, plain
        self.trace, self.layer_ms = trace, layer_ms


def p95(values: list) -> float:
    """The 95th percentile of every value (Python's inclusive
    quantiles)."""
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def layer_times(system, chunk) -> dict:
    """Device ms of each layer of the step on one chunk, alone, from a
    copy of the running state: one warm run, then CUDA events around
    three runs."""
    import torch

    out = {}
    for name, fn in system.layers(chunk):
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(3):
            fn()
        end.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(end) / 3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    spec = Spec(args.workload)

    import torch

    chips = spec.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    # one intra-op thread for the whole process, the program's staging
    # copies included: the configurations' ``assumed`` say why, PERF.md
    # gives the rate with torch's default
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    result = measure(spec, args, device)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def set_up(spec: Spec, seed: int, device):
    """The replay set from the seed, the system built and its initial
    state copied, and the warm-up chunks driven through it."""
    import torch

    from benchmark import window as win
    from benchmark.adapter import System
    from benchmark.traffic import generator

    replay = generator.build(spec.config, spec.mix, seed, device)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    system = System(spec.config, replay, device)
    init = system.snapshot()
    win.drive(system, replay.chunks, 0, count=spec.mix["warmup_chunks"])
    _sync(device)
    return replay, system, init


def observe(spec: Spec, system, replay, seed: int, seconds: float,
            traced: bool):
    """The measured window: (Window, None, None). If ``traced``, an
    untraced window and then one under the profiler, each for at most
    TRACE_SECONDS: (traced Window, untraced Window, Trace). The profiler
    slows the host's side of the loop, so what the host clock reads
    comes from the untraced one."""
    from benchmark import window as win

    sampler = win.Sampler(spec.checks["checked_chunks"], seed,
                          len(replay.chunks))
    warm = spec.mix["warmup_chunks"]
    device = system.device
    if not traced:
        w = win.drive(system, replay.chunks, warm, seconds=seconds,
                      sampler=sampler)
        _sync(device)
        return w, None, None
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import trace as tr

    seconds = min(seconds, TRACE_SECONDS)
    plain = win.drive(system, replay.chunks, warm, seconds=seconds)
    _sync(device)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        w = win.drive(system, replay.chunks, warm + plain.chunks,
                      seconds=seconds, sampler=sampler,
                      span=lambda n: record_function(tr.SPAN_PREFIX + n))
        _sync(device)
    return w, plain, tr.reduce(prof)


def hand_over(system, checker, w, init, seed: int):
    """The kept chunks with their states on the host, and the initial
    state on the host; the system and its state are freed."""
    import torch

    from benchmark import window as win

    kept = []
    for k in w.kept:
        slots = checker.lanes(seed, k.g)
        kept.append(win.Kept(k.g, system.lanes(k.before, slots),
                             system.lanes(k.after, slots), k.outputs))
    init_host = system.lanes(init, list(range(system.slots)))
    device = system.device
    system.close()
    w.kept = []
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return kept, init_host


def judge(checker, kept: list, init_host: dict, seed: int, **kw):
    """(numbers {name: (value, limit)}, chunks that failed a limit)."""
    per_chunk = [checker.readings([k], seed, **kw) for k in kept]
    start = checker.start(init_host)
    numbers = checker.numbers(per_chunk, start)
    failed = sum(1 for r in per_chunk if any(
        v > lim for v, lim in checker.numbers([r], start).values()))
    return numbers, failed


def measure(spec: Spec, args, device) -> dict:
    """Set up, warm up, measure, check: the result line's fields. On a
    CPU device (the tests) the program runs its plain versions and the
    memory peak reads 0."""
    import torch

    from benchmark.check import Checker

    cuda = device.type == "cuda"
    replay, system, init = set_up(spec, args.seed, device)
    setup_s = time.perf_counter() - T0
    w, plain, trace = observe(spec, system, replay, args.seed, args.seconds,
                              bool(args.trace))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    metrics = {}
    if trace is not None:
        last = replay.chunks[(w.first + w.chunks - 1) % len(replay.chunks)]
        layer_ms = layer_times(system, last) if cuda else {}
        run = Run(spec.config, replay, w, plain, trace, layer_ms)
        for m in spec.per_layer:
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {
            "wideband_msps": w.chunks * replay.chunk_samples
            / (w.end - w.start) / 1e6,
            "chunk_ms_p95": 1e3 * p95(w.latency_s),
            "setup_s": setup_s}
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    checker = Checker(spec.config, replay, system.tier, spec.checks, device)
    kept, init_host = hand_over(system, checker, w, init, args.seed)
    checks, failed = judge(checker, kept, init_host, args.seed)
    correct = bool(kept) and all(v <= lim for v, lim in checks.values())

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": w.chunks, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace is not None:
        from benchmark import trace as tr

        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
        out["breakdown"] = tr.breakdown(trace)
    out["checks"] = {n: {"value": v, "limit": lim}
                     for n, (v, lim) in checks.items()}
    return out


if __name__ == "__main__":
    sys.exit(main())
