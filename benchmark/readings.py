"""Readings for setting the check's limits: each number the check
compares, on sound runs of the program (the lower readings) and on the
control (the upper), for each of a list of seeds, in one process.

    python3 benchmark/readings.py --workload <name> --seeds 1,2,3 \
        --seconds 3 [--program-tf32]

For each seed: set-up, warm-up and a window of ``--seconds`` at the
cell's own load, then the numbers of

* ``program``: the program's outputs and state against the reference;
* ``stale``: the same with the program's state before each chunk in
  place of its state after, the reading of a step that leaves a leaf
  unchanged, for each leaf's gap;
* ``control``: the reference computed in the precision below the one the
  configuration states (float32 with TF32 off): float32 with every filter
  operand rounded to TF32, from the same states, in the program's place;
* with ``--program-tf32``, ``program_tf32``: a second run of the program
  with its TF32 switched on (``torch.backends``), against the reference.

One JSON line a seed and kind. The benchmark's own runs never run this.
"""
import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))


def readings_of(spec, seed: int, seconds: float, device, control: bool):
    from benchmark import run
    from benchmark.check import Checker
    from benchmark.reference import dsp

    replay, system, init = run.set_up(spec, seed, device)
    w, _, _ = run.observe(spec, system, replay, seed, seconds, False)
    checker = Checker(spec.config, replay, system.tier, spec.checks, device)
    kept, init_host = run.hand_over(system, checker, w, init, seed)
    start = checker.start(init_host)

    def numbers(**kw):
        return checker.all_readings(
            [checker.readings([k], seed, **kw) for k in kept], start)

    both = [checker.readings([k], seed, stale=True) for k in kept]
    out = {"program": checker.all_readings([r for r, _ in both], start),
           "stale": checker.all_readings([r for _, r in both], start)}
    if control:
        out["control"] = numbers(control=dsp.Precision.tf32_control())
    return out, w.chunks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--program-tf32", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from benchmark import run

    spec = run.Spec(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        got, chunks = readings_of(spec, seed, args.seconds, device, True)
        for kind, numbers in got.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": kind, "chunks": chunks,
                              "numbers": numbers}), flush=True)
        if args.program_tf32:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            got, chunks = readings_of(spec, seed, args.seconds, device, False)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": "program_tf32", "chunks": chunks,
                              "numbers": got["program"]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
