#!/usr/bin/env python3
"""The JAX package's own decode of bench.py's five bank legs at full width,
kept as digests that the port is held to.

    JAX_PLATFORMS=cpu python tools/reference_digests.py

Runs each bank leg of bench.py as bench.py's main runs it (1023 slots;
C4FM in int8 and in int4, DMR and P25 Phase 2 with 3 warm-up and 6 timed
chunks of 1024 x 5120 samples; NBFM 2 + 6 chunks of 1024 x 6400) with the
JAX package on the CPU. A spy on bench.py's ``_synth_iq8_chunks`` keeps
the int8 chunks the leg feeds, and one on the JAX ``Orchestrator`` keeps
the orchestrator it runs, so the leg itself runs unchanged. Each bank's
``bench_torch.bank_digest`` goes into tests/torch_reference/banks_1023.json
with its tolerance (``TOLERANCES``), the leg's record without its timing,
the seconds the leg took, and the numpy and jax versions. A bank takes
1-3 minutes on a CPU, the whole file about 6; the digests come out the
same on every run.

``python3 chip_smoke.py reference`` rebuilds the same scenes on the card's
host (bench_torch's scene builders), checks every chunk's sha256 against
this file, runs the port's Orchestrator(device="cuda") on them and holds
its digest to the reference's. This tool imports JAX by design, so it runs
only where the JAX package does.
"""
from __future__ import annotations

import json
import platform
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "tests" / "torch_reference" / "banks_1023.json"

SLOTS = 1023
TIMED_CHUNKS = 6            # bench.py's main: timed_chunks=6 for each leg

# bank -> (bench.py's leg, its arguments beyond slots and timed_chunks)
BANKS = {
    "c4fm": ("bench_orchestrator_bank", {}),
    "c4fm_int4": ("bench_orchestrator_bank", {"ingest": "int4"}),
    "dmr": ("bench_orchestrator_bank_dmr", {}),
    "p25p2": ("bench_orchestrator_bank_p25p2", {}),
    "nbfm": ("bench_orchestrator_bank_nbfm", {}),
}

# each bank's tolerance (bench_torch.compare_digests) and why; PERF.md's
# findings hold the runs behind each
TOLERANCES = {
    "c4fm": {"slots_differing": 1, "may_differ": ["metrics"],
             "why": "frames and audio segments equal slot by slot; one "
                    "slot's metrics (its dibit count) may differ: the "
                    "card's channelizer rounds differently from XLA:CPU's "
                    "(its FFT; XLA fuses the polyphase sums into FMAs), "
                    "and one of 1023 slots' timing loops carries that "
                    "into a symbol (on the CPU a port-only change of the "
                    "inverse FFT's precision moves one of 32 slots' "
                    "metrics the same way, no frames)"},
    "c4fm_int4": {"slots_differing": 1023, "frames_per_slot": None,
                  "totals_share": {"frames": 0.043, "segments": 0.058},
                  "why": "int4 sits at the decode threshold, where an ulp "
                         "of difference in the channelizer moves frames "
                         "on most slots (on the CPU, on 32 slots of the "
                         "full scene: the port against the JAX package, "
                         "and a port-only change of the inverse FFT's "
                         "precision, each move 25-30 slots, frames off by "
                         "4.85-5.02 a slot (rms), segments 0.98-1.05). No "
                         "slot can be held; the totals are held within "
                         "three standard deviations of that spread over "
                         "1023 slots (4.3% of the frames, 5.8% of the "
                         "segments)"},
    "dmr": {"why": "equal slot by slot"},
    "p25p2": {"why": "equal slot by slot"},
    "nbfm": {"rms_rel": 1e-3,
             "why": "counts equal slot by slot; the audio RMS within 1e-3 "
                    "relative: the card's float audio may sit an ulp "
                    "from the CPU's at a mu-law level boundary"},
}


class _Synthesized(Exception):
    """Raised by the synthesis spy to stop a leg once its chunks exist."""


def run_reference(bank: str, slots: int = SLOTS,
                  timed_chunks: int = TIMED_CHUNKS, synthesis_only=False,
                  **kw):
    """Run bench.py's leg for `bank` (``BANKS``) with the JAX package,
    its arguments `slots`, `timed_chunks` and `kw` beside the bank's own.
    Returns (the leg's record, the bank's digest). With `synthesis_only`
    the leg stops once it has synthesized its chunks, and the int8 chunks
    are returned."""
    import bench
    import bench_torch
    from sdrtrunk_tpu.runtime import orchestrator as orchestrator_module

    name, own = BANKS[bank]
    seen = {}
    synth = bench._synth_iq8_chunks
    base = orchestrator_module.Orchestrator

    def synth_spy(*args, **kwargs):
        seen["chunks"] = synth(*args, **kwargs)
        if synthesis_only:
            raise _Synthesized
        return seen["chunks"]

    class Orchestrator(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen["orch"] = self
            seen["segments"] = bench_torch._segment_slots(self)

    bench._synth_iq8_chunks = synth_spy
    orchestrator_module.Orchestrator = Orchestrator
    try:
        record = getattr(bench, name)(slots=slots, timed_chunks=timed_chunks,
                                      **own, **kw)
    except _Synthesized:
        return seen["chunks"]
    finally:
        bench._synth_iq8_chunks = synth
        orchestrator_module.Orchestrator = base
    return record, bench_torch.bank_digest(seen["orch"], seen["chunks"],
                                           seen["segments"])


def write(banks: dict, meta: dict, path: Path = OUT) -> None:
    """The file: the run's facts, then one bank a line (compact JSON)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    head = json.dumps(meta, indent=1)[:-2]
    body = ",\n".join(f"{json.dumps(k)}: "
                      + json.dumps(v, separators=(",", ":"))
                      for k, v in banks.items())
    path.write_text(f'{head},\n "banks": {{\n{body}\n}}\n}}\n')


def main() -> int:
    import jax
    import numpy as np
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(ROOT))

    banks = {}
    for bank in BANKS:
        t0 = time.perf_counter()
        record, digest = run_reference(bank)
        seconds = time.perf_counter() - t0
        leg, own = BANKS[bank]
        banks[bank] = {
            "leg": f"bench.py::{leg}", "slots": SLOTS,
            "timed_chunks": TIMED_CHUNKS, **own, "seconds": round(seconds, 1),
            "record": {k: v for k, v in record.items()
                       if k not in ("msps", "realtime_factor")},
            "tolerance": TOLERANCES[bank], "digest": digest}
        print(json.dumps({"bank": bank, "seconds": round(seconds, 1),
                          "totals": digest["totals"]}), flush=True)
    meta = {"generated_by": "tools/reference_digests.py",
            "reference": "the JAX package (sdrtrunk_tpu) on the CPU",
            "numpy": np.__version__, "jax": jax.__version__,
            "python": platform.python_version()}
    write(banks, meta)
    print(f"wrote {OUT.relative_to(ROOT)} ({OUT.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
