#!/usr/bin/env python3
"""The JAX package's own decode of bench.py's five bank legs and of five
more live cells at full width, kept as digests that the port is held to.

    JAX_PLATFORMS=cpu python tools/reference_digests.py [banks_1023]
        [cells_full_width]

writes both files, or the ones named.

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

The cells (tests/torch_reference/cells_full_width.json, the same layout)
are chip_smoke.py's live LTR and MPT1327 mixed banks (1023 slots), LSM
and AM (64) and C4FM on 25 kHz channels (511), which bench.py does not
run: ``bench_torch.cell_bytes`` builds each cell's bytes and recipe on
the host with the port's NumPy host modules (on the CPU), the JAX
``Orchestrator`` is built from the recipe (``orchestrator_from_recipe``
with the JAX package's classes) and run as ``bench_torch.run_bank`` runs
it, and its digest also holds the events (``bank_digest(...,
events=True)``).

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
CELLS_OUT = ROOT / "tests" / "torch_reference" / "cells_full_width.json"

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


# each cell's tolerance (events always equal); one looser than equal slot
# by slot names its CPU evidence (PERF.md's findings hold the runs)
_AUDIO_ULPS = ("the audio RMS within 1e-4 relative: the port's float "
               "audio may sit some ulps from the reference's at a mu-law "
               "level boundary, one level apart")
CELL_TOLERANCES = {
    "ltr": {"rms_rel": 1e-4,
            "why": "messages, frames and audio counts equal slot by slot; "
                   + _AUDIO_ULPS + " (on the CPU at full width 13 of 1023 "
                   "slots, 1.4e-5 at most; a port-only change of the inverse "
                   "FFT's precision gives 12, 9 of them the same, 1.0e-5 "
                   "at most; at 32 slots of the full scene slot 25, "
                   "3.8e-6, which that change moves to 1.9e-6)"},
    "mpt1327": {"rms_rel": 1e-4,
                "why": "messages, frames and audio counts equal slot by "
                       "slot, the grant followed; " + _AUDIO_ULPS + " (on "
                       "the CPU at full width 76 of 1023 slots, 4.4e-6 at "
                       "most; a port-only change of the inverse FFT's "
                       "precision gives 76, 4.8e-6 at most; at 32 slots of "
                       "the full scene slot 22, 1.2e-8, which that change "
                       "keeps and joins slot 11, 6.7e-6)"},
    "lsm": {"slots_differing": 1, "frames_per_slot": 6,
            "why": "one slot may lose up to 6 frames: slot 27's Gardner "
                   "loop sits where the channelizer's last bits decide it. "
                   "On the CPU at full width the port equals the reference "
                   "on all 64 slots, and a port-only change of the inverse "
                   "FFT's precision moves slot 27 from 22 frames to 16 "
                   "(5932 dibits to 5954), every other slot equal"},
    "am": {"rms_rel": 1e-12,
           "why": "audio counts and PCM equal slot by slot (on the CPU at "
                  "full width, also with a port-only change of the inverse "
                  "FFT's precision); the RMS is summed in float64 by each "
                  "machine's NumPy, whose SIMD reduction order may differ "
                  "by an ulp"},
    "c4fm_25k": {"slots_differing": 1, "may_differ": ["metrics"],
                 "why": "frames, audio segments and the grant equal slot "
                        "by slot; one slot's metrics (its dibit count) may "
                        "differ, as the 12.5 kHz C4FM bank's: on the CPU "
                        "at full width slot 108 counts 4915 dibits to the "
                        "reference's 4914, with the inverse FFT in either "
                        "precision (the channelizer's last bits moving a "
                        "timing loop by one symbol)"},
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


def run_cell(cell: str, slots=None, timed_chunks=None, chunk_blocks=None):
    """Run a cell (``bench_torch.CELLS``; full width where an argument is
    None) with the JAX package: the bytes and recipe from
    ``bench_torch.cell_bytes``, the JAX Orchestrator built from the recipe
    and run as ``bench_torch.run_bank`` runs a scene. Returns (the
    record, the digest with its events, the recipe)."""
    import bench_torch
    from sdrtrunk_tpu.runtime.identifiers import IdentifierCollection
    from sdrtrunk_tpu.runtime.orchestrator import Orchestrator
    from sdrtrunk_tpu.runtime.traffic import FrequencyBand

    chunks, recipe = bench_torch.cell_bytes(cell, slots, timed_chunks,
                                            chunk_blocks)
    orch = bench_torch.orchestrator_from_recipe(
        recipe, chunks, Orchestrator, IdentifierCollection, FrequencyBand)
    scene = bench_torch.BankScene(
        recipe["kind"], orch, chunks, recipe["warmup"],
        recipe["timed_chunks"], bench_torch._segment_slots(orch),
        recipe=recipe)
    record = bench_torch.run_bank(scene)
    return (record, bench_torch.bank_digest(orch, chunks, scene.segments,
                                            events=True), recipe)


def write(banks: dict, meta: dict, path: Path = OUT) -> None:
    """The file: the run's facts, then one bank a line (compact JSON)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    head = json.dumps(meta, indent=1)[:-2]
    body = ",\n".join(f"{json.dumps(k)}: "
                      + json.dumps(v, separators=(",", ":"))
                      for k, v in banks.items())
    path.write_text(f'{head},\n "banks": {{\n{body}\n}}\n}}\n')


def _bank_entries() -> dict:
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
    return banks


def _cell_entries() -> dict:
    import bench_torch
    cells = {}
    for cell in bench_torch.CELLS:
        t0 = time.perf_counter()
        record, digest, recipe = run_cell(cell)
        seconds = time.perf_counter() - t0
        cells[cell] = {
            "builder": f"bench_torch.py::scene_bank_{cell}",
            "slots": digest["slots"], "warmup": recipe["warmup"],
            "timed_chunks": recipe["timed_chunks"],
            "orchestrator": {k: v for k, v in recipe["kwargs"].items()
                             if k != "slots"},
            "channel_map": recipe["channel_map"],
            "free_slots": recipe["free_slots"],
            "seconds": round(seconds, 1),
            "record": {k: v for k, v in record.items()
                       if k not in ("msps", "realtime_factor")},
            "tolerance": CELL_TOLERANCES[cell], "digest": digest}
        print(json.dumps({"cell": cell, "seconds": round(seconds, 1),
                          "totals": digest["totals"]}), flush=True)
    return cells


FILES = {"banks_1023": (OUT, _bank_entries),
         "cells_full_width": (CELLS_OUT, _cell_entries)}


def main(argv: list[str]) -> int:
    import jax
    import numpy as np
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(ROOT))

    names = argv or list(FILES)
    unknown = sorted(set(names) - set(FILES))
    if unknown:
        raise SystemExit(f"unknown file(s) {unknown}; the files are "
                         f"{list(FILES)}")
    meta = {"generated_by": "tools/reference_digests.py",
            "reference": "the JAX package (sdrtrunk_tpu) on the CPU",
            "numpy": np.__version__, "jax": jax.__version__,
            "python": platform.python_version()}
    for name in names:
        path, entries = FILES[name]
        write(entries(), meta, path)
        print(f"wrote {path.relative_to(ROOT)} ({path.stat().st_size} "
              f"bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
