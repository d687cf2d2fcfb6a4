#!/usr/bin/env python3
"""The JAX package's own decode of bench.py's five bank legs and of five
more live cells at full width, kept as digests that the port is held to.

    JAX_PLATFORMS=cpu python tools/reference_digests.py [banks_1023]
        [cells_full_width] [paths_full_width]

writes the three files, or the ones named.

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

The paths (tests/torch_reference/paths_full_width.json, the same layout)
are the main path's own scene and the tiers beside the bank:
``c4fm_grant`` (phase 5: 1023 slots, a control channel granting channel
600), with the ``worker_view`` of the JAX package's own
``host_process=True`` worker on the same bytes, which the port's worker
is held to, and the same view of the in-process run; ``slots_c4fm`` and
``slots_p25p2`` (the per-slot tier at 31 slots, the recording taps and a
sample-rate change, the P25 Phase 2 key handed to a grant) and
``multibank`` (``banks=``, 31 slots) and ``c4fm_ppm`` (c4fm_grant's
bytes through a tuner reading +0.7 ppm, the PPM correction on: its
digest also records every metrics line, the correction and the retuned
plan), built by ``bench_torch.cell_bytes`` and run as the cells are;
``monitor``: the JAX package's CLI, ``monitor --bank --traffic-slots
1022`` with every other setting at its default, on ``c4fm_grant``'s
bytes written as a 16-bit IQ wave (``bench_torch.monitor_inputs``), held
by ``bench_torch.monitor_digest``; and ``monitor_mixed``: the CLI's
``monitor --traffic-slots 4`` on chip_smoke.py's mixed scene rebuilt on
the host (``bench_torch.mixed_monitor_inputs``: P25, DMR and LTR control
channels, every call as mp2, the P25 bits tap), each mp2 call's PCM kept
beside the file in tests/torch_reference/monitor_mixed_pcm.npz for the
card's PCM swap. Every JAX run takes its device plan from copies
(``plan_copied``).

    JAX_PLATFORMS=cpu python tools/reference_digests.py paths_full_width

takes about 4 minutes.

``python3 chip_smoke.py reference`` rebuilds the same scenes on the card's
host (bench_torch's scene builders), checks every chunk's sha256 against
this file, runs the port's Orchestrator(device="cuda") on them and holds
its digest to the reference's. This tool imports JAX by design, so it runs
only where the JAX package does.
"""
from __future__ import annotations

import contextlib
import json
import platform
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "tests" / "torch_reference" / "banks_1023.json"
CELLS_OUT = ROOT / "tests" / "torch_reference" / "cells_full_width.json"
PATHS_OUT = ROOT / "tests" / "torch_reference" / "paths_full_width.json"
# the float32 PCM of each mp2 call of the reference's mixed monitor, by
# call file name (np.savez_compressed)
MIXED_PCM = ROOT / "tests" / "torch_reference" / "monitor_mixed_pcm.npz"

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


# each path's tolerance, as the cells' (events, taps and the rate change
# always equal); one looser than equal slot by slot names its CPU evidence
# (PERF.md's findings hold the runs)
_DC_BIN = ("the granted slot's metrics (its dibit count) may differ: for "
           "its first two chunks, before its tune takes effect (two chunks "
           "of grant latency), it reads the untuned DC bin, which carries "
           "no channel here, and its timing loop on the int8 noise there "
           "follows the channelizer's last bits")
# the mixed monitor's two mp2 calls: the P25 grant's call at 2 s and
# the LTR channel's own from the start
MIXED_P25_CALL = "call_00001_2.00s.mp2"
MIXED_LTR_CALL = "call_00002_0.00s.mp2"

PATH_TOLERANCES = {
    "c4fm_grant": {"slots_differing": 1, "may_differ": ["metrics"],
                   "why": "frames, audio segments, events and the grant "
                          "equal slot by slot; one slot's metrics (its "
                          "dibit count) may differ, as the bench C4FM "
                          "bank's: on the CPU at full width slot 454 "
                          "counts 13763 dibits to the reference's 13762, "
                          "and with a port-only change of the inverse "
                          "FFT's precision (complex128) 13762, every slot "
                          "equal (the channelizer's last bits moving a "
                          "timing loop by one symbol)"},
    "slots_c4fm": {"slots_differing": 1, "may_differ": ["metrics"],
                   "why": "frames, audio segments, events, the taps and "
                          "the rate change equal slot by slot; " + _DC_BIN
                          + " (on the CPU at full width slot 30 counts "
                          "13849 dibits to the reference's 13851, one "
                          "fewer in each of those chunks, and 13854 with a "
                          "port-only change of the inverse FFT's "
                          "precision)"},
    "slots_p25p2": {"why": "equal slot by slot"},
    "multibank": {"slots_differing": 1, "may_differ": ["metrics"],
                  "rms_rel": 1e-6,
                  "why": "frames, segments, messages, audio counts and "
                         "events equal slot by slot; " + _DC_BIN + " (on "
                         "the CPU at full width slot 10 counts 14499 "
                         "dibits to the reference's 14497, and 14502 with "
                         "a port-only change of the inverse FFT's "
                         "precision); the LTR slots' audio RMS within 1e-6 "
                         "relative: banks= carries float audio, no mu-law, "
                         "and the port's sits some ulps from the "
                         "reference's (on the CPU at full width all 10 LTR "
                         "slots, 3.4e-8 at most, about half their samples "
                         "a few ulps apart; 3.3e-8 with the inverse FFT in "
                         "complex128)"},
    "c4fm_ppm": {
        "slots_differing": 330, "frames_per_slot": 6,
        "may_differ": ["frames", "metrics", "segments", "segments_sha"],
        "totals_share": {"frames": 0.002, "segments": 0.003},
        "ppm": {"correction_ppm": 1e-3, "pll_error_hz": 0.1, "steps": 1e-8},
        "why": "the correction fires at the same chunk, its value within "
               "1e-3 ppm (it is one PLL reading: on the CPU at full width "
               "1.3e-7 ppm apart), every metrics line's correction and "
               "PLL error equal but a 0.1 Hz rounding step, each slot's "
               "bins equal and its step the reference's plus what the "
               "corrections' difference makes, within a float32 ulp (the "
               "plan is float32); events and the grant equal. A frequency "
               "error the voice slots' loops track with a lag leaves their "
               "symbols nearer the decision boundaries, where the "
               "channelizer's last bits move frames: on the CPU at full "
               "width the port parts from the reference on 107 of 1023 "
               "slots (frames on 56, by 3 at most, segments on 6, by one), "
               "and a port-only change of the inverse FFT's precision "
               "(complex128) parts the port from itself on 100 (48, 3, "
               "one), the control channel and the granted slot equal in "
               "all three; totals within 9 frames of 17195 and segments "
               "equal. Bounds: three times that spread"},
    "monitor": {"pll_error_hz": 0.1,
                "why": "the event log, call files, sidecars, PCM, summary "
                       "and every metrics line equal but the control PLL's "
                       "error, which a line rounds to 0.1 Hz: it may round "
                       "one step apart where the raw error sits at a "
                       "rounding boundary, as the raw error follows the "
                       "channelizer's last bits (on the CPU at full width "
                       "within 2.7e-3 Hz of the reference's, 6.4e-3 Hz "
                       "with a port-only change of the inverse FFT's "
                       "precision; every rounded line equal)"},
    "monitor_mixed": {
        "pll_error_hz": 0.1,
        "mp2_frames": {MIXED_P25_CALL: 6, MIXED_LTR_CALL: 35},
        "mp2_encoder_frames": {MIXED_P25_CALL: 6, MIXED_LTR_CALL: 13},
        "pcm_abs": 1e-6,
        "why": "the event log, the bits tap, the calls' names, sidecars, "
               "byte and frame counts, the summary and every metrics line "
               "equal but a 0.1 Hz rounding step of the PLL error (as the "
               "monitor's); each mp2 call's frames apart bounded by what "
               "its PCM swap shows (the reference's PCM of the call, kept "
               "in monitor_mixed_pcm.npz, through each encoder). The P25 "
               "call (20 frames) carries the reference's PCM exactly, so "
               "it parts by the port's encoder alone: 4 frames on the CPU "
               "and on the card (its x4 resample sums in another order "
               "than XLA's, and a quantizer decision within an ulp flips: "
               "tests/test_torch_mpeg.py); bound 6. The LTR call (84 "
               "frames): the port's encoder on the reference's PCM parts "
               "by 11, the reference's encoder on the port's PCM (banks= "
               "carries it as float audio, 2.98e-7 at most from the "
               "reference's on the CPU and on the card) by 22; the run by "
               "24 on the CPU, 27 on the card; bound 35, the two shares "
               "and 2. The port's encoder on the reference's PCM within "
               "its share and 2 (6, 13), its bytes on the card the CPU's, "
               "and the port's PCM within 1e-6 of the reference's "
               "(measured 0 and 2.98e-7)"},
}
WORKER_TOLERANCE = {"why": "equal field by field to the reference's own "
                           "worker (on the CPU at full width the port's "
                           "worker view equals it). Both packages' workers "
                           "part from their in-process bank on the granted "
                           "slot (frames 7 to 10, so the segment rows): the "
                           "in-process bank routes the chunk in flight at "
                           "the grant, framed from the slot's untuned bin, "
                           "to the granted call; the worker does not "
                           "(ROADMAP Queue 3, Waiting)"}


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
    None) with the JAX package (``run_path``). Returns (the record, the
    digest with its events, the recipe)."""
    return run_path(cell, slots, timed_chunks, chunk_blocks)[:3]


@contextlib.contextmanager
def plan_copied():
    """The JAX Orchestrator's device plan uploaded from copies of its host
    arrays while the block runs. On the CPU ``jnp.asarray`` may alias a
    64-byte-aligned NumPy buffer instead of copying it, and ``_tune``
    writes ``bins`` and ``steps`` in place, so a chunk already queued
    could take a retune one chunk early, or not, by the buffer's alignment
    and the threads' timing (ROADMAP Queue 3, Waiting 11). From copies, a
    retune takes effect from chunk n + 2, as ``run()``'s docstring says
    and as the port does."""
    import jax.numpy as jnp
    from sdrtrunk_tpu.runtime.orchestrator import Orchestrator

    dispatch = Orchestrator._dispatch

    def _dispatch(self, dev_iq):
        if self._plan_dev is None:
            self._plan_dev = (jnp.asarray(self.bins.copy()),
                              jnp.asarray(self.steps.copy()))
        return dispatch(self, dev_iq)
    Orchestrator._dispatch = _dispatch
    try:
        yield
    finally:
        Orchestrator._dispatch = dispatch


def _jax_orchestrator(recipe: dict, chunks):
    """The JAX package's Orchestrator built from a recipe."""
    import bench_torch
    from sdrtrunk_tpu.runtime.identifiers import IdentifierCollection
    from sdrtrunk_tpu.runtime.orchestrator import Orchestrator
    from sdrtrunk_tpu.runtime.traffic import FrequencyBand
    return bench_torch.orchestrator_from_recipe(
        recipe, chunks, Orchestrator, IdentifierCollection, FrequencyBand)


def run_path(cell: str, slots=None, timed_chunks=None, chunk_blocks=None):
    """Run a cell or a path (``bench_torch.CELLS``, ``PATHS``; full width
    where an argument is None) with the JAX package: the bytes and recipe
    from ``bench_torch.cell_bytes``, the JAX Orchestrator built from the
    recipe (its prepare included) and run as ``bench_torch.run_bank`` runs
    a scene (its steps included). Returns (the record, the digest with its
    events and steps, the recipe, the ``worker_view`` of the run)."""
    import bench_torch

    chunks, recipe = bench_torch.cell_bytes(cell, slots, timed_chunks,
                                            chunk_blocks, keep=True)
    record, _, digest, view = run_recipe(recipe, chunks)
    return record, digest, recipe, view


def run_recipe(recipe: dict, chunks) -> tuple:
    """A recipe (``bench_torch.cell_bytes``', its keyword arguments as the
    caller set them: a tier's ``host_process``, ``bank_mode`` or
    ``banks``) run by the JAX package as ``bench_torch.run_bank`` runs a
    scene, its steps included. Returns (the record, the steps recorded,
    the digest with its events and steps, None with ``host_process``, its
    ``worker_view``)."""
    import bench_torch

    orch = _jax_orchestrator(recipe, chunks)
    try:
        scene = bench_torch.BankScene(
            recipe["kind"], orch, chunks, recipe["warmup"],
            recipe["timed_chunks"], bench_torch._segment_slots(orch),
            recipe=recipe)
        with plan_copied():
            record = bench_torch.run_bank(scene)
        digest = None if orch.bank_host is not None else \
            bench_torch.bank_digest(orch, chunks, scene.segments,
                                    events=True, steps=scene.steps)
        return (record, scene.steps, digest,
                bench_torch.worker_view(orch, chunks))
    finally:
        orch.close()


def run_worker(slots=None, timed_chunks=None, chunk_blocks=None) -> dict:
    """The JAX package's ``host_process=True`` bank on c4fm_grant's bytes
    and recipe, run as ``run_path`` runs it. Returns what its parent sees
    (``bench_torch.worker_view``)."""
    import bench_torch

    chunks, recipe = bench_torch.cell_bytes("c4fm_grant", slots,
                                            timed_chunks, chunk_blocks,
                                            keep=True)
    recipe["kwargs"]["host_process"] = True
    return run_recipe(recipe, chunks)[3]


def run_monitor(directory: Path, slots=None, timed_chunks=None,
                chunk_blocks=None):
    """The JAX package's CLI, ``monitor`` on the main path's bytes
    (``bench_torch.monitor_inputs`` in directory), on the CPU in this
    process. Returns (its digest, ``monitor_digest``; the inputs)."""
    import io

    import bench_torch
    from sdrtrunk_tpu import cli

    inputs = bench_torch.monitor_inputs(directory, slots, timed_chunks,
                                        chunk_blocks)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), plan_copied():
        rc = cli.main(["--platform", "cpu", *inputs["argv"]])
    if rc != 0:
        raise AssertionError(f"the reference's monitor exited {rc}")
    return bench_torch.monitor_digest(
        out.getvalue().splitlines(), inputs["audio"], inputs["events"],
        inputs["wave"]), inputs


def run_mixed_monitor(directory: Path, **kw):
    """The JAX package's CLI, ``monitor --traffic-slots 4`` on the mixed
    monitor's bytes (``bench_torch.mixed_monitor_inputs(directory,
    **kw)``: P25, DMR and LTR control channels, every call as mp2, the P25
    bits tap), on the CPU in this process. Returns (its digest,
    ``monitor_digest``; the inputs; {call file name: the float32 PCM its
    mp2 encodes})."""
    import io

    import bench_torch
    from sdrtrunk_tpu import cli
    from sdrtrunk_tpu.audio import recorder

    inputs = bench_torch.mixed_monitor_inputs(directory, **kw)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), plan_copied(), \
            bench_torch.mp2_pcm_kept(recorder) as pcm:
        rc = cli.main(["--platform", "cpu", *inputs["argv"]])
    if rc != 0:
        raise AssertionError(f"the reference's mixed monitor exited {rc}")
    return bench_torch.monitor_digest(
        out.getvalue().splitlines(), inputs["audio"], inputs["events"],
        inputs["wave"]), inputs, pcm


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


def _path_entries() -> dict:
    import tempfile

    import numpy as np

    import bench_torch
    paths = {}
    for cell in bench_torch.PATHS:
        t0 = time.perf_counter()
        record, digest, recipe, view = run_path(cell)
        seconds = time.perf_counter() - t0
        paths[cell] = {
            "builder": f"bench_torch.py::scene_bank_{cell}",
            "slots": digest["slots"], "warmup": recipe["warmup"],
            "timed_chunks": recipe["timed_chunks"],
            "orchestrator": {k: v for k, v in recipe["kwargs"].items()
                             if k != "slots"},
            **{k: recipe[k] for k in ("activate_kinds", "prepare", "steps")
               if k in recipe},
            "free_slots": recipe["free_slots"],
            "seconds": round(seconds, 1),
            "record": {k: v for k, v in record.items()
                       if k not in ("msps", "realtime_factor", "ppm_wall")},
            "tolerance": PATH_TOLERANCES[cell], "digest": digest}
        if cell == "c4fm_grant":
            paths[cell].update(worker_builder="bench_torch.py::"
                               "scene_bank_worker",
                               worker_view=run_worker(),
                               in_process_view=view,
                               worker_tolerance=WORKER_TOLERANCE)
        print(json.dumps({"path": cell, "seconds": round(seconds, 1),
                          "totals": digest["totals"]}), flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        digest, inputs = run_monitor(Path(tmp))
        argv = [a.replace(tmp, "<dir>") for a in inputs["argv"]]
    seconds = time.perf_counter() - t0
    paths["monitor"] = {
        "builder": "bench_torch.py::monitor_inputs", "argv": argv,
        "slots": digest["header"]["slots"],
        "chunks": len(digest["metrics"]), "seconds": round(seconds, 1),
        "tolerance": PATH_TOLERANCES["monitor"], "digest": digest}
    print(json.dumps({"path": "monitor", "seconds": round(seconds, 1),
                      "summary": digest["summary"]}), flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        digest, inputs, pcm = run_mixed_monitor(Path(tmp))
        argv = [a.replace(tmp, "<dir>") for a in inputs["argv"]]
    seconds = time.perf_counter() - t0
    np.savez_compressed(MIXED_PCM, **pcm)
    paths["monitor_mixed"] = {
        "builder": "bench_torch.py::mixed_monitor_inputs", "argv": argv,
        "slots": digest["header"]["slots"],
        "chunks": len(digest["metrics"]), "seconds": round(seconds, 1),
        "pcm": str(MIXED_PCM.relative_to(ROOT)),
        "tolerance": PATH_TOLERANCES["monitor_mixed"], "digest": digest}
    print(json.dumps({"path": "monitor_mixed", "seconds": round(seconds, 1),
                      "summary": digest["summary"]}), flush=True)
    return paths


FILES = {"banks_1023": (OUT, _bank_entries),
         "cells_full_width": (CELLS_OUT, _cell_entries),
         "paths_full_width": (PATHS_OUT, _path_entries)}


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
