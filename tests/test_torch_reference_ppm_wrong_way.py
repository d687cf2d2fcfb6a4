"""A tuner error the C4FM loop misreads, held to the JAX package; and
``c4fm_ppm``'s full-width bytes.

At +2 ppm (about +907 Hz at 453.6 MHz, the drift a cheap RTL2832 tuner
may show) the DQPSK loop of the control channel settles a quarter of the
symbol rate (1200 Hz) away and reads about -246 Hz: the PPM correction
fires with the wrong sign, in both packages alike (ROADMAP Queue 3,
"Waiting" 12). Until that is fixed in both, the port must keep the
reference's answer: on a cut of the main path's scene through such a
tuner (16 slots, 3 + 4 chunks of 1024 x 1024, a window of 0.16 s, the
in-process bank) the port's correction fires at the reference's chunk
with its value, its lines, retuned plan and decode equal slot by slot
(the PPM step within ``PATH_TOLERANCES["c4fm_ppm"]["ppm"]``).

The file's ``c4fm_ppm`` entry holds the chunk hashes that the card's hold
checks before it runs; they are ``cell_bytes``' here too.
"""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

import bench_torch
from sdrtrunk_tpu_torch import use_device

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FILE = ROOT / "tests" / "torch_reference" / "paths_full_width.json"
_spec = importlib.util.spec_from_file_location(
    "reference_digests", ROOT / "tools" / "reference_digests.py")
reference_digests = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(reference_digests)

SLOTS, TIMED, BLOCKS, WINDOW_S = 16, 4, 1024, 0.16
PPM = 2.0                        # the tuner's error
FIRES_AT = 3                     # the chunk whose line shows the correction
TOLERANCE = {"ppm": reference_digests.PATH_TOLERANCES["c4fm_ppm"]["ppm"]}

_RUN: dict = {}


def _pair() -> tuple:
    """(the reference's digest, the port's, the port's Orchestrator) on
    the cut; made once."""
    if not _RUN:
        from sdrtrunk_tpu_torch.runtime.identifiers import \
            IdentifierCollection
        from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator
        from sdrtrunk_tpu_torch.runtime.traffic import FrequencyBand

        chunks, recipe = bench_torch._cell_c4fm_ppm(
            SLOTS, TIMED, BLOCKS, ppm=PPM, window_s=WINDOW_S)
        want = reference_digests.run_recipe(recipe, chunks)[2]
        with use_device("cpu"):
            orch = bench_torch.orchestrator_from_recipe(
                recipe, chunks, Orchestrator, IdentifierCollection,
                FrequencyBand, device="cpu")
            try:
                scene = bench_torch.BankScene(
                    recipe["kind"], orch, chunks, recipe["warmup"],
                    recipe["timed_chunks"],
                    bench_torch._segment_slots(orch), recipe=recipe)
                bench_torch.run_bank(scene)
                got = bench_torch.bank_digest(orch, chunks, scene.segments,
                                              events=True, steps=scene.steps)
            finally:
                orch.close()
        _RUN.update(want=want, got=got, orch=orch)
    return _RUN["want"], _RUN["got"], _RUN["orch"]


def test_the_wrong_way_correction_matches_the_reference():
    want, got, orch = _pair()
    held = bench_torch.compare_digests(got, want, TOLERANCE)
    assert held["ok"], held
    assert held["differing"] == [] and held["whole_differing"] == {}
    assert held["chunks_equal"] and held["events_equal"]
    assert orch.bank_mode and got["totals"]["events"] == 1


def test_it_fires_once_the_wrong_way_in_both():
    """The tuner reads high, so the right correction is positive (as
    c4fm_ppm's +0.58 ppm); the loop's reading is negative and both
    packages correct by about -0.54 ppm, once, at the same chunk, and
    then read about -40 Hz."""
    want, got, orch = _pair()
    ppm, ref = got["ppm"], want["ppm"]
    lines = ppm["lines"]
    assert len(lines) == 3 + TIMED
    t_fire = lines[FIRES_AT][0]
    assert [t for t, _ in ppm["corrections"]] == [t_fire] == \
        [t for t, _ in ref["corrections"]]
    assert -PPM < ppm["correction_ppm"] < -0.4
    assert ppm["correction_ppm"] == pytest.approx(
        ref["correction_ppm"], abs=TOLERANCE["ppm"]["correction_ppm"])
    threshold_hz = 0.4e-6 * orch.slots[0].frequency_hz
    errors = [e for _, _, e in lines]
    assert all(e < -threshold_hz for e in errors[1:FIRES_AT + 2])
    assert all(-threshold_hz / 2 < e < 0 for e in errors[FIRES_AT + 2:])
    assert [e for _, _, e in ref["lines"]] == pytest.approx(errors, abs=0.1)


def test_c4fm_ppm_chunk_hashes_are_cell_bytes():
    """The full-width cell's seven chunks, built here by ``cell_bytes``,
    hash to the file's entry."""
    want = json.loads(FILE.read_text())["banks"]["c4fm_ppm"]["digest"]
    chunks, _ = bench_torch.cell_bytes("c4fm_ppm")
    assert bench_torch._chunk_hashes(chunks) == want["chunks"]
    assert len(want["chunks"]) == 7
