"""A PPM correction that fires, held to the JAX package in each host tier.

``c4fm_ppm`` is the main path's scene (``c4fm_grant``) captured through a
tuner reading ``bench_torch.PPM_ERROR`` ppm high: every channel row is
moved by its RF frequency times that error. Here it is cut to 16 slots of
the full scene (the control channel and the granted channel kept), 3 + 4
chunks of 1024 x 1024 samples, with an observation window of 0.16 s in
place of the full scene's 0.4 s: the control channel's PLL reads about
+266 Hz from the second chunk on, so the correction fires in the fourth
chunk (index 3), while the fifth is in flight, and every active slot is
retuned. The cut's control channel sends no grant before GRANT_FROM_S
(``p25_streams``' ``grant_from_s``), so that the grant comes after the
correction (in the sixth chunk) and ``_activate`` tunes the granted slot
with the correction in force. (The control loop acquires the +322 Hz
offset over the first 0.2 s, where the channelizer's last bits move its
trajectory: at 8 and 10 slots the second chunk's reading parts from the
reference's by 5.9 and 3.1 Hz, and at 10 and 12 a voice slot's frame
count by one. At 16 slots every line agrees, and the control and granted
slots; three voice slots count a frame apart or their metrics alone, as
the port's own inverse FFT in complex128 moves two of them. At full width
every line agrees from the first, at 0.41 s, past the acquisition.)

The same bytes and recipe drive the JAX Orchestrator
(``tools/reference_digests.run_recipe``, its device plan from copies, as
``plan_copied`` says) and the port's on the CPU in the four host tiers:
the in-process bank, ``host_process=True`` (the worker), the per-slot
tier (below 32 slots, ``bank_mode`` unset) and ``banks=``. In each the
port must give the reference's chunk, value, metrics lines, retuned plan
and decode, within ``CUT_TOLERANCE`` (the PPM step within
``PATH_TOLERANCES["c4fm_ppm"]["ppm"]``); and in each a retune made while
chunk n is processed takes effect from chunk n + 2: the line after the
correction still reads the uncorrected error, the next the corrected
one. The per-slot and ``banks=`` tiers read the control PLL from the
decoder state's own tensor, which the retune resets in place: the live
step hands out a copy (before, the port read 0 Hz on the line after the
correction).
"""
import copy
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import bench_torch
from sdrtrunk_tpu_torch import use_device

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "reference_digests", ROOT / "tools" / "reference_digests.py")
reference_digests = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(reference_digests)

SLOTS, TIMED, BLOCKS = 16, 4, 1024
WINDOW_S = 0.16                  # two chunks of 0.08192 s, less a little
GRANT_FROM_S = 0.35              # the first grant after the correction
FIRES_AT = 3                     # the chunk whose line shows the correction
GRANTED_AT = 5                   # the chunk whose processing follows it
TIERS = ("bank", "worker", "slots", "banks")
# the cut held slot by slot: the control and granted slots equal, the
# PPM step as at full width, and at most 3 voice slots a frame apart (the
# channelizer's last bits: measured, slots 9, 10 and 14 by one frame or
# their metrics alone in every tier; the port with its inverse FFT in
# complex128 gives slots 9 and 10 the reference's frames and metrics)
CUT_TOLERANCE = {"slots_differing": 3, "frames_per_slot": 1,
                 "may_differ": ["frames", "metrics"],
                 "ppm": reference_digests.PATH_TOLERANCES["c4fm_ppm"]["ppm"]}

_RUNS: dict = {}


def _cut() -> tuple:
    """The cut's (chunks, recipe), made once."""
    if "cut" not in _RUNS:
        _RUNS["cut"] = bench_torch._cell_c4fm_ppm(
            SLOTS, TIMED, BLOCKS, window_s=WINDOW_S,
            grant_from_s=GRANT_FROM_S)
    return _RUNS["cut"]


def _tier(recipe: dict, tier: str) -> dict:
    """The recipe in a host tier."""
    recipe = copy.deepcopy(recipe)
    kw = recipe["kwargs"]
    if tier == "worker":
        kw["host_process"] = True
    elif tier == "slots":
        del kw["bank_mode"]
    elif tier == "banks":
        del kw["bank_mode"], kw["decoder"]
        kw["banks"] = [["c4fm", kw.pop("slots")]]
    return recipe


def _port(recipe: dict, chunks):
    """The port's run of a recipe on the CPU, as ``run_recipe`` runs the
    reference's: (its digest, or its worker view with the steps under a
    worker, the Orchestrator after the run)."""
    from sdrtrunk_tpu_torch.runtime.identifiers import IdentifierCollection
    from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator
    from sdrtrunk_tpu_torch.runtime.traffic import FrequencyBand

    with use_device("cpu"):
        orch = bench_torch.orchestrator_from_recipe(
            recipe, chunks, Orchestrator, IdentifierCollection,
            FrequencyBand, device="cpu")
        try:
            scene = bench_torch.BankScene(
                recipe["kind"], orch, chunks, recipe["warmup"],
                recipe["timed_chunks"], bench_torch._segment_slots(orch),
                recipe=recipe)
            bench_torch.run_bank(scene)
            if orch.bank_host is not None:
                digest = {**bench_torch.worker_view(orch, chunks),
                          **scene.steps}
            else:
                digest = bench_torch.bank_digest(
                    orch, chunks, scene.segments, events=True,
                    steps=scene.steps)
        finally:
            orch.close()
    return digest, orch


def _pair(tier: str):
    """(the reference's digest, the port's, the port's Orchestrator) in a
    tier; made once a tier."""
    if tier not in _RUNS:
        chunks, recipe = _cut()
        recipe = _tier(recipe, tier)
        _, steps, want, view = reference_digests.run_recipe(recipe, chunks)
        if want is None:
            want = {**view, **steps}
        got, orch = _port(recipe, chunks)
        _RUNS[tier] = (want, got, orch)
    return _RUNS[tier]


@pytest.mark.parametrize("tier", TIERS)
def test_the_correction_matches_the_reference(tier):
    want, got, orch = _pair(tier)
    held = bench_torch.compare_digests(got, want, CUT_TOLERANCE)
    assert held["ok"], held
    assert held["chunks_equal"] and held["events_equal"]
    assert held["whole_differing"] == {}
    assert held["ppm"]["ok"] and not held["ppm"]["differing"]
    # the control slot and the granted slot equal
    assert {d["slot"] for d in held["differing"]} <= set(range(1, SLOTS - 1))
    assert held["totals"]["events"] == [1, 1]
    assert orch.bank_mode == (tier in ("bank", "worker"))
    assert ("metrics" in got) == (tier != "worker")   # a worker's view
    assert (orch.banks is not None) == (tier == "banks")
    # the grant followed: its event, and every slot active
    assert got["totals"]["events"] == 1
    assert sum(s.active for s in orch.slots) == SLOTS


@pytest.mark.parametrize("tier", TIERS)
def test_it_fires_once_and_retunes_from_chunk_n_plus_2(tier):
    want, got, orch = _pair(tier)
    ppm, ref = got["ppm"], want["ppm"]
    lines = ppm["lines"]
    assert len(lines) == 3 + TIMED
    t_fire = lines[FIRES_AT][0]
    assert [t for t, _ in ppm["corrections"]] == [t_fire] == \
        [t for t, _ in ref["corrections"]]
    # the monitor's entry is the correction subtracted: +PPM_ERROR seen
    (_, applied), = ppm["corrections"]
    assert ppm["correction_ppm"] == -applied == orch.correction_ppm
    assert 0.4 < ppm["correction_ppm"] < bench_torch.PPM_ERROR
    assert ppm["correction_ppm"] == pytest.approx(ref["correction_ppm"],
                                                  abs=1e-6)
    threshold_hz = 0.4e-6 * orch.slots[0].frequency_hz
    errors = [e for _, _, e in lines]
    assert all(e > threshold_hz for e in errors[1:FIRES_AT + 2])
    # written while chunk FIRES_AT + 1 was in flight: that chunk still
    # reads the uncorrected error, the next ones the corrected
    assert errors[FIRES_AT + 1] == pytest.approx(errors[FIRES_AT], abs=2.0)
    assert all(abs(e) < threshold_hz / 2 for e in errors[FIRES_AT + 2:])
    assert [c for _, c, _ in lines] == [0.0] * FIRES_AT + [round(
        ppm["correction_ppm"], 3)] * (len(lines) - FIRES_AT)


@pytest.mark.parametrize("tier", TIERS)
def test_every_active_slot_is_tuned_with_the_correction(tier):
    """The plan after the run: each slot's step is its residual offset
    after the correction, f * correction / 1e6 above its offset, at the
    channel rate; the slots retuned by the correction, the control slot
    and the granted slot (activated after it, tuned by ``_activate``)
    alike, the granted slot's row the reference's."""
    want, got, orch = _pair(tier)
    ppm = got["ppm"]
    plan = ppm["plan"]
    assert [row[0] for row in plan] == list(range(SLOTS))
    _, recipe = _cut()
    before = {recipe["center_hz"] + off for off in recipe["activate_hz"]}
    granted, = [s for s in orch.slots
                if not s.is_control and s.frequency_hz not in before]
    t_fire = ppm["corrections"][0][0]
    assert granted.active
    assert granted.activated_at == ppm["lines"][GRANTED_AT][0] > t_fire
    assert plan[granted.index][1] == granted.frequency_hz
    # the reference's row, its step moved by the corrections' difference
    row = want["ppm"]["plan"][granted.index]
    dppm = ppm["correction_ppm"] - want["ppm"]["correction_ppm"]
    assert plan[granted.index][:4] == row[:4]
    assert plan[granted.index][4] == pytest.approx(
        row[4] + 2 * np.pi * row[1] * dppm * 1e-6 / ppm["channel_rate"],
        abs=CUT_TOLERANCE["ppm"]["steps"])
    ch = orch.rx.channelizer
    for slot, f_hz, b0, b1, step in plan:
        offset = f_hz - orch.center_frequency_hz
        shifted = offset + ppm["correction_ppm"] * 1e-6 * f_hz
        assert b0 == b1 == ch.channel_for_frequency(shifted)
        residual = shifted - ch.center_frequency(b0)
        assert step == pytest.approx(
            2 * np.pi * residual / ppm["channel_rate"], abs=1e-8)


def test_the_live_step_hands_out_a_copy_of_the_pll():
    """On the per-slot tier and banks= the control PLL the host reads is a
    copy of the decoder state's tensor, not the tensor a retune resets in
    place."""
    from sdrtrunk_tpu_torch.runtime.identifiers import IdentifierCollection
    from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator
    from sdrtrunk_tpu_torch.runtime.traffic import FrequencyBand

    chunks, recipe = _cut()
    for tier in ("slots", "banks"):
        r = _tier(recipe, tier)
        with use_device("cpu"):
            orch = bench_torch.orchestrator_from_recipe(
                r, chunks, Orchestrator, IdentifierCollection,
                FrequencyBand, device="cpu")
            out, _ = orch._dispatch(orch._upload(orch._prepare(chunks[0])))
        pll = out["pll_freq"] if tier == "slots" else \
            out[f"{orch.slots[0].bank_key}/pll"]
        state = orch.state["dec"] if tier == "slots" else \
            orch.state[orch.slots[0].bank_key]
        assert pll.data_ptr() != state["psk"].pll_freq.data_ptr()
        before = pll.clone()
        orch._tune(0, orch.slots[0].frequency_hz
                   - orch.center_frequency_hz)
        assert torch.equal(pll, before)


def test_the_cell_at_full_width_in_the_file():
    """paths_full_width.json's c4fm_ppm (the JAX package at 1023 slots):
    the correction fires once, in the second warm-up chunk, the chunk
    after it still reads the uncorrected error; the plan holds every
    active slot."""
    import json
    entry = json.loads((ROOT / "tests" / "torch_reference"
                        / "paths_full_width.json").read_text()
                       )["banks"]["c4fm_ppm"]
    digest = entry["digest"]
    ppm = digest["ppm"]
    assert entry["slots"] == digest["slots"] == 1023
    assert entry["orchestrator"]["ppm_correction"] is True
    assert entry["orchestrator"]["ppm_observation_seconds"] == \
        bench_torch.PPM_WINDOW_S
    assert entry["tolerance"] == \
        reference_digests.PATH_TOLERANCES["c4fm_ppm"]
    assert len(ppm["corrections"]) == 1
    assert ppm["corrections"][0][0] == ppm["lines"][1][0]
    assert 0.4 < ppm["correction_ppm"] < bench_torch.PPM_ERROR
    errors = [e for _, _, e in ppm["lines"]]
    assert errors[2] == pytest.approx(errors[1], abs=2.0)
    assert all(abs(e) < 100.0 for e in errors[3:])
    assert len(ppm["plan"]) == 1023
    assert digest["totals"]["events"] == 1
