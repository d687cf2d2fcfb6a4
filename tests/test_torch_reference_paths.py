"""The main path's grant, the worker, the per-slot tier, banks= and the
monitor, held to the JAX package:

* the main path's scene (``c4fm_grant``: phase 5's 1023-slot C4FM bank,
  a control channel granting channel 600), here at 32 slots of the full
  scene (the granted channel kept), and the per-slot C4FM and P25 Phase 2
  cells at 4 of their 31 slots (the control, the channel it grants and 2
  voice channels; every slot of the per-slot tier runs the same code) and
  the multibank at its 31, each at 1 timed chunk of 1024 blocks (1250 for
  the multibank, whose LTR bank needs K a multiple of 25): the bytes and
  recipe (``bench_torch.cell_bytes``) drive the JAX Orchestrator
  (``tools/reference_digests.run_path``) and the port's
  (``bench_torch.scene_bank_<cell>``) on the CPU, and the port's digest is
  held to the JAX package's within the path's tolerance, events, the
  recording taps, the sample-rate change and the P25 Phase 2 keys
  included. These cuts reach the grant on every cell and, for P25 Phase
  2, the key learned by the control slot and handed to the granted one;
  the granted calls' voice starts at 1.3 s, beyond them;
* the worker (``host_process=True``) on the 32-slot cut: what its parent
  sees (``worker_view``) equals the in-process port's view (at full width
  both packages' workers part from their in-process banks on the granted
  slot, the file shows how; at the cut the untuned bin the granted slot
  reads until its tune takes effect carries no channel, so they agree);
* compare_digests finds a per-slot slot whose segments differ, and a
  step that differs; compare_monitor holds the PLL error within its
  bound and everything else equal;
* tests/torch_reference/paths_full_width.json (tools/reference_digests.py,
  the JAX package on the CPU) holds c4fm_grant (1023 slots, with the
  views of the reference's worker and of its in-process run), the
  per-slot and multibank cells (31) and the monitor
  (1023), each with its chunk hashes, digest, events and a tolerance with
  its why, in under 200 KB; beside them c4fm_ppm and the mixed monitor,
  which tests/test_torch_reference_ppm.py and
  tests/test_torch_reference_mixed_monitor.py hold.
"""
import copy
import importlib.util
import json
from pathlib import Path

import numpy as np
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

# path -> (its slots here, its full width, chunk blocks here)
PATHS = {"c4fm_grant": (32, 1023, 1024), "slots_c4fm": (4, 31, 1024),
         "slots_p25p2": (4, 31, 1024), "multibank": (31, 31, 1250)}

_RUNS: dict = {}


def _pair(path):
    """(the JAX digest, the port's CPU digest, the port's scene, the JAX
    run's worker view) of a path at its cut, one timed chunk; made once a
    path."""
    if path not in _RUNS:
        slots, _, blocks = PATHS[path]
        _, want, _, view = reference_digests.run_path(path, slots, 1,
                                                      blocks)
        with use_device("cpu"):
            scene = getattr(bench_torch, f"scene_bank_{path}")(
                slots, 1, blocks)
            bench_torch.run_bank(scene)
        got = bench_torch.bank_digest(scene.orch, scene.chunks,
                                      scene.segments, events=True,
                                      steps=scene.steps)
        _RUNS[path] = (want, got, scene, view)
    return _RUNS[path]


@pytest.mark.parametrize("path", list(PATHS))
def test_path_matches_the_reference(path):
    want, got, scene, _ = _pair(path)
    tolerance = reference_digests.PATH_TOLERANCES[path]
    held = bench_torch.compare_digests(got, want, tolerance)
    assert held["ok"], held
    assert held["chunks_equal"] and held["events_equal"]
    assert not held["whole_differing"]
    orch = scene.orch
    assert got["slots"] == PATHS[path][0] == len(orch.slots)
    # the grant followed: its event, and every slot active
    assert got["totals"]["events"] == 1 and not orch.skipped_grants
    assert sum(s.active for s in orch.slots) == len(orch.slots)
    assert got["totals"]["frames"] > 0
    assert orch.bank_mode == (path == "c4fm_grant")
    if path == "multibank":
        assert [s.kind for s in orch.slots].count("ltr") == 10
        assert got["totals"]["messages"] > 0
        assert got["totals"]["open"] == 10


def test_p25p2_key_learned_and_handed_to_the_grant():
    want, got, scene, _ = _pair("slots_p25p2")
    key = list(bench_torch.P25P2_KEY)
    assert got["keys"] == want["keys"] == [key] * len(scene.orch.slots)
    # the granted slot was free when ``prepare`` set the voice slots'
    # keys: its key is the one the control slot learned, handed over
    granted = scene.orch.slots[-1]
    assert granted.active and not granted.is_control
    assert granted.activated_at > 0
    assert granted.processor.state.scramble_key == bench_torch.P25P2_KEY
    control = scene.orch.slots[0]
    assert control.is_control
    assert control.processor.state.scramble_key == bench_torch.P25P2_KEY


def test_taps_and_rate_change_fields():
    want, got, scene, _ = _pair("slots_c4fm")
    orch, recipe = scene.orch, scene.recipe
    taps = got["taps"]
    assert taps == want["taps"]
    chunk = recipe["kwargs"]["chunk_samples"]
    assert taps["iq_samples"] == recipe["timed_chunks"] * chunk
    assert taps["iq_rate"] == int(recipe["sample_rate"])
    assert taps["bits_bytes"] > 0
    voice = next(s for s in orch.slots
                 if s.frequency_hz == pytest.approx(
                     recipe["steps"]["taps"]["slot_hz"]))
    assert taps["slot"] == voice.index
    change = got["rate_change"]
    assert change == want["rate_change"]
    assert change["sample_rate"] == recipe["sample_rate"] / 2
    assert change["bins"] == 512 == orch.rx.channelizer.channels
    assert change["chunk_samples"] == 16 * 512 == orch.chunk_samples
    assert change["slots"] == [[s.frequency_hz, s.active]
                               for s in orch.slots]
    assert all(active for _, active in change["slots"])
    assert change["plan_bins"] == orch.bins.tolist()
    assert change["metrics"]["active_channels"] == len(orch.slots)
    assert change["samples"] == orch.samples_processed
    assert "upload_ms" not in change["metrics"]


def test_worker_equals_the_in_process_view():
    _, _, scene, want_view = _pair("c4fm_grant")
    slots, _, blocks = PATHS["c4fm_grant"]
    own = bench_torch.worker_view(scene.orch, scene.chunks)
    assert own == want_view
    with use_device("cpu"):
        worker = bench_torch.scene_bank_worker(slots, 1, blocks)
        try:
            assert worker.orch.bank_host is not None
            assert worker.chunks is scene.chunks     # the kept bytes
            bench_torch.run_bank(worker)
            view = bench_torch.worker_view(worker.orch, worker.chunks)
        finally:
            worker.orch.close()
    held = bench_torch.compare_digests(
        view, own, reference_digests.WORKER_TOLERANCE)
    assert held["ok"], held
    assert view == own
    assert view["totals"]["segments"] > 0 and view["totals"]["events"] == 1


def test_compare_digests_finds_a_slot_and_a_step():
    want, got, _, _ = _pair("slots_c4fm")
    other = copy.deepcopy(want)
    other["segments_sha"][3] = "0" * bench_torch.SLOT_HASH_HEX
    held = bench_torch.compare_digests(got, other, {})
    assert not held["ok"]
    assert [d["slot"] for d in held["differing"]] == [3]
    assert set(held["differing"][0]) == {"slot", "segments_sha"}
    assert bench_torch.compare_digests(got, other,
                                       {"slots_differing": 1})["ok"]
    other = copy.deepcopy(want)
    other["rate_change"]["bins"] = 1024
    held = bench_torch.compare_digests(got, other, {"slots_differing": 1})
    assert not held["ok"] and set(held["whole_differing"]) == \
        {"rate_change"}
    assert held["events_equal"] and not held["differing"]


def test_compare_monitor_bounds_the_pll_error():
    want = _file()["banks"]["monitor"]["digest"]
    got = copy.deepcopy(want)
    assert bench_torch.compare_monitor(got, want, {})["ok"]
    line = next(i for i, v in enumerate(want["pll_error_hz"])
                if v is not None)
    got["pll_error_hz"][line] += 0.2
    held = bench_torch.compare_monitor(got, want, {"pll_error_hz": 0.1})
    assert not held["ok"] and not held["differing"]
    assert held["pll_error_hz_max"] == pytest.approx(0.2)
    assert bench_torch.compare_monitor(got, want,
                                       {"pll_error_hz": 0.25})["ok"]
    got = copy.deepcopy(want)
    got["calls"][0]["pcm_sha256"] = "0" * 64
    held = bench_torch.compare_monitor(got, want, {"pll_error_hz": 1.0})
    assert not held["ok"] and set(held["differing"]) == {"calls"}


def _file() -> dict:
    return json.loads(FILE.read_text())


def test_the_file_is_small_and_names_the_reference():
    assert FILE.stat().st_size < 200_000
    data = _file()
    assert list(data["banks"]) == [*bench_torch.PATHS, "monitor",
                                   "monitor_mixed"]
    # c4fm_ppm and the mixed monitor are held by their own files
    # (test_torch_reference_ppm.py, test_torch_reference_mixed_monitor.py)
    assert list(bench_torch.PATHS) == [*PATHS, "c4fm_ppm"]
    assert data["generated_by"] == "tools/reference_digests.py"
    assert data["numpy"] and data["jax"]
    for name, entry in data["banks"].items():
        assert entry["tolerance"] == \
            reference_digests.PATH_TOLERANCES[name]
        assert entry["tolerance"]["why"]


@pytest.mark.parametrize("path", list(PATHS))
def test_each_path_is_full_width_with_a_tolerance(path):
    entry = _file()["banks"][path]
    digest = entry["digest"]
    _, slots, timed, _ = bench_torch.PATHS[path]
    assert entry["slots"] == digest["slots"] == slots == PATHS[path][1]
    assert entry["timed_chunks"] == timed
    assert len(digest["chunks"]) == entry["warmup"] + timed
    assert entry["builder"] == f"bench_torch.py::scene_bank_{path}"
    fields = ["frames", "metrics", "segments", "segments_sha"]
    if path == "multibank":
        fields += ["messages", "audio_samples", "open", "rms"]
    if path == "slots_p25p2":
        fields.append("keys")
    for field in fields:
        assert len(digest[field]) == slots
    assert len(digest["events"]) == 64
    totals = digest["totals"]
    assert totals["events"] >= 1                   # the grant
    frames = "fragments_decoded" if path == "slots_p25p2" \
        else "frames_decoded"
    assert totals["frames"] == entry["record"][frames] > 0
    assert totals["segments"] == entry["record"]["audio_segments"] > 0
    if path == "slots_c4fm":
        assert digest["taps"]["iq_samples"] == \
            timed * entry["orchestrator"]["chunk_samples"]
        assert digest["rate_change"]["bins"] == 512
    if path == "slots_p25p2":
        assert digest["keys"] == [list(bench_torch.P25P2_KEY)] * slots
    if path == "c4fm_grant":
        view = entry["in_process_view"]
        assert entry["worker_builder"] == \
            "bench_torch.py::scene_bank_worker"
        assert entry["worker_tolerance"] == \
            reference_digests.WORKER_TOLERANCE
        assert view["chunks"] == digest["chunks"]
        assert view["frames"] == digest["frames"]
        assert view["events"] == digest["events"]
        assert view["totals"]["segments"] == totals["segments"]


def test_the_references_worker_parts_from_its_in_process_bank():
    """The reference's worker, on c4fm_grant's bytes, sees what its
    in-process bank sees but on the granted slot (the last: channel 600):
    the in-process bank routes the chunk in flight at the grant, framed
    from the slot's untuned bin (the DC bin, channel 511's carrier here),
    to the granted call, and the worker does not: 7 frames to 10, so the
    segment rows differ, their count equal."""
    entry = _file()["banks"]["c4fm_grant"]
    worker, in_process = entry["worker_view"], entry["in_process_view"]
    apart = bench_torch.compare_digests(worker, in_process, {})
    assert apart["chunks_equal"] and apart["events_equal"]
    assert apart["differing"] == [{"slot": 1022, "frames": [7, 10]}]
    assert set(apart["whole_differing"]) == {"segment_rows"}
    assert worker["totals"]["segments"] == in_process["totals"]["segments"]
    assert bench_torch.compare_digests(
        worker, worker, reference_digests.WORKER_TOLERANCE)["ok"]


def test_the_monitor_entry_is_the_clis_full_width_run():
    entry = _file()["banks"]["monitor"]
    digest = entry["digest"]
    grant = _file()["banks"]["c4fm_grant"]
    assert entry["builder"] == "bench_torch.py::monitor_inputs"
    assert entry["slots"] == digest["header"]["slots"] == 1023
    assert digest["header"]["bank_mode"] is True
    assert entry["chunks"] == len(digest["metrics"]) == \
        len(grant["digest"]["chunks"])
    argv = entry["argv"]
    assert argv[0] == "monitor" and "--bank" in argv
    assert argv[argv.index("--traffic-slots") + 1] == "1022"
    # every other setting at its default: PPM correction on, so every
    # line carries the control PLL's error; no correction fired
    assert all(v is not None for v in digest["pll_error_hz"])
    assert {m["correction_ppm"] for m in digest["metrics"]} == {0.0}
    assert len(digest["wave_sha256"]) == 64
    assert digest["summary"]["summary"] and digest["events"]
    assert any(e["details"].startswith("GRANT") for e in digest["events"])
    assert digest["calls"] and all(c["samples"] > 0
                                   for c in digest["calls"])
    assert np.isfinite([c["rms"] for c in digest["calls"]]).all()
