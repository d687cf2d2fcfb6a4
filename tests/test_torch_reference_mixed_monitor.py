"""The mixed monitor and its mp2 calls, held to the JAX package.

``bench_torch.mixed_monitor_inputs`` rebuilds chip_smoke.py's
``monitor_mixed`` scene on the host: P25 Phase 1, DMR and LTR control
channels of the 1023-channel grid, both grants followed, the LTR channel
recording its calls as mp2 (so every call is written as mp2, the port's
rewritten ``audio/mpeg.py``) and the P25 channel its dibits (the bits
tap), run through ``monitor --traffic-slots 4`` (banks= of c4fm, dmr and
ltr, 5 slots each). Here it is cut to 10 chunks of 1024 x 1250 samples
(1 s, the LTR call alone; the P25 call starts at 2 s): the JAX CLI
(``tools/reference_digests.run_mixed_monitor``) and the port's
(``python -m sdrtrunk_tpu_torch.cli --platform cpu``) run on the same
wave, and the port's files and lines are held to the reference's
(``compare_monitor`` within ``PATH_TOLERANCES["monitor_mixed"]``): the
event log, the bits tap, the summary and every metrics line equal, the
calls' names, sidecars and frame counts equal, and their frames within
the bound.

The mp2 frames that differ have two causes, told apart by swapping the
PCM: the port's encoder on the reference's own PCM (its x4 resample sums
in another order than XLA's) and the LTR call's PCM, which banks= carries
as float audio some ulps from the reference's. Each call of the cut is
bounded by its own swap. The file's entry (the full scene, 6 chunks of
1024 x 6250) is checked too: its wave is ``mixed_monitor_inputs``' byte
for byte, and the reference's PCM of both its calls (the P25 call, which
starts at 2 s, outside the cut, among them) through each encoder gives
the file's frames and the port's within the file's per-call bounds.
"""
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import bench_torch
from sdrtrunk_tpu_torch import cli

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FILE = ROOT / "tests" / "torch_reference" / "paths_full_width.json"
_spec = importlib.util.spec_from_file_location(
    "reference_digests", ROOT / "tools" / "reference_digests.py")
reference_digests = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(reference_digests)

CUT = {"chunks": 10, "chunk_blocks": 1250}
# the cut's one call, the LTR channel's own from the start (28 frames),
# bounded by the rule of the full scene's LTR call
# (PATH_TOLERANCES["monitor_mixed"]): measured here, the port's encoder on
# the reference's PCM parts by 6 frames and the reference's encoder on the
# port's PCM by 9, the run by 7; the run's bound the two shares and 2, the
# encoder's its share and 2
CUT_CALL = "call_00001_0.00s.mp2"
CUT_MP2_FRAMES, CUT_ENCODER_FRAMES = 17, 8

_RUN: dict = {}


def _runs(tmp_path_factory):
    """(the reference's digest, its PCM a call, the port's digest, its
    PCM a call, the port's stdout lines); made once."""
    if not _RUN:
        want, _, want_pcm = reference_digests.run_mixed_monitor(
            tmp_path_factory.mktemp("reference"), **CUT)
        inputs = bench_torch.mixed_monitor_inputs(
            tmp_path_factory.mktemp("port"), **CUT)
        from sdrtrunk_tpu_torch.audio import recorder
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                bench_torch.mp2_pcm_kept(recorder) as pcm:
            rc = cli.main(["--platform", "cpu", *inputs["argv"]])
        assert rc == 0
        lines = out.getvalue().splitlines()
        got = bench_torch.monitor_digest(lines, inputs["audio"],
                                         inputs["events"], inputs["wave"])
        _RUN.update(want=want, want_pcm=want_pcm, got=got, pcm=pcm,
                    lines=lines)
    return _RUN


@pytest.fixture
def runs(tmp_path_factory):
    return _runs(tmp_path_factory)


def _cut_tolerance() -> dict:
    """The full scene's tolerance with the cut's call and its bounds."""
    return {**reference_digests.PATH_TOLERANCES["monitor_mixed"],
            "mp2_frames": {CUT_CALL: CUT_MP2_FRAMES},
            "mp2_encoder_frames": {CUT_CALL: CUT_ENCODER_FRAMES}}


def test_the_files_and_lines_match_the_reference(runs):
    want, got = runs["want"], runs["got"]
    held = bench_torch.compare_monitor(got, want, _cut_tolerance())
    assert held["ok"], held
    for field in ("wave_sha256", "header", "summary", "metrics", "events",
                  "bits"):
        assert got[field] == want[field], field
    assert held["pll_error_hz_max"] <= 0.1
    header = got["header"]
    assert header["bank_mode"] is False
    # both grants followed, each in the event log
    grants = sorted(r["details"] for r in got["events"]
                    if r["details"].startswith("GRANT"))
    assert grants == ["GRANT channel 600", "GRANT channel 610"]


def test_the_bits_tap_equals_the_references(runs):
    bits = runs["got"]["bits"]
    assert list(bits) == ["P25.bits"]
    assert bits["P25.bits"]["bytes"] > 0
    assert bits == runs["want"]["bits"]


def test_the_mp2_calls(runs):
    """Every call is whole MPEG-1 Layer II frames of the encoder's fixed
    header; names, sidecars and frame counts equal the reference's; the
    frames that differ are counted call by call by compare_monitor."""
    want, got = runs["want"]["calls"], runs["got"]["calls"]
    assert [c["name"] for c in got] == [c["name"] for c in want] == \
        [CUT_CALL]
    for g, w in zip(got, want):
        assert g["sidecar"] == w["sidecar"]
        assert g["frames"] == w["frames"] == len(g["frame_sha"]) > 0
        assert g["bytes"] == g["frames"] * bench_torch.MP2_FRAME_BYTES
    apart = bench_torch._mp2_frames_apart(got, want)
    assert set(apart) == {CUT_CALL}
    assert apart[CUT_CALL] <= CUT_MP2_FRAMES < got[0]["frames"]
    # a call garbled whole is outside the bound
    broken = [{**g, "frame_sha": ["0" * bench_torch.SLOT_HASH_HEX]
               * g["frames"]} for g in got]
    held = bench_torch.compare_monitor({**runs["got"], "calls": broken},
                                       runs["want"], _cut_tolerance())
    assert not held["ok"] and set(held["differing"]) == {"calls"}


def _encode(module, pcm) -> bytes:
    from sdrtrunk_tpu_torch import use_device
    with use_device("cpu"):
        return bench_torch.mp2_encode(module, pcm)


def test_the_pcm_swap_tells_the_causes_apart(runs):
    """Each run's mp2 bytes are its encoder on its PCM. The swap of the
    cut's call holds (``compare_mp2_swap``): the port's PCM within 1e-6
    of the reference's, the port's encoder on the reference's PCM within
    its bound. The run parts from the reference by no more than the two
    shares together: the encoder's (the port's encoder on the reference's
    PCM) and the PCM's (the reference's encoder on the port's PCM)."""
    from sdrtrunk_tpu.audio import mpeg as ref_mpeg
    from sdrtrunk_tpu_torch.audio import mpeg

    calls = {c["name"]: c for c in runs["got"]["calls"]}
    ref_calls = {c["name"]: c for c in runs["want"]["calls"]}
    assert sorted(runs["want_pcm"]) == sorted(runs["pcm"]) == sorted(calls)
    swap = bench_torch.mp2_swap(runs["want"]["calls"], runs["want_pcm"],
                                runs["pcm"], lambda x: _encode(mpeg, x))
    assert bench_torch.compare_mp2_swap(swap, _cut_tolerance()) == []
    for name, ref_pcm in runs["want_pcm"].items():
        own = runs["pcm"][name]
        want = bench_torch.mp2_encode(ref_mpeg, ref_pcm)
        assert bench_torch.mp2_frame_shas(want) == \
            ref_calls[name]["frame_sha"]
        port_on_own = bench_torch.mp2_frame_shas(_encode(mpeg, own))
        assert port_on_own == calls[name]["frame_sha"]
        pcm_share = bench_torch.mp2_frames_apart(
            bench_torch.mp2_frame_shas(bench_torch.mp2_encode(ref_mpeg,
                                                              own)),
            ref_calls[name]["frame_sha"])
        run_apart = bench_torch.mp2_frames_apart(
            port_on_own, ref_calls[name]["frame_sha"])
        assert run_apart <= swap[name]["encoder_apart"] + pcm_share
        if np.array_equal(own, ref_pcm):
            assert pcm_share == 0
            assert run_apart == swap[name]["encoder_apart"]


def test_the_swap_fails_a_pcm_or_encoder_fault(runs):
    """compare_mp2_swap fails a PCM off by more than its bound, a call the
    port did not write, an encoder past its bound and a card encoder
    whose bytes are not the CPU's."""
    from sdrtrunk_tpu_torch.audio import mpeg

    tol = _cut_tolerance()
    ref = runs["want_pcm"][CUT_CALL]

    def swap(own, encode=lambda x: _encode(mpeg, x), cpu=None):
        return bench_torch.mp2_swap(runs["want"]["calls"],
                                    runs["want_pcm"], own, encode, cpu)
    assert bench_torch.compare_mp2_swap(swap(runs["pcm"]), tol) == []
    assert bench_torch.compare_mp2_swap(
        swap({CUT_CALL: ref + np.float32(1e-5)}), tol)
    assert bench_torch.compare_mp2_swap(swap({}), tol)
    assert bench_torch.compare_mp2_swap(
        swap(runs["pcm"], encode=lambda x: _encode(mpeg, 0.5 * x)), tol)
    assert bench_torch.compare_mp2_swap(
        swap(runs["pcm"], cpu=lambda x: b""), tol)


def test_the_file_and_its_pcm_hold_both_calls():
    """The full scene's two calls: the reference's encoder on the kept
    PCM gives the file's frames exactly, and the port's encoder on it
    parts from them by the encoder's share alone, within the file's
    per-call bound (measured 4 of the P25 call's 20 frames, 11 of the LTR
    call's 84)."""
    from sdrtrunk_tpu.audio import mpeg as ref_mpeg
    from sdrtrunk_tpu_torch.audio import mpeg

    entry = json.loads(FILE.read_text())["banks"]["monitor_mixed"]
    calls = entry["digest"]["calls"]
    tol = entry["tolerance"]
    pcm = np.load(ROOT / entry["pcm"])
    assert [c["name"] for c in calls] == [reference_digests.MIXED_P25_CALL,
                                          reference_digests.MIXED_LTR_CALL]
    for c in calls:
        assert bench_torch.mp2_frame_shas(
            bench_torch.mp2_encode(ref_mpeg, pcm[c["name"]])) == \
            c["frame_sha"]
    swap = bench_torch.mp2_swap(calls, pcm, {c["name"]: pcm[c["name"]]
                                             for c in calls},
                                lambda x: _encode(mpeg, x))
    assert bench_torch.compare_mp2_swap(swap, tol) == []
    assert {n: r["encoder_apart"] for n, r in swap.items()} == {
        reference_digests.MIXED_P25_CALL: 4,
        reference_digests.MIXED_LTR_CALL: 11}


def test_the_files_wave_is_mixed_monitor_inputs(tmp_path):
    """The file's wave sha256 is that of ``mixed_monitor_inputs``' wave,
    built here at full width."""
    entry = json.loads(FILE.read_text())["banks"]["monitor_mixed"]
    inputs = bench_torch.mixed_monitor_inputs(tmp_path)
    assert bench_torch._file_sha(inputs["wave"]) == \
        entry["digest"]["wave_sha256"]
    argv = [a.replace(str(tmp_path), "<dir>") for a in inputs["argv"]]
    assert argv == entry["argv"]


def test_the_entry_is_the_full_scene():
    entry = json.loads(FILE.read_text())["banks"]["monitor_mixed"]
    digest = entry["digest"]
    assert entry["builder"] == "bench_torch.py::mixed_monitor_inputs"
    assert entry["tolerance"] == \
        reference_digests.PATH_TOLERANCES["monitor_mixed"]
    argv = entry["argv"]
    assert argv[0] == "monitor"
    assert argv[argv.index("--traffic-slots") + 1] == str(
        bench_torch.MIXED_SLOTS)
    assert argv[argv.index("--max-chunks") + 1] == str(
        bench_torch.MIXED_CHUNKS) == str(entry["chunks"])
    assert entry["slots"] == 3 * (1 + bench_torch.MIXED_SLOTS)
    calls = digest["calls"]
    assert len(calls) == 2 and all(c["name"].endswith(".mp2")
                                   for c in calls)
    assert sum(c["frames"] for c in calls) == 104
    pcm = np.load(ROOT / entry["pcm"])
    assert sorted(pcm.files) == sorted(c["name"] for c in calls)
    for c in calls:
        assert pcm[c["name"]].dtype == np.float32
        assert len(pcm[c["name"]]) == round(c["sidecar"]["duration"]
                                            * 8000.0)
    assert list(digest["bits"]) == ["P25.bits"]
    assert sorted(r["details"] for r in digest["events"]
                  if r["details"].startswith("GRANT")) == \
        ["GRANT channel 600", "GRANT channel 610"]
