"""The port's bench (bench_torch.py) against the JAX package's (bench.py) on
the CPU, inputs from the same seeds:

* ``_synth_iq8_chunks``: the int8 chunks equal byte for byte (the port
  synthesizes on the host with the reference's NumPy operations,
  ``synthesize_bank_host``);
* ``roofline_nbfm``: the same flops and bytes a sample and arithmetic
  intensity for the same (M, channels), to the reference's rounding;
* the NBFM bank bench (``bench_orchestrator_bank_nbfm``, its chunk fixed
  at 1024 x 6400) at 32 slots, the fewest that keep bank mode's width, and
  one timed chunk: the same record but for the timing, and the same
  digest (``bench_torch.bank_digest``);
* ``python -m sdrtrunk_tpu_torch.cli bench --small`` exits 0 on the CPU;
  its last line has bench.py's headline keys (read from bench.py's
  source) but for the two renamed links, and no leg holds an error;
* without CUDA the full bench and ``--smoke`` raise, naming CUDA, and a
  leg's error makes the bench exit 1 after it prints the headline.

tests/test_torch_bench_banks.py holds the digital bank benches.
"""
import ast
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
import bench_torch
from sdrtrunk_tpu.dsp.channelizer import Channelizer as JChannelizer
from sdrtrunk_tpu.receiver import WidebandReceiver as JWidebandReceiver
from sdrtrunk_tpu_torch import use_device
from sdrtrunk_tpu_torch.receiver import WidebandReceiver
from sdrtrunk_tpu_torch.signal.generators import c4fm_modulate

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "reference_digests", ROOT / "tools" / "reference_digests.py")
reference_digests = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(reference_digests)
RENAMED = {"live_c4fm_tunnel": "live_c4fm_h2d_mbps",
           "ici_predicted_efficiency": "nvlink_predicted_efficiency"}


@pytest.mark.parametrize("m,slots,blocks", [(64, 40, 256), (1024, 33, 128)])
def test_synth_iq8_chunks_match_the_reference(m, slots, blocks):
    rng = np.random.default_rng(3)
    hmat = np.asarray(JChannelizer.design(m * 12500.0, 12500.0).hmat)
    chunk = m * blocks
    k = 2 * chunk // m
    total_chunks = 3
    bins = rng.choice(np.arange(1, m), slots, replace=False)
    starts = rng.integers(0, 500, slots)
    base = c4fm_modulate(rng.integers(0, 4, 4000).astype(np.uint8),
                         sample_rate=25000.0).astype(np.complex64)
    assert len(base) >= 500 + total_chunks * k
    want = bench._synth_iq8_chunks(base, starts, bins, k, m, total_chunks,
                                   chunk, hmat)
    got = bench_torch._synth_iq8_chunks(base, starts, bins, k, m,
                                        total_chunks, chunk,
                                        torch.as_tensor(hmat))
    assert len(got) == total_chunks
    for g, w in zip(got, want):
        assert g.dtype == np.int8 and g.shape == w.shape == (chunk, 2)
        assert g.tobytes() == w.tobytes()
    # the peak over every chunk scaled to 118
    assert max(int(np.abs(w.astype(np.int16)).max()) for w in want) >= 117


@pytest.mark.parametrize("m", [64, 1024])
def test_roofline_counts_match_the_reference(m):
    fs = m * 12500.0
    offsets = [(i - m // 2 + 1) * 12500.0 for i in range(m - 1)]
    want = bench.roofline_nbfm(JWidebandReceiver(fs, offsets,
                                                 decoder="nbfm"), 100.0)
    got = bench_torch.roofline_nbfm(
        WidebandReceiver(fs, offsets, decoder="nbfm", device="cpu"), 100.0)
    assert set(got) == set(want)
    assert round(got["flops_per_sample"], 1) == want["flops_per_sample"]
    assert round(got["bytes_per_sample"], 1) == want["bytes_per_sample"]
    assert round(got["arithmetic_intensity"], 2) == \
        want["arithmetic_intensity"]
    assert "H100" in got["peak_assumption"]


def test_nbfm_bank_bench_matches_the_reference():
    want, want_digest = reference_digests.run_reference(
        "nbfm", slots=32, timed_chunks=1)
    with use_device("cpu"):
        scene = bench_torch.scene_orchestrator_bank_nbfm(slots=32,
                                                         timed_chunks=1)
        got = bench_torch.run_bank(scene)
    timing = {"msps", "realtime_factor"}
    assert {k: v for k, v in got.items() if k not in timing} == \
        {k: v for k, v in want.items() if k not in timing}
    assert got["channels_with_audio"] == 32
    # the digest: chunk hashes, per-slot audio samples, open segments and
    # RMS (within the reference file's 1e-3 relative; equal here)
    digest = bench_torch.bank_digest(scene.orch, scene.chunks,
                                     scene.segments)
    held = bench_torch.compare_digests(
        digest, want_digest, reference_digests.TOLERANCES["nbfm"])
    assert held["ok"] and held["differing"] == [], held
    assert digest["totals"]["open"] == 32


def _reference_headline_keys() -> list:
    """The keys of bench.py's ``headline`` dict, read from its source."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "headline")
    return [k.value for k in node.value.keys]


def test_bench_small_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "sdrtrunk_tpu_torch.cli", "bench", "--small"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    headline, full = json.loads(lines[-1]), json.loads(lines[-2])
    want = [RENAMED.get(k, k) for k in _reference_headline_keys()]
    assert list(headline) == want
    assert headline["nbfm_msps"] > 0 and headline["c4fm_msps"] > 0
    assert set(headline["scaling_retention_pct"]) == {"1", "2", "4", "8"}
    detail = full["detail"]
    assert detail["device"]["name"] == "cpu"
    assert detail["host"]["cores"] >= 1
    assert detail["orchestrator"]["iters"] == 2
    assert bench_torch._errors(detail) == []


def test_full_bench_and_smoke_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["bench_torch.py"], ["bench_torch.py", "--smoke"]):
        monkeypatch.setattr(sys, "argv", argv)
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_torch.main()


def test_a_leg_error_exits_1_after_the_headline(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["bench_torch.py", "--small"])
    monkeypatch.setattr(bench_torch, "bench_receiver",
                        lambda *a, **k: ({"msps": 1.0}, None))
    monkeypatch.setattr(bench_torch, "roofline_nbfm",
                        lambda rx, msps: {"mfu": 0.0})
    monkeypatch.setattr(bench_torch, "bench_orchestrator",
                        lambda **k: {"realtime_factor": 1.0})
    monkeypatch.setattr(bench_torch, "measure_scaling",
                        lambda: {"error": "RuntimeError: exit 1"})
    assert bench_torch.main() == 1
    out, err = capsys.readouterr()
    assert list(json.loads(out.strip().splitlines()[-1])) == \
        [RENAMED.get(k, k) for k in _reference_headline_keys()]
    assert ".scaling" in err
    # an isolated run's failed attempt counts too
    assert bench_torch._errors({"bank": {"realtime_factor": 1.2,
                                         "attempts": [1.2, {"error": "x"}]}}
                               ) == [".bank.attempts[1]"]
