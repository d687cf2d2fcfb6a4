"""The port's two-process harness (python -m
sdrtrunk_tpu_torch.parallel.multiprocess) over gloo on the CPU: each
process feeds its time slice of the seed-7 capture and verifies its own
channel group against a single-device recompute, once and over 3
streamed chunks. No efficiency bound: a throughput ratio on a shared CPU
measures the load, not the pipeline."""
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 120


def test_two_process_pipeline(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sdrtrunk_tpu_torch.parallel.multiprocess",
         "--device", "cpu", "--init-method", f"file://{tmp_path}/pg",
         "--world-size", "2", "--rank", str(i)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            assert p.returncode == 0, err[-2000:]
            results.append(json.loads(out.strip().splitlines()[-1]))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a worker did not finish in {WORKER_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.kill()
            p.communicate()

    assert [r["process"] for r in results] == [0, 1]
    for r in results:
        assert r["ok"] and r["streaming_ok"], r
        assert r["devices"] == 2 and r["channels"] == 4
        assert r["samples"] == 2 * 32 * 256
        assert r["streaming_chunks"] == 3
        assert r["backend"] == "gloo"
        assert r["msps_per_process"] > 0


def test_worker_refuses_cuda_without_a_card(tmp_path):
    """--device cuda (the default) runs over NCCL on the card; without one
    it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "-m", "sdrtrunk_tpu_torch.parallel.multiprocess",
         "--init-method", f"file://{tmp_path}/pg", "--world-size", "1",
         "--rank", "0"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=WORKER_TIMEOUT_S)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert not proc.stdout.strip()
