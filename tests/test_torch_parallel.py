"""The port's sharded channelizer pipeline (sdrtrunk_tpu_torch/parallel/
pipeline.py) over gloo ranks on the CPU, against the JAX package.

tests/test_parallel.py's four scenes (M = 16, 8 channels, inputs from
numpy seeds: sharded one-shot, streaming over 3 chunks, a tone that stays
phase-continuous across the chunk joins, a tone at DC) run at S = 2 and 4
ranks, each rank a JAX-free subprocess (tests/torch_parallel_rank.py)
that saves its channel group; the groups, stacked in rank order, are the
plan's channels in order. Each scene is held against

  * the port's single-device Channelizer + extract_channels on the whole
    capture: bit for bit (the shard runs the same operations on the same
    values: the branch sums per block, a batched IFFT per block, the mixer
    at the global block index as one float32 multiply and add);
  * the JAX ShardedChannelizerPipeline on a mesh of S of conftest's
    virtual CPU devices: within 1e-4 one-shot and 5e-5 streaming, the
    bounds of tests/test_parallel.py (XLA contracts the mixer's multiply
    and add differently inside shard_map).

A group of one rank runs in this process; a plan whose channel count does
not divide over the ranks raises ValueError, as the reference's does.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from sdrtrunk_tpu.dsp.channelizer import Channelizer as JChannelizer
from sdrtrunk_tpu.dsp.extract import plan_channels as jplan_channels
from sdrtrunk_tpu.parallel.pipeline import (
    ShardedChannelizerPipeline as JPipeline)
from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer
from sdrtrunk_tpu_torch.dsp.extract import extract_channels, plan_channels
from sdrtrunk_tpu_torch.parallel.pipeline import ShardedChannelizerPipeline
from torch_parallel_rank import FS, M, SCENES, run_scene, scene

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 120
JAX_TOL = {False: 1e-4, True: 5e-5}          # one-shot, streaming


@pytest.fixture(scope="module", params=[2, 4], ids=["S2", "S4"])
def ranks(request, tmp_path_factory):
    """(S, scene -> (chunks, C, K) the ranks' groups stacked, the refusal
    messages): S rank processes over one gloo group."""
    s = request.param
    out = tmp_path_factory.mktemp(f"ranks{s}")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_parallel_rank.py"),
         "--init-method", f"file://{out}/pg", "--world-size", str(s),
         "--rank", str(r), "--out", str(out)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(s)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=RANK_TIMEOUT_S)
            assert p.returncode == 0, err[-2000:]
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank of {s} did not finish in {RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.kill()
            p.communicate()
    groups = {name: np.concatenate(
        [np.load(out / f"{name}_r{r}.npy") for r in range(s)], axis=1)
        for name in SCENES}
    refused = [(out / f"refused_r{r}.txt").read_text() for r in range(s)]
    return s, groups, refused


def single_device(name: str) -> np.ndarray:
    """The port's single-device path on the whole capture, chunk by chunk
    with carried state: (chunks, C, K)."""
    offsets, chunks, streaming = scene(name)
    ch = Channelizer.design(FS, 12500.0, 9, channels=M, device="cpu")
    plan = plan_channels(ch, offsets)
    state, phase, outs = ch.init_state(), None, []
    for x in chunks:
        y, state = ch(torch.as_tensor(x), state)
        out, phase = extract_channels(y, plan, phase)
        outs.append(out.numpy())
    return np.stack(outs)


def jax_pipeline(name: str, s: int) -> np.ndarray:
    """The JAX ShardedChannelizerPipeline on S virtual CPU devices."""
    offsets, chunks, streaming = scene(name)
    ch = JChannelizer.design(FS, 12500.0, 9, channels=M)
    mesh = Mesh(np.array(jax.devices()[:s]), ("shard",))
    pipe = JPipeline(ch, jplan_channels(ch, offsets), mesh)
    if not streaming:
        return np.asarray(pipe.build()(jnp.asarray(chunks[0])))[None]
    run, carry, outs = pipe.build_streaming(), pipe.init_carry(), []
    for x in chunks:
        out, carry = run(jnp.asarray(x), carry)
        outs.append(np.asarray(out))
    return np.stack(outs)


def _hold(name: str, s: int, got: np.ndarray) -> None:
    want = single_device(name)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    ref = jax_pipeline(name, s)
    err = float(np.abs(got - ref).max())
    assert err < JAX_TOL[scene(name)[2]], (name, s, err)


def _dphi(stream: np.ndarray) -> np.ndarray:
    s = stream[64:]
    return np.angle(s[1:] * np.conj(s[:-1]))


def test_sharded_matches_single_device(ranks):
    s, groups, _ = ranks
    _hold("sharded", s, groups["sharded"])


def test_sharded_streaming_matches_single_device(ranks):
    s, groups, _ = ranks
    _hold("streaming", s, groups["streaming"])


def test_sharded_streaming_tone_phase_continuous(ranks):
    s, groups, _ = ranks
    got = groups["tone_continuous"]
    _hold("tone_continuous", s, got)
    dphi = _dphi(np.concatenate(list(got[:, 0])))
    # a continuous stream: a uniform tiny residual everywhere, the two
    # chunk joins and the shard joins included
    assert abs(np.mean(dphi)) < 1e-3
    assert np.max(np.abs(dphi - np.mean(dphi))) < 0.05


def test_sharded_tone_decodes(ranks):
    s, groups, _ = ranks
    got = groups["tone_dc"]
    _hold("tone_dc", s, got)
    assert abs(np.mean(_dphi(got[0, 0]))) < 1e-3


def test_uneven_channel_count_raises(ranks):
    s, _, refused = ranks
    assert all(f"channel count 7 must divide evenly over {s}" in r
               for r in refused), refused


@pytest.fixture
def group_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["sharded", "streaming"])
def test_world_size_one_in_process(group_of_one, name):
    """The degenerate ring: no halo message, rank 0 carries the stream's
    own tail; the all-to-all is a copy."""
    got = run_scene(name, 0, 1)
    np.testing.assert_array_equal(got, single_device(name))


def test_device_follows_the_rule(group_of_one):
    """No device given means cuda:<rank>: without CUDA that raises (there
    is no CPU fallback), and on a card this gloo group is refused for it
    (a CUDA pipeline runs over NCCL only)."""
    ch = Channelizer.design(FS, 12500.0, 9, channels=M, device="cpu")
    plan = plan_channels(ch, [0.0])
    raised, match = ((ValueError, "nccl") if torch.cuda.is_available()
                     else (RuntimeError, "cuda"))
    with pytest.raises(raised, match=match):
        ShardedChannelizerPipeline(ch, plan)
