"""One rank of the port's sharded channelizer pipeline over gloo, for
tests/test_torch_parallel.py; imports no JAX.

    python tests/torch_parallel_rank.py --init-method file://PATH \\
        --world-size S --rank R --out DIR

Runs every scene of ``SCENES`` (tests/test_parallel.py's four, built from
numpy seeds) through ``ShardedChannelizerPipeline`` on the CPU and saves
the rank's channel group of each as ``DIR/<scene>_r<R>.npy``, (chunks, C/S,
K) complex64; ``DIR/refused_r<R>.txt`` holds the ValueError a plan of 7
channels gets at this world size. The test imports ``SCENES`` for the
same inputs.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

M = 16
FS = M * 12500.0
OFFSETS = [2 * 12500.0, 5 * 12500.0 + 3000.0, -3 * 12500.0, 7 * 12500.0,
           -6 * 12500.0 - 2000.0, 12500.0, 4 * 12500.0, -12500.0]
TONE_HZ = 5 * 12500.0 + 3000.0
TONE_PLAN = [TONE_HZ] + [i * 12500.0 for i in (1, 2, 3, 4, 6, 7, -2)]


def _noise(rng, n: int) -> np.ndarray:
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64)


def _tone(n: int) -> np.ndarray:
    from sdrtrunk_tpu_torch.signal import generators
    return np.asarray(generators.tone(TONE_HZ, FS, n), np.complex64)


def scene(name: str) -> tuple[list, list, bool]:
    """(offsets, chunks, streaming): the capture of tests/test_parallel.py's
    test of that name, in chunks for the streaming ones."""
    if name == "sharded":
        rng = np.random.default_rng(0)
        return OFFSETS, [_noise(rng, 8 * M * 32)], False
    if name == "streaming":
        rng = np.random.default_rng(3)
        return OFFSETS, [_noise(rng, 8 * M * 16) for _ in range(3)], True
    if name == "tone_continuous":
        n = 8 * M * 32
        x = _tone(3 * n)
        return TONE_PLAN, [x[j * n:(j + 1) * n] for j in range(3)], True
    if name == "tone_dc":
        return TONE_PLAN, [_tone(8 * M * 64)], False
    raise ValueError(name)


SCENES = ("sharded", "streaming", "tone_continuous", "tone_dc")


def run_scene(name: str, rank: int, world_size: int) -> np.ndarray:
    """The rank's channel group of each chunk, (chunks, C/S, K)."""
    import torch

    from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer
    from sdrtrunk_tpu_torch.dsp.extract import plan_channels
    from sdrtrunk_tpu_torch.parallel.pipeline import (
        ShardedChannelizerPipeline)

    offsets, chunks, streaming = scene(name)
    ch = Channelizer.design(FS, 12500.0, 9, channels=M, device="cpu")
    pipe = ShardedChannelizerPipeline(ch, plan_channels(ch, offsets),
                                      device="cpu")
    part = len(chunks[0]) // world_size

    def mine(x):
        return torch.as_tensor(x[rank * part:(rank + 1) * part])
    if not streaming:
        return pipe.build()(mine(chunks[0])).numpy()[None]
    run, carry, outs = pipe.build_streaming(), pipe.init_carry(), []
    for x in chunks:
        out, carry = run(mine(x), carry)
        outs.append(out.numpy())
    return np.stack(outs)


def refusal() -> str:
    """The ValueError of a plan whose 7 channels do not divide over the
    group, or '' if none was raised."""
    from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer
    from sdrtrunk_tpu_torch.dsp.extract import plan_channels
    from sdrtrunk_tpu_torch.parallel.pipeline import (
        ShardedChannelizerPipeline)

    ch = Channelizer.design(FS, 12500.0, 9, channels=M, device="cpu")
    try:
        ShardedChannelizerPipeline(ch, plan_channels(ch, OFFSETS[:7]),
                                   device="cpu")
    except ValueError as e:
        return str(e)
    return ""


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--init-method", required=True)
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=args.init_method,
                            world_size=args.world_size, rank=args.rank)
    try:
        for name in SCENES:
            np.save(os.path.join(args.out, f"{name}_r{args.rank}.npy"),
                    run_scene(name, args.rank, args.world_size))
        with open(os.path.join(args.out, f"refused_r{args.rank}.txt"),
                  "w") as f:
            f.write(refusal())
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
