"""Multi-process harness of the sharded channelizer pipeline (port of
sdrtrunk_tpu/parallel/multiprocess.py).

N processes form one torch.distributed group, one process a device; each
owns a contiguous TIME slice of the capture (one tuner or host feeding
its own slice) and runs ``ShardedChannelizerPipeline`` on it, the halo
ring and the all-to-all riding the group's backend: NCCL with ``--device
cuda``, gloo with ``--device cpu``. Every process verifies ITS channel
group against a single-device recompute (the port's ``Channelizer`` +
``extract_channels`` on the whole capture), once and over 3 streamed
chunks, so correctness needs no gather.

The reference gives each process 2 local XLA devices; here one rank is one
device, so ``devices == world_size`` and the scene has ``2 * world_size``
channels.

Run one worker per process:

    python -m sdrtrunk_tpu_torch.parallel.multiprocess \\
        --init-method tcp://127.0.0.1:PORT --world-size 2 --rank I \\
        --device cpu

Each prints one JSON line: {"process": I, "ok": bool, "max_err": ...,
"streaming_ok": ..., "msps_per_process": ...} and exits 1 unless ok.
tests/test_torch_multiprocess.py drives it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

TOL = 1e-3                       # the reference's bound


def worker(init_method: str, world_size: int, rank: int,
           device: str = "cuda", m: int = 32, blocks: int = 256,
           iters: int = 4) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    from .. import resolve_device
    from ..dsp.channelizer import Channelizer
    from ..dsp.extract import extract_channels, plan_channels
    from .pipeline import ShardedChannelizerPipeline

    if device == "cuda":
        resolve_device("cuda")          # raises without CUDA
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, world_size=world_size,
                            rank=rank)
    try:
        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        fs = m * 12500.0
        ch = Channelizer.design(fs, 12500.0, 9, channels=m, device=dev)
        c = 2 * world_size
        offsets = [((i % (m - 2)) - (m // 2 - 1)) * 12500.0
                   for i in range(c)]
        plan = plan_channels(ch, offsets)
        pipe = ShardedChannelizerPipeline(ch, plan, device=dev)
        run = pipe.build()
        rows = slice(rank * c // world_size, (rank + 1) * c // world_size)

        # the whole capture comes from a shared seed, so every process can
        # compute the single-device reference; each feeds only its slice
        n = world_size * m * blocks
        rng = np.random.default_rng(7)
        x_np = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
                ).astype(np.complex64)
        shard_len = n // world_size
        x = torch.as_tensor(x_np[rank * shard_len:(rank + 1) * shard_len],
                            device=dev)

        y = run(x)
        y_ref, _ = ch(torch.as_tensor(x_np, device=dev))
        streams_ref, _ = extract_channels(y_ref, plan)
        max_err = float((y - streams_ref[rows]).abs().max())

        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            y = run(x)
        sync()
        dt = time.perf_counter() - t0
        msps = n * iters / dt / 1e6 / world_size

        # live ingest: consecutive chunks of ONE stream, each process
        # feeding its slice of every chunk, the carry riding the joins
        stream_run = pipe.build_streaming()
        carry = pipe.init_carry()
        n_chunks = 3
        x_all = (rng.standard_normal(n_chunks * n)
                 + 1j * rng.standard_normal(n_chunks * n)
                 ).astype(np.complex64)
        state, phase = ch.init_state(), None
        stream_err = 0.0
        for j in range(n_chunks):
            chunk = x_all[j * n:(j + 1) * n]
            yj, carry = stream_run(torch.as_tensor(
                chunk[rank * shard_len:(rank + 1) * shard_len], device=dev),
                carry)
            y_ref_j, state = ch(torch.as_tensor(chunk, device=dev), state)
            ref_j, phase = extract_channels(y_ref_j, plan, phase)
            stream_err = max(stream_err,
                             float((yj - ref_j[rows]).abs().max()))

        result = {"process": rank,
                  "ok": bool(max_err < TOL and stream_err < TOL),
                  "max_err": max_err,
                  "streaming_ok": bool(stream_err < TOL),
                  "streaming_max_err": stream_err,
                  "streaming_chunks": n_chunks,
                  "msps_per_process": msps,
                  "devices": world_size, "channels": c, "samples": n,
                  "device": str(dev),
                  "backend": dist.get_backend()}
        print(json.dumps(result), flush=True)
        return result
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m sdrtrunk_tpu_torch.parallel.multiprocess")
    p.add_argument("--init-method", required=True,
                   help="tcp://host:port or file://path, the same for all")
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                   help="cuda runs over NCCL, cpu over gloo")
    p.add_argument("--blocks", type=int, default=256)
    p.add_argument("--m", type=int, default=32)
    args = p.parse_args(argv)
    r = worker(args.init_method, args.world_size, args.rank, args.device,
               m=args.m, blocks=args.blocks)
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
