"""Time-sharded channelize + extract over the ranks of a torch.distributed
process group (port of sdrtrunk_tpu/parallel/pipeline.py).

The reference is one SPMD program over a jax ``Mesh``: ``shard_map`` with
``lax.ppermute`` for the halo and ``lax.all_to_all`` for the transpose.
Here every rank of a process group, one process a device, runs
``ShardedChannelizerPipeline`` on its own contiguous time slice of the
capture, and the collectives are torch.distributed's:

  * each rank channelizes its slice after an overlap-save HALO exchange:
    the last ``taps_per_channel * M`` samples go to rank r+1 over a ring of
    ``batch_isend_irecv``, the only traffic the filter bank needs;
  * it extracts every planned channel with the mixer and the two-bin
    rotator at the GLOBAL block index, so shard joins stay
    phase-continuous (``dsp/extract.py::extract_channels(start=)``);
  * one ``all_to_all_single`` transposes (channels, local time) so that
    rank g holds ALL time of channel group g, ready for a batched decoder.

The backend follows the device: NCCL for CUDA tensors, gloo for CPU ones;
a group with another backend raises, and nothing is picked by what
happens to work. The reference's ``input_sharding`` / ``output_sharding``
(``NamedSharding`` objects) have no torch meaning and are not ported: the
input is each rank's own slice and the output its own channel group.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..dsp.channelizer import Channelizer, channelize_core
from ..dsp.extract import ChannelPlan, extract_channels

__all__ = ["ShardedChannelizerPipeline"]

TWO_PI = 2.0 * np.pi


@dataclass
class ShardedChannelizerPipeline:
    """Channelize + extract across the ranks of ``group`` (None: the
    default group), run by every rank on its own device.

    ``device`` defaults to ``cuda:<rank % device count>`` (the local rank
    on one host) and raises without CUDA; pass ``device="cpu"`` for the
    gloo path. Each call takes the rank's time slice ``x_local`` (L,)
    complex64 on that device, L a multiple of M and at least the filter
    history, the same L on every rank, and returns the rank's channel
    group: rows ``r * C/S .. (r+1) * C/S`` of the plan, (C/S, K_total)
    complex64 with K_total = 2 * S * L / M.
    """
    channelizer: Channelizer
    plan: ChannelPlan
    group: object = None
    device: object = None

    def __post_init__(self):
        if not dist.is_initialized():
            raise RuntimeError("ShardedChannelizerPipeline needs an "
                               "initialized torch.distributed process group")
        self._group = self.group if self.group is not None \
            else dist.group.WORLD
        self.rank = dist.get_rank(self._group)
        if self.device is None:
            resolve_device("cuda")          # raises without CUDA
            self.device = f"cuda:{self.rank % torch.cuda.device_count()}"
        self.device = resolve_device(self.device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        want = "nccl" if self.device.type == "cuda" else "gloo"
        backend = dist.get_backend(self._group)
        if backend != want:
            raise ValueError(f"a {self.device.type} pipeline runs over "
                             f"{want}; the group's backend is {backend}")
        n = self.n_shards
        if self.plan.count % n:
            raise ValueError(
                f"channel count {self.plan.count} must divide evenly over "
                f"{n} devices")

    @property
    def n_shards(self) -> int:
        return dist.get_world_size(self._group)

    def _peer(self, offset: int) -> int:
        """The global rank of the group's rank r + offset, on the ring."""
        return dist.get_global_rank(
            self._group, (self.rank + offset) % self.n_shards)

    def _ring(self, tail: torch.Tensor) -> torch.Tensor:
        """Send this rank's tail to rank r+1 and return rank r-1's (on rank
        0 the last rank's: the stream's last ``hist`` samples). At world
        size 1 that is the rank's own tail, with no message (send and
        recv refuse the own rank)."""
        if self.n_shards == 1:
            return tail
        got = torch.empty_like(tail)
        ops = [dist.P2POp(dist.isend, torch.view_as_real(tail),
                          self._peer(1), self._group),
               dist.P2POp(dist.irecv, torch.view_as_real(got),
                          self._peer(-1), self._group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return got

    def _transpose(self, streams: torch.Tensor) -> torch.Tensor:
        """(C, K_local) -> this rank's (C/S, S * K_local): group g to rank
        g, the pieces received stacked by source rank, which is time
        order."""
        s = self.n_shards
        c, k_local = streams.shape
        send = streams.reshape(s, c // s, k_local).contiguous()
        got = torch.empty_like(send)
        dist.all_to_all_single(torch.view_as_real(got),
                               torch.view_as_real(send), group=self._group)
        return got.permute(1, 0, 2).reshape(c // s, s * k_local)

    def _check(self, x_local: torch.Tensor, hist: int) -> torch.Tensor:
        m = self.channelizer.channels
        if x_local.dim() != 1 or x_local.device != self.device:
            raise ValueError(f"x_local must be 1-D on {self.device}, got "
                             f"{tuple(x_local.shape)} on {x_local.device}")
        n = x_local.shape[0]
        if n % m or n < hist:
            raise ValueError(f"slice length {n} must be a multiple of "
                             f"M={m} and at least the {hist}-sample history")
        return x_local.to(torch.complex64).contiguous()

    def _shard(self, x_local, halo, hmat, mixer_phase, rot_k):
        """(b)-(d) on one rank: channelize after the halo, extract at the
        global block index, transpose."""
        y = channelize_core(torch.cat([halo, x_local]), hmat)
        streams, _ = extract_channels(y, self.plan, (mixer_phase, rot_k),
                                      start=self.rank * y.shape[0])
        return self._transpose(streams)

    def build(self):
        """Returns fn: x_local (L,) -> the rank's (C/S, K_total) streams
        of one capture: rank 0's halo is zeros and the mixer starts at
        phase 0 (the reference's build())."""
        ch = self.channelizer
        hist = ch.taps_per_channel * ch.channels
        hmat = ch.hmat.to(self.device)
        phase0 = torch.zeros((self.plan.count,), dtype=torch.float32,
                             device=self.device)

        def run(x_local: torch.Tensor) -> torch.Tensor:
            x_local = self._check(x_local, hist)
            halo = self._ring(x_local[-hist:])
            if self.rank == 0:
                halo = torch.zeros_like(halo)
            return self._shard(x_local, halo, hmat, phase0, 0)

        return run

    # ---------------------------------------------------------- streaming

    def init_carry(self) -> dict:
        """Zero carry for build_streaming(): the channelizer history (the
        stream's ``taps_per_channel * M`` samples before the next chunk;
        meaningful on rank 0, which alone reads it), the per-channel mixer
        phase and the two-bin rotator index, the state the single-device
        streaming path carries (Channelizer state + extract_channels
        phase), so sharded streaming equals it chunk for chunk."""
        ch = self.channelizer
        hist = ch.taps_per_channel * ch.channels
        return {
            "tail": torch.zeros((hist,), dtype=torch.complex64,
                                device=self.device),
            "mixer_phase": torch.zeros((self.plan.count,),
                                       dtype=torch.float32,
                                       device=self.device),
            "rot_k": 0,
        }

    def build_streaming(self):
        """Returns fn: (x_local (L,), carry) -> (the rank's (C/S, K_total)
        streams, new carry). Consecutive calls are one continuous stream:
        rank 0's halo is the carried tail, and the ring's wrap-around
        message, the last rank's tail, is the stream's last samples, so
        rank 0 keeps it as the next chunk's; mixer and rotator run at the
        global stream position."""
        ch = self.channelizer
        m = ch.channels
        hist = ch.taps_per_channel * m
        hmat = ch.hmat.to(self.device)
        step = torch.as_tensor((TWO_PI * self.plan.offsets / self.plan.rate)
                               .astype(np.float32), device=self.device)

        def run(x_local: torch.Tensor, carry: dict):
            x_local = self._check(x_local, hist)
            got = self._ring(x_local[-hist:])
            halo = carry["tail"] if self.rank == 0 else got
            out = self._shard(x_local, halo, hmat, carry["mixer_phase"],
                              carry["rot_k"])
            k_total = 2 * self.n_shards * x_local.shape[0] // m
            new_carry = {
                "tail": got if self.rank == 0 else carry["tail"],
                "mixer_phase": torch.remainder(
                    carry["mixer_phase"] + step * k_total, TWO_PI),
                "rot_k": (carry["rot_k"] + k_total) % 4,
            }
            return out, new_carry

        return run
