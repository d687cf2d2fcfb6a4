"""A cell cut to a size the CPU runs in seconds: M = 64 bins at 800 kS/s
(the same 12.5 kHz channels), few slots, short chunks, the program on its
plain PyTorch versions."""
from __future__ import annotations

import types

import torch


# cells whose files the benchmark keeps but BENCHMARK.json does not list
# (PERF.md section 7): the tests still hold them
HELD = {"c4fm_site_31": {"name": "c4fm_site_31", "config": "p25p1_c4fm_12m8",
                         "traffic": "p25_site", "chips": 1}}


def spec(workload: str, slots: int = 12, blocks: int = 800,
         checked_slots: int = 8):
    from benchmark import run

    s = run.Spec(workload, HELD.get(workload))
    s.config = {**s.config, "channels": 64, "sample_rate_hz": 800000.0}
    s.mix = {**s.mix, "slots": min(s.mix["slots"], slots),
             "chunk_blocks": blocks, "replay_chunks": 4, "warmup_chunks": 2}
    s.checks = {**s.checks, "checked_chunks": 2,
                "checked_slots": checked_slots}
    return s


def measure(s, seed: int = 3, seconds: float = 1.0, trace: int = 0):
    """A run of the cut cell on the CPU (the window drives at least one
    chunk a kept sample can take)."""
    import sdrtrunk_tpu_torch as st
    from benchmark import run

    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace)
    with st.use_device("cpu"):
        return run.measure(s, args, torch.device("cpu"))
