"""The port's digital bank benches (bench_torch.py) against the JAX
package's (bench.py) on the CPU, the same seeds and scenes: the C4FM bank
in int8 and in int4, DMR and P25 Phase 2, each at 32 slots (the fewest that
keep bank mode) and the smallest chunk of 1024 x chunk_blocks, in steps of
128 blocks, at which every slot decodes a frame in 3 warm-up chunks and one
timed chunk (1152, 1152, 640 and 640 blocks). Every field of the record
but the timing is equal: frames or fragments decoded, audio segments,
active channels, slots and chunk.

tests/test_torch_bench.py holds the rest of the bench.
"""
import numpy as np
import pytest
import torch

import bench
import bench_torch
from sdrtrunk_tpu_torch import use_device

torch.set_num_threads(1)

CASES = {
    "c4fm": ("bench_orchestrator_bank", {"chunk_blocks": 1152}),
    "c4fm_int4": ("bench_orchestrator_bank", {"chunk_blocks": 1152,
                                              "ingest": "int4"}),
    "dmr": ("bench_orchestrator_bank_dmr", {"chunk_blocks": 640}),
    "p25p2": ("bench_orchestrator_bank_p25p2", {"chunk_blocks": 640}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bank_bench_matches_the_reference(case):
    name, kw = CASES[case]
    kw = {"slots": 32, "timed_chunks": 1, **kw}
    want = getattr(bench, name)(**kw)
    with use_device("cpu"):
        got = getattr(bench_torch, name)(**kw)
    timing = {"msps", "realtime_factor"}
    assert {k: v for k, v in got.items() if k not in timing} == \
        {k: v for k, v in want.items() if k not in timing}
    decoded = got.get("frames_decoded", got.get("fragments_decoded"))
    assert decoded >= kw["slots"]
    assert np.isfinite(got["msps"]) and got["msps"] > 0
