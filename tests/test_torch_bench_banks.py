"""The port's digital bank benches (bench_torch.py) against the JAX
package's (bench.py) on the CPU, the same seeds and scenes: the C4FM bank
in int8 and in int4, DMR and P25 Phase 2, each at 32 slots (the fewest that
keep bank mode) and the smallest chunk of 1024 x chunk_blocks, in steps of
128 blocks, at which every slot decodes a frame in 3 warm-up chunks and one
timed chunk (1152, 1152, 640 and 640 blocks). Every field of the record
but the timing is equal: frames or fragments decoded, audio segments,
active channels, slots and chunk. So is the bank's digest
(``bench_torch.bank_digest``: the chunk hashes, and per slot the frames,
the metrics, the audio segments), the one chip_smoke.py's ``reference``
phase holds the card's decode to at 1023 slots.

tests/test_torch_bench.py holds the rest of the bench.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import bench_torch
from sdrtrunk_tpu_torch import use_device

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "reference_digests", ROOT / "tools" / "reference_digests.py")
reference_digests = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(reference_digests)

CASES = {
    "c4fm": ("scene_orchestrator_bank", {"chunk_blocks": 1152}),
    "c4fm_int4": ("scene_orchestrator_bank", {"chunk_blocks": 1152,
                                              "ingest": "int4"}),
    "dmr": ("scene_orchestrator_bank_dmr", {"chunk_blocks": 640}),
    "p25p2": ("scene_orchestrator_bank_p25p2", {"chunk_blocks": 640}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bank_bench_matches_the_reference(case):
    name, kw = CASES[case]
    kw = {"slots": 32, "timed_chunks": 1, **kw}
    own = reference_digests.BANKS[case][1]
    want, want_digest = reference_digests.run_reference(
        case, **{k: v for k, v in kw.items() if k not in own})
    with use_device("cpu"):
        scene = getattr(bench_torch, name)(**kw)
        got = bench_torch.run_bank(scene)
    timing = {"msps", "realtime_factor"}
    assert {k: v for k, v in got.items() if k not in timing} == \
        {k: v for k, v in want.items() if k not in timing}
    decoded = got.get("frames_decoded", got.get("fragments_decoded"))
    assert decoded >= kw["slots"]
    assert np.isfinite(got["msps"]) and got["msps"] > 0
    digest = bench_torch.bank_digest(scene.orch, scene.chunks,
                                     scene.segments)
    assert digest == want_digest
    assert digest["totals"]["frames"] == decoded
