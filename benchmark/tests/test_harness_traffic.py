"""The generator: the same seed gives the same bytes, another seed other
bytes; the mix's slot assignment."""
import numpy as np
import pytest
import torch

from benchmark.tests import tiny
from benchmark.traffic import generator

torch.set_num_threads(1)


@pytest.mark.parametrize("workload", ["c4fm_bank_1023", "nbfm_bank_1023",
                                      "c4fm_site_31"])
def test_seed_gives_bytes(workload):
    s = tiny.spec(workload, blocks=64)
    a = generator.build(s.config, s.mix, 2**31 + 7, "cpu")
    b = generator.build(s.config, s.mix, 2**31 + 7, "cpu")
    c = generator.build(s.config, s.mix, 5, "cpu")
    assert len(a.chunks) == s.mix["replay_chunks"]
    assert all(x.dtype == np.int8 and x.shape == (64 * 64, 2)
               for x in a.chunks)
    assert all(np.array_equal(x, y) for x, y in zip(a.chunks, b.chunks))
    assert not all(np.array_equal(x, y) for x, y in zip(a.chunks, c.chunks))
    assert np.abs(np.concatenate(a.chunks)).max() == s.mix["peak"]


def test_assignment():
    mix = {"slots": 40, "signals": [{"count": 1}, {"share": 0.25},
                                    {"rest": True}]}
    owner = generator.assign(mix, np.random.default_rng(1))
    assert owner[0] == 0
    assert owner.count(1) == 10 and owner.count(2) == 29
    assert owner == generator.assign(mix, np.random.default_rng(1))


def test_placement():
    cfg = {"channels": 1024, "sample_rate_hz": 12.8e6}
    full = generator.slot_offsets(cfg, {"slots": 1023, "placement": "all"})
    assert len(set(np.round(full / 12500).astype(int) % 1024)) == 1023
    spread = generator.slot_offsets(cfg, {"slots": 31, "placement": "spread"})
    assert spread[0] == full[0] and spread[-1] == full[-1]
