"""The live step's constants on the device (``tracing.h2d_once``), on the
CPU at the cut sizes of ``benchmark/tests/tiny.py`` (M = 64 at 800 kS/s,
40 slots: the bank tier).

* Three chunks of the C4FM and the NBFM bank, the step's constants kept
  from the first chunk on, give the outputs and every state leaf, bit for
  bit, of the same chunks with the constants dropped before each step.
* The recurrence keys its four arrays by pole, block and block count: two
  poles at one shape, and a second block count, each copy their own, and
  a repeat copies nothing.
* ``compact_and_correlate`` copies one pattern set once, whichever array
  holds its bytes, and another set anew.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import sdrtrunk_tpu_torch as st  # noqa: E402
from benchmark.tests import tiny  # noqa: E402
from sdrtrunk_tpu_torch.dsp import iir  # noqa: E402
from sdrtrunk_tpu_torch.runtime import tracing  # noqa: E402
from sdrtrunk_tpu_torch.runtime.orchestrator import (  # noqa: E402
    compact_and_correlate, sync_patterns)
from sdrtrunk_tpu_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh():
    tracing.enable(False)
    tracing.drain()
    tracing.forget_constants()
    yield
    tracing.enable(False)
    tracing.drain()


def _steps(workload: str, forget: bool) -> list:
    """Three chunks of the cut cell's bank through ``_dispatch``; each
    step's outputs and state leaves, cloned."""
    from benchmark.adapter import System
    from benchmark.traffic import generator

    s = tiny.spec(workload, slots=40, blocks=400)
    dev = torch.device("cpu")
    with st.use_device("cpu"):
        replay = generator.build(s.config, s.mix, 2**31 + 7, dev)
        orch = System(s.config, replay, dev).orch
        got = []
        for chunk in replay.chunks[:3]:
            if forget:
                tracing.forget_constants()
            out, _ = orch._dispatch(orch._upload(orch._prepare(chunk)))
            got.append(([v.clone() for _, v in sorted(out.items())],
                        [leaf.clone() for leaf in tree_leaves(orch.state)]))
    return got


@pytest.mark.parametrize("workload", ["c4fm_bank_1023", "nbfm_bank_1023"])
def test_kept_constants_change_no_bit(workload):
    tracing.enable(True)
    kept = _steps(workload, forget=False)
    _, counts = tracing.drain()
    fresh = _steps(workload, forget=True)
    _, fresh_counts = tracing.drain()
    tracing.enable(False)
    # C4FM: the power monitor's 4 and the sync patterns; NBFM: the
    # squelch's 4 and the de-emphasis's 4; the slots' plan's 2 once
    per_step = 5 if workload.startswith("c4fm") else 8
    assert counts == {"h2d": per_step + 2, "h2d.cached": 2 * per_step}
    assert fresh_counts == {"h2d": 3 * per_step + 2}
    assert len(kept) == len(fresh) == 3
    for (out_k, state_k), (out_f, state_f) in zip(kept, fresh):
        assert len(out_k) == len(out_f) and len(state_k) == len(state_f)
        assert all(torch.equal(a, b) for a, b in zip(out_k, out_f))
        assert all(torch.equal(a, b) for a, b in zip(state_k, state_f))


def _pole(x, alpha):
    return iir.single_pole(x, alpha, torch.zeros(x.shape[:1]))


def test_two_poles_and_two_lengths_copy_their_own():
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((3, 128 * 4 - 5)),
                        dtype=torch.float32)
    longer = torch.as_tensor(rng.standard_normal((3, 128 * 7)),
                             dtype=torch.float32)
    squelch, deemph = 0.0004, iir.deemphasis_alpha(25000.0)
    cases = ((x, squelch), (x, deemph), (longer, squelch))
    tracing.enable(True)
    first = [_pole(*case) for case in cases]
    _, counts = tracing.drain()
    assert counts == {"h2d": 12}          # each pole and length: 4 arrays
    again = [_pole(*case) for case in cases]
    _, counts = tracing.drain()
    assert counts == {"h2d.cached": 12}
    tracing.enable(False)
    alone = []                            # from constants built for each
    for case in cases:
        tracing.forget_constants()
        alone.append(_pole(*case))
    for a, b, c in zip(first, again, alone):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(first[0], first[1])


def test_sync_patterns_copy_once_per_set():
    rng = np.random.default_rng(9)
    dib = torch.as_tensor(rng.integers(0, 4, (4, 300)), dtype=torch.uint8)
    valid = torch.as_tensor(rng.random((4, 300)) < 0.8)
    p25, p25_errors = sync_patterns("c4fm")
    dmr, dmr_errors = sync_patterns("dmr")
    tracing.enable(True)
    a = compact_and_correlate(dib, valid, 256, p25, p25_errors)
    b = compact_and_correlate(dib, valid, 256, p25.copy(), p25_errors)
    _, counts = tracing.drain()
    assert counts == {"h2d": 1, "h2d.cached": 1}
    compact_and_correlate(dib, valid, 256, dmr, dmr_errors)
    compact_and_correlate(dib, valid, 256, dmr.astype(np.int64),
                          dmr_errors)
    _, counts = tracing.drain()
    assert counts == {"h2d": 1, "h2d.cached": 1}
    tracing.enable(False)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
