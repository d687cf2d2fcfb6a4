"""The plain reference against the port's CPU path at a tiny cut: every
cell's run comes out correct, each number well inside its limit, and the
reference's designs equal the program's."""
import numpy as np
import pytest
import torch

from benchmark.reference import c4fm, dsp, nbfm
from benchmark.tests import tiny

torch.set_num_threads(1)


@pytest.mark.parametrize("workload,slots", [("c4fm_bank_1023", 12),
                                            ("nbfm_bank_1023", 40),
                                            ("c4fm_site_31", 12)])
def test_cut_cell_correct(workload, slots):
    res = tiny.measure(tiny.spec(workload, slots=slots), seed=2**31 + 3)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"wideband_msps", "setup_s"}


def test_designs_match_program():
    from sdrtrunk_tpu_torch.decoders.c4fm import C4FMDecoder
    from sdrtrunk_tpu_torch.decoders.nbfm import NBFMDecoder
    from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer

    ch = Channelizer.design(12.8e6, 12500.0, device="cpu")
    mine = dsp.channelizer_prototype(1024, 9).reshape(-1, 1024)
    assert np.array_equal(mine.astype(np.float32), ch.hmat.numpy())
    import json
    from benchmark.run import ROOT
    cfg = json.loads((ROOT / "benchmark/configs/p25p1_c4fm_12m8.json").read_text())
    chain = c4fm.Chain(cfg["decoder"], 25000.0)
    dec = C4FMDecoder(device="cpu")
    assert np.array_equal(chain.taps.astype(np.float32),
                          dec.baseband_taps.numpy())
    assert np.array_equal(chain.bank, dec.demod.bank.numpy())
    cfg = json.loads((ROOT / "benchmark/configs/nbfm_12m8.json").read_text())
    chain = nbfm.Chain(cfg["decoder"], 25000.0)
    dec = NBFMDecoder(device="cpu")
    assert np.array_equal(chain.taps.astype(np.float32),
                          dec.baseband_taps.numpy())
    assert np.array_equal(chain.resampler.astype(np.float32),
                          dec.resampler_taps.numpy())
    assert (chain.up, chain.down) == (dec.up, dec.down)


def test_sync_images():
    from sdrtrunk_tpu_torch.protocol.p25p1.bankframer import \
        SYNC_DIBIT_PATTERNS

    assert np.array_equal(c4fm.sync_dibits(), SYNC_DIBIT_PATTERNS)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0])
    got = dsp.round_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]
