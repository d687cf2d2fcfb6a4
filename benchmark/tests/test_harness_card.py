"""On the card (``python -m pytest --noconftest -m cuda benchmark/tests``):
a short run of each cell comes out correct at full width, and the
control fails the cell's limits there. Skips without a card."""
import pytest
import torch


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["c4fm_bank_1023", "nbfm_bank_1023",
                                      "c4fm_site_31"])
def test_cell_on_card(workload):
    _card()
    import types

    from benchmark import run
    from benchmark.tests.tiny import HELD

    spec = run.Spec(workload, HELD.get(workload))
    res = run.measure(spec, types.SimpleNamespace(seed=2**31 + 17,
                                                  seconds=2.0, trace=0),
                      torch.device("cuda", 0))
    assert res["correct"], res["checks"]
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["c4fm_bank_1023", "nbfm_bank_1023"])
def test_control_on_card(workload):
    _card()
    from benchmark import readings, run

    spec = run.Spec(workload)
    got, _ = readings.readings_of(spec, 2**31 + 19, 2.0,
                                  torch.device("cuda", 0), True)
    limits = spec.checks["limits"]
    assert all(got["program"][n] <= lim for n, lim in limits.items()), got
    assert any(got["control"][n] > lim for n, lim in limits.items()), got
