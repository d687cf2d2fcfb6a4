"""The control: the reference computed at the precision below the
configuration's (float32 with every filter operand rounded to TF32) in
the program's place fails the cell's limits, where the program passes
them, at a tiny cut on the CPU."""
import pytest
import torch

from benchmark.tests import tiny

torch.set_num_threads(1)


@pytest.mark.parametrize("workload,slots", [("c4fm_bank_1023", 12),
                                            ("nbfm_bank_1023", 40),
                                            ("c4fm_site_31", 12)])
def test_control_fails(workload, slots):
    import sdrtrunk_tpu_torch as st
    from benchmark import readings

    s = tiny.spec(workload, slots=slots)
    with st.use_device("cpu"):
        got, _ = readings.readings_of(s, 2**31 + 11, 1.0,
                                      torch.device("cpu"), True)
    limits = s.checks["limits"]
    assert all(got["program"][n] <= lim for n, lim in limits.items()), got
    assert any(got["control"][n] > lim for n, lim in limits.items()), got
