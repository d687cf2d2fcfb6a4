"""The port's parity harness (sdrtrunk_tpu_torch/parity.py) against the JAX
package's on the CPU, and the golden captures of tests/golden/.

* The float64 host oracles are the reference's code: on the same capture
  and the same float32 taps they give the same dibits, array for array.
* ``parity_report`` (seed 0 clean, seed 1 at 12 dB), ``parity_report_dmr``
  and ``parity_report_gardner`` equal the reference's reports key for
  key, the reference's ``tpu_*`` keys read as ``device_*``: the port's
  per-channel decode on the CPU (the plain loops) frames the same events
  with the same error rates as the reference's XLA scan.
* The golden .bits files are reproduced byte for byte by the port's
  oracle from the same fixed-seed transmissions, the port's device decode
  (here the plain loops) frames each capture's events in manifest.json,
  and ``write_golden`` into a temporary directory writes files equal in
  bytes to tests/golden/.
Nothing here writes into tests/golden/.
"""
import json
import os

import numpy as np
import pytest
import torch

from sdrtrunk_tpu import parity as jparity
from sdrtrunk_tpu.decoders.c4fm import C4FMDecoder as JC4FMDecoder
from sdrtrunk_tpu.decoders.dmr import DMRDecoder as JDMRDecoder
from sdrtrunk_tpu.decoders.lsm import LSMDecoder as JLSMDecoder
from sdrtrunk_tpu_torch import parity, use_device

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
JAX_DECODERS = {"c4fm": JC4FMDecoder, "dmr": JDMRDecoder,
                "lsm": JLSMDecoder}


def _as_port_keys(report: dict) -> dict:
    """The reference's report with ``tpu`` in its keys read as
    ``device``."""
    return {key.replace("tpu", "device"): value
            for key, value in report.items()}


@pytest.fixture(scope="module")
def captures():
    with use_device("cpu"):
        return parity.golden_captures()


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(GOLDEN, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("protocol", parity.GOLDEN_PROTOCOLS)
def test_oracle_matches_reference_oracle(captures, protocol):
    iq, dec, dibits = captures[protocol]
    taps = dec.baseband_taps.cpu().numpy()
    np.testing.assert_array_equal(
        taps, np.asarray(JAX_DECODERS[protocol]().baseband_taps))
    if protocol == "lsm":
        want = jparity.host_gardner_demod(iq, 25000.0, baseband_taps=taps)
    else:
        want = jparity.host_c4fm_demod(
            iq, 25000.0, sample_counter_gain=0.4 if protocol == "dmr"
            else 0.3, baseband_taps=taps)
    np.testing.assert_array_equal(dibits, want)


@pytest.mark.parametrize("protocol", parity.GOLDEN_PROTOCOLS)
def test_golden_bits_reproduced_and_framed(captures, manifest, protocol):
    from sdrtrunk_tpu_torch.audio.recorder import BitsReader

    iq, dec, dibits = captures[protocol]
    meta = manifest[protocol]
    golden_dibits = BitsReader.read(os.path.join(GOLDEN, f"{protocol}.bits"))
    assert len(dibits) == meta["dibits"]
    np.testing.assert_array_equal(golden_dibits[:len(dibits)], dibits)
    assert parity.golden_events(protocol, dibits) == meta["events"]
    # the device decode (the per-channel call; here the plain loop)
    device = parity.decode_dibits(dec, iq)
    assert parity.golden_events(protocol, device) == meta["events"]
    n = min(len(device), len(dibits))
    assert float(np.mean(device[100:n] == dibits[100:n])) > 0.999


def test_write_golden_equals_checked_in_files(tmp_path):
    with use_device("cpu"):
        manifest = parity.write_golden(str(tmp_path))
    for name in ("c4fm.bits", "dmr.bits", "lsm.bits", "manifest.json"):
        with open(os.path.join(GOLDEN, name), "rb") as f:
            want = f.read()
        assert (tmp_path / name).read_bytes() == want, name
    assert set(manifest) == set(parity.GOLDEN_PROTOCOLS)


REPORTS = {
    "c4fm_clean": (lambda m, **kw: m.parity_report(seed=0, n_frames=4, **kw)),
    "c4fm_12db": (lambda m, **kw: m.parity_report(seed=1, n_frames=4,
                                                  snr_db=12.0)),
    "dmr": (lambda m, **kw: m.parity_report_dmr()),
    "lsm": (lambda m, **kw: m.parity_report_gardner()),
}


@pytest.mark.parametrize("name", sorted(REPORTS))
def test_report_equals_reference(name, tmp_path):
    kw = ({"bits_path": str(tmp_path / "cap.bits")} if name == "c4fm_clean"
          else {})
    want = _as_port_keys(REPORTS[name](jparity, **kw))
    with use_device("cpu"):
        got = REPORTS[name](parity, **kw)
    assert got == want
    # the reference's own pass rule (its main())
    assert got["events_match"]
    assert got["frames_device"] == got["frames_expected"]
    if name != "lsm":
        assert got["device_ber_vs_truth"] < 0.01
    if name == "c4fm_clean":
        assert got["bits_roundtrip_ok"] and got["path_agreement"] == 1.0


def test_main_passes_on_the_cpu(capsys):
    with use_device("cpu"):
        assert parity.main(["--protocols", "dmr,lsm"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["protocol"] for r in rows] == ["dmr", "lsm-gardner"]


def test_reports_need_a_device_without_use_device():
    """Outside ``use_device("cpu")`` the reports decode on the card: on a
    machine without one they raise rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        parity.parity_report_dmr()
