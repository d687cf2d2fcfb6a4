"""The live recording taps on the CPU: IQ and bits recording started and
stopped mid-run, on the per-slot path and on the bank path, the port's
Orchestrator against the JAX one on tests/test_torch_orchestrator.py's
C4FM capture (a P25 control channel at +25 kHz, 800 kHz of int8 IQ, 4
slots, chunks of 64 * 256).

Each run takes the first 1.0 s: 2 chunks, then the wideband IQ tap and a
bits tap on the control slot start, 36 chunks, both stop, 12 more chunks.
The files must be byte for byte the JAX orchestrator's from the same
starting state, and hold what tests/test_monitor.py::
test_monitor_recording_taps checks of them: the bits re-frame (the
control channel's TSBKs are in them), and the IQ wave has the capture's
rate and the recorded chunks' samples.
"""
import numpy as np
import pytest
import torch

import test_orchestrator as to
from sdrtrunk_tpu.audio.recorder import BitsReader
from sdrtrunk_tpu.io.wave import read_complex_wave
from sdrtrunk_tpu.protocol.p25p1 import P25P1Framer
from test_torch_orchestrator import _capture
from test_torch_orchestrator_slots import run_pair

torch.set_num_threads(1)

CHUNK = 64 * 256
BEFORE, DURING, AFTER = 2, 36, 12


@pytest.fixture(scope="module")
def iq8():
    return _capture()[:(BEFORE + DURING + AFTER) * CHUNK]


def _record(orch, tmp, name):
    """Run the orchestrator with both taps on for the middle chunks;
    returns the (IQ path, bits path)."""
    iq_path, bits_path = tmp / f"{name}.wav", tmp / f"{name}.bits"
    orch.run(max_chunks=BEFORE)
    orch.start_iq_recording(iq_path)
    orch.start_bits_recording(0, bits_path)
    orch.run(max_chunks=DURING)
    orch.stop_iq_recording()
    orch.stop_bits_recording(0)
    orch.run(max_chunks=AFTER)
    return iq_path, bits_path


@pytest.fixture(scope="module", params=[False, True], ids=["slots", "bank"])
def taps(request, iq8, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("taps")
    jorch, _, orch, _ = run_pair(iq8, to.FS, to.CENTER_HZ, [to.CONTROL_OFF],
                                 run=False, slots=4, chunk_samples=CHUNK,
                                 bank_mode=request.param)
    return (request.param, _record(jorch, tmp, "jax"),
            _record(orch, tmp, "port"), orch)


def test_taps_write_the_reference_files(taps):
    bank, jax_files, port_files, orch = taps
    assert orch.bank_mode is bank
    for got, want in zip(port_files, jax_files):
        assert got.read_bytes() == want.read_bytes(), got.name
    assert orch.samples_processed == (BEFORE + DURING + AFTER) * CHUNK
    assert not orch._bits_recorders and orch._iq_writer is None


def test_recorded_bits_reframe(taps):
    _, _, (_, bits_path), _ = taps
    dibits = BitsReader.read(bits_path)
    # DURING chunks of 0.02 s at 4800 baud, less the loop's acquisition
    assert len(dibits) > 0.9 * DURING * CHUNK / to.FS * 4800
    msgs = P25P1Framer().process(dibits)
    assert sum(1 for m in msgs if m.duid.name == "TSBK") >= 4


def test_recorded_iq_wave(taps, iq8):
    _, _, (iq_path, _), _ = taps
    iq, rate = read_complex_wave(iq_path)
    assert rate == int(to.FS)
    assert len(iq) == DURING * CHUNK
    want = iq8[BEFORE * CHUNK:(BEFORE + DURING) * CHUNK] / 127.0
    np.testing.assert_allclose(iq.real, want[:, 0], atol=1 / 32767 + 1e-7)
    np.testing.assert_allclose(iq.imag, want[:, 1], atol=1 / 32767 + 1e-7)
