"""``host_process=True`` on the CPU: the port's digital bank with its host
layer (bank framer, decoder states, traffic manager) in a worker process
(runtime/bank_worker.py, the reference's byte-for-byte copy), against the
in-process bank run, on the capture of tests/test_orchestrator_bank.py::
test_bank_worker_process_matches_in_process (tests/test_torch_orchestrator
.py's: a P25 control channel granting a traffic channel that carries one
voice call; 800 kHz of int8 IQ, 4 slots, chunks of 64 * 256), its first
2.0 s.

Three runs from one state (the JAX orchestrator's, carried across with
convert.py): the JAX in-process bank, the port's in-process bank and the
port's worker. The worker run must follow the grant, give the same events,
AudioSegments and frame counts, tear the traffic slot down, and keep the
metrics trace but for "events" (the parent's traffic manager holds none
when the worker owns it, as in the reference). close() may be called
twice. host_process is refused, as by the reference, for the per-slot
path, the analog and mixed banks and banks=.
"""
import json

import pytest
import torch

import test_orchestrator as to
from sdrtrunk_tpu_torch.convert import tree_map
from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator
from test_torch_orchestrator import _capture, _source, pair
from test_torch_orchestrator_slots import events, frames, segments

torch.set_num_threads(1)

_KEYS = ("t", "samples", "active_channels", "frames", "audio_segments")


@pytest.fixture(scope="module")
def runs():
    # the first 2.0 s: the call is over by 1.2 s and its slot torn down
    # 0.6 s after
    chunk = 64 * 256
    iq8 = _capture()[:int(2.0 * to.FS) // chunk * chunk]
    jorch, _, inproc, in_lines = pair(iq8)
    worker_lines = []
    worker = Orchestrator(
        _source(iq8), to.FS, to.CENTER_HZ, [to.CONTROL_OFF], slots=4,
        chunk_samples=64 * 256, idle_teardown_seconds=0.6, bank_mode=True,
        host_process=True, metrics_sink=worker_lines.append, device="cpu")
    worker.rx.load_state_dict(inproc.rx.state_dict())
    worker.state = tree_map(lambda t: t.clone(), inproc.state)
    try:
        jorch.run()
        inproc.run()
        worker.run()
        yield jorch, inproc, in_lines, worker, worker_lines
    finally:
        worker.close()


def test_worker_follows_the_grant_like_in_process(runs):
    jorch, inproc, _, worker, _ = runs
    assert worker.bank_host is not None and worker.bank_proc is None
    freq = to.CENTER_HZ + to.TRAFFIC_OFF
    assert not worker.skipped_grants
    assert [e for e in worker.events if e.frequency_hz == pytest.approx(freq)]
    assert events(worker) == events(inproc) == events(jorch)
    assert frames(worker) == frames(inproc) == frames(jorch)
    slot = next(s for s in worker.slots
                if not s.is_control and s.frequency_hz == freq)
    assert not slot.active


def test_worker_gives_the_same_audio(runs):
    _, inproc, _, worker, _ = runs
    segs = [s for s in worker.audio_segments if s.duration > 0]
    assert len(segs) == 1 and segs[0].duration == pytest.approx(18 * 0.020)
    assert segments(worker) == segments(inproc)
    assert to.GROUP in [i.value for i in segs[0].identifiers.all()
                        if i.role.name == "TO"]


def test_worker_metrics_trace(runs):
    _, _, in_lines, _, worker_lines = runs

    def trace(lines):
        return [{k: json.loads(line)[k] for k in _KEYS} for line in lines]
    assert trace(worker_lines) == trace(in_lines)
    assert {json.loads(line)["events"] for line in worker_lines} == {0}
    status = [s["metrics"] for s in runs[3].channel_status()]
    assert status == [None] * 4


def test_close_twice_stops_the_worker(runs):
    worker = runs[3]
    proc = worker.bank_host._proc
    assert proc.is_alive()
    worker.close()
    worker.close()
    assert worker.bank_host is None and not proc.is_alive()


@pytest.mark.parametrize("kwargs", [
    {"bank_mode": False}, {"slots": 4},
    {"bank_mode": True, "decoder": "nbfm"},
    {"bank_mode": True, "decoder": "ltr"},
    {"banks": [("c4fm", 4)]}],
    ids=["per-slot", "default-4-slots", "analog", "mixed", "banks"])
def test_host_process_refused_like_the_reference(kwargs):
    args = {"slots": 4, **kwargs}
    with pytest.raises(ValueError, match="host_process requires a digital "
                                         "single-kind bank mode"):
        Orchestrator(lambda n: None, to.FS, to.CENTER_HZ, [to.CONTROL_OFF],
                     host_process=True, device="cpu", **args)
