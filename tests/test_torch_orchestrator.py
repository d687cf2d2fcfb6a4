"""The whole slice on the CPU: the port's bank-mode Orchestrator against
the JAX one on the capture of tests/test_orchestrator_bank.py.

800 kHz of int8 IQ, 4 slots in bank mode: a P25 control channel
broadcasts IDEN_UP and a group-voice grant; the grant must activate a
traffic slot while running, the call there must become one AudioSegment
(18 IMBE frames of 20 ms, talkgroup 0x457) and the slot must be torn down
when the call goes idle. Both orchestrators start from one state, carried
across with convert.py, and must give the same events, frame counts,
audio and metrics trace.

ingest_format="int4", the reference's packed 4-bit wire format: the
host-side pack equals the reference's ``_prepare`` byte for byte (int8,
float and complex input), the unpack equals the reference's ``ingest``
for every byte value, and the reference's own int4 scene
(tests/test_orchestrator_bank.py::test_int4_ingest_decodes_like_int8)
run through the port passes that test's assertions against the port's
int8 run above.
"""
import json

import jax
import numpy as np
import pytest
import torch

import test_orchestrator as to
from sdrtrunk_tpu.parallel.boundary import complex_flags, unpack_tree
from sdrtrunk_tpu.runtime.identifiers import IdentifierRole
from sdrtrunk_tpu.runtime.orchestrator import Orchestrator as JOrchestrator
from sdrtrunk_tpu.signal import generators
from sdrtrunk_tpu_torch.convert import (params_from_numpy,
                                        receiver_state_from_numpy)
from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator

torch.set_num_threads(1)

_TRACE_KEYS = ("t", "samples", "active_channels", "frames", "events",
               "audio_segments")


def _capture() -> np.ndarray:
    total_dibits = int(2.6 * to.BAUD)
    rng = np.random.default_rng(7)
    voice = [rng.integers(0, 2, (9, 144)).astype(np.uint8) for _ in range(2)]
    wide = None
    for offset, dibits in (
            (to.CONTROL_OFF, to._control_stream(total_dibits)),
            (to.TRAFFIC_OFF, to._traffic_stream(total_dibits, voice))):
        iq = generators.c4fm_modulate(dibits, to.FS)
        if wide is None:
            n = len(iq) // 64 * 64
            wide = np.zeros(n, np.complex64)
        t = np.arange(n) / to.FS
        wide += (iq[:n] * np.exp(2j * np.pi * offset * t)).astype(np.complex64)
    scale = float(np.max(np.abs(np.stack([wide.real, wide.imag]))))
    return np.clip(np.stack([wide.real, wide.imag], -1) / scale * 120.0,
                   -127, 127).astype(np.int8)


def _source(iq8):
    pos = 0

    def read(num):
        nonlocal pos
        chunk = iq8[pos:pos + num]
        pos += num
        return chunk if len(chunk) else None

    return read


def pair(iq8, control=(to.CONTROL_OFF,)):
    """A JAX and a port orchestrator on one capture, the port's started
    from the JAX one's design arrays and receiver state; returns (JAX
    orchestrator, its metrics lines, port orchestrator, its lines)."""
    kw = dict(slots=4, chunk_samples=64 * 256, idle_teardown_seconds=0.6,
              bank_mode=True)
    j_lines, t_lines = [], []
    jorch = JOrchestrator(_source(iq8), to.FS, to.CENTER_HZ, list(control),
                          metrics_sink=j_lines.append, **kw)
    torch_orch = Orchestrator(_source(iq8), to.FS, to.CENTER_HZ,
                              list(control), metrics_sink=t_lines.append,
                              device="cpu", **kw)
    # one starting point: the JAX orchestrator's design arrays and its
    # (float-pair packed) receiver state after the control slot was tuned
    jrx = jorch.rx
    torch_orch.rx.load_state_dict(params_from_numpy(
        jrx.channelizer.hmat, jrx.decoder.baseband_taps,
        jrx.decoder.demod.bank))
    flags = complex_flags(jrx.init_state())
    tree = jax.tree.map(np.asarray, unpack_tree(jorch.state, flags))
    torch_orch.state = receiver_state_from_numpy(tree, device="cpu")
    np.testing.assert_array_equal(torch_orch.bins, jorch.bins)
    np.testing.assert_array_equal(torch_orch.steps, jorch.steps)
    return jorch, j_lines, torch_orch, t_lines


@pytest.fixture(scope="module")
def runs():
    jorch, j_lines, torch_orch, t_lines = pair(_capture())
    jorch.run()
    torch_orch.run()
    return jorch, j_lines, torch_orch, t_lines


def _events(orch):
    # by name: the port's DecodeEventType is its own copy of the enum
    return [(e.event_type.name, e.frequency_hz, round(e.time_start, 6),
             e.details) for e in orch.events]


def test_same_events_and_grant_followed(runs):
    jorch, _, orch, _ = runs
    freq = to.CENTER_HZ + to.TRAFFIC_OFF
    assert not orch.skipped_grants
    assert [e for e in orch.events if e.frequency_hz == pytest.approx(freq)]
    assert _events(orch) == _events(jorch)


def test_same_frame_counts(runs):
    jorch, _, orch, _ = runs
    got = [s["frames"] for s in orch.channel_status()]
    assert got == [s["frames"] for s in jorch.channel_status()]
    assert got[0] > 0 and sum(got[1:]) >= 4


def test_voice_becomes_one_audio_segment(runs):
    jorch, _, orch, _ = runs
    segs = [s for s in orch.audio_segments if s.duration > 0]
    ref = [s for s in jorch.audio_segments if s.duration > 0]
    assert len(segs) == len(ref) == 1
    assert segs[0].duration == pytest.approx(18 * 0.020)
    assert segs[0].duration == ref[0].duration
    tgs = [i.value for i in segs[0].identifiers.all()
           if i.role.name == IdentifierRole.TO.name]
    assert to.GROUP in tgs


def test_same_metrics_trace(runs):
    _, j_lines, _, t_lines = runs
    trace = [{k: json.loads(line)[k] for k in _TRACE_KEYS}
             for line in t_lines]
    assert trace == [{k: json.loads(line)[k] for k in _TRACE_KEYS}
                     for line in j_lines]
    active = [m["active_channels"] for m in trace]
    assert max(active) == 2 and active[-1] == 1


def test_traffic_slot_torn_down(runs):
    _, _, orch, _ = runs
    freq = to.CENTER_HZ + to.TRAFFIC_OFF
    assert freq not in orch.traffic.active
    slot = next(s for s in orch.slots
                if not s.is_control and s.frequency_hz == freq)
    assert not slot.active


def test_bounded_run_consumes_exactly_max_chunks():
    iq8 = np.zeros((64 * 64 * 10, 2), np.int8)
    reads = []

    def source(num):
        reads.append(num)
        return iq8[:num]

    orch = Orchestrator(source, to.FS, to.CENTER_HZ, [to.CONTROL_OFF],
                        slots=4, chunk_samples=64 * 64, bank_mode=True,
                        ppm_correction=False, device="cpu")
    orch.run(max_chunks=3)
    assert len(reads) == 3
    assert orch.samples_processed == 3 * 64 * 64


def test_run_chunk_processes_one_chunk():
    """The un-pipelined entry: one chunk through device step, transfer,
    bank framing and the metrics sink."""
    lines = []
    orch = Orchestrator(lambda n: None, to.FS, to.CENTER_HZ,
                        [to.CONTROL_OFF], slots=4, chunk_samples=64 * 64,
                        bank_mode=True, ppm_correction=False,
                        metrics_sink=lines.append, device="cpu")
    metrics = orch.run_chunk(np.zeros((64 * 64, 2), np.int8))
    assert metrics["samples"] == 64 * 64
    assert metrics["frames"] == 0 and metrics["active_channels"] == 1
    assert json.loads(lines[-1]) == metrics


@pytest.fixture(scope="module")
def int4_pair():
    """A JAX and a port orchestrator with ingest_format="int4" (nothing
    run)."""
    args = dict(slots=4, bank_mode=True, ppm_correction=False,
                ingest_format="int4")
    return (JOrchestrator(lambda n: None, to.FS, to.CENTER_HZ,
                          [to.CONTROL_OFF], **args),
            Orchestrator(lambda n: None, to.FS, to.CENTER_HZ,
                         [to.CONTROL_OFF], device="cpu", **args))


@pytest.mark.parametrize("kind", ["int8", "float", "complex"])
def test_int4_pack_equals_reference(int4_pair, kind):
    """The host-side pack (``_prepare``): int8 pairs, float pairs and
    complex samples, full scale and beyond it, become the reference's
    bytes exactly."""
    jorch, orch = int4_pair
    rng = np.random.default_rng(4)
    if kind == "int8":
        iq = rng.integers(-128, 128, (4096, 2)).astype(np.int8)
    else:
        iq = (rng.standard_normal((4096, 2)) * 0.6).astype(np.float32)
        if kind == "complex":
            iq = (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)
    got, want = orch._prepare(iq), jorch._prepare(iq)
    assert got.dtype == want.dtype == np.uint8 and got.shape == (4096,)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 200                # every nibble pair used


def _closure_fn(fn, name, seen=None):
    """The function called `name` among fn's closures (the reference's
    ``ingest`` is local to its ``_build_live_step``)."""
    seen = set() if seen is None else seen
    fn = getattr(fn, "__wrapped__", fn)
    if id(fn) in seen or not callable(fn) or not hasattr(fn, "__closure__"):
        return None
    seen.add(id(fn))
    if fn.__name__ == name:
        return fn
    for cell in fn.__closure__ or ():
        found = _closure_fn(cell.cell_contents, name, seen)
        if found is not None:
            return found
    return None


def test_int4_unpack_equals_reference(int4_pair):
    """The device-side unpack (``ingest`` of uint8): every byte value
    gives the reference's two floats exactly."""
    from sdrtrunk_tpu_torch.runtime.orchestrator import ingest

    jorch, _ = int4_pair
    ref_ingest = _closure_fn(jorch.step, "ingest")
    assert ref_ingest is not None
    b = np.arange(256, dtype=np.uint8)
    got = ingest(torch.as_tensor(b))
    want = np.asarray(ref_ingest(jax.numpy.asarray(b)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (256, 2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def int4_run():
    """The port's bank on the capture of ``runs`` through
    ingest_format="int4" (tests/test_orchestrator_bank.py's
    bank_run_int4)."""
    orch = Orchestrator(_source(_capture()), to.FS, to.CENTER_HZ,
                        [to.CONTROL_OFF], slots=4, chunk_samples=64 * 256,
                        idle_teardown_seconds=0.6, bank_mode=True,
                        ingest_format="int4", device="cpu")
    orch.run()
    return orch


def test_int4_ingest_decodes_like_int8(runs, int4_run):
    """tests/test_orchestrator_bank.py::test_int4_ingest_decodes_like_int8
    on the port: the int4 run follows the grant and gives the int8 run's
    one call, of the same length, and its frames within two."""
    _, _, ref, _ = runs
    orch = int4_run
    freq = to.CENTER_HZ + to.TRAFFIC_OFF
    assert not orch.skipped_grants
    assert [e for e in orch.events
            if e.frequency_hz == pytest.approx(freq)]
    segs = [s for s in orch.audio_segments if s.duration > 0]
    ref_segs = [s for s in ref.audio_segments if s.duration > 0]
    assert len(segs) == len(ref_segs) == 1
    assert segs[0].duration == pytest.approx(ref_segs[0].duration)
    f4 = sum(s["frames"] for s in orch.channel_status())
    f8 = sum(s["frames"] for s in ref.channel_status())
    assert f4 >= f8 - 2, (f4, f8)


def test_unknown_ingest_format_raises():
    with pytest.raises(ValueError, match="unknown ingest_format 'int2'"):
        Orchestrator(lambda n: None, to.FS, to.CENTER_HZ, [to.CONTROL_OFF],
                     slots=4, ingest_format="int2", device="cpu")


def _mode(orch):
    return {"bank_mode": orch.bank_mode, "banks": orch.banks,
            "bank_proc": type(orch.bank_proc).__name__,
            "worker": orch.bank_host is not None,
            "kinds": [s.kind for s in orch.slots],
            "processors": [type(s.processor).__name__ for s in orch.slots],
            "bins": orch.bins.tolist(), "chunk": orch.chunk_samples}


@pytest.mark.parametrize("kwargs", [
    {"banks": [("c4fm", 2), ("dmr", 2)]}, {"bank_mode": False},
    {"bank_mode": None}, {"bank_mode": True, "host_process": True}],
    ids=["banks", "per-slot", "per-slot-default", "host-process"])
def test_formerly_refused_options_run_as_the_reference(kwargs):
    """banks=, the per-slot path (bank_mode False, or None under 32
    slots) and host_process=True build what the reference builds and run
    a chunk (tests/test_torch_orchestrator_slots.py, test_torch_multibank
    .py and test_torch_bank_worker.py hold their runs against it)."""
    args = dict(slots=4, ppm_correction=False, **kwargs)
    orch = Orchestrator(lambda n: None, to.FS, to.CENTER_HZ,
                        [to.CONTROL_OFF], device="cpu", **args)
    try:
        metrics = orch.run_chunk(np.zeros((orch.chunk_samples, 2), np.int8))
        assert metrics["samples"] == orch.chunk_samples
        if not kwargs.get("host_process"):
            # the reference's worker is a JAX process of its own: its
            # constructor is held here, its run in test_torch_bank_worker
            jorch = JOrchestrator(lambda n: None, to.FS, to.CENTER_HZ,
                                  [to.CONTROL_OFF], **args)
            assert _mode(orch) == _mode(jorch)
        else:
            assert orch.bank_host is not None and orch.bank_proc is None
    finally:
        orch.close()


def test_unknown_decoder_kind_raises():
    with pytest.raises(ValueError, match="unknown decoder kind 'pocsag'"):
        Orchestrator(lambda n: None, to.FS, to.CENTER_HZ, [to.CONTROL_OFF],
                     slots=4, decoder="pocsag", bank_mode=True, device="cpu")


@pytest.mark.parametrize("decoder,analog,mixed,chunk,ka,bit_cap", [
    ("c4fm", False, False, 16 * 64, None, None),
    ("nbfm", True, False, 64 * 25, 16, None),
    ("ltr", False, True, 64 * 125, 80, 32),
    ("ltrnet", False, True, 64 * 125, 80, 32),
    ("passport", False, True, 64 * 125, 80, 32),
    ("mpt1327", False, True, 64 * 125, 80, 32)])
def test_bank_attributes_and_channel_map(decoder, analog, mixed, chunk, ka,
                                         bit_cap):
    """What the reference's callers read of a bank-mode orchestrator:
    ``bank_mode``, ``bank_analog``, ``bank_mixed`` and the ``channel_map``
    it was given, kept and passed on to the mixed bank's processors; and
    each kind's default chunk, audio length and bit budget (reference
    orchestrator.py:200-216, :579-598: 0.01 s at 300 baud gives ceil((3.75
    + 16) / 32) * 32 = 32 bits, at 1200 baud ceil((15 + 16) / 32) * 32)."""
    from sdrtrunk_tpu_torch.runtime.traffic import FrequencyBand

    band = FrequencyBand(identifier=0, base_frequency_hz=459e6,
                         channel_spacing_hz=12500.0)
    orch = Orchestrator(lambda n: None, to.FS, to.CENTER_HZ,
                        [to.CONTROL_OFF], slots=4, decoder=decoder,
                        bank_mode=True, ppm_correction=False,
                        channel_map=band, device="cpu")
    assert orch.bank_mode is True
    assert (orch.bank_analog, orch.bank_mixed) == (analog, mixed)
    assert orch.channel_map is band
    assert orch.chunk_samples == chunk
    assert (orch._bank_ka, orch._bank_bit_cap) == (ka, bit_cap)
    if mixed:
        assert orch.bank_proc.channel_map is band
        assert orch.bank_proc.kind == decoder
        assert orch.bank_proc.states is orch.bank_proc.procs
        assert orch.bank_proc.procs[0] is not None      # the control slot
    if decoder == "mpt1327":
        # the control slot's processor registered the map as band 0
        assert orch.traffic.resolve_frequency(0, 77) == \
            459e6 + 77 * 12500.0
