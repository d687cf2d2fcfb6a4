"""The per-slot Orchestrator path on the CPU (below 32 slots, the default
``bank_mode``): the port against the JAX one, each slot's dibits or audio
framed and decoded on the host by its own channel processor.

Scenes:

* C4FM (tests/test_orchestrator.py, 800 kHz, slots=4; the first 2.0 s of
  tests/test_torch_orchestrator.py's 2.6 s of int8 IQ): a P25 control channel
  grants a traffic channel that carries HDU + 2 LDU1 + TDULC; the grant
  must be followed, the call's messages decoded on the traffic slot, one
  AudioSegment of 18 IMBE frames made, and the slot torn down when idle.
* NBFM (tests/test_orchestrator_protocols.py::nbfm_run, 2 slots, 2.0 s):
  a 1 kHz tone keyed from 0.4 s to 1.4 s must become one squelch-gated
  AudioSegment.
* the channel lifecycle of tests/test_channel_lifecycle.py: retune remaps
  and drops, the retune that drops the control channel raises, source
  events are dispatched, a sample-rate change rebuilds the receiver and
  keeps the plan, and then runs a chunk, and an error state stops every
  channel. Each case runs on both orchestrators and must leave the same
  plan.
* a single-kind analog-trunking decoder under 32 slots without banks=,
  which the reference cannot run (its per-slot leg sends the audio alone
  to a processor that only takes process_mixed): the port refuses it.
* a sample-rate change of an analog or analog-trunking bank (40 slots),
  which the reference cannot rebuild (its set_sample_rate reads the
  decoder's demodulator, which these decoders lack): the port refuses it
  before changing anything; a C4FM bank and the per-slot path rebuild in
  both.

Both orchestrators start from one state, carried across with convert.py,
and must give the same events, per-slot frame counts, AudioSegments and
metrics trace (the keys tests/test_torch_orchestrator.py compares). The
DMR and P25 Phase 2 scenes are in test_torch_orchestrator_slots_protocols.py.
"""
import json

import jax
import numpy as np
import pytest
import torch

import test_orchestrator as to
from sdrtrunk_tpu.parallel.boundary import complex_flags, unpack_tree
from sdrtrunk_tpu.runtime.identifiers import IdentifierCollection as JIds
from sdrtrunk_tpu.runtime.identifiers import IdentifierRole
from sdrtrunk_tpu.runtime.orchestrator import Orchestrator as JOrchestrator
from sdrtrunk_tpu.signal import generators
from sdrtrunk_tpu.sources import tuner as jtuner
from sdrtrunk_tpu_torch.convert import receiver_state_from_numpy
from sdrtrunk_tpu_torch.runtime.identifiers import IdentifierCollection
from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator
from sdrtrunk_tpu_torch.sources import tuner
from test_torch_gardner_banks import _design_arrays, _source
from test_torch_orchestrator import _capture

torch.set_num_threads(1)

_TRACE_KEYS = ("t", "samples", "active_channels", "frames", "events",
               "audio_segments")


def run_pair(wide, fs, center_hz, control, params=_design_arrays,
             prepare=None, jax_kw=None, port_kw=None, run=True, **kw):
    """The JAX and the port's orchestrators on one capture from one state:
    the JAX design arrays (``params(jorch.rx)``) and its receiver state
    after the control slots were tuned. ``prepare(orch)``, when given,
    runs on each before its run; ``jax_kw`` and ``port_kw`` hold keyword
    arguments whose values are objects of one package's own host layer;
    with ``run`` False neither is run. Returns (jorch, its metrics lines,
    orch, its lines)."""
    j_lines, t_lines = [], []
    jorch = JOrchestrator(_source(wide), fs, center_hz, list(control),
                          metrics_sink=j_lines.append, **kw, **(jax_kw or {}))
    orch = Orchestrator(_source(wide), fs, center_hz, list(control),
                        metrics_sink=t_lines.append, device="cpu", **kw,
                        **(port_kw or {}))
    orch.rx.load_state_dict(params(jorch.rx))
    flags = complex_flags(jorch.rx.init_state())
    tree = jax.tree.map(np.asarray, unpack_tree(jorch.state, flags))
    orch.state = receiver_state_from_numpy(tree, device="cpu")
    np.testing.assert_array_equal(orch.bins, jorch.bins)
    np.testing.assert_array_equal(orch.steps, jorch.steps)
    if prepare is not None:
        prepare(jorch)
        prepare(orch)
    if run:
        jorch.run()
        orch.run()
    return jorch, j_lines, orch, t_lines


def events(orch):
    # by name: the port's DecodeEventType is its own copy of the enum
    return [(e.event_type.name, e.frequency_hz, round(e.time_start, 6),
             e.details) for e in orch.events]


def segments(orch):
    return [(round(s.start_time, 6), round(s.duration, 6), sorted(
        (i.role.name, str(i.value)) for i in s.identifiers.all()))
        for s in orch.audio_segments]


def trace(lines):
    return [{k: json.loads(line)[k] for k in _TRACE_KEYS} for line in lines]


def frames(orch):
    return [s["frames"] for s in orch.channel_status()]


def flush_open(orch):
    """Flush every active slot's open call into an AudioSegment."""
    for slot in orch.slots:
        if slot.active:
            orch._slot_flush_drain(slot)


# --------------------------------------------------------------- C4FM

@pytest.fixture(scope="module")
def c4fm():
    # the first 2.0 s: the call is over by 1.2 s and its slot torn down
    # 0.6 s after
    chunk = 64 * 256
    return run_pair(_capture()[:int(2.0 * to.FS) // chunk * chunk], to.FS,
                    to.CENTER_HZ, [to.CONTROL_OFF], slots=4,
                    chunk_samples=chunk, idle_teardown_seconds=0.6)


def test_c4fm_runs_per_slot(c4fm):
    jorch, _, orch, _ = c4fm
    assert not orch.bank_mode and not jorch.bank_mode
    assert orch.bank_proc is None and orch.step is not None
    assert [type(s.processor).__name__ for s in orch.slots] == \
        [type(s.processor).__name__ for s in jorch.slots]


def test_c4fm_grant_followed_with_same_events(c4fm):
    jorch, _, orch, _ = c4fm
    freq = to.CENTER_HZ + to.TRAFFIC_OFF
    assert not orch.skipped_grants
    assert [e for e in orch.events if e.frequency_hz == pytest.approx(freq)]
    assert events(orch) == events(jorch)
    assert frames(orch) == frames(jorch)
    status = [s for s in orch.channel_status()
              if not s["control"] and s["frequency_hz"] == freq]
    assert status and status[0]["frames"] >= 4     # HDU + 2 LDU1 + TDULC


def test_c4fm_traffic_call_messages(c4fm):
    jorch, _, orch, _ = c4fm
    freq = to.CENTER_HZ + to.TRAFFIC_OFF

    def duids(o):
        slot = next(s for s in o.slots
                    if not s.is_control and s.frequency_hz == freq)
        return [m.duid.name for m in slot.processor.messages if m.valid], \
            slot.processor
    got, proc = duids(orch)
    assert got == duids(jorch)[0]
    assert "HDU" in got and "TDULC" in got and got.count("LDU1") == 2
    ldu = next(m for m in proc.messages if m.valid and m.duid.name == "LDU1")
    assert ldu.content.link_control.fields["group_address"] == to.GROUP
    assert ldu.content.link_control.fields["source_address"] == to.SOURCE


def test_c4fm_voice_becomes_one_audio_segment(c4fm):
    jorch, _, orch, _ = c4fm
    segs = [s for s in orch.audio_segments if s.duration > 0]
    assert len(segs) == 1
    assert segs[0].duration == pytest.approx(18 * 0.020)
    assert segments(orch) == segments(jorch)
    tgs = [i.value for i in segs[0].identifiers.all()
           if i.role.name == IdentifierRole.TO.name]
    assert to.GROUP in tgs


def test_c4fm_idle_teardown_and_metrics(c4fm):
    jorch, j_lines, orch, t_lines = c4fm
    freq = to.CENTER_HZ + to.TRAFFIC_OFF
    assert freq not in orch.traffic.active
    assert not next(s for s in orch.slots
                    if not s.is_control and s.frequency_hz == freq).active
    assert trace(t_lines) == trace(j_lines)
    active = [m["active_channels"] for m in trace(t_lines)]
    assert len(active) > 50 and max(active) == 2 and active[-1] == 1


# --------------------------------------------------------------- NBFM

def _nbfm_capture():
    """tests/test_orchestrator_protocols.py's NBFM scene: a 1 kHz tone
    keyed from 0.4 s to 1.4 s at +25 kHz over a faint noise floor."""
    fs, duration = to.FS, 2.0
    n = int(duration * fs) // 64 * 64
    tone = np.sin(2 * np.pi * 1000.0 * np.arange(int(duration * 8000))
                  / 8000.0)
    iq = generators.nbfm_modulate(tone, 8000.0, fs)[:n]
    key = np.zeros(n, np.float32)
    key[int(0.4 * fs):int(1.4 * fs)] = 1.0
    t = np.arange(n) / fs
    wide = (iq * key * np.exp(2j * np.pi * 25_000.0 * t)).astype(np.complex64)
    wide += (1e-5 * (np.random.default_rng(5).standard_normal(n)
                     + 1j * np.random.default_rng(6).standard_normal(n))
             ).astype(np.complex64)
    return wide


@pytest.fixture(scope="module")
def nbfm():
    out = run_pair(_nbfm_capture(), to.FS, to.CENTER_HZ, [25_000.0],
                   slots=2, decoder="nbfm", chunk_samples=64 * 400)
    for o in (out[0], out[2]):
        flush_open(o)
    return out


def test_nbfm_squelch_gated_segment(nbfm):
    jorch, j_lines, orch, t_lines = nbfm
    assert not orch.bank_mode
    segs = [s for s in orch.audio_segments if s.duration > 0]
    assert len(segs) == 1
    assert segs[0].start_time == pytest.approx(0.45, abs=0.1)
    assert 0.9 < segs[0].duration < 1.8
    assert segments(orch) == segments(jorch)
    assert trace(t_lines) == trace(j_lines)
    # the same PCM within the analog chain's 1e-4 (test_torch_analog)
    ref = next(s for s in jorch.audio_segments if s.duration > 0)
    np.testing.assert_allclose(segs[0].samples, ref.samples, atol=1e-4)
    spec = np.abs(np.fft.rfft(segs[0].samples[400:4000]))
    assert np.fft.rfftfreq(3600, 1 / 8000.0)[np.argmax(spec)] == \
        pytest.approx(1000.0, abs=20.0)


# --------------------------------------------------------------- lifecycle

FS = 64 * 12500.0
CENTER = 460_000_000.0


def _pair(**kw):
    args = dict(source=lambda n: None, sample_rate=FS,
                center_frequency_hz=CENTER, control_offsets_hz=[25_000.0],
                slots=4, ppm_correction=False, **kw)
    return JOrchestrator(**args), Orchestrator(device="cpu", **args)


def _plan(orch):
    return {"center": orch.center_frequency_hz, "bins": orch.bins.tolist(),
            "steps": np.round(orch.steps, 6).tolist(),
            "active": [s.active for s in orch.slots],
            "freqs": [s.frequency_hz for s in orch.slots],
            "skipped": list(orch.skipped_grants),
            "channels": orch.rx.channelizer.channels,
            "chunk": orch.chunk_samples}


def _retune_remap(orch, ids):
    orch._activate(CENTER + 150_000.0, ids)
    traffic = next(s for s in orch.slots if s.active and not s.is_control)
    before = int(orch.bins[traffic.index][0])
    orch.retune(CENTER - 100_000.0)
    assert orch.center_frequency_hz == CENTER - 100_000.0 and traffic.active
    ch = orch.rx.channelizer
    assert orch.bins[traffic.index][0] == ch.channel_for_frequency(
        traffic.frequency_hz - orch.center_frequency_hz) != before


def _retune_drop(orch, ids):
    orch._activate(CENTER + 150_000.0, ids)
    traffic = next(s for s in orch.slots if s.active and not s.is_control)
    orch.retune(CENTER - 300_000.0)
    assert not traffic.active
    assert traffic.frequency_hz in orch.skipped_grants


def _rate_rebuild(orch, ids):
    orch._activate(CENTER + 150_000.0, ids)
    m_before = orch.rx.channelizer.channels
    orch.set_sample_rate(128 * 12500.0)
    ch = orch.rx.channelizer
    assert ch.channels == 2 * m_before
    assert orch.chunk_samples == 16 * ch.channels
    for slot in (s for s in orch.slots if s.active):
        assert orch.bins[slot.index][0] == ch.channel_for_frequency(
            slot.frequency_hz - orch.center_frequency_hz)


_CASES = {"retune_remaps_active_slots": _retune_remap,
          "retune_drops_out_of_coverage_traffic": _retune_drop,
          "rebuild_keeps_plan": _rate_rebuild}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_lifecycle_matches_reference(case):
    jorch, orch = _pair()
    _CASES[case](jorch, JIds())
    _CASES[case](orch, IdentifierCollection())
    assert _plan(orch) == _plan(jorch)
    assert [s.processor is not None for s in orch.slots] == \
        [s.processor is not None for s in jorch.slots]


def test_retune_that_drops_control_raises():
    for orch in _pair():
        with pytest.raises(ValueError, match="drops the control channel"):
            orch.retune(CENTER + 5_000_000.0)


def _event(orch, name: str, value):
    """A SourceEvent of the orchestrator's own package."""
    module = jtuner if isinstance(orch, JOrchestrator) else tuner
    return module.SourceEvent(module.SourceEventType[name], value=value)


def test_source_event_dispatch():
    jorch, orch = _pair()
    for o in (jorch, orch):
        o.on_source_event(_event(o, "FREQUENCY_CHANGE", CENTER + 50_000.0))
    assert orch.center_frequency_hz == CENTER + 50_000.0
    assert _plan(orch) == _plan(jorch)


def test_event_driven_rate_change_runs_decode():
    """After a sample-rate rebuild the step runs, on the new bin grid."""
    plans = []
    for orch in _pair():
        orch.on_source_event(_event(orch, "SAMPLE_RATE_CHANGE", 32 * 12500.0))
        iq = (np.random.default_rng(0).normal(
            0, 0.01, (orch.chunk_samples, 2)) @ np.array([1, 1j])
        ).astype(np.complex64)
        out = orch.run_chunk(iq)
        assert isinstance(out, dict) and out["samples"] == len(iq)
        plans.append(_plan(orch))
    assert plans[1] == plans[0] and plans[1]["channels"] == 32


def test_error_state_stops_all_channels():
    fs = 32 * 12500.0
    rng = np.random.default_rng(0)
    noise = (0.01 * (rng.standard_normal(32 * 64)
                     + 1j * rng.standard_normal(32 * 64))).astype(np.complex64)
    for cls, ids, kw in ((JOrchestrator, JIds, {}),
                         (Orchestrator, IdentifierCollection,
                          {"device": "cpu"})):
        calls = [0]

        def source(num):
            calls[0] += 1
            return noise[:num]

        orch = cls(source, fs, 460e6, [25000.0], slots=3,
                   chunk_samples=32 * 64, ppm_correction=False, **kw)
        orch._activate(460e6 - 25000.0, ids())
        assert sum(s.active for s in orch.slots) == 2
        orch.run(max_chunks=2)
        orch.on_source_event(_event(orch, "ERROR_STATE", "usb stall"))
        assert orch.error_state == "usb stall"
        assert not any(s.active for s in orch.slots)
        assert not orch.traffic.active
        before = calls[0]
        orch.run(max_chunks=5)          # must not consume further chunks
        assert calls[0] == before


@pytest.mark.parametrize("kind", ["ltr", "ltrnet", "passport", "mpt1327"])
def test_single_kind_analog_trunking_per_slot_raises(kind):
    with pytest.raises(ValueError, match=r"banks=.*bank_mode=True"):
        Orchestrator(lambda n: None, FS, CENTER, [25_000.0], slots=4,
                     decoder=kind, device="cpu")
    for kw in ({"bank_mode": True}, {"banks": [(kind, 4)]}):
        orch = Orchestrator(lambda n: None, FS, CENTER, [25_000.0], slots=4,
                            decoder=kind, ppm_correction=False, device="cpu",
                            **kw)
        assert orch.bank_mixed == ("bank_mode" in kw)


_ANALOG_BANK_KINDS = ["nbfm", "am", "ltr", "ltrnet", "passport", "mpt1327"]


@pytest.mark.parametrize("kind", _ANALOG_BANK_KINDS)
def test_rate_change_of_an_analog_bank_raises(kind):
    """A sample-rate change cannot rebuild an analog or analog-trunking
    bank (40 slots: bank_mode on): the reference's set_sample_rate reads
    its decoder's demodulator, which these decoders lack, and raises
    AttributeError; the port raises a named ValueError before it changes
    anything."""
    new_rate = 128 * 12500.0
    ref = JOrchestrator(lambda n: None, FS, CENTER, [25_000.0], slots=40,
                        decoder=kind, ppm_correction=False)
    assert ref.bank_mode
    with pytest.raises(AttributeError, match="demod"):
        ref.set_sample_rate(new_rate)
    port = Orchestrator(lambda n: None, FS, CENTER, [25_000.0], slots=40,
                        decoder=kind, ppm_correction=False, device="cpu")
    rx, chunk = port.rx, port.chunk_samples
    with pytest.raises(ValueError, match=f"cannot rebuild a '{kind}' bank"):
        port.set_sample_rate(new_rate)
    with pytest.raises(ValueError, match="cannot rebuild"):
        port.on_source_event(_event(port, "SAMPLE_RATE_CHANGE", new_rate))
    assert port.sample_rate == FS and port.rx is rx
    assert port.chunk_samples == chunk


@pytest.mark.parametrize("slots", [40, 4])
def test_rate_change_rebuilds_a_c4fm_bank_and_the_per_slot_path(slots):
    """The digital bank (40 slots) and the per-slot path (4) rebuild in
    both packages: the same bins, chunk and bank transfer size."""
    new_rate = 128 * 12500.0
    orchs = [cls(lambda n: None, FS, CENTER, [25_000.0], slots=slots,
                 decoder="c4fm", ppm_correction=False, **kw)
             for cls, kw in ((JOrchestrator, {}),
                             (Orchestrator, {"device": "cpu"}))]
    for orch in orchs:
        assert orch.bank_mode == (slots >= 32)
        orch.set_sample_rate(new_rate)
    ref, port = orchs
    assert port.sample_rate == ref.sample_rate == new_rate
    assert port.rx.channelizer.channels == ref.rx.channelizer.channels == 128
    assert port.chunk_samples == ref.chunk_samples
    assert port._bank_cap == ref._bank_cap
    assert np.array_equal(port.bins, ref.bins)
    assert np.array_equal(port.steps, ref.steps)
