"""The Gardner slice as a whole on the CPU: the port's bank-mode
Orchestrator against the JAX one, for P25 Phase 2 (decoder="p25p2") and
P25 Phase 1 LSM (decoder="lsm"). Both orchestrators start from one state,
carried across with convert.py, and must give the same events, per-slot
frame counts, audio segments and metrics trace. The live step's packed
bank bytes are compared on every chunk over the region the host reads
(dibits below counts; sync hits at lags below counts - 19 for P25P2,
protocol/p25p2/bankframer.py:154-170, and below counts - 23 for P25P1,
protocol/p25p1/bankframer.py:149-175) on each slot that was tuned.

P25P2 scene: the trunked scene of tests/test_orchestrator_protocols.py
(800 kHz, 4 slots in bank mode). The control channel's unscrambled network
status MAC teaches the scramble key (WACN/system/NAC), an IDEN_UP gives the
band plan, and MAC grants send talkgroup 0x222 to a traffic channel, where
scrambled PTT + VOICE_4 timeslots and an END_PTT must become one
AudioSegment; the traffic slot's framer must get the learned key
preloaded. Cut to size for the CPU (that file is marked slow; its bank
fixture runs 2.6 s of capture): the capture is 1.4 s, modulated at 50 kHz
and interpolated to 800 kHz (modulating at 800 kHz took 45 s); the grants
run for 0.48 s right after the first network-status/IDEN fragment; the
traffic call starts at 0.45 s, after the grant has taken effect (the
pipelined loop applies a grant two 0.02 s chunks after the chunk that
carried it); and the idle teardown, whose flush turns the voice channel's
open call into the AudioSegment, is 0.3 s instead of 0.8 s.

LSM scene: tests/test_orchestrator_bank.py::test_lsm_bank_mode_decodes
(400 kHz, 4 slots, a control channel of six TSBKs), cut from 2.0 s to
1.0 s and modulated at 50 kHz, interpolated to 400 kHz.
"""
import json

import jax
import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

import test_orchestrator_protocols as tp
from sdrtrunk_tpu.parallel.boundary import complex_flags, unpack_tree
from sdrtrunk_tpu.protocol.bits import from_int
from sdrtrunk_tpu.protocol.p25p1.duid import DUID
from sdrtrunk_tpu.protocol.p25p1.framer import P25P1FrameAssembler
from sdrtrunk_tpu.protocol.p25p1.tsbk import tsbk_encode
from sdrtrunk_tpu.protocol.p25p2 import P25P2FragmentAssembler
from sdrtrunk_tpu.protocol.p25p2.mac import build_mac_pdu, mac_structure_encode
from sdrtrunk_tpu.protocol.p25p2.timeslot import (MacPduType, facch_encode,
                                                  sacch_encode, voice4_encode)
from sdrtrunk_tpu.runtime.bank_processor import unpack_dibits, unpack_hits
from sdrtrunk_tpu.runtime.identifiers import IdentifierRole
from sdrtrunk_tpu.runtime.orchestrator import Orchestrator as JOrchestrator
from sdrtrunk_tpu.signal import generators
from sdrtrunk_tpu_torch.convert import (params_from_numpy,
                                        receiver_state_from_numpy)
from sdrtrunk_tpu_torch.runtime.orchestrator import Orchestrator

torch.set_num_threads(1)

KEY = (0xA4BC3, 0x123, 0x29A)                   # WACN, system, NAC
P2BAUD = 6000.0
SECONDS = 1.4
TRAFFIC_START_S = 0.45
IDLE_TEARDOWN_S = 0.3
GRANTS = 4                  # grant fragments, 0.12 s each, from 0.14 s
MOD_RATE = 50000.0
CHUNK = 64 * 256
_TRACE_KEYS = ("t", "samples", "active_channels", "frames", "events",
               "audio_segments")


def _capture() -> np.ndarray:
    """The wideband capture: control and traffic channels, pi/4-DQPSK
    modulated at 50 kHz and interpolated to 800 kHz."""
    total = int(SECONDS * P2BAUD)
    rng = np.random.default_rng(41)
    asm = P25P2FragmentAssembler(wacn=KEY[0], system=KEY[1], nac=KEY[2])
    net = mac_structure_encode(123, {
        "wacn": KEY[0], "system_id": KEY[1], "color_code": KEY[2],
        "frequency_band": 1, "channel_number": 2})
    iden = np.zeros(72, np.uint8)
    iden[0:8] = from_int(125, 8)
    iden[8:12] = from_int(1, 4)                  # band id 1
    iden[12:21] = from_int(100, 9)               # 12.5 kHz bw
    iden[30:40] = from_int(100, 10)              # 12.5 kHz spacing
    iden[40:72] = from_int(int(tp.BASE_HZ / 5), 32)
    grant = mac_structure_encode(64, {
        "service_options": 0, "frequency_band": 1,
        "channel_number": tp.CHAN_NUM, "group_address": tp.GROUP,
        "source_address": tp.SOURCE})

    def facch(pdu_type, structures):
        return facch_encode(build_mac_pdu(pdu_type, structures, 156),
                            scrambled=False)

    f_net, f_iden = facch(MacPduType.ACTIVE, [net]), facch(
        MacPduType.ACTIVE, [iden])
    f_grant, idle = facch(MacPduType.ACTIVE, [grant]), facch(
        MacPduType.IDLE, [])
    frags = [asm.assemble(0, [f_net, f_iden, f_net, f_iden])]
    frags += [asm.assemble(i % 3, [f_grant, idle, f_grant, idle])
              for i in range(1, 1 + GRANTS)]
    control = np.concatenate([rng.integers(0, 4, 100).astype(np.uint8),
                              P25P2FragmentAssembler.to_dibits(frags)])

    ptt = np.zeros(180, np.uint8)
    ptt[0:3] = from_int(MacPduType.PTT.value, 3)
    ptt[80:88] = from_int(0x80, 8)               # clear
    ptt[104:128] = from_int(tp.SOURCE, 24)
    ptt[128:144] = from_int(tp.GROUP, 16)
    endptt = np.zeros(180, np.uint8)
    endptt[0:3] = from_int(MacPduType.END_PTT.value, 3)
    endptt[104:128] = from_int(tp.SOURCE, 24)
    endptt[128:144] = from_int(tp.GROUP, 16)
    frames = rng.integers(0, 2, (4, 72)).astype(np.uint8)
    asm_t = P25P2FragmentAssembler(wacn=KEY[0], system=KEY[1], nac=KEY[2])
    voice = [asm_t.assemble(i, [sacch_encode(ptt, scrambled=True),
                                voice4_encode(frames),
                                sacch_encode(ptt, scrambled=True),
                                voice4_encode(frames)]) for i in range(3)]
    voice.append(asm_t.assemble(0, [sacch_encode(endptt, scrambled=True),
                                    idle,
                                    sacch_encode(endptt, scrambled=True),
                                    idle]))
    traffic = np.concatenate(
        [rng.integers(0, 4, int(TRAFFIC_START_S * P2BAUD)).astype(np.uint8),
         P25P2FragmentAssembler.to_dibits(voice)])
    streams = []
    for off, d in ((tp.CONTROL_OFF, control), (tp.TRAFFIC_OFF, traffic)):
        iq = generators.lsm_modulate(tp._pad(d, total, rng), MOD_RATE,
                                     symbol_rate=P2BAUD)
        streams.append((off, resample_poly(iq, int(tp.FS / MOD_RATE), 1)))
    n = min(len(iq) for _, iq in streams) // 64 * 64
    t = np.arange(n) / tp.FS
    return sum((iq[:n] * np.exp(2j * np.pi * off * t)).astype(np.complex64)
               for off, iq in streams)


def _source(wide):
    pos = 0

    def read(num):
        nonlocal pos
        chunk = wide[pos:pos + num]
        pos += num
        return chunk if len(chunk) else None

    return read


def _recording(orch, packed):
    """Wrap orch.step so that each chunk's packed bank bytes (the one flat
    transfer: "packed", or "packed_audio" for an analog bank) and slot
    plan are kept."""
    step = orch.step

    def spy(x, state, bins, steps):
        out, st = step(x, state, bins, steps)
        (buf,) = out.values()
        packed.append((buf.numpy() if isinstance(buf, torch.Tensor)
                       else np.asarray(buf), np.array(bins)))
        return out, st

    orch.step = spy


def _design_arrays(jrx) -> dict:
    """The JAX receiver's design arrays as the port's state dict, for a
    decoder that holds its taps itself (the DQPSK chains, NBFM, AM)."""
    demod = getattr(jrx.decoder, "demod", None)
    return params_from_numpy(
        jrx.channelizer.hmat, jrx.decoder.baseband_taps,
        interp_bank=None if demod is None else demod.bank,
        resampler_taps=getattr(jrx.decoder, "resampler_taps", None))


def _run_pair(wide, fs, center_hz, control_off, prepare=None,
              params=_design_arrays, jax_kw=None, port_kw=None, **kw):
    """The JAX and the port's orchestrators on one capture, from one state:
    the JAX design arrays (``params(jorch.rx)``) and its (float-pair
    packed) receiver state after the control slot was tuned.
    ``prepare(orch)``, when given, runs on each orchestrator before its
    run. ``jax_kw`` and ``port_kw`` hold keyword arguments whose values
    are objects of one package's own host layer (a FrequencyBand).
    Returns (jorch, its metrics lines, its packed chunks, orch, lines,
    packed chunks)."""
    j_lines, t_lines, j_packed, t_packed = [], [], [], []
    jorch = JOrchestrator(_source(wide), fs, center_hz, [control_off],
                          metrics_sink=j_lines.append, bank_mode=True, **kw,
                          **(jax_kw or {}))
    orch = Orchestrator(_source(wide), fs, center_hz, [control_off],
                        metrics_sink=t_lines.append, bank_mode=True,
                        device="cpu", **kw, **(port_kw or {}))
    jrx = jorch.rx
    orch.rx.load_state_dict(params(jrx))
    flags = complex_flags(jrx.init_state())
    tree = jax.tree.map(np.asarray, unpack_tree(jorch.state, flags))
    orch.state = receiver_state_from_numpy(tree, device="cpu")
    np.testing.assert_array_equal(orch.bins, jorch.bins)
    np.testing.assert_array_equal(orch.steps, jorch.steps)
    _recording(jorch, j_packed)
    _recording(orch, t_packed)
    if prepare is not None:
        prepare(jorch)
        prepare(orch)
    jorch.run()
    orch.run()
    return jorch, j_lines, j_packed, orch, t_lines, t_packed


@pytest.fixture(scope="module")
def runs():
    return _run_pair(_capture(), tp.FS, tp.CENTER_HZ, tp.CONTROL_OFF,
                     slots=4, decoder="p25p2", chunk_samples=CHUNK,
                     idle_teardown_seconds=IDLE_TEARDOWN_S)


def _events(orch):
    # by name: the port's DecodeEventType is its own copy of the enum
    return [(e.event_type.name, e.frequency_hz, round(e.time_start, 6),
             e.details) for e in orch.events]


def test_scramble_key_learned_and_preloaded(runs):
    jorch, _, _, orch, _, _ = runs
    assert orch.bank_proc.states[0].scramble_key == KEY
    freq = tp.CENTER_HZ + tp.TRAFFIC_OFF
    slot = next(s for s in orch.slots
                if not s.is_control and s.frequency_hz == freq)
    assert orch.bank_proc.states[slot.index].scramble_key == KEY
    assert orch.traffic.protocol == jorch.traffic.protocol == "APCO25-P2"


def test_same_events_and_grant_followed(runs):
    jorch, _, _, orch, _, _ = runs
    freq = tp.CENTER_HZ + tp.TRAFFIC_OFF
    assert not orch.skipped_grants
    assert [e for e in orch.events if e.frequency_hz == pytest.approx(freq)]
    assert _events(orch) == _events(jorch)


def test_same_frame_counts(runs):
    jorch, _, _, orch, _, _ = runs
    got = [s["frames"] for s in orch.channel_status()]
    assert got == [s["frames"] for s in jorch.channel_status()]
    assert got[0] > 0 and sum(got[1:]) >= 4


def test_voice_becomes_one_audio_segment(runs):
    jorch, _, _, orch, _, _ = runs
    segs = [s for s in orch.audio_segments if s.duration > 0]
    ref = [s for s in jorch.audio_segments if s.duration > 0]
    assert len(segs) == len(ref) == 1
    assert segs[0].duration == ref[0].duration >= 4 * 0.020
    tgs = [i.value for i in segs[0].identifiers.all()
           if i.role.name == IdentifierRole.TO.name]
    assert tp.GROUP in tgs


def _trace(lines):
    return [{k: json.loads(line)[k] for k in _TRACE_KEYS} for line in lines]


def test_same_metrics_trace(runs):
    _, j_lines, _, _, t_lines, _ = runs
    trace = _trace(t_lines)
    assert trace == _trace(j_lines)
    active = [m["active_channels"] for m in trace]
    assert max(active) == 2 and active[-1] == 1


def _compare_packed(jorch, j_packed, orch, t_packed, sync_len,
                    pll_tol=1e-5) -> int:
    """Compare every chunk's flat transfer over what the host reads, on
    each slot tuned when the chunk ran; returns the slot-chunks compared."""
    assert jorch._bank_cap == orch._bank_cap
    assert len(j_packed) == len(t_packed) > 0
    compared = 0
    for (jbuf, jbins), (tbuf, tbins) in zip(j_packed, t_packed):
        np.testing.assert_array_equal(tbins, jbins)
        assert len(tbuf) == len(jbuf)
        jd4, jh, jc, jpll = jorch._split_packed(jbuf)
        td4, th, tc, tpll = orch._split_packed(tbuf)
        assert tpll == pytest.approx(jpll, rel=1e-5, abs=pll_tol)
        jdib, tdib = unpack_dibits(jd4), unpack_dibits(td4)
        jhit, thit = unpack_hits(jh), unpack_hits(th)
        for s in np.nonzero((jbins != 0).any(axis=1))[0]:
            n = int(jc[s])
            assert int(tc[s]) == n > 50
            np.testing.assert_array_equal(tdib[s, :n], jdib[s, :n])
            read = max(n - (sync_len - 1), 0)
            np.testing.assert_array_equal(thit[s, :read], jhit[s, :read])
            compared += 1
    return compared


def test_packed_bank_bytes_match_reference(runs):
    jorch, _, j_packed, orch, _, t_packed = runs
    # the traffic slot was compared too, not only the control slot
    assert _compare_packed(jorch, j_packed, orch, t_packed, 20) > len(j_packed)


# --------------------------------------------------------------- LSM

LSM_FS = 32 * 12500.0
LSM_OFF = 3 * 12500.0


def _lsm_capture() -> np.ndarray:
    """int8 (n, 2) IQ of a control channel of six TSBKs, LSM-modulated
    (tests/test_orchestrator_bank.py::test_lsm_bank_mode_decodes)."""
    rng = np.random.default_rng(5)
    asm = P25P1FrameAssembler(nac=0x293)
    tsbk = asm.assemble(DUID.TSBK, tsbk_encode(
        0x3A, rng.integers(0, 2, 64).astype(np.uint8)))
    total = int(1.0 * 4800)
    stream = np.concatenate([rng.integers(0, 4, 150).astype(np.uint8)]
                            + [tsbk] * 6)
    stream = np.concatenate(
        [stream, rng.integers(0, 4, total - len(stream)).astype(np.uint8)])
    iq = resample_poly(generators.lsm_modulate(stream, MOD_RATE),
                       int(LSM_FS / MOD_RATE), 1)
    n = len(iq) // 32 * 32
    t = np.arange(n) / LSM_FS
    wide = (iq[:n] * np.exp(2j * np.pi * LSM_OFF * t)).astype(np.complex64)
    return np.clip(np.stack([wide.real, wide.imag], -1) * 100.0,
                   -127, 127).astype(np.int8)


@pytest.fixture(scope="module")
def lsm_runs():
    iq8 = _lsm_capture()
    n = len(iq8) // (32 * 256) * (32 * 256)     # whole chunks only
    return _run_pair(iq8[:n], LSM_FS, 460e6, LSM_OFF, slots=4,
                     decoder="lsm", chunk_samples=32 * 256,
                     ppm_correction=False)


def test_lsm_bank_decodes_like_reference(lsm_runs):
    jorch, j_lines, _, orch, t_lines, _ = lsm_runs
    got = [s["frames"] for s in orch.channel_status()]
    assert got == [s["frames"] for s in jorch.channel_status()]
    assert got[0] >= 4
    assert orch.traffic.protocol == "APCO25"
    assert _events(orch) == _events(jorch)
    assert [s.duration for s in orch.audio_segments] == \
        [s.duration for s in jorch.audio_segments]
    assert _trace(t_lines) == _trace(j_lines)


def test_lsm_packed_bank_bytes_match_reference(lsm_runs):
    """As for P25P2, but the control slot's PLL frequency (read only by the
    ppm monitor, off here) is held within 2e-4 rad/sample: at gain 0.3 the
    Gardner loop now and then turns an ulp of difference into another arm
    of the mid-point interpolator (the drift tests/test_torch_gardner.py
    notes), and the PLL frequency, which swings by 1e-3 from chunk to
    chunk on this signal, then steps by about 1e-4 and converges back
    over some chunks. Dibits and sync hits stay exact."""
    jorch, _, j_packed, orch, _, t_packed = lsm_runs
    assert _compare_packed(jorch, j_packed, orch, t_packed, 24,
                           pll_tol=2e-4) == len(j_packed)   # control slot
