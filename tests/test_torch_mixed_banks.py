"""The analog-trunking slice as a whole on the CPU: the port's bank-mode
Orchestrator(decoder="ltr" | "ltrnet" | "passport" | "mpt1327") against
the JAX one. Both start from one state, carried across with convert.py,
and must give the same per-slot messages, decode events, AudioSegments
(start times and durations) and metrics trace. The live step's one flat
transfer (mu-law PCM | gate bits | compacted bits | counts) is compared
on every chunk, on each slot that was tuned:

* gate bits and counts exactly;
* the compacted bits exactly over the region the host reads,
  bits[s][:counts[s]] (past it the reference's sort leaves the votes of
  samples with no symbol and the port's scatter leaves zeros);
* PCM within one mu-law level: the audio agrees within 1e-4
  (test_torch_analog), and both packages truncate float to int, so an ulp
  at a .5 boundary moves the level by one. The samples off by one are
  counted and held to what was measured (``OFF_BY_ONE``): none for LTR,
  LTR-Net and Passport, one of 22400 for MPT1327, whose float audio there
  sits some ulps from the reference's at a level boundary (the same
  sample is equal through both packages' mu-law,
  tests/test_torch_reference_cells.py).

Scenes. LTR: tests/test_orchestrator_bank.py::test_ltr_mixed_bank_mode
(400 kHz, 32 bins, 4 slots, one NBFM carrier with an 800 Hz voice tone
plus sub-audible CALL words; the default chunk of 125 * M), cut from 2.0 s
to 1.4 s. LTR-Net and Passport: the same scene with their own words
(``ltrnet_encode_word``, ``passport_encode_word``), which the reference's
tests have no bank scene for. MPT1327: tests/test_multibank.py::
test_mpt1327_live_trunking (800 kHz, a control channel of AFSK GTC
codewords whose grant maps through the ``channel_map`` to a channel of FM
voice) in bank mode with 4 slots, cut from 2.2 s to 1.5 s.
"""
import enum

import numpy as np
import pytest
import torch

from sdrtrunk_tpu.protocol.ltr.ltrnet import ltrnet_encode_word
from sdrtrunk_tpu.protocol.ltr.messages import ltr_encode_word
from sdrtrunk_tpu.protocol.mpt1327 import SYNC_CONTROL, mpt_encode_codeword
from sdrtrunk_tpu.protocol.passport import passport_encode_word
from sdrtrunk_tpu.runtime.traffic import FrequencyBand as JFrequencyBand
from sdrtrunk_tpu.signal import generators
from sdrtrunk_tpu_torch.convert import params_from_numpy
from sdrtrunk_tpu_torch.runtime.traffic import FrequencyBand
from test_ltr import _fsk_modulate
from test_mpt1327 import _afsk_modulate, _gtc_data
from test_torch_gardner_banks import _events, _run_pair, _trace

torch.set_num_threads(1)

CENTER_HZ = 460e6
LTR_FS, LTR_M, LTR_OFF, LTR_SECONDS = 32 * 12500.0, 32, 2 * 12500.0, 1.4
MPT_FS, MPT_M, MPT_SECONDS = 64 * 12500.0, 64, 1.5
MPT_BASE_HZ, MPT_CHANNEL, MPT_CONTROL_OFF = 459_000_000.0, 77, 25_000.0
MPT_GRANTED_OFF = MPT_BASE_HZ + MPT_CHANNEL * 12500.0 - CENTER_HZ

# samples a level apart in the whole run, as measured on the CPU
OFF_BY_ONE = {"ltr": 0, "ltrnet": 0, "passport": 0, "mpt1327": 1}

_WORDS = {
    "ltr": lambda: ltr_encode_word(0, 5, 5, 77, 5),
    "ltrnet": lambda: ltrnet_encode_word(0, 5, 3, 42, 7),
    "passport": lambda: passport_encode_word(0, 55, 3, 999, 0, 20),
}


def _int8(wide, scale=110.0):
    return np.clip(np.stack([wide.real, wide.imag], -1) * scale,
                   -127, 127).astype(np.int8)


def _fsk_capture(kind):
    """One NBFM carrier: an 800 Hz voice tone plus sub-audible square FSK
    words of the kind, as the LTR reference scene builds it."""
    rng = np.random.default_rng(11)
    bits = np.concatenate([rng.integers(0, 2, 25).astype(np.uint8)]
                          + [_WORDS[kind]()] * 30)
    data = _fsk_modulate(bits, amplitude=0.35)
    need = int(8000 * LTR_SECONDS)
    data = np.tile(data, need // len(data) + 1)[:need]
    voice = 0.5 * np.sin(2 * np.pi * 800.0 * np.arange(need) / 8000.0)
    iq = generators.nbfm_modulate(data + voice, 8000.0, LTR_FS)
    chunk = LTR_M * 125
    n = len(iq) // chunk * chunk
    t = np.arange(n) / LTR_FS
    return _int8(iq[:n] * np.exp(2j * np.pi * LTR_OFF * t))


def _mpt_capture():
    """A control channel of AFSK GTC codewords granting channel 77, and FM
    voice (800 Hz) on the granted channel."""
    n = int(MPT_FS * MPT_SECONDS) // (MPT_M * 125) * (MPT_M * 125)
    t = np.arange(n) / MPT_FS
    gtc = np.concatenate([SYNC_CONTROL, mpt_encode_codeword(
        _gtc_data(channel=MPT_CHANNEL))])
    bits = np.tile(np.concatenate(
        [np.random.default_rng(0).integers(0, 2, 24).astype(np.uint8), gtc]),
        40)
    ctrl_audio = _afsk_modulate(bits)
    need = int(n / MPT_FS * 8000.0) + 100
    ctrl_audio = np.tile(ctrl_audio, need // len(ctrl_audio) + 1)[:need]
    ctrl_iq = generators.nbfm_modulate(ctrl_audio, 8000.0, MPT_FS)[:n]
    voice = 0.6 * np.sin(2 * np.pi * 800.0 * np.arange(need) / 8000.0)
    voice_iq = generators.nbfm_modulate(voice, 8000.0, MPT_FS)[:n]
    wide = (ctrl_iq * np.exp(2j * np.pi * MPT_CONTROL_OFF * t)
            + voice_iq * np.exp(2j * np.pi * MPT_GRANTED_OFF * t))
    return _int8(wide, 55.0)


def _mixed_design_arrays(jrx) -> dict:
    """The nested decoder's design arrays: the NBFM decoder's taps and
    the slicer's own."""
    dec = jrx.decoder
    if hasattr(dec, "fsk"):
        slicer = {"fsk.taps": dec.fsk.taps}
    else:
        a = dec.afsk
        slicer = {"afsk.rtaps": a.rtaps,
                  "afsk.tone_taps": np.stack([*a.mark_taps, *a.space_taps]),
                  "afsk.avg_taps": a.avg_taps}
    return params_from_numpy(jrx.channelizer.hmat, dec.nbfm.baseband_taps,
                             resampler_taps=dec.nbfm.resampler_taps,
                             nested="nbfm", slicer_taps=slicer)


@pytest.fixture(scope="module", params=["ltr", "ltrnet", "passport",
                                        "mpt1327"])
def runs(request):
    kind = request.param
    if kind == "mpt1327":
        band = dict(identifier=0, base_frequency_hz=MPT_BASE_HZ,
                    channel_spacing_hz=12500.0)
        out = _run_pair(_mpt_capture(), MPT_FS, CENTER_HZ, MPT_CONTROL_OFF,
                        params=_mixed_design_arrays, slots=4, decoder=kind,
                        ppm_correction=False, idle_teardown_seconds=5.0,
                        jax_kw={"channel_map": JFrequencyBand(**band)},
                        port_kw={"channel_map": FrequencyBand(**band)})
    else:
        out = _run_pair(_fsk_capture(kind), LTR_FS, CENTER_HZ, LTR_OFF,
                        params=_mixed_design_arrays, slots=4, decoder=kind,
                        ppm_correction=False)
    for o in (out[0], out[3]):
        for slot in o.slots:
            if slot.active:
                o._slot_flush_drain(slot)
    return kind, out


def _plain(value):
    """A message or event field as plain data: the port's enums and
    classes are its own copies, so objects are compared by content."""
    if isinstance(value, enum.Enum):
        return value.name
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if hasattr(value, "__dict__"):
        return {k: _plain(v) for k, v in vars(value).items()}
    return value


def _slot_messages(orch):
    return [[_plain(m) for m in (p.messages if p is not None else [])]
            for p in orch.bank_proc.procs]


def _slot_events(orch):
    return [[(e.event_type.name, e.protocol, round(e.time_start, 6),
              e.details, sorted(str(i.value) for i in e.identifiers.all()))
             for e in (p.history.events if p is not None else [])]
            for p in orch.bank_proc.procs]


def test_mixed_attributes(runs):
    kind, (jorch, _, _, orch, _, _) = runs
    assert orch.bank_mode and orch.bank_mixed and not orch.bank_analog
    assert orch.bank_mode == jorch.bank_mode
    assert orch.bank_mixed == jorch.bank_mixed
    assert orch.chunk_samples == jorch.chunk_samples
    assert orch._bank_ka == jorch._bank_ka == 80
    assert orch._bank_bit_cap == jorch._bank_bit_cap
    assert orch.traffic.protocol == jorch.traffic.protocol
    assert (orch.channel_map is None) == (kind != "mpt1327")


def test_same_messages(runs):
    kind, (jorch, _, _, orch, _, _) = runs
    got = _slot_messages(orch)
    assert got == _slot_messages(jorch)
    want_type = {"ltr": "CALL", "ltrnet": "OSW_CALL_START", "passport": "CALL_START",
                 "mpt1327": "GTC"}[kind]
    types = [m["message_type"] for m in got[0]]
    assert types.count(want_type) >= 3, types
    frames = [s["frames"] for s in orch.channel_status()]
    assert frames == [s["frames"] for s in jorch.channel_status()]
    assert frames[0] == len(got[0])


def test_same_events(runs):
    kind, (jorch, _, _, orch, _, _) = runs
    assert _events(orch) == _events(jorch)
    got = _slot_events(orch)
    assert got == _slot_events(jorch)
    if kind == "mpt1327":
        # the GTC grant, mapped through the channel map, was followed
        freq = CENTER_HZ + MPT_GRANTED_OFF
        assert [e for e in orch.events
                if e.frequency_hz == pytest.approx(freq)]
        assert not orch.skipped_grants
        granted = [s for s in orch.slots
                   if not s.is_control and s.frequency_hz == freq]
        assert granted and granted[0].active
    elif kind == "ltrnet":
        # the copied LTRNetChannelProcessor looks for tracker events of
        # type "call" while LtrNetTracker emits "CALL_START", so neither
        # package's slot history gets an event; the tracker's own agree
        tracked = orch.bank_proc.procs[0].tracker.events
        assert tracked == jorch.bank_proc.procs[0].tracker.events
        assert tracked and tracked[0]["type"] == "CALL_START"
    else:
        assert got[0] and got[0][0][0] == "CALL_GROUP"


def _segments(orch):
    return [(round(s.start_time, 6), s.duration) for s in orch.audio_segments]


def test_same_audio_segments(runs):
    kind, (jorch, _, _, orch, _, _) = runs
    assert _segments(orch) == _segments(jorch)
    segs = [s for s in orch.audio_segments if s.duration > 0.2]
    assert len(segs) >= (2 if kind == "mpt1327" else 1)
    # the strongest tone above the sub-audible band (the 300-baud data
    # lies below 400 Hz and outweighs the voice in the LTR-family scenes)
    peaks = []
    for seg in segs:
        spec = np.abs(np.fft.rfft(seg.samples[400:]))
        freqs = np.fft.rfftfreq(len(seg.samples) - 400, 1 / 8000.0)
        spec[freqs < 400.0] = 0.0
        peaks.append(float(freqs[int(np.argmax(spec))]))
    assert any(700.0 < p < 900.0 for p in peaks), peaks      # the voice


def test_same_metrics_trace(runs):
    kind, (_, j_lines, _, _, t_lines, _) = runs
    trace = _trace(t_lines)
    assert trace == _trace(j_lines)
    assert max(m["active_channels"] for m in trace) == \
        (2 if kind == "mpt1327" else 1)
    assert trace[-1]["frames"] >= 0 and sum(m["frames"] for m in trace) >= 3


def _levels(pcm):
    return (pcm & 127).astype(np.int32) * np.where(pcm >= 128, -1, 1)


def test_packed_mixed_matches_reference(runs):
    kind, (jorch, _, j_packed, orch, _, t_packed) = runs
    c, ka, cap = len(orch.slots), orch._bank_ka, orch._bank_bit_cap
    nb = (ka + 7) // 8
    assert len(j_packed) == len(t_packed) > 0
    compared = samples = off_by_one = bits_read = 0
    for (jbuf, jbins), (tbuf, tbins) in zip(j_packed, t_packed):
        np.testing.assert_array_equal(tbins, jbins)
        assert len(tbuf) == len(jbuf) == c * (ka + nb + cap // 8 + 4)
        jl = _levels(jbuf[:c * ka]).reshape(c, ka)
        tl = _levels(tbuf[:c * ka]).reshape(c, ka)
        _, jgate, jbits, jcounts = jorch._split_packed_mixed(jbuf)
        _, tgate, tbits, tcounts = orch._split_packed_mixed(tbuf)
        for s in np.nonzero((jbins != 0).any(axis=1))[0]:
            np.testing.assert_array_equal(tgate[s], jgate[s])
            n = int(jcounts[s])
            assert int(tcounts[s]) == n <= cap
            np.testing.assert_array_equal(tbits[s, :n], jbits[s, :n])
            assert not tbits[s, n:].any()
            diff = np.abs(tl[s] - jl[s])
            assert diff.max() <= 1
            off_by_one += int((diff == 1).sum())
            samples += ka
            bits_read += n
            compared += 1
    assert compared >= len(j_packed)
    assert off_by_one <= OFF_BY_ONE[kind], (kind, off_by_one, samples)
    baud = 1200.0 if kind == "mpt1327" else 300.0
    seconds = len(j_packed) * orch.chunk_samples / orch.sample_rate
    assert bits_read >= 0.9 * baud * seconds
