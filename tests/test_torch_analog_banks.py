"""The analog slice as a whole on the CPU: the port's bank-mode
Orchestrator(decoder="nbfm" | "am") against the JAX one. Both start from
one state, carried across with convert.py, and must give the same
AudioSegments (count, start times, durations) and metrics trace. The live
step's one flat transfer (PCM | gate bits) is compared on every chunk, on
each slot that was tuned:

* gate bits exactly;
* PCM within one level: the audio agrees within 1e-4 (test_torch_analog),
  and both packages truncate float to int, so an ulp at a .5 boundary of
  mu-law's level (or of int16's step) could move the level by one. The
  samples off by one are counted, and none are: both scenes' PCM is
  equal, in both formats (the mu-law level is rounded as the reference's
  compile rounds it, tests/test_torch_reference_digests.py).

NBFM scene: tests/test_orchestrator_bank.py::test_analog_bank_audio_segments
(400 kHz, 32 bins, 4 slots, two NBFM tones, one of them on the pinned slot
and one activated directly), for audio_format "mulaw8" and "int16", at its
full 1.2 s. AM scene, built here alike: two carriers with a 1 kHz tone at
50% depth, 0.8 s.
"""
import sys

import numpy as np
import pytest
import torch

from sdrtrunk_tpu.signal.generators import nbfm_modulate
from test_torch_gardner_banks import _run_pair, _trace

torch.set_num_threads(1)

FS = 32 * 12500.0
M = 32
CHUNK = M * 25 * 32                 # K = 1600 channel samples, 512 audio
CENTER_HZ = 460e6
OFFSETS = (2 * 12500.0, -5 * 12500.0)
AM_TONE_HZ = 1000.0


def _int8(wide):
    scale = float(np.max(np.abs(np.stack([wide.real, wide.imag])))) or 1.0
    return np.clip(np.stack([wide.real, wide.imag], -1) / scale * 120.0,
                   -127, 127).astype(np.int8)


def _nbfm_capture():
    """The reference scene's int8 capture: NBFM tones at 500 and 800 Hz."""
    dur = 1.2
    n = int(FS * dur) // (M * 25) * (M * 25)
    t = np.arange(n) / FS
    wide = np.zeros(n, np.complex64)
    for k, off in enumerate(OFFSETS):
        audio = 0.8 * np.sin(2 * np.pi * (500.0 + 300 * k)
                             * np.arange(int(8000 * dur)) / 8000.0)
        iq = nbfm_modulate(audio, 8000.0, FS)[:n]
        wide[:len(iq)] += (iq * np.exp(2j * np.pi * off * t[:len(iq)])
                           ).astype(np.complex64)
    return _int8(wide)


def _am_capture():
    """Two AM carriers, each with a 1 kHz tone at 50% depth."""
    n = int(FS * 0.8) // CHUNK * CHUNK
    t = np.arange(n) / FS
    wide = np.zeros(n, np.complex64)
    for k, off in enumerate(OFFSETS):
        env = 1.0 + 0.5 * np.sin(2 * np.pi * AM_TONE_HZ * t + k)
        wide += (0.4 * env * np.exp(2j * np.pi * off * t + 1j * k)
                 ).astype(np.complex64)
    return _int8(wide)


def _activate_second(orch):
    """Start the second channel directly, as the reference scene does
    (an analog bank has no control channel to grant it)."""
    module = sys.modules[type(orch).__module__]
    orch._activate(CENTER_HZ + OFFSETS[1], module.IdentifierCollection())


def _run(capture, decoder, audio_format):
    out = _run_pair(capture, FS, CENTER_HZ, OFFSETS[0],
                    prepare=_activate_second, slots=4, decoder=decoder,
                    chunk_samples=CHUNK, ppm_correction=False,
                    audio_format=audio_format)
    jorch, orch = out[0], out[3]
    for o in (jorch, orch):
        for slot in o.slots:
            if slot.active:
                o._slot_flush_drain(slot)
    return out


@pytest.fixture(scope="module", params=["mulaw8", "int16"])
def nbfm_runs(request):
    return request.param, _run(_nbfm_capture(), "nbfm", request.param)


@pytest.fixture(scope="module")
def am_runs():
    return _run(_am_capture(), "am", "mulaw8")


def _levels(pcm, audio_format):
    """Signed PCM levels: int16 samples, or mu-law's sign * level."""
    if audio_format == "int16":
        return pcm.view("<i2").astype(np.int32)
    return (pcm & 127).astype(np.int32) * np.where(pcm >= 128, -1, 1)


def _compare_packed_audio(jorch, j_packed, orch, t_packed):
    """Every chunk's flat transfer on each tuned slot: gate bits exact,
    PCM within one level. Returns (slot-chunks compared, samples compared,
    samples one level apart)."""
    fmt, ka = orch.audio_format, orch._bank_ka
    assert jorch._bank_ka == ka and jorch.audio_format == fmt
    width = 2 if fmt == "int16" else 1
    c = len(orch.slots)
    assert len(j_packed) == len(t_packed) > 0
    compared = samples = off_by_one = 0
    for (jbuf, jbins), (tbuf, tbins) in zip(j_packed, t_packed):
        np.testing.assert_array_equal(tbins, jbins)
        assert len(tbuf) == len(jbuf) == c * (ka * width + (ka + 7) // 8)
        n = c * ka * width
        jl = _levels(jbuf[:n], fmt).reshape(c, ka)
        tl = _levels(tbuf[:n], fmt).reshape(c, ka)
        jg = jbuf[n:].reshape(c, -1)
        tg = tbuf[n:].reshape(c, -1)
        for s in np.nonzero((jbins != 0).any(axis=1))[0]:
            np.testing.assert_array_equal(tg[s], jg[s])
            diff = np.abs(tl[s] - jl[s])
            assert diff.max() <= 1
            off_by_one += int((diff == 1).sum())
            samples += ka
            compared += 1
    return compared, samples, off_by_one


def _segments(orch):
    return [(round(s.start_time, 6), s.duration) for s in orch.audio_segments]


def _dominant_hz(samples):
    spec = np.abs(np.fft.rfft(samples[800:]))
    return np.fft.rfftfreq(len(samples) - 800, 1 / 8000.0)[np.argmax(spec)]


def test_nbfm_bank_gives_same_audio_segments(nbfm_runs):
    _, (jorch, _, _, orch, _, _) = nbfm_runs
    assert _segments(orch) == _segments(jorch)
    segs = [s for s in orch.audio_segments if s.duration > 0.2]
    assert len(segs) >= 2
    assert 350.0 < _dominant_hz(segs[0].samples) < 950.0


def test_nbfm_bank_same_metrics_trace(nbfm_runs):
    _, (_, j_lines, _, _, t_lines, _) = nbfm_runs
    trace = _trace(t_lines)
    assert trace == _trace(j_lines)
    assert max(m["active_channels"] for m in trace) == 2


def test_nbfm_packed_audio_matches_reference(nbfm_runs):
    fmt, (jorch, _, j_packed, orch, _, t_packed) = nbfm_runs
    compared, samples, off_by_one = _compare_packed_audio(
        jorch, j_packed, orch, t_packed)
    assert compared == 2 * len(j_packed)          # both tuned slots
    assert off_by_one == 0, (fmt, off_by_one, samples)


def test_am_bank_matches_reference(am_runs):
    jorch, j_lines, j_packed, orch, t_lines, t_packed = am_runs
    assert _segments(orch) == _segments(jorch)
    segs = [s for s in orch.audio_segments if s.duration > 0.2]
    assert len(segs) >= 2
    for seg in segs:
        assert abs(_dominant_hz(seg.samples) - AM_TONE_HZ) < 50.0
    assert _trace(t_lines) == _trace(j_lines)
    compared, samples, off_by_one = _compare_packed_audio(
        jorch, j_packed, orch, t_packed)
    assert compared == 2 * len(j_packed)
    assert off_by_one == 0, (off_by_one, samples)
