"""What a later cell adds as files alone: a signal kind is a module found
by name, and moving the kinds out of the generator left every replay
set's bytes as they were; the check's front, taught the two-bin join,
leaves every reading of the one-bin cells as it was; the Gardner
kernel's roofline count; the NBFM check's guard against a discriminator
unsure near a chunk's end."""
import hashlib
import json
import math
import sys

import numpy as np
import pytest
import torch

from benchmark import roofline
from benchmark.reference import dsp, nbfm
from benchmark.run import ROOT
from benchmark.tests import tiny
from benchmark.traffic import generator, signals

torch.set_num_threads(1)


def digest(r) -> str:
    """SHA-256 of a replay set: its chunks' bytes in order, then its
    slots' offsets, bins and mixer steps."""
    h = hashlib.sha256()
    for x in r.chunks:
        h.update(np.ascontiguousarray(x).tobytes())
    for a in (r.offsets_hz, r.bins, r.step_rad):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


# each mix at the tiny cut (64 blocks of 64 bins, 4 chunks), built on the
# CPU with one thread by the generator as it was before the signal kinds
# left it
RECORDED = {
    ("c4fm_bank_1023", 2147483655):
        "d2cc38c859c89d57515ac12834c21bd5c2f28cfcca0b7b6dc03efc39230eb864",
    ("c4fm_bank_1023", 3200000041):
        "799a00245a77e1060df94454a58e6ec6b43926f0b63398428d6e5c8026f97dfe",
    ("nbfm_bank_1023", 2147483655):
        "c996c174f8378dcfe774902ac5592278500f996d56fa75113fa3e67504e9a0a2",
    ("nbfm_bank_1023", 3200000041):
        "c8ed7197a501f5ccf06ddec24d067f155ea286cebcd495c852da6a6e40715864",
    ("c4fm_site_31", 2147483655):
        "ff337181957b776f8318861e7e4a1f6664ee17c50ee7aad1c262c3f022a68be9",
    ("c4fm_site_31", 3200000041):
        "6ca93f83c52a0fb59ad5fcfd7a350a7f792c8cbf0c81ee2070cb812bc4110e77",
}


@pytest.mark.parametrize("workload,seed", sorted(RECORDED))
def test_replay_bytes_as_recorded(workload, seed):
    s = tiny.spec(workload, blocks=64)
    assert digest(generator.build(s.config, s.mix, seed, "cpu")) \
        == RECORDED[workload, seed]


def _readings(workload: str, slots: int, seed: int) -> dict:
    """Every number ``Checker.all_readings`` gives on a run of the cut cell
    that drives three chunks from the end of its warm-up (by count, not by
    the clock), checking the two the seed draws."""
    import sdrtrunk_tpu_torch as st
    from benchmark import run
    from benchmark import window as win
    from benchmark.check import Checker

    s = tiny.spec(workload, slots=slots)
    cpu = torch.device("cpu")
    with st.use_device("cpu"):
        replay, system, init = run.set_up(s, seed, cpu)
        w = win.drive(system, replay.chunks, s.mix["warmup_chunks"], count=3,
                      sampler=win.Sampler(s.checks["checked_chunks"], seed,
                                          len(replay.chunks)))
        checker = Checker(s.config, replay, system.tier, s.checks, cpu)
        kept, init_host = run.hand_over(system, checker, w, init, seed)
    return checker.all_readings([checker.readings([k], seed) for k in kept],
                                checker.start(init_host))


READINGS_SEED = 2147483659
# each cell's readings at the tiny cut (12, 40 and 12 slots), taken on the
# CPU with one thread before the check's front learnt the two-bin join
READINGS = {
    "c4fm_bank_1023": {
        "dibit_errors": 0, "count_gap": 0, "hit_errors": 0,
        "chan_gap": 3.263179289445053e-08, "mixer_phase_gap": 0.0,
        "rot_gap": 0.0, "fir_gap": 1.872117731895836e-07,
        "agc_gap": 4.0510229425082e-07, "power_gap": 1.3190406602842432e-07,
        "window_gap": 0.00043959682952776315,
        "sampling_point_gap": 0.002251855555329918,
        "detected_sps_gap": 6.555648562756033e-05,
        "pll_phase_gap": 0.00029683515339229416,
        "pll_freq_gap": 6.637880906865991e-06,
        "prev_preceding_gap": 0.00011874952380592958,
        "prev_current_gap": 0.003753249542087992, "init_gap": 0.0,
        "leaves_unmatched": 0},
    "nbfm_bank_1023": {
        "pcm_differ_pct": 0.0, "gate_errors": 0, "lanes_checked": 16,
        "lanes_set_aside": 0, "chan_gap": 3.263179289445053e-08,
        "mixer_phase_gap": 0.0, "rot_gap": 0.0,
        "fir_gap": 3.934601263042097e-06, "prev_gap": 2.931450404671619e-07,
        "power_gap": 8.88314186919237e-08, "deemph_gap": 5.309284017984695e-07,
        "resamp_gap": 3.6875388952362087e-06, "init_gap": 0.0,
        "leaves_unmatched": 0},
    "c4fm_site_31": {
        "dibit_errors": 0, "count_gap": 0, "hit_errors": 0,
        "chan_gap": 3.236661680358512e-08, "mixer_phase_gap": 0.0,
        "rot_gap": 0.0, "fir_gap": 1.7597474399223997e-07,
        "agc_gap": 4.311850072675537e-07, "power_gap": 1.2419303692638054e-07,
        "window_gap": 0.00031635920768298116,
        "sampling_point_gap": 0.0042791557456913765,
        "detected_sps_gap": 9.737584372260244e-05,
        "pll_phase_gap": 0.0002665793994069965,
        "pll_freq_gap": 1.479450995153092e-06,
        "prev_preceding_gap": 0.00017355328171956368,
        "prev_current_gap": 0.000851850639493003, "init_gap": 0.0,
        "leaves_unmatched": 0},
}


@pytest.mark.parametrize("workload,slots", [("c4fm_bank_1023", 12),
                                            ("nbfm_bank_1023", 40),
                                            ("c4fm_site_31", 12)])
def test_readings_as_recorded(workload, slots):
    assert _readings(workload, slots, READINGS_SEED) == READINGS[workload]


def _tone_mix(kind: str) -> dict:
    s = tiny.spec("nbfm_bank_1023", slots=4, blocks=64)
    return s.config, {**s.mix, "signals": [
        {"signal": kind, "tone_hz": [300.0, 3000.0], "deviation_hz": 3000.0,
         "level": 0.7, "rest": True}]}


def test_unknown_kind_names_its_file():
    config, mix = _tone_mix("no_such_kind")
    with pytest.raises(ValueError, match=r"signals/no_such_kind\.py"):
        generator.build(config, mix, 1, "cpu")
    with pytest.raises(ValueError, match="unknown signal"):
        generator.signal_kind("../c4fm")


def test_kind_found_by_name(monkeypatch, tmp_path):
    """A module on the package's search path is a kind by its name alone:
    here fm_tone's own functions under another name give fm_tone's
    bytes."""
    name = "plugged_tone"
    (tmp_path / f"{name}.py").write_text(
        "from benchmark.traffic.signals.fm_tone import make, fill\n")
    monkeypatch.setattr(signals, "__path__",
                        [*signals.__path__, str(tmp_path)])
    full = f"{signals.__name__}.{name}"
    try:
        config, mix = _tone_mix(name)
        got = generator.build(config, mix, 7, "cpu")
        config, mix = _tone_mix("fm_tone")
        assert digest(got) == digest(generator.build(config, mix, 7, "cpu"))
    finally:
        sys.modules.pop(full, None)


def test_gardner_roofline_count():
    """The P25 Phase 2 bank's Gardner launch (1023 x 20480 at 50 kHz,
    6000 symbols/s, W = 16): bytes bind, 188.96 MB over 3.35 TB/s."""
    sps = 50000.0 / 6000.0
    ms = roofline.gardner_ms(1023, 20480, int(2 * sps), sps)
    assert ms == pytest.approx(0.0564, rel=0.02)
    assert ms == pytest.approx(1e3 * (8 * 1023 * 20480 + 1023 * 20480
                                      + 129 * 8 * 4
                                      + 2 * 1023 * (16 * 8 + 16 + 24))
                               / roofline.HBM_BYTES_PER_S)


def _chain():
    cfg = json.loads((ROOT / "benchmark/configs/nbfm_12m8.json").read_text())
    return nbfm.Chain(cfg["decoder"], 25000.0)


def test_guard_sets_aside_an_unsure_discriminator():
    """Open squelch: a tone whose step lies 5e-4 inside +/-pi at the
    chunk's end, and two tones whose sum passes at 0.7% of its rms five
    samples before the end, are set aside. A voice-band tone, the same
    near-pi tone only before the flip window, the same pass 60 samples
    before the end, and a squelch held shut: as before."""
    chain = _chain()
    k = 2000
    n = np.arange(k)
    rate = chain.rate
    delay = (len(chain.taps) - 1) // 2      # the linear-phase FIR's

    def tone(hz, phase=0.0):
        return np.exp(1j * (dsp.TWO_PI * np.cumsum(np.broadcast_to(
            hz, n.shape)) / rate + phase))

    def passing(at):
        """1 kHz at 1 and 1.1 kHz at 0.99, opposed at output sample at."""
        w = dsp.TWO_PI * 100.0 / rate
        return tone(1000.0) + 0.99 * tone(1100.0, np.pi - w * (at - delay))

    near = rate * (math.pi - 5e-4) / dsp.TWO_PI
    late = n >= k - chain.flip_window - 2 * len(chain.taps)
    lanes = [tone(near), tone(1000.0), tone(np.where(late, 1000.0, near)),
             1e-6 * tone(near), passing(k - 5), passing(k - 60)]
    streams = torch.as_tensor(np.stack(lanes))
    state = nbfm.fresh(chain, len(lanes))
    state["power"] = np.array([1.0, 1.0, 1.0, 0.0, 1.0, 1.0])
    out, _ = nbfm.decode(chain, streams, state, dsp.Precision())
    assert out["gate"][:, -1].tolist() == [True] * 3 + [False] + [True] * 2
    assert out["unsure"].tolist() == [True, False, False, True, True, False]
    assert nbfm.guard(None, out).tolist() == [False, True, True, False,
                                              False, True]
    r = nbfm.summarize(nbfm.readings(chain, out, out, None))
    assert (r["lanes_checked"], r["lanes_set_aside"]) == (6, 2)


def test_flip_window_covers_the_deemphasis():
    """A flip's jump, carried past the window, lies under a millionth of
    itself."""
    chain = _chain()
    assert chain.flip_window == 260
    assert (1.0 - chain.deemph_alpha) ** chain.flip_window \
        <= nbfm.FLIP_DECAY
