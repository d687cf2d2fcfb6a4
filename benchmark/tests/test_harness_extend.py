"""What a later cell adds as files alone: a signal kind is a module found
by name, and moving the kinds out of the generator left every replay
set's bytes as they were; the Gardner kernel's roofline count; the NBFM
check's guard against a discriminator unsure near a chunk's end."""
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
