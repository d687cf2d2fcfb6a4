"""The check's two-bin front (``check.front`` for a decoder kind whose
reference states ``SLOT_FRONT = "bin_pair"``, a P25 Phase 2 slot's wide
channel) against the port's own select and mix, at the tiny cut on the
CPU: the streams, and the mixer phase and join rotation the program
carries, for the rotation entering a chunk at 0, 1, 2 and 3; the join's
passband; planted faults; and the adapter's refusal of a plan that is
not the check's front."""
import sys
import types
from unittest import mock

import numpy as np
import pytest
import torch

from benchmark import adapter
from benchmark.adapter import System
from benchmark.check import bin_pairs, front, slot_front
from benchmark.reference import dsp
from benchmark.tests import tiny
from benchmark.traffic import generator

torch.set_num_threads(1)

SEED = 2**31 + 29
SLOTS = 8
# 63 blocks: 126 channel samples a chunk, not a multiple of 4, so the
# rotation entering a chunk moves on by 2 each chunk
BLOCKS = 63
# the program's front is float32: its channelizer, and mixer angles up to
# 126 x pi/2 = 198 rad (an ulp 1.5e-5) from a step 4.4e-8 rad off -pi/2;
# at this cut its streams read 1.1e-5 of their peak from the float64
# front, its mixer phase 6.5e-6 rad
STREAM_TOL = 4e-5
PHASE_TOL = 2e-5
# the C4FM bank's configuration and mix under the Phase 2 decoder: only
# the front is read
P25P2 = {"decoder": {"kind": "p25p2"}}


@pytest.fixture
def cpu():
    import sdrtrunk_tpu_torch as st

    with st.use_device("cpu"):
        yield torch.device("cpu")


@pytest.fixture
def p25p2(monkeypatch):
    """A stand-in for the Phase 2 reference module, stating its front."""
    def state(front="bin_pair"):
        mod = types.ModuleType("benchmark.reference.p25p2")
        if front is not None:
            mod.SLOT_FRONT = front
        monkeypatch.setitem(sys.modules, mod.__name__, mod)
    state()
    return state


def _spec(config=P25P2):
    s = tiny.spec("c4fm_bank_1023", slots=SLOTS, blocks=BLOCKS)
    s.config = {**s.config, **config}
    return s


def _hmat(config):
    m = config["channels"]
    return dsp.channelizer_prototype(m, config["taps_per_branch"]
                                     ).reshape(-1, m)


def _set_rot(system, rot: int) -> None:
    state = system.orch.state
    system.orch.state = {**state, "rot": torch.full_like(state["rot"], rot)}


def _program_streams(system, chunk) -> torch.Tensor:
    """The slots' streams out of the program's select and mix on a chunk,
    from a copy of its running state."""
    from sdrtrunk_tpu_torch import receiver

    real = receiver.dynamic_select_mix
    seen = {}

    def select_mix(*args):
        seen["streams"], phase = real(*args)
        return seen["streams"], phase
    with mock.patch.object(receiver, "dynamic_select_mix", select_mix):
        for _, fn in system.layers(chunk)[:2]:     # channelize, select_mix
            fn()
    return seen["streams"]


def gaps(system, chunk: np.ndarray, slots: list, pairs, steps,
         hmat) -> dict:
    """Drive one chunk through the program and read its front against
    the check's, from the program's state before the chunk: the largest
    over the slots of the widest stream gap over the reference's peak,
    the mixer phase gap in radians (turns left out), the rotation's."""
    before = system.lanes(system.snapshot(), slots)
    got = _program_streams(system, chunk)[slots].cpu().numpy().astype(
        np.complex128)
    system.dispatch(system.upload(system.prepare(chunk)))
    after = system.lanes(system.snapshot(), slots)
    x = dsp.ingest(chunk, dsp.Precision(), system.device)
    rows, phase = front(x, before, hmat, pairs[slots], steps[slots],
                        dsp.Precision())
    want = rows.cpu().numpy()
    peak = np.maximum(np.abs(want).max(axis=1), dsp.TINY)
    turn = np.remainder(after["mixer_phase"] - phase + np.pi,
                        dsp.TWO_PI) - np.pi
    rot = (int(before["rot"]) + want.shape[1]) % 4
    return {"rot_before": int(before["rot"]),
            "stream_gap": float((np.abs(got - want).max(axis=1)
                                 / peak).max()),
            "mixer_phase_gap": float(np.abs(turn).max()),
            "rot_gap": float(abs(after["rot"] - rot))}


def _drive(system, config, replay, chunks=2) -> list:
    pairs, steps = slot_front(config, replay)
    return [gaps(system, replay.chunks[g], list(range(SLOTS)), pairs, steps,
                 _hmat(config))
            for g in range(chunks)]


def test_front_states_the_pair(p25p2):
    s = _spec()
    replay = generator.build(s.config, s.mix, SEED, "cpu")
    m = s.config["channels"]
    pairs, steps = slot_front(s.config, replay)
    assert pairs.tolist() == [[b, (b + 1) % m] for b in replay.bins]
    assert np.all(steps == 2.0 * np.pi * -6250.0 / 25000.0)
    p25p2(None)                                    # states no front
    pairs, steps = slot_front(s.config, replay)
    assert pairs.tolist() == [[b, b] for b in replay.bins]
    assert not steps.any()


def test_pair_rule_between_centres():
    """Off the bins' centres, and around the wrap at negative offsets."""
    cfg = {"channels": 64, "sample_rate_hz": 800000.0}
    sp = 12500.0
    pairs, steps = bin_pairs(
        cfg, np.array([3.3 * sp, -0.2 * sp, -30.6 * sp, 30.9 * sp]))
    assert pairs.tolist() == [[3, 4], [63, 0], [33, 34], [30, 31]]
    assert np.allclose(steps * 25000.0 / (2 * np.pi),
                       [-0.2 * sp, 0.3 * sp, -0.1 * sp, 0.4 * sp])


@pytest.mark.parametrize("rot", [0, 1, 2, 3])
def test_pair_front_follows_the_program(cpu, p25p2, rot):
    s = _spec()
    replay = generator.build(s.config, s.mix, SEED, "cpu")
    system = System(s.config, replay, cpu)
    _set_rot(system, rot)
    got = _drive(system, s.config, replay)
    system.close()
    assert [g["rot_before"] for g in got] == [rot, (rot + 2) % 4]
    for g in got:
        assert g["stream_gap"] < STREAM_TOL, got
        assert g["mixer_phase_gap"] < PHASE_TOL, got
        assert g["rot_gap"] == 0, got


def test_join_passband():
    """From a fresh state, a tone within +/-9 kHz of a pair's centre, the
    seam between its bins included, comes out at unit gain within 2e-4
    (the prototype's ripple: 1.2e-4 read on a 125 Hz grid) at its offset
    from the slot's frequency; at +/-12.5 kHz, a lone bin's half-amplitude edge, at half
    within 1e-3."""
    cfg = {"channels": 64, "sample_rate_hz": 800000.0, "taps_per_branch": 9}
    hmat = _hmat(cfg)
    sp, rate = 12500.0, 25000.0
    pairs, steps = bin_pairs(cfg, np.array([5 * sp]))
    n = np.arange(256 * 32)
    before = {"chan": np.zeros(hmat.size, np.complex128),
              "mixer_phase": np.zeros(1), "rot": np.float64(0.0)}
    for d in [*np.arange(-9000.0, 9001.0, 250.0), -12500.0, 12500.0]:
        x = torch.as_tensor(np.exp(2j * np.pi * (5.5 * sp + d) * n / 8e5))
        rows, _ = front(x, before, hmat, pairs, steps, dsp.Precision())
        z = rows[0, 2 * hmat.shape[0]:].numpy()        # past the fill
        gain = np.abs(z)
        turn = np.angle(np.mean(z[1:] * np.conj(z[:-1])))
        if abs(d) <= 9000.0:
            assert np.abs(gain - 1.0).max() < 2e-4, d
        else:
            assert np.abs(gain - 0.5).max() < 1e-3, d
        # mixed down to the slot, half a bin below the pair's centre
        want = 2 * np.pi * (d + sp / 2) / rate
        assert abs(np.angle(np.exp(1j * (turn - want)))) < 1e-9, d


def _rot_not_carried(monkeypatch, system):
    real = System.dispatch

    def dispatch(self, dev_iq):
        rot = self.orch.state["rot"]
        out = real(self, dev_iq)
        self.orch.state = {**self.orch.state, "rot": rot}
        return out
    monkeypatch.setattr(System, "dispatch", dispatch)


def _join_from_stale_rot(monkeypatch, system):
    """The join's cycle starts each chunk where the first chunk's did."""
    from sdrtrunk_tpu_torch import receiver

    real = receiver.dynamic_select_mix

    def select_mix(y, rot, *args):
        return real(y, torch.zeros_like(rot), *args)
    monkeypatch.setattr(receiver, "dynamic_select_mix", select_mix)


def _pair_shifted_down(monkeypatch, system):
    system.orch.bins = (system.orch.bins - 1) % 64


@pytest.mark.parametrize("fault", [_rot_not_carried, _join_from_stale_rot,
                                   _pair_shifted_down],
                         ids=lambda f: f.__name__[1:])
def test_planted_fault_fails_the_front(cpu, p25p2, monkeypatch, fault):
    s = _spec()
    replay = generator.build(s.config, s.mix, SEED, "cpu")
    system = System(s.config, replay, cpu)
    fault(monkeypatch, system)
    got = _drive(system, s.config, replay)
    system.close()
    worst = max(max(g["stream_gap"], g["mixer_phase_gap"], g["rot_gap"])
                for g in got)
    assert worst > 0.1, got


def test_adapter_refuses_another_front(cpu, p25p2):
    """The program tunes a Phase 2 slot to a pair: where the kind's
    reference states one bin a slot, or a step is off in a slot, the
    plan is refused at set-up, naming the slot."""
    s = _spec()
    replay = generator.build(s.config, s.mix, SEED, "cpu")
    system = System(s.config, replay, cpu)
    pairs, steps = slot_front(s.config, replay)
    steps[3] += 1e-6
    with pytest.raises(RuntimeError, match=r"slot 3 \(1 in all\)"):
        adapter._same_front(system.orch, pairs, steps)
    system.close()
    p25p2(None)
    with pytest.raises(RuntimeError, match=r"slot 0 \(8 in all\)"):
        System(s.config, replay, cpu)
