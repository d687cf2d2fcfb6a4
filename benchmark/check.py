"""Deciding ``correct``: the program's outputs and carried state against
the plain reference (``reference/<decoder kind>.py``), chunk by chunk.

The symbol loops are decision-directed feedback loops: started from two
states a rounding apart they can settle on different timings for
seconds, so the reference cannot follow the program from a state of its
own. It follows the program step by step instead: for each chunk the
window kept, it starts from the program's own carried state before the
chunk, runs the chunk through ingest, the slots' channel front
(``front``: the channelizer, each slot's bin or, where its decoder
kind's reference states ``SLOT_FRONT = "bin_pair"``, its two bins
joined, and the residual mix: ``slot_front``) and the decoder chain,
and compares the chunk's outputs (what the program's transfer says for
a seeded sample of slots) and every leaf of the state after it: the
front's (``FRONT``: the channelizer's input history, the slots' mixer
phases, the two-bin join's rotation) and the chain's
(``STATE`` of the reference module). So a step that stops carrying any
leaf across chunks, whose outputs the reference would follow, fails
that leaf's gap. Two more numbers cover the start: the program's state
before its first chunk against the reference's fresh state
(``init_gap``) and the leaves that one side carries and the other does
not (``leaves_unmatched``).

A leaf's gap, per checked slot (``leaf_gaps``), by its kind: ``lane``,
the widest gap over the slot's largest value of the leaf; ``leaf``, the
widest gap over the largest value of the leaf over every checked slot;
``angle``, the gap in radians, turns left out; ``abs``, the widest gap
itself; ``near``, the least gap to any of the reference's candidates
(``<leaf>_near``, the raw samples beside the one it keeps). The chain's
``GUARDED`` leaves are compared in the slots its ``guard`` holds: the
C4FM loop's where both sides took as many symbols, the NBFM audio's
where the squelch is open and the discriminator is well conditioned
near the chunk's end (``reference/nbfm.py``).

Each number's limit is in ``checks/<workload>.json``, beside the sample
sizes, with the readings it was set from in PERF.md.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from .reference import dsp

FRONT = {"chan": "abs", "mixer_phase": "angle", "rot": "abs"}
SHARED = ("chan", "rot")         # leaves without a slot axis


def _rows(v, shared: bool) -> np.ndarray:
    v = np.asarray(v)
    return v.reshape(1, -1) if shared else v.reshape(v.shape[0], -1)


def leaf_gaps(kinds: dict, got: dict, want: dict, guarded=(),
              held=None) -> dict:
    """{``<leaf>_gap``: per-slot gaps} of every leaf in ``kinds`` that
    both states carry; those of the leaves in ``guarded`` only in the
    slots that ``held`` (a mask) holds."""
    out = {}
    for leaf, kind in kinds.items():
        if leaf not in got or leaf not in want:
            continue
        shared = leaf in SHARED
        a, b = _rows(got[leaf], shared), _rows(want[leaf], shared)
        d = a - b
        if kind == "angle":
            d = np.remainder(d + np.pi, dsp.TWO_PI) - np.pi
        elif kind == "near":
            d = np.abs(a - _rows(want[f"{leaf}_near"], shared)).min(
                axis=1, keepdims=True)
        gap = np.abs(d).max(axis=1)
        if kind == "lane":
            gap = gap / np.maximum(np.abs(b).max(axis=1), dsp.TINY)
        elif kind == "leaf":
            gap = gap / max(float(np.abs(b).max()), dsp.TINY)
        if leaf in guarded:
            gap = gap[held]
        out[f"{leaf}_gap"] = gap.astype(np.float64).tolist()
    return out


def bin_pairs(config: dict, offsets: np.ndarray) -> tuple:
    """(the bin pair (slots, 2), the residual mixer step) of slots at
    baseband offsets f served from two adjacent bins: the wide channel of
    a P25 Phase 2 slot, which sdrtrunk's DecodeConfigP25Phase2 asks for
    (50 kHz) and serves from two channelizer outputs through
    TwoChannelSynthesizerM2; the JAX package's
    ``runtime/orchestrator.py:609-631`` keeps the rule, and the port with
    it. With spacing = sample rate / M, the pair is (floor(f / spacing)
    mod M, floor(f / spacing) + 1 mod M), the residual f - (centre of the
    lower bin + spacing / 2), a bin's centre m spacing with m taken into
    (-M/2, M/2], and the step 2 pi residual / the channel rate (2
    spacing)."""
    m = config["channels"]
    spacing = config["sample_rate_hz"] / m
    low = np.floor(offsets / spacing).astype(np.int64)
    wrapped = low % m
    centre = np.where(wrapped > m // 2, wrapped - m, wrapped) * spacing
    residual = offsets - (centre + spacing / 2.0)
    rate = 2.0 * config["sample_rate_hz"] / m
    pairs = np.stack([low % m, (low + 1) % m], axis=1)
    return pairs, 2.0 * np.pi * residual / rate


def slot_front(config: dict, replay) -> tuple:
    """Each slot's channel front, slot by slot, as its decoder kind's
    reference module states it in ``SLOT_FRONT``: ``"bin"`` (the
    default), the bin the replay set put it in at the replay set's step,
    or ``"bin_pair"`` (``bin_pairs``). Returns (the bin pairs (slots, 2),
    both the slot's bin for one bin, the residual mixer steps), the form
    of the program's plan. The replay set's bytes do not depend on it:
    each slot is synthesised into its own bin at the bin's centre, inside
    its pair's flat band (``tests/test_harness_front.py``). Every slot of
    a configuration has its decoder kind."""
    mod = importlib.import_module(
        f"benchmark.reference.{config['decoder']['kind']}")
    paired = np.full(len(replay.bins),
                     getattr(mod, "SLOT_FRONT", "bin") == "bin_pair")
    pairs, steps = bin_pairs(config, replay.offsets_hz)
    return (np.where(paired[:, None], pairs, replay.bins[:, None]),
            np.where(paired, steps, replay.step_rad))


def front(x: torch.Tensor, before: dict, hmat: np.ndarray, pairs, steps,
          p: dsp.Precision) -> tuple:
    """The channel front of slots over one ingested chunk from ``before``
    (its ``chan``, ``mixer_phase`` and ``rot``): each slot's bin, or where
    its pair (a row of ``pairs``) holds two bins, the two joined from
    ``rot`` on; then mixed by the slot's residual step. Returns ((slots,
    K) rows, the mixer phase after the chunk)."""
    paired = pairs[:, 0] != pairs[:, 1]
    if not paired.any():
        streams = dsp.channelize_bins(x, before["chan"], hmat, pairs[:, 0],
                                      p)
    else:
        both = dsp.channelize_bins(x, before["chan"], hmat,
                                   pairs.reshape(-1), p)
        lo = both[0::2]
        joined = dsp.join_pair(lo, both[1::2], before["rot"])
        streams = torch.where(torch.as_tensor(paired, device=lo.device)
                              [:, None], joined, lo)
    return dsp.mix(streams, steps, before["mixer_phase"])


class Checker:
    """The reference side of one run: the configuration's chain, the
    replay set and the workload's limits."""

    def __init__(self, config: dict, replay, tier: str, limits: dict,
                 device):
        self.mod = importlib.import_module(
            f"benchmark.reference.{config['decoder']['kind']}")
        m = config["channels"]
        self.rate = 2.0 * config["sample_rate_hz"] / m
        self.chain = self.mod.Chain(config["decoder"], self.rate)
        self.hmat = dsp.channelizer_prototype(
            m, config["taps_per_branch"]).reshape(-1, m)
        self.kinds = {**FRONT, **self.mod.STATE}
        self.pairs, self.steps = slot_front(config, replay)
        self.replay = replay
        self.tier = tier
        self.limits = limits
        self.device = device

    def lanes(self, seed: int, g: int) -> list:
        """The slots checked in chunk g: slot 0 and a seeded sample of the
        rest, ``checked_slots`` in all."""
        n = len(self.replay.bins)
        want = min(self.limits["checked_slots"], n)
        rng = np.random.default_rng([seed, g])
        rest = rng.choice(np.arange(1, n), want - 1, replace=False)
        return [0] + sorted(rest.tolist())

    def step(self, chunk: np.ndarray, before: dict, slots,
             p: dsp.Precision):
        """One chunk through the reference from ``before`` (host state of
        the slots): (what its outputs would say, the state after it)."""
        x = dsp.ingest(chunk, p, self.device)
        rows, phase = front(x, before, self.hmat, self.pairs[slots],
                            self.steps[slots], p)
        out, after = self.mod.decode(self.chain, rows, before, p)
        hist = torch.cat([torch.as_tensor(before["chan"], device=x.device),
                          x.to(torch.complex128)])
        after["chan"] = hist[-len(before["chan"]):].cpu().numpy()
        after["mixer_phase"] = phase
        after["rot"] = np.float64((int(before["rot"]) + rows.shape[1]) % 4)
        return self.mod.expected(self.chain, self.tier, out, after,
                                 self.replay.channel_samples), after

    def readings(self, kept: list, seed: int,
                 p: dsp.Precision = dsp.Precision(), control=None,
                 stale: bool = False):
        """Per-lane readings over the kept chunks (their states on the
        host, at ``lanes(seed, g)``). With ``control`` (a Precision), the
        reference at that precision stands in the program's place. With
        ``stale``, (those readings, the readings with the program's state
        before each chunk standing for its state after: those of a step
        that leaves each leaf unchanged, leaf by leaf)."""
        k = self.replay.channel_samples
        r: dict = {}
        r_stale: dict = {}

        def add(to, got, want, got_state, want_state):
            held = self.mod.guard(got, want)
            for part in (self.mod.readings(self.chain, got, want, want_state),
                         leaf_gaps(self.kinds, got_state, want_state,
                                   self.mod.GUARDED, held)):
                for key, v in part.items():
                    to.setdefault(key, []).extend(v)

        for keep in kept:
            slots = self.lanes(seed, keep.g)
            before = keep.before
            chunk = self.replay.chunks[keep.g % len(self.replay.chunks)]
            want, want_state = self.step(chunk, before, slots, p)
            if control is None:
                got = self.mod.symbols(self.chain, self.tier,
                                       {**keep.outputs,
                                        "slots": len(self.replay.bins)},
                                       slots, k)
                add(r, got, want, keep.after, want_state)
                if stale:
                    add(r_stale, got, want, keep.before, want_state)
            else:
                got, got_state = self.step(chunk, before, slots, control)
                add(r, got, want, got_state, want_state)
        return (r, r_stale) if stale else r

    def start(self, snap_host: dict) -> dict:
        """The numbers of the program's state before its first chunk: the
        largest gap to the reference's fresh state over every leaf both
        carry, and the count of leaves only one side carries."""
        lanes = len(snap_host["mixer_phase"])
        fresh = self.mod.fresh(self.chain, lanes)
        fresh["chan"] = np.zeros(self.hmat.size, np.complex128)
        fresh["mixer_phase"] = np.zeros(lanes)
        fresh["rot"] = np.float64(0.0)
        both = set(fresh) & set(snap_host)
        return {"init_gap": max(float(np.abs(np.asarray(snap_host[key])
                                             - fresh[key]).max())
                                for key in both),
                "leaves_unmatched": len(set(fresh) ^ set(snap_host))}

    def all_readings(self, per_chunk: list, start: dict) -> dict:
        """Every number the readings of one or more chunks give, compared
        or not."""
        readings: dict = {}
        for r in per_chunk:
            for key, v in r.items():
                readings.setdefault(key, []).extend(v)
        values = self.mod.summarize(readings)
        for leaf in self.kinds:
            values[f"{leaf}_gap"] = max(readings.get(f"{leaf}_gap", []),
                                        default=0.0)
        values.update(start)
        return values

    def numbers(self, per_chunk: list, start: dict) -> dict:
        """{name: (value, limit)} of every number compared."""
        values = self.all_readings(per_chunk, start)
        return {name: (values[name], limit)
                for name, limit in self.limits["limits"].items()}
