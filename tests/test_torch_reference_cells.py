"""The cells beside the bench banks, held to the JAX package: chip_smoke.py's
live LTR and MPT1327 mixed banks, LSM, AM and C4FM on 25 kHz channels.

* each cell's bytes and recipe (``bench_torch.cell_bytes``) drive the JAX
  Orchestrator (``tools/reference_digests.run_cell``) and the port's
  (``bench_torch.scene_bank_<cell>``) on the CPU, here at 32 slots of the
  full scene and chunks cut to 1024 to 2048 blocks (1250 where K must be
  a multiple of 25); the port's digest is held to the JAX package's within the
  cell's tolerance, events included;
* tests/torch_reference/cells_full_width.json (tools/reference_digests.py,
  the JAX package on the CPU) holds the five cells at full width (1023,
  1023, 64, 64 and 511 slots), each with its chunk hashes, per-slot digest,
  events and a stated tolerance, in under 200 KB;
* a channel's stream is the full scene's at any width;
* a mixed bank's digest holds each slot's messages and audio, and
  ``compare_digests`` finds a slot whose messages differ and holds the
  events;
* the mixed bank's flat transfer is the reference's on a dense float32
  sweep (a jitted copy of the reference's mixed branch against
  ``pack_mixed``); within 8 ulps of every mu-law level boundary its level
  departs from the reference's only where torch's log1p and XLA's differ
  in the last ulp, and by one level at most.
"""
import copy
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
from sdrtrunk_tpu_torch import use_device
from sdrtrunk_tpu_torch.runtime.orchestrator import pack_mixed

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FILE = ROOT / "tests" / "torch_reference" / "cells_full_width.json"
_spec = importlib.util.spec_from_file_location(
    "reference_digests", ROOT / "tools" / "reference_digests.py")
reference_digests = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(reference_digests)

SLOTS = 32
# cell -> (its full width, chunk blocks here; K = 2 * blocks must be a
# multiple of 25 for the analog front ends)
CELLS = {"ltr": (1023, 1250), "mpt1327": (1023, 1250), "lsm": (64, 1024),
         "am": (64, 1250), "c4fm_25k": (511, 2048)}

_RUNS: dict = {}


def _pair(cell):
    """(the JAX digest, the port's CPU digest, the port's scene) of a cell
    at SLOTS slots, one timed chunk; made once a cell."""
    if cell not in _RUNS:
        blocks = CELLS[cell][1]
        _, want, _ = reference_digests.run_cell(cell, SLOTS, 1, blocks)
        with use_device("cpu"):
            scene = getattr(bench_torch, f"scene_bank_{cell}")(
                SLOTS, 1, blocks)
            bench_torch.run_bank(scene)
        got = bench_torch.bank_digest(scene.orch, scene.chunks,
                                      scene.segments, events=True)
        _RUNS[cell] = (want, got, scene)
    return _RUNS[cell]


@pytest.mark.parametrize("cell", list(CELLS))
def test_cell_matches_the_reference(cell):
    want, got, scene = _pair(cell)
    tolerance = reference_digests.CELL_TOLERANCES[cell]
    held = bench_torch.compare_digests(got, want, tolerance)
    assert held["ok"], held
    assert held["chunks_equal"] and held["events_equal"]
    assert got["slots"] == SLOTS == len(scene.orch.slots)
    totals = got["totals"]
    if cell in ("ltr", "lsm"):
        assert totals["frames"] >= SLOTS
    if cell == "c4fm_25k":
        assert totals["frames"] > 0
    if cell == "mpt1327":           # the GTC mapped and followed
        assert totals["messages"] >= 2 and totals["events"] == 1
        assert not scene.orch.skipped_grants
    if cell in ("ltr", "mpt1327", "am"):
        assert totals["open"] == SLOTS and totals["audio_samples"] > 0


def _file() -> dict:
    return json.loads(FILE.read_text())


def test_the_file_is_small_and_names_the_reference():
    assert FILE.stat().st_size < 200_000
    data = _file()
    assert list(data["banks"]) == list(CELLS) == list(bench_torch.CELLS)
    assert data["generated_by"] == "tools/reference_digests.py"
    assert data["numpy"] and data["jax"]


@pytest.mark.parametrize("cell", list(CELLS))
def test_each_cell_is_full_width_with_a_tolerance(cell):
    entry = _file()["banks"][cell]
    digest = entry["digest"]
    _, slots, timed, _ = bench_torch.CELLS[cell]
    assert entry["slots"] == digest["slots"] == slots == CELLS[cell][0]
    assert entry["timed_chunks"] == timed
    assert len(digest["chunks"]) == entry["warmup"] + timed
    assert entry["builder"] == f"bench_torch.py::scene_bank_{cell}"
    assert entry["tolerance"] == reference_digests.CELL_TOLERANCES[cell]
    assert entry["tolerance"]["why"]
    fields = ["frames", "metrics", "segments", "segments_sha"]
    if cell in ("ltr", "mpt1327"):
        fields += ["messages", "audio_samples", "open", "rms"]
    elif cell == "am":
        fields += ["audio_samples", "open", "rms"]
    for field in fields:
        assert len(digest[field]) == slots
    assert len(digest["events"]) == 64
    totals = digest["totals"]
    if cell == "am":
        assert totals["open"] == entry["record"]["channels_with_audio"]
    else:
        assert totals["frames"] == entry["record"]["frames_decoded"] > 0
        assert totals["segments"] == entry["record"]["audio_segments"]
    # the grant of the two cells with a control channel, followed
    assert totals["events"] == (1 if cell in ("mpt1327", "c4fm_25k")
                                else 0)


def test_a_channel_is_the_full_scenes_at_any_width():
    """32 slots of a cell carry the full grid's first channels (and its
    granted channel) with the full scene's streams: the first chunk's
    bins agree with the full scene's."""
    from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer
    kw = {"timed_chunks": 1, "chunk_blocks": 1024}
    small, small_recipe = bench_torch.cell_bytes("c4fm_25k", 4, **kw)
    full, recipe = bench_torch.cell_bytes("c4fm_25k", 511, **kw)
    assert small_recipe["free_slots"] == recipe["free_slots"] == 1
    assert small_recipe["activate_hz"] == recipe["activate_hz"][:2]
    ch = Channelizer.design(12.8e6, 25000.0, device="cpu")

    def bins(chunk, offsets):
        x = torch.as_tensor(chunk.astype(np.float32)).view(torch.complex64)
        y, _ = ch(x.reshape(-1), ch.init_state())
        return y[:, [ch.channel_for_frequency(o) for o in offsets]]
    offsets = [small_recipe["control_offset_hz"],
               *small_recipe["activate_hz"],
               300 * 25000.0 - 255 * 25000.0]
    a, b = bins(small[1], offsets), bins(full[1], offsets)
    # each chunk is scaled by its own scene's peak: compare the shapes
    a = a / a.abs().max()
    b = b / b.abs().max()
    corr = (a * b.conj()).sum(0).abs() / (a.abs().square().sum(0).sqrt()
                                          * b.abs().square().sum(0).sqrt())
    assert bool((corr > 0.95).all()), corr


def test_mixed_digest_holds_messages_and_audio():
    _, got, scene = _pair("mpt1327")
    procs = scene.orch.bank_proc.procs
    for field in ("messages", "audio_samples", "open", "rms"):
        assert len(got[field]) == SLOTS
    assert got["messages"][0] == bench_torch._sha(
        [bench_torch._plain(m) for m in procs[0].messages]
    )[:bench_torch.SLOT_HASH_HEX]
    assert got["totals"]["messages"] == len(procs[0].messages) >= 2
    granted = [s for s in scene.orch.slots
               if s.active and not s.is_control
               and s.frequency_hz == pytest.approx(
                   bench_torch.CENTER_HZ + 300 * 12500.0 - 511 * 12500.0)]
    assert granted and procs[granted[0].index] is not None
    seg = procs[3].audio.segment
    assert got["open"][3] == 1 and got["audio_samples"][3] == \
        len(seg.samples)


def test_compare_digests_finds_a_message_and_an_event():
    want, got, _ = _pair("mpt1327")
    other = copy.deepcopy(want)
    other["messages"][0] = "0" * bench_torch.SLOT_HASH_HEX
    held = bench_torch.compare_digests(got, other, {"rms_rel": 1.0})
    assert not held["ok"]
    assert [d["slot"] for d in held["differing"]] == [0]
    assert set(held["differing"][0]) == {"slot", "messages"}
    other = copy.deepcopy(want)
    other["events"] = "0" * 64
    held = bench_torch.compare_digests(got, other, {"rms_rel": 1.0})
    assert not held["ok"] and not held["events_equal"]
    assert bench_torch.compare_digests(
        got, other, {"rms_rel": 1.0, "may_differ": ["events"]})["ok"]
    # a digest without events (banks_1023.json's) holds none
    del other["events"]
    assert bench_torch.compare_digests(got, other, {"rms_rel": 1.0})["ok"]


@jax.jit
def _reference_mixed(audio, gate, bits, valid):
    """The reference's packing of the mixed analog-trunking bank, copied
    from its live step (sdrtrunk_tpu/runtime/orchestrator.py, the
    ``bank_mixed`` branch) and compiled as a step: mu-law PCM | gates |
    compacted bits | counts, at a bit cap of 32."""
    a = jnp.clip(audio, -1.0, 1.0)
    c_, ka = a.shape
    comp = jnp.log1p(255.0 * jnp.abs(a)) * (1.0 / np.log(256.0))
    level = jnp.clip((comp * 127.0 + 0.5).astype(jnp.int32), 0, 127)
    pcm8 = (jnp.where(a < 0, 128, 0) + level).astype(jnp.uint8)
    g = gate.reshape(c_, ka // 8, 8).astype(jnp.int32)
    g8 = (g * jnp.array([128, 64, 32, 16, 8, 4, 2, 1],
                        jnp.int32)).sum(-1).astype(jnp.uint8)
    kb = bits.shape[1]
    cap = 32
    t_iota = jax.lax.broadcasted_iota(jnp.int32, (c_, kb), 1)
    combined = jnp.where(valid, t_iota, kb) * 2 + bits.astype(jnp.int32)
    sbits = (jax.lax.sort(combined, dimension=-1) & 1)[:, :cap]
    counts = jnp.minimum(jnp.sum(valid, axis=-1), cap).astype(jnp.int32)
    b8 = (sbits.reshape(c_, cap // 8, 8)
          * jnp.array([128, 64, 32, 16, 8, 4, 2, 1], jnp.int32)
          ).sum(-1).astype(jnp.uint8)
    return pcm8.reshape(-1), g8.reshape(-1), b8, counts


def _level_boundaries(ulps: int = 8) -> np.ndarray:
    """The float32 samples within `ulps` of each mu-law level boundary
    (where level + 0.5 crosses an integer), of both signs."""
    level = np.arange(1, 128) - 0.5
    edge = (np.power(256.0, level / 127.0) - 1.0) / 255.0
    near = np.float32(edge)[:, None].view(np.int32) \
        + np.arange(-ulps, ulps + 1, dtype=np.int32)[None, :]
    near = near.reshape(-1).view(np.float32)
    return np.concatenate([near, -near])


def test_mixed_mulaw_levels_are_the_references():
    rows, ka = 1025, 1024
    sweep = np.linspace(-1.0, 1.0, rows * ka - 4, dtype=np.float32)
    # beyond the clip, and the samples the 4-slot MPT1327 and the 32-slot
    # LTR scenes put one level apart (their float audio some ulps off the
    # reference's at a level boundary)
    seen = np.float32([1.5, -2.0, -float.fromhex("0x1.f7f844p-7"),
                       float.fromhex("0x1.033d2p-1")])
    audio = np.concatenate([sweep, seen]).reshape(rows, ka)
    rng = np.random.default_rng(9)
    gate = rng.integers(0, 2, (rows, ka)).astype(bool)
    bits = rng.integers(0, 2, (rows, 40)).astype(np.uint8)
    valid = rng.random((rows, 40)) < 0.7
    want = [np.asarray(v) for v in _reference_mixed(audio, gate, bits,
                                                    valid)]
    buf = pack_mixed(torch.as_tensor(audio), torch.as_tensor(gate),
                     torch.as_tensor(bits), torch.as_tensor(valid),
                     32).numpy()
    n = rows * ka
    got_pcm = buf[:n]
    assert np.array_equal(got_pcm, want[0]), \
        np.flatnonzero(got_pcm != want[0])[:10]
    assert list(got_pcm[-4:]) == [127, 255, 128 + 36, 112]
    got_gate = buf[n:n + n // 8]
    assert np.array_equal(got_gate, want[1])
    b8 = buf[n + n // 8:n + n // 8 + rows * 4].reshape(rows, 4)
    counts = buf[n + n // 8 + rows * 4:].view(np.int32)
    assert np.array_equal(counts, want[3])
    got_bits = np.unpackbits(b8, axis=1)
    want_bits = np.unpackbits(want[2], axis=1)
    for r in range(rows):
        assert np.array_equal(got_bits[r, :counts[r]],
                              want_bits[r, :counts[r]])


@jax.jit
def _reference_log1p_level(a):
    """The reference's log1p of the mixed branch and the level it gives."""
    comp = jnp.log1p(255.0 * jnp.abs(a))
    level = jnp.clip((comp * (1.0 / np.log(256.0)) * 127.0 + 0.5
                      ).astype(jnp.int32), 0, 127)
    return comp, level


def test_mixed_mulaw_departs_at_level_boundaries_only_by_log1p():
    """Within 8 ulps of every level boundary the port's level is the
    reference's but where torch's float32 log1p and XLA's differ in the
    last ulp (446 of these 4318 samples on the CPU, 62 of them a level
    apart): the scaling and rounding after log1p are the reference's on
    every sample, and no sample is more than a level apart."""
    edges = _level_boundaries()             # (254 rows of 17 ulps)
    rows = len(edges) // 17
    comp, want = (np.array(v) for v in _reference_log1p_level(edges))
    buf = pack_mixed(torch.as_tensor(edges.reshape(rows, 17)),
                     torch.zeros((rows, 17), dtype=torch.bool),
                     torch.zeros((rows, 8), dtype=torch.uint8),
                     torch.zeros((rows, 8), dtype=torch.bool), 8).numpy()
    got = buf[:len(edges)] & 127
    assert np.array_equal(buf[:len(edges)] >= 128, edges < 0)
    assert np.abs(got.astype(int) - want).max() <= 1
    # the port's arithmetic after log1p (runtime/orchestrator.py _mulaw8)
    # on the reference's log1p gives the reference's level everywhere
    from sdrtrunk_tpu_torch.runtime.orchestrator import _MULAW_SCALE
    own = torch.clamp((torch.as_tensor(comp) * _MULAW_SCALE + 0.5)
                      .to(torch.int32), 0, 127).numpy()
    assert np.array_equal(own, want)
    log1p = torch.log1p(255.0 * torch.abs(torch.as_tensor(edges))).numpy()
    apart = got != want
    assert apart.any() and not apart[log1p == comp].any()

