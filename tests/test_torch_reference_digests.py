"""The port's bench scenes are bench.py's bytes, and the JAX package's
full-width decode of them is on file.

* bench_torch's scene builders synthesize on the host with the reference's
  own NumPy synthesis bank (``synthesize_bank_host``), so each of the five
  bank scenes (C4FM in int8 and in int4, DMR, P25 Phase 2, NBFM) equals
  bench.py's ``_synth_iq8_chunks`` byte for byte, here at 32 slots and
  chunks of 1024 x 128 (NBFM's chunk is fixed at 1024 x 6400);
* ``synthesize_bank_host`` equals the reference's ``synthesize_bank``
  byte for byte;
* tests/torch_reference/banks_1023.json (tools/reference_digests.py, the
  JAX package on the CPU) holds five banks of 1023 slots, each with its
  chunk hashes, per-slot digest and a stated tolerance, in under 200 KB;
* ``compare_digests`` finds a slot that differs and holds a tolerance;
* the analog bank's mu-law bytes are the reference's on every float32
  level boundary of a dense sweep: XLA folds the reference's two constant
  factors into one, and the port rounds that one product as XLA does (the
  1023-slot NBFM bank parted from the reference on one slot, 45 samples a
  chunk, before the port did).

tests/test_torch_bench_banks.py and tests/test_torch_bench.py hold the
JAX Orchestrator's digest equal to the port's CPU digest at 32 slots.
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
from sdrtrunk_tpu.dsp.channelizer import Channelizer as JChannelizer
from sdrtrunk_tpu.dsp.synthesizer import synthesize_bank
from sdrtrunk_tpu_torch import use_device
from sdrtrunk_tpu_torch.dsp.synthesizer import synthesize_bank_host
from sdrtrunk_tpu_torch.runtime.orchestrator import pack_audio

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FILE = ROOT / "tests" / "torch_reference" / "banks_1023.json"
_spec = importlib.util.spec_from_file_location(
    "reference_digests", ROOT / "tools" / "reference_digests.py")
reference_digests = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(reference_digests)

SCENES = {"c4fm": "scene_orchestrator_bank",
          "c4fm_int4": "scene_orchestrator_bank",
          "dmr": "scene_orchestrator_bank_dmr",
          "p25p2": "scene_orchestrator_bank_p25p2",
          "nbfm": "scene_orchestrator_bank_nbfm"}


@pytest.mark.parametrize("bank", list(SCENES))
def test_scene_bytes_are_bench_pys(bank):
    kw = {} if bank == "nbfm" else {"chunk_blocks": 128}
    want = reference_digests.run_reference(bank, slots=32, timed_chunks=1,
                                           synthesis_only=True, **kw)
    own = reference_digests.BANKS[bank][1]
    with use_device("cpu"):
        scene = getattr(bench_torch, SCENES[bank])(slots=32, timed_chunks=1,
                                                   **kw, **own)
    assert len(scene.chunks) == len(want) == scene.warmup + 1
    for got, ref in zip(scene.chunks, want):
        assert got.dtype == ref.dtype == np.int8
        assert got.shape == ref.shape
        assert got.tobytes() == ref.tobytes()


def test_host_synthesis_is_the_reference_byte_for_byte():
    m = 1024
    hmat = np.asarray(JChannelizer.design(m * 12500.0, 12500.0).hmat)
    rng = np.random.default_rng(5)
    u = (rng.standard_normal((301, m))
         + 1j * rng.standard_normal((301, m))).astype(np.complex64)
    want = synthesize_bank(u, hmat)
    got = synthesize_bank_host(u, hmat)
    assert got.dtype == want.dtype == np.complex64
    assert got.tobytes() == want.tobytes()


def _file() -> dict:
    return json.loads(FILE.read_text())


def test_the_file_is_small_and_names_the_reference():
    assert FILE.stat().st_size < 200_000
    data = _file()
    assert list(data["banks"]) == list(SCENES)
    assert data["generated_by"] == "tools/reference_digests.py"
    assert data["numpy"] and data["jax"]


@pytest.mark.parametrize("bank", list(SCENES))
def test_each_bank_is_1023_slots_with_a_tolerance(bank):
    entry = _file()["banks"][bank]
    digest = entry["digest"]
    assert entry["slots"] == digest["slots"] == 1023
    assert entry["timed_chunks"] == 6
    assert len(digest["chunks"]) == (8 if bank == "nbfm" else 9)
    assert entry["tolerance"]["why"]
    for field in ("frames", "metrics", "segments", "segments_sha"):
        assert len(digest[field]) == 1023
    assert entry["tolerance"] == reference_digests.TOLERANCES[bank]
    if bank == "nbfm":
        assert digest["totals"]["open"] == entry["record"][
            "channels_with_audio"] == 1023
    else:
        decoded = entry["record"].get("frames_decoded",
                                      entry["record"].get("fragments_decoded"))
        assert digest["totals"]["frames"] == decoded
        assert digest["totals"]["segments"] == \
            entry["record"]["audio_segments"]


def test_compare_digests_finds_a_slot_and_holds_a_tolerance():
    want = _file()["banks"]["c4fm"]["digest"]
    got = copy.deepcopy(want)
    assert bench_torch.compare_digests(got, want, {})["ok"]
    got["frames"][7] += 1
    got["totals"]["frames"] += 1
    held = bench_torch.compare_digests(got, want, {})
    assert not held["ok"] and held["chunks_equal"]
    assert held["differing"] == [{"slot": 7, "frames": [want["frames"][7] + 1,
                                                        want["frames"][7]]}]
    assert bench_torch.compare_digests(
        got, want, {"slots_differing": 1, "frames_per_slot": 1})["ok"]
    got["frames"][7] += 1
    assert not bench_torch.compare_digests(
        got, want, {"slots_differing": 1, "frames_per_slot": 1})["ok"]
    got = copy.deepcopy(want)
    got["chunks"][3] = "0" * 64
    held = bench_torch.compare_digests(got, want, {"slots_differing": 1023})
    assert not held["ok"] and not held["chunks_equal"]


@jax.jit
def _reference_mulaw(a):
    """The reference's mu-law packing of the analog bank, compiled as its
    live step compiles it (sdrtrunk_tpu/runtime/orchestrator.py, the
    ``bank_analog`` branch of the step)."""
    comp = jnp.log1p(255.0 * jnp.abs(a)) * (1.0 / np.log(256.0))
    level = jnp.clip((comp * 127.0 + 0.5).astype(jnp.int32), 0, 127)
    return (jnp.where(a < 0, 128, 0) + level).astype(jnp.uint8).reshape(-1)


def test_mulaw_levels_are_the_references():
    sweep = np.linspace(-1.0, 1.0, (1 << 20) + 1, dtype=np.float32)
    # two samples of the bench's NBFM slot 300 at 1023 slots
    seen = -np.float32([float.fromhex("0x1.b2bf78p-2"),
                        float.fromhex("0x1.b2bf76p-2")])
    audio = np.concatenate([sweep, seen])[None, :]
    want = np.asarray(_reference_mulaw(jnp.asarray(audio)))
    got = pack_audio(torch.as_tensor(audio),
                     torch.zeros(audio.shape, dtype=torch.bool),
                     "mulaw8").numpy()[:audio.size]
    assert np.array_equal(got, want), np.flatnonzero(got != want)[:10]
    assert list(got[-2:]) == [236, 236]
