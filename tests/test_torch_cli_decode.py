"""``decode`` and ``replay`` of the port's CLI against the JAX package's on
the CPU (--platform cpu for both): the same captures give the same JSON
lines, message for message.

Captures: tests/test_cli.py's P25 Phase 1 capture and its two-channel P25
replay (chip_smoke.replay_scene, the same construction); the decode
scenes that chip_smoke's ``cli`` phase runs on the card
(chip_smoke.decode_scenes: DMR, P25 Phase 2 with its scramble key, LTR,
MPT1327, and the P25 capture at 48 kHz, which both CLIs decode at the
capture's rate: the DQPSK loop at W = 20), the LTR one also through the
LTR-Net and Passport framers; the
P25 capture LSM-modulated through p25p1-lsm; an NBFM and an AM tone with
--audio, the written audio within 1 LSB of int16.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from cli_pair import both, rows
from sdrtrunk_tpu_torch.io.wave import read_real_wave, write_complex_wave
from sdrtrunk_tpu_torch.signal import generators
from test_cli import _write_p25_capture

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    return {scene: (p, path, flags) for scene, p, path, flags, _ in
            chip_smoke.decode_scenes(d)}


def _same_lines(argv):
    ref, port = both(argv)
    assert port == ref
    return rows(ref)


def test_decode_p25(tmp_path):
    out = _same_lines(["decode", _write_p25_capture(tmp_path),
                       "--protocol", "p25p1"])
    assert out[-1] == {"summary": True, "protocol": "p25p1", "messages": 2}


@pytest.mark.parametrize("protocol,scene", [
    ("dmr", "dmr"), ("p25p2", "p25p2"), ("ltr", "ltr"),
    ("mpt1327", "mpt1327"), ("ltrnet", "ltr"), ("passport", "ltr"),
    ("p25p1", "p25p1_48k")])
def test_decode_scene(scenes, protocol, scene):
    scene_protocol, path, flags = scenes[scene]
    out = _same_lines(["decode", path, "--protocol", protocol, *flags])
    if protocol == scene_protocol:
        assert out[-1]["messages"] > 0


def test_decode_lsm(tmp_path):
    from sdrtrunk_tpu_torch.protocol.p25p1 import (DUID,
                                                   P25P1FrameAssembler)
    from sdrtrunk_tpu_torch.protocol.p25p1.tsbk import tsbk_encode
    rng = np.random.default_rng(5)
    asm = P25P1FrameAssembler(nac=0x293)
    tsbk = asm.assemble(DUID.TSBK, tsbk_encode(
        0x3A, rng.integers(0, 2, 64).astype(np.uint8)))
    dibits = np.concatenate([rng.integers(0, 4, 150).astype(np.uint8)]
                            + [tsbk] * 3)
    path = tmp_path / "lsm.wav"
    write_complex_wave(path, generators.lsm_modulate(dibits, 25000.0), 25000)
    out = _same_lines(["decode", path, "--protocol", "p25p1-lsm"])
    assert out[-1]["messages"] > 0


@pytest.mark.parametrize("protocol", ["nbfm", "am"])
def test_decode_analog_audio(tmp_path, protocol):
    fs = 25000.0
    audio = np.sin(2 * np.pi * 700.0 * np.arange(4000) / 8000.0)
    if protocol == "nbfm":
        iq = generators.nbfm_modulate(audio, 8000.0, fs)
    else:
        t = np.arange(int(len(audio) * fs / 8000.0))
        iq = (0.5 * (1 + 0.5 * np.sin(2 * np.pi * 700.0 * t / fs))
              ).astype(np.complex64)
    path = tmp_path / "in.wav"
    write_complex_wave(path, iq, int(fs))
    ref, port = both(
        ["decode", path, "--protocol", protocol, "--audio",
         tmp_path / "ref.wav"],
        ["decode", path, "--protocol", protocol, "--audio",
         tmp_path / "port.wav"])
    assert [r for r in rows(port) if "wrote_audio" not in r] == \
        [r for r in rows(ref) if "wrote_audio" not in r]
    a, rate = read_real_wave(tmp_path / "ref.wav")
    b, rate_b = read_real_wave(tmp_path / "port.wav")
    assert rate == rate_b == 8000 and a.shape == b.shape and len(a) > 1000
    np.testing.assert_allclose(b, a, rtol=0, atol=1.0 / 32767)


def test_replay_batched_digital(tmp_path):
    cap, playlist, center = chip_smoke.replay_scene(tmp_path)
    out = _same_lines(["replay", cap, "--playlist", playlist,
                       "--center-frequency", center])
    assert out[-1]["channels"] == 2
    assert {r["channel"] for r in out
            if r.get("duid") == "TSBK" and r.get("valid")} == \
        {"P25-0", "P25-1"}
