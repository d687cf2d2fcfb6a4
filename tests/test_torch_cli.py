"""The port's CLI (sdrtrunk_tpu_torch/cli.py) against the JAX package's on
the CPU (--platform cpu for both), on tests/test_cli.py's scenes and the
commands it does not cover:

* info on the 37.5 kHz tone and on a noisy two-tone capture: the same
  offsets, power within 0.1 dB (its printed rounding) on every channel
  within 120 dB of the strongest; a channel further down is the two
  float32 FFTs' rounding (the pure tone leaves most channels near -180
  dB), and both must put it there;
* channelize of the same capture, with --channels (the written channel
  wave within 1 LSB of int16) and without (the same bins and offsets,
  power within 0.1 dB);
* replay of the NBFM playlist, the playlist editor's whole sequence, and
  import-playlist of tests/test_playlist_import.py's XML: the same lines
  and the same playlist files;
* instrument and waterfall of the P25 capture: the same summary and the
  same arrays in the .npz;
* monitor --source test for 2 chunks: the same header and summary lines
  and, but for the upload timing, the same metrics lines;
* the same subcommands, flags and choices; bench reaches the port's
  bench_torch.main with the sys.argv flags the reference gives
  bench.main (--small, and --profile for --trace).

tests/test_torch_cli_decode.py holds decode and the digital replay.
"""
import json
import re
import sys

import numpy as np
import pytest
import torch

from cli_pair import both, rows
from sdrtrunk_tpu import cli as ref_cli
from sdrtrunk_tpu.config import (ChannelConfig, DecodeConfig, Playlist,
                                 SourceConfig)
from sdrtrunk_tpu_torch import cli as port_cli
from sdrtrunk_tpu_torch.io.wave import read_complex_wave, write_complex_wave
from sdrtrunk_tpu_torch.signal import generators
from test_cli import _write_p25_capture
from test_playlist_import import _XML

torch.set_num_threads(1)


@pytest.fixture
def band(tmp_path):
    fs = 200_000.0
    path = tmp_path / "band.wav"
    write_complex_wave(path, generators.tone(37500.0, fs, 16384,
                                             amplitude=0.5), int(fs))
    return path


def _close_db(port, ref, key="power_db", span_db=120.0):
    assert len(port) == len(ref)
    floor = max(r.get(key, -np.inf) for r in ref) - span_db
    for p, r in zip(port, ref):
        assert {k: v for k, v in p.items() if k != key} == \
            {k: v for k, v in r.items() if k != key}
        if key in r and r[key] >= floor:
            assert abs(p[key] - r[key]) <= 0.1 + 1e-9, (p, r)
        elif key in r:
            assert p[key] < floor + 0.1, (p, r)


def test_info(band, tmp_path):
    ref, port = both(["info", band])
    _close_db(rows(port), rows(ref))
    hot = max((r for r in rows(port) if "offset_hz" in r),
              key=lambda r: r["power_db"])
    assert abs(hot["offset_hz"] - 37500.0) < 12500.0
    fs = 200_000.0
    t = np.arange(1 << 15)
    noisy = (0.5 * np.exp(2j * np.pi * 37500.0 * t / fs)
             + 0.05 * np.exp(-2j * np.pi * 62500.0 * t / fs)
             + 0.01 * np.random.default_rng(6).standard_normal(len(t)))
    write_complex_wave(tmp_path / "noisy.wav", noisy, int(fs))
    ref, port = both(["info", tmp_path / "noisy.wav",
                      "--bandwidth", "6250"])
    _close_db(rows(port), rows(ref), span_db=np.inf)


def test_channelize(band, tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref, port = both(
        ["channelize", band, "--channels", "37500,-12500",
         "--output", tmp_path / "ref"],
        ["channelize", band, "--channels", "37500,-12500",
         "--output", tmp_path / "port"])
    assert [l.replace(str(tmp_path / "port"), "D") for l in port] == \
        [l.replace(str(tmp_path / "ref"), "D") for l in ref]
    for off in (37500, -12500):
        a, rate = read_complex_wave(tmp_path / "ref" / f"channel_{off}.wav")
        b, rate_b = read_complex_wave(tmp_path / "port" /
                                      f"channel_{off}.wav")
        assert rate == rate_b and a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=1.0 / 32767)
    ref, port = both(["channelize", band])
    _close_db(rows(port), rows(ref))


def test_replay_nbfm(tmp_path):
    fs = 400_000.0
    center = 851_000_000.0
    audio = np.sin(2 * np.pi * 700.0 * np.arange(6000) / 8000)
    iq = generators.nbfm_modulate(audio, 8000, fs)
    n = (len(iq) // 32) * 32
    off = 3 * 12500.0
    wb = (iq[:n] * np.exp(2j * np.pi * off * np.arange(n) / fs)
          ).astype(np.complex64)
    cap = tmp_path / "wb.wav"
    write_complex_wave(cap, wb, int(fs))
    ppath = tmp_path / "pl.json"
    Playlist(channels=[ChannelConfig(
        name="FM1", source=SourceConfig(frequency_hz=center + off),
        decode=DecodeConfig(decoder="nbfm"))]).save(ppath)
    ref, port = both(["replay", cap, "--playlist", ppath,
                      "--center-frequency", center])
    assert port == ref
    assert rows(port)[-1] == {"summary": True, "channels": 1, "messages": 0}


_EDITS = [
    ["new"],
    ["add-channel", "--name", "Ctrl", "--frequency", "460025000",
     "--decoder", "p25p1", "--system", "Sys"],
    ["add-channel", "--name", "FM", "--frequency", "154000000"],
    ["set", "--name", "FM", "--field", "decode.squelch_threshold_db",
     "--value", "-60"],
    ["set", "--name", "FM", "--field", "record.audio", "--value", "true"],
    ["disable", "--name", "Ctrl"],
    ["enable", "--name", "Ctrl"],
    ["remove-channel", "--name", "FM"],
    ["list"],
]


def test_playlist_editor(tmp_path):
    for edit in _EDITS:
        action, *rest = edit
        ref, port = both(
            ["playlist", action, "--playlist", tmp_path / "ref.json", *rest],
            ["playlist", action, "--playlist", tmp_path / "port.json",
             *rest])
        assert [l.replace("port.json", "ref.json") for l in port] == ref
    for name in ("{}.json", "{}.json.backup"):
        assert (tmp_path / name.format("port")).read_text() == \
            (tmp_path / name.format("ref")).read_text()


def test_import_playlist(tmp_path):
    xml = tmp_path / "playlist.xml"
    xml.write_text(_XML)
    ref, port = both(["import-playlist", xml, tmp_path / "ref.json"],
                     ["import-playlist", xml, tmp_path / "port.json"])
    assert [l.replace("port.json", "ref.json") for l in port] == ref
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()


@pytest.mark.parametrize("command,flags", [
    ("instrument", []), ("waterfall", ["--fft-size", "256", "--ascii"])])
def test_host_taps(tmp_path, command, flags):
    cap = _write_p25_capture(tmp_path)
    ref, port = both([command, cap, *flags, "--output",
                      tmp_path / "ref.npz"],
                     [command, cap, *flags, "--output",
                      tmp_path / "port.npz"])
    assert [l.replace("port.npz", "ref.npz") for l in port] == ref
    a, b = np.load(tmp_path / "ref.npz"), np.load(tmp_path / "port.npz")
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        np.testing.assert_array_equal(b[key], a[key])


def test_monitor_test_source(tmp_path):
    center = 450_000_000.0
    ppath = tmp_path / "pl.json"
    Playlist(channels=[ChannelConfig(
        name="FM", source=SourceConfig(frequency_hz=center + 25000.0),
        decode=DecodeConfig(decoder="nbfm"))]).save(ppath)
    argv = ["monitor", "--playlist", ppath, "--source", "test",
            "--sample-rate", 800_000, "--center-frequency", center,
            "--max-chunks", 2]
    ref, port = both(argv)

    def steady(lines):
        return [{k: v for k, v in row.items()
                 if k not in ("upload_ms", "upload_mbps")}
                for row in rows(lines)]
    assert steady(port) == steady(ref)
    header, summary = rows(port)[0], rows(port)[-1]
    assert header["monitor"] and header["slots"] == 2
    assert summary["samples"] > 0 and len(port) == 4


def _surface(module) -> dict:
    """{subcommand: (sorted option strings and positionals, choices)} of a
    CLI, read from its --help."""
    def help_of(argv):
        with pytest.raises(SystemExit) as done:
            run(module, argv)
        assert done.value.code == 0

    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        module.main(["--help"])
    subs = next(m for m in re.findall(r"\{([a-z,-]+)\}", out.getvalue())
                if "info" in m).split(",")
    surface = {"": re.findall(r"--[a-z-]+", out.getvalue())}
    for sub in subs:
        out = io.StringIO()
        with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
            module.main([sub, "--help"])
        usage = out.getvalue().split("\n\n")[0]
        surface[sub] = sorted(set(re.findall(r"--?[a-z][a-z-]*|\{[^}]*\}|"
                                             r"\b[a-z]+\b", usage)))
    return surface


def test_same_subcommands_and_flags():
    ref, port = _surface(ref_cli), _surface(port_cli)
    assert set(port) == set(ref)
    for sub in ref:
        want = [w.replace("sdrtrunk_tpu", "sdrtrunk_tpu_torch")
                for w in ref[sub]]
        assert sorted(set(port[sub])) == sorted(set(want)), sub


@pytest.mark.parametrize("flags", [[], ["--small"], ["--trace"],
                                   ["--small", "--trace"]])
def test_bench_reaches_bench_torch_main_with_the_reference_flags(
        monkeypatch, flags):
    import bench
    import bench_torch
    seen = {}

    def record(name, code):
        def main():
            seen[name] = list(sys.argv)
            return code
        return main

    monkeypatch.setattr(sys, "argv", list(sys.argv))
    monkeypatch.setattr(bench, "main", record("ref", None))
    monkeypatch.setattr(bench_torch, "main", record("port", 1))
    assert ref_cli.main(["bench", *flags]) == 0
    assert port_cli.main(["bench", *flags]) == 1      # its exit code
    assert seen["ref"][0] == "bench.py"
    assert seen["port"] == ["bench_torch.py", *seen["ref"][1:]]
    assert ("--profile" in seen["port"]) == ("--trace" in flags)
