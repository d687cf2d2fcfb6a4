"""``monitor`` of the port's CLI (the copied MonitorSession over the
port's Orchestrator) against the JAX package's on the CPU (--platform cpu
for both), on tests/test_monitor.py's scene: a P25 control channel at
+25 kHz granting a traffic channel that carries two voice superframes,
2.6 s at 800 kS/s, the control channel recording its dibits and the
wideband IQ, 3 traffic slots, chunks of 64 x 256.

These must be equal: the summary line, the event log's rows, the set of
call files and their sidecars (as JSON), and the .bits tap's bytes. The
call audio and the IQ tap are held within 1 LSB of int16.

The device rule: MonitorSession builds its Orchestrator with no device,
so without a use_device block it raises here, where there is no CUDA; the
copied channel processors build an AuxDecoder with no device, which under
--platform cpu lands on the CPU, as the reference's monitor builds it
(an NBFM channel with decode.aux=["fleetsync2"], the per-slot path).
"""
import json

import numpy as np
import pytest
import torch

from cli_pair import both, rows
from sdrtrunk_tpu.config import (ChannelConfig, DecodeConfig, Playlist,
                                 RecordConfig, SourceConfig)
from sdrtrunk_tpu_torch.io.wave import read_complex_wave, read_real_wave
from test_monitor import _write_capture
from test_orchestrator import CENTER_HZ, CONTROL_OFF

torch.set_num_threads(1)


def _argv(tmp, out: str, capture, playlist):
    return ["monitor", "--playlist", playlist, "--input", capture,
            "--center-frequency", CENTER_HZ,
            "--audio-dir", tmp / out / "audio",
            "--event-log", tmp / out / "events.jsonl",
            "--traffic-slots", 3, "--chunk-samples", 64 * 256, "--quiet"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("monitor")
    capture = tmp / "capture.wav"
    _write_capture(capture)
    playlist = tmp / "playlist.json"
    Playlist(channels=[ChannelConfig(
        name="Control", system="TestSys", site="Site1",
        source=SourceConfig(frequency_hz=CENTER_HZ + CONTROL_OFF),
        decode=DecodeConfig(decoder="p25p1"),
        record=RecordConfig(baseband_iq=True, demodulated_bits=True))]
    ).save(playlist)
    ref, port = both(_argv(tmp, "ref", capture, playlist),
                     _argv(tmp, "port", capture, playlist))
    return tmp, rows(ref), rows(port)


def test_summary_and_header(runs):
    tmp, ref, port = runs
    assert port == ref
    assert port[-1]["summary"] and port[-1]["events"] > 0


def test_event_log(runs):
    tmp, _, _ = runs
    want = (tmp / "ref" / "events.jsonl").read_text().splitlines()
    got = (tmp / "port" / "events.jsonl").read_text().splitlines()
    assert [json.loads(l) for l in got] == [json.loads(l) for l in want]
    assert want


def test_call_files(runs):
    tmp, _, _ = runs
    ref_dir, port_dir = tmp / "ref" / "audio", tmp / "port" / "audio"
    names = sorted(p.name for p in ref_dir.iterdir())
    assert sorted(p.name for p in port_dir.iterdir()) == names
    calls = [n for n in names if n.startswith("call_") and
             n.endswith(".wav")]
    assert calls
    for name in calls:
        assert json.loads((port_dir / f"{name}.json").read_text()) == \
            json.loads((ref_dir / f"{name}.json").read_text())
        a, rate = read_real_wave(ref_dir / name)
        b, rate_b = read_real_wave(port_dir / name)
        assert rate == rate_b and a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=1.0 / 32767)


def test_recording_taps(runs):
    tmp, _, _ = runs
    ref_dir, port_dir = tmp / "ref" / "audio", tmp / "port" / "audio"
    want = (ref_dir / "Control.bits").read_bytes()
    assert (port_dir / "Control.bits").read_bytes() == want and want
    a, rate = read_complex_wave(ref_dir / "wideband_iq.wav")
    b, rate_b = read_complex_wave(port_dir / "wideband_iq.wav")
    assert rate == rate_b and a.shape == b.shape and len(a)
    np.testing.assert_allclose(b, a, rtol=0, atol=1.0 / 32767)


def _one_nbfm_playlist(path, aux=()):
    Playlist(channels=[ChannelConfig(
        name="FM", source=SourceConfig(frequency_hz=CENTER_HZ + 25000.0),
        decode=DecodeConfig(decoder="nbfm", aux=list(aux)))]).save(path)


def test_monitor_session_needs_the_card_unless_asked(tmp_path):
    from sdrtrunk_tpu_torch import use_device
    from sdrtrunk_tpu_torch.config import Playlist as PortPlaylist
    from sdrtrunk_tpu_torch.monitor import MonitorSession
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _one_nbfm_playlist(tmp_path / "p.json")
    playlist = PortPlaylist.load(tmp_path / "p.json")

    def session():
        return MonitorSession(playlist, lambda n: None, 800_000.0,
                              CENTER_HZ, emit=None)
    with pytest.raises(RuntimeError, match="cuda"):
        session()
    with use_device("cpu"):
        s = session()
    assert s.orch.device == torch.device("cpu")
    s.orch.close()


def test_aux_decoder_follows_the_platform(tmp_path, monkeypatch):
    from sdrtrunk_tpu import monitor as ref_monitor
    from sdrtrunk_tpu_torch import monitor

    seen = {}
    for name, module in (("ref", ref_monitor), ("port", monitor)):
        init = module.MonitorSession.__init__

        def spy(self, *args, init=init, name=name, **kw):
            init(self, *args, **kw)
            seen[name] = [a for s in self.orch.slots if s.processor
                          for a in getattr(s.processor, "aux", [])]
        monkeypatch.setattr(module.MonitorSession, "__init__", spy)
    _one_nbfm_playlist(tmp_path / "p.json", aux=["fleetsync2"])
    ref, port = both(["monitor", "--playlist", tmp_path / "p.json",
                      "--source", "test", "--sample-rate", 800_000,
                      "--center-frequency", CENTER_HZ, "--max-chunks", 1,
                      "--quiet"])
    assert rows(port) == rows(ref)
    assert [a.protocol for a in seen["port"]] == \
        [a.protocol for a in seen["ref"]] == ["fleetsync2"]
    assert seen["port"][0].device == torch.device("cpu")
