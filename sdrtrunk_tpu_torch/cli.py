"""Headless CLI of the port (port of sdrtrunk_tpu/cli.py; the reference's
--headless mode, SDRTrunk.java:141, without pixels).

    python -m sdrtrunk_tpu_torch.cli [--platform {cpu,device}] COMMAND ...

Commands, flags and JSON lines are the reference's:
  info             <iq.wav>                      band summary + occupancy
  channelize       <iq.wav> [--channels f1,f2]   polyphase channelize
  decode           <iq.wav> --protocol P         single-channel decode
  replay           <iq.wav> --playlist cfg.json  multi-channel decode
  instrument       <iq.wav>                      eye / constellation taps
  waterfall        <iq.wav>                      spectral frames
  monitor          --playlist cfg.json ...       live trunked monitoring
  playlist         ACTION --playlist cfg.json    headless playlist editor
  import-playlist  <playlist.xml> <out.json>     import a reference playlist
  bench            [--small] [--trace]           throughput benchmark

The device: every command runs on the card unless ``--platform cpu`` is
given, which enters ``use_device("cpu")`` for the whole command. This
departs from the reference on purpose: its ``main`` defaults the
host-scale commands (info, channelize, decode, replay, ...) to the CPU,
but the port's entry points run on the card unless asked. ``--platform
device`` is the default spelled out. Without CUDA and without ``--platform
cpu`` a command that touches a device raises; nothing falls back.

``decode`` runs one channel through the decoders' per-channel call (the
symbol and bit-timing kernels at C = 1); ``replay``
runs each protocol group of a playlist as one (C, T) ``batched_call``, one
kernel launch a group. All structured output is JSON lines on stdout;
audio and bitstream artifacts are written next to the input or to
--output.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def _emit(obj) -> None:
    print(json.dumps(obj, default=str), flush=True)


def _load_iq(path):
    from .io.wave import read_complex_wave
    iq, rate = read_complex_wave(path)
    return np.asarray(iq), float(rate)


def _device():
    from . import resolve_device
    return resolve_device(None)


# ------------------------------------------------------------------ decode

def _decode_single(iq: np.ndarray, fs: float, protocol: str,
                   options: dict) -> dict:
    """Run one protocol chain over complex baseband; returns a result dict
    with 'messages' (list of dicts) and optional 'audio' (np array, rate)."""
    import torch

    dev = _device()
    result = {"messages": [], "audio": None, "audio_rate": 8000.0}

    def channel():
        return torch.as_tensor(np.asarray(iq, np.complex64), device=dev)

    def dibit_chain(decoder_cls, config, framer, describe):
        pre = options.get("precomputed_dibits")
        if pre is not None:
            dibits = pre
        else:
            dec = decoder_cls(config, device=dev)
            out, _ = dec(channel(), dec.init_state())
            dibits = out["dibits"].cpu().numpy()[out["valid"].cpu().numpy()]
        for frame in framer.process(dibits):
            result["messages"].append(describe(frame))

    if protocol == "nbfm" or protocol == "am":
        from .decoders import AMConfig, AMDecoder, NBFMConfig, NBFMDecoder
        if protocol == "nbfm":
            dec = NBFMDecoder(NBFMConfig(
                sample_rate=fs,
                bandwidth=options.get("bandwidth", 12500.0),
                squelch_threshold_db=options.get("squelch_db", -78.0)),
                device=dev)
        else:
            dec = AMDecoder(AMConfig(sample_rate=fs), device=dev)
        out, _ = dec(channel(), dec.init_state())
        result["audio"] = out["audio"].cpu().numpy()
    elif protocol in ("p25p1", "p25p1-lsm"):
        from .protocol.p25p1 import P25P1Framer
        from .protocol.p25p1.messages import decode_frame

        def describe(frame):
            msg = decode_frame(frame)
            d = {"protocol": "p25p1", "duid": msg.duid.name,
                 "nac": msg.nac, "valid": msg.valid,
                 "bit_errors": msg.bit_errors, "start": msg.start}
            content = msg.content
            if content is not None and hasattr(content, "opcode_name"):
                d["opcode"] = content.opcode_name
                d.update(getattr(content, "fields", {}) or {})
            if content is not None and hasattr(content, "link_control") \
                    and content.link_control is not None:
                d["lc"] = content.link_control.opcode_name
                d.update(content.link_control.fields or {})
            return d

        if protocol == "p25p1-lsm":
            from .decoders.lsm import LSMConfig, LSMDecoder
            dibit_chain(LSMDecoder, LSMConfig(sample_rate=fs),
                        P25P1Framer(), describe)
        else:
            from .decoders.c4fm import C4FMConfig, C4FMDecoder
            dibit_chain(C4FMDecoder, C4FMConfig(sample_rate=fs),
                        P25P1Framer(), describe)
    elif protocol == "dmr":
        from .decoders.dmr import DMRConfig, DMRDecoder
        from .protocol.dmr import DMRFramer

        def describe(frame):
            d = {"protocol": "dmr", "pattern": frame.pattern.name,
                 "timeslot": frame.timeslot, "kind": frame.content_kind,
                 "start": frame.start}
            c = frame.content
            if c is not None and hasattr(c, "opcode_name"):
                d["opcode"] = c.opcode_name
                d.update(getattr(c, "fields", {}) or {})
            if c is not None and hasattr(c, "flco_name"):
                d["flco"] = c.flco_name
                d.update(getattr(c, "fields", {}) or {})
            return d

        dibit_chain(DMRDecoder, DMRConfig(sample_rate=fs),
                    DMRFramer(), describe)
    elif protocol == "p25p2":
        from .decoders.p25p2 import P25P2Config, P25P2Decoder
        from .protocol.p25p2 import P25P2Framer

        framer = P25P2Framer(options.get("wacn", 0),
                             options.get("system", 0),
                             options.get("nac", 0))

        def describe(frag):
            return {"protocol": "p25p2",
                    "fragment": frag.fragment_number,
                    "start": frag.start,
                    "timeslots": [
                        {"duid": t.duid.name, "index": t.index,
                         "mac": t.mac_pdu_type.name
                         if t.mac_pdu_type else None}
                        for t in frag.timeslots]}

        dibit_chain(P25P2Decoder, P25P2Config(sample_rate=fs),
                    framer, describe)
    elif protocol in ("ltr", "ltrnet", "passport", "mpt1327"):
        # FM demod to 8 kHz audio, then the sub-audible/audio FSK layer
        from .decoders import NBFMConfig, NBFMDecoder
        nbfm = NBFMDecoder(NBFMConfig(sample_rate=fs,
                                      squelch_threshold_db=-120.0),
                           device=dev)
        out, _ = nbfm(channel(), nbfm.init_state())
        audio = out["audio"]
        result["audio"] = audio.cpu().numpy()
        if protocol == "mpt1327":
            from .dsp.afsk import AFSK1200Demodulator
            from .protocol.mpt1327 import MPT1327Framer
            n = (audio.shape[0] // 10) * 10
            demod = AFSK1200Demodulator(device=dev)
            bits, valid, _ = demod(audio[:n])
            rx = bits.cpu().numpy()[valid.cpu().numpy()]
            for m in MPT1327Framer("control").process(rx):
                result["messages"].append(
                    {"protocol": "mpt1327",
                     "type": m.message_type.value, "start": m.start,
                     **m.fields})
        else:
            from .decoders.ltr import LTRDecoder
            dec = LTRDecoder(device=dev)
            o2, _ = dec(audio, dec.init_state())
            rx = o2["bits"].cpu().numpy()[o2["valid"].cpu().numpy()]
            if protocol == "ltr":
                from .protocol.ltr import LTRFramer
                for m in LTRFramer("OSW").process(rx):
                    result["messages"].append(
                        {"protocol": "ltr",
                         "type": m.message_type.value, "area": m.area,
                         "channel": m.channel, "home": m.home,
                         "group": m.group, "free": m.free,
                         "start": m.start})
            elif protocol == "ltrnet":
                from .protocol.ltr import LtrNetFramer, LtrNetTracker
                tracker = LtrNetTracker()
                for m in LtrNetFramer("OSW").process(rx):
                    tracker.process(m)
                    result["messages"].append(
                        {"protocol": "ltrnet",
                         "type": m.message_type.value, "start": m.start,
                         **m.fields})
                result["events"] = tracker.events
                if tracker.site_id is not None:
                    result["site_id"] = tracker.site_id
            else:
                from .protocol.passport import PassportFramer
                for m in PassportFramer().process(rx):
                    result["messages"].append(
                        {"protocol": "passport",
                         "type": m.message_type.value, "lcn": m.lcn,
                         "site": m.site, "group": m.group,
                         "start": m.start})
    else:
        raise ValueError(f"unknown protocol {protocol}")
    return result


# ------------------------------------------------------------------ cmds

def cmd_info(args) -> int:
    import torch

    from .dsp.spectrum import channel_power_map
    iq, fs = _load_iq(args.input)
    centers, power = channel_power_map(
        torch.as_tensor(iq[: min(len(iq), 1 << 20)], device=_device()), fs,
        channel_bandwidth=args.bandwidth)
    _emit({"file": str(args.input), "sample_rate": fs,
           "samples": len(iq), "duration_s": len(iq) / fs})
    for c, p in zip(centers.tolist(), power.tolist()):
        _emit({"offset_hz": round(c, 1), "power_db": round(p, 1)})
    return 0


def _channelize(iq: np.ndarray, fs: float, bandwidth: float):
    """(channelizer, (K, M) output on the device) for a whole capture cut
    to a multiple of M."""
    import torch

    from .dsp.channelizer import Channelizer
    ch = Channelizer.design(fs, bandwidth, device=_device())
    n = (len(iq) // ch.channels) * ch.channels
    y, _ = ch(torch.as_tensor(iq[:n], device=ch.hmat.device))
    return ch, y


def cmd_channelize(args) -> int:
    from .dsp.extract import extract_channels, plan_channels
    iq, fs = _load_iq(args.input)
    ch, y = _channelize(iq, fs, args.bandwidth)
    _emit({"channels": ch.channels, "channel_rate": ch.channel_sample_rate,
           "blocks": int(y.shape[0])})
    if args.channels:
        offsets = [float(f) for f in args.channels.split(",")]
        streams, _ = extract_channels(y, plan_channels(ch, offsets))
        streams = streams.cpu().numpy()
        from .io.wave import write_complex_wave
        outdir = Path(args.output or ".")
        for off, stream in zip(offsets, streams):
            path = outdir / f"channel_{int(off)}.wav"
            write_complex_wave(path, stream,
                               int(ch.channel_sample_rate))
            _emit({"offset_hz": off, "wrote": str(path),
                   "samples": int(stream.shape[0])})
    else:
        power = 10.0 * np.log10(
            np.mean(np.abs(y.cpu().numpy()) ** 2, axis=0) + 1e-20)
        for m in range(ch.channels):
            _emit({"bin": m,
                   "offset_hz": ch.center_frequency(m),
                   "power_db": round(float(power[m]), 1)})
    return 0


def cmd_decode(args) -> int:
    iq, fs = _load_iq(args.input)
    if args.offset:
        n = np.arange(len(iq))
        iq = (iq * np.exp(-2j * np.pi * args.offset * n / fs)
              ).astype(np.complex64)
    options = {"bandwidth": args.bandwidth, "squelch_db": args.squelch_db,
               "wacn": args.wacn, "system": args.system, "nac": args.nac}
    result = _decode_single(iq, fs, args.protocol, options)
    for msg in result["messages"]:
        _emit(msg)
    _emit({"summary": True, "protocol": args.protocol,
           "messages": len(result["messages"])})
    if args.audio and result["audio"] is not None:
        from .io.wave import write_real_wave
        write_real_wave(args.audio, result["audio"],
                        int(result["audio_rate"]))
        _emit({"wrote_audio": args.audio,
               "samples": int(len(result["audio"]))})
    return 0


def cmd_replay(args) -> int:
    """Decode every enabled playlist channel from a wideband capture."""
    from .config import Playlist
    from .convert import tree_map
    from .dsp.extract import extract_channels, plan_channels
    from .receiver import make_channel_decoder
    playlist = Playlist.load(args.playlist)
    iq, fs = _load_iq(args.input)
    center = args.center_frequency
    ch, y = _channelize(iq, fs, args.bandwidth)
    enabled = [c for c in playlist.channels if c.enabled]
    offsets = [c.source.frequency_hz - center for c in enabled]
    streams_dev, _ = extract_channels(y, plan_channels(ch, offsets))
    streams = streams_dev.cpu().numpy()

    # each protocol group's symbol recovery is one (C, T) batched call:
    # one kernel launch a group
    DIBIT_PROTOCOLS = ("p25p1", "p25p1-lsm", "dmr", "p25p2", "c4fm")
    precomputed: dict[int, np.ndarray] = {}
    by_protocol: dict[str, list[int]] = {}
    for i, cfg in enumerate(enabled):
        if cfg.decode.decoder in DIBIT_PROTOCOLS:
            by_protocol.setdefault(cfg.decode.decoder, []).append(i)
    for proto, idxs in by_protocol.items():
        dec = make_channel_decoder(proto, ch.channel_sample_rate,
                                   device=y.device)
        c = len(idxs)
        state0 = tree_map(lambda a: a.expand((c,) + a.shape).clone(),
                          dec.init_state())
        out, _ = dec.batched_call(streams_dev[idxs], state0)
        dib = out["dibits"].cpu().numpy()
        val = out["valid"].cpu().numpy()
        for row, i in enumerate(idxs):
            precomputed[i] = dib[row][val[row]]

    total = 0
    for i, (cfg, stream) in enumerate(zip(enabled, streams)):
        opts = {}
        if i in precomputed:
            opts["precomputed_dibits"] = precomputed[i]
        result = _decode_single(stream, ch.channel_sample_rate,
                                cfg.decode.decoder, opts)
        for msg in result["messages"]:
            msg["channel"] = cfg.name
            _emit(msg)
            total += 1
    _emit({"summary": True, "channels": len(enabled), "messages": total})
    return 0


def cmd_instrument(args) -> int:
    """Instrumentation taps (the reference's eye-diagram / constellation
    viewers, headless): FM-demodulate the channel, build the eye and the
    differential constellation, emit summary JSON and optionally the raw
    arrays as .npz. Host NumPy, as in the reference."""
    from .dsp.instrument import (best_eye, constellation_metrics,
                                 dqpsk_constellation)

    iq, fs = _load_iq(args.input)
    sps = fs / args.symbol_rate
    points = dqpsk_constellation(iq, sps)
    cmetrics = constellation_metrics(points)
    # full-rate quadrature discriminator: the eye needs the channel
    # sample rate, not the 8 kHz audio tap
    demod = np.angle(iq[1:] * np.conj(iq[:-1]))
    eye, eye_offset, opening = best_eye(demod, sps)
    summary = {"input": args.input, "symbol_rate": args.symbol_rate,
               "constellation": cmetrics,
               "eye_traces": int(eye.shape[0]),
               "eye_offset": round(eye_offset, 3),
               "eye_opening": round(opening, 3)}
    if args.output:
        np.savez(args.output, eye=eye, constellation=points)
        summary["output"] = args.output
    _emit(summary)
    return 0


def cmd_waterfall(args) -> int:
    """Frame-rate spectral frames for a capture (the spectral/waterfall
    display surface, spectrum/DFTProcessor.java): prints a summary JSON,
    optionally writes the (frames, fft) dB matrix as .npz and renders an
    ASCII waterfall preview. Host NumPy, as in the reference."""
    from .dsp.dft_processor import DFTProcessor

    iq, fs = _load_iq(args.input)
    proc = DFTProcessor(fs, fft_size=args.fft_size,
                        frame_rate=args.frame_rate,
                        complex_input=np.iscomplexobj(iq))
    rows = proc.receive(iq)
    summary = {"input": args.input, "sample_rate": fs,
               "fft_size": args.fft_size, "frame_rate": args.frame_rate,
               "frames": int(rows.shape[0]),
               "peak_db": (round(float(rows.max()), 1)
                           if rows.size else None)}
    if args.output:
        np.savez(args.output, waterfall=rows, sample_rate=fs,
                 frame_rate=args.frame_rate)
        summary["output"] = args.output
    if args.ascii and rows.size:
        # coarse terminal waterfall: one char per bin bucket, one row
        # per frame (newest last)
        ramp = " .:-=+*#%@"
        lo, hi = float(rows.min()), float(rows.max())
        span = max(hi - lo, 1e-6)
        width = min(args.fft_size, 96)
        step = rows.shape[1] // width
        for row in rows[:40]:
            cells = row[:width * step].reshape(width, step).max(axis=1)
            idx = ((cells - lo) / span * (len(ramp) - 1)).astype(int)
            print("".join(ramp[i] for i in idx))
    _emit(summary)
    return 0


def cmd_bench(args) -> int:
    """The repository root's bench_torch.py (the port's bench.py): the
    full bench on the card, --small on the CPU, --trace a torch.profiler
    trace. Returns its exit code: 1 when a leg recorded an error."""
    import bench_torch
    flags = []
    if args.small:
        flags.append("--small")
    if getattr(args, "trace", False):
        flags.append("--profile")
    sys.argv = ["bench_torch.py"] + flags
    return bench_torch.main()


def cmd_monitor(args) -> int:
    """Run the LIVE Orchestrator over a playlist: every enabled channel
    is pinned, trunked control channels follow traffic grants into free
    slots, decode events + metrics stream as JSONL, and completed call
    audio lands as WAV+metadata as calls end. The reference's headless
    live application (gui/SDRTrunk.java:141,281-300) as one command."""
    from .config import Playlist
    from .monitor import MonitorSession

    playlist = Playlist.load(args.playlist)

    if args.input:
        from .sources.recording import RecordingTuner
        center = args.center_frequency
        if center is None:
            raise SystemExit("monitor --input needs --center-frequency "
                             "(the RF frequency at capture center)")
        tuner = RecordingTuner(args.input, center_frequency=center,
                               loop=args.loop)
        source_read = tuner._read_chunk
        sample_rate = tuner.sample_rate
    elif args.source == "test":
        from .sources.test_tuner import TestTuner
        tuner = TestTuner(sample_rate=args.sample_rate or 12_800_000.0)
        center = args.center_frequency or tuner.frequency
        tuner.frequency = center
        source_read = tuner._read_chunk
        sample_rate = tuner.sample_rate
    else:
        # hardware: first discovered RTL dongle over libusb (the only
        # tuner family with a live bulk-streaming path wired up;
        # TunerManager.java discovery -> RTL2832TunerController)
        from .sources.libusb import (LibUsbTransport, available,
                                     discover_tuners)
        found = discover_tuners() if available() else []
        rtl = next((t for t in found if t["kind"] == "rtl2832"), None)
        if rtl is None:
            names = ", ".join(t["label"] for t in found) or "none"
            raise SystemExit(
                f"no RTL dongle found (devices: {names}); use --input "
                "for file replay or --source test")
        from .sources.rtl_live import RtlLiveTuner
        dev = rtl["device"]
        transport = LibUsbTransport(dev.vendor_id, dev.product_id)
        center = args.center_frequency
        if center is None:
            raise SystemExit("live RTL monitoring needs "
                             "--center-frequency")
        tuner = RtlLiveTuner(
            transport, sample_rate=int(args.sample_rate or 2_400_000),
            frequency=center)
        source_read = tuner._read_chunk
        sample_rate = tuner.sample_rate

    session = MonitorSession(
        playlist, source_read, sample_rate, center,
        emit=(None if args.quiet else
              (lambda line: print(line, flush=True))),
        audio_dir=args.audio_dir, event_log_path=args.event_log,
        traffic_slots=args.traffic_slots,
        bank_mode=(True if args.bank else None),
        chunk_samples=args.chunk_samples,
        host_process=args.host_process)
    session.wire_sigint()
    if hasattr(tuner, "add_listener"):
        tuner.add_listener(session.orch.on_source_event)
    _emit({"monitor": True, "sample_rate": sample_rate,
           "center_frequency_hz": center,
           "decoder_kinds": session.plan["kinds"],
           "slots": session.plan["slots"],
           "bank_mode": session.orch.bank_mode,
           "channels": [{"name": n, "offset_hz": off, "kind": k}
                        for off, k, n in session.plan["controls"]]})
    max_chunks = args.max_chunks
    if args.duration:
        per = session.orch.chunk_samples / sample_rate
        max_chunks = max(1, int(round(args.duration / per)))
    summary = session.run(max_chunks=max_chunks)
    _emit(summary)
    return 0


def cmd_playlist(args) -> int:
    """Headless playlist editor (the reference's JavaFX playlist editor
    surface, gui/playlist/, without pixels): list / add-channel /
    remove-channel / enable / disable / set-field on the native JSON
    playlist, with the reference PlaylistManager's versioned
    backup-on-save."""
    from .config import (ChannelConfig, DecodeConfig, Playlist,
                         SourceConfig)

    path = Path(args.playlist)
    if args.action == "new":
        if path.exists():
            raise SystemExit(f"{path} already exists")
        Playlist().save(path)
        _emit({"created": str(path)})
        return 0
    playlist = Playlist.load(path)

    def find(name: str) -> int:
        for i, c in enumerate(playlist.channels):
            if c.name == name:
                return i
        raise SystemExit(f"no channel named {name!r}")

    if args.action == "list":
        for c in playlist.channels:
            _emit({"name": c.name, "system": c.system, "site": c.site,
                   "enabled": c.enabled,
                   "frequency_hz": c.source.frequency_hz,
                   "decoder": c.decode.decoder})
        _emit({"summary": True, "channels": len(playlist.channels),
               "aliases": len(playlist.aliases),
               "streams": len(playlist.streams)})
        return 0
    if args.action == "add-channel":
        if args.name is None or args.frequency is None:
            raise SystemExit("add-channel needs --name and --frequency")
        playlist.channels.append(ChannelConfig(
            name=args.name, system=args.system or "",
            site=args.site or "",
            source=SourceConfig(frequency_hz=args.frequency),
            decode=DecodeConfig(decoder=args.decoder or "nbfm")))
        playlist.save(path)
        _emit({"added": args.name, "channels": len(playlist.channels)})
        return 0
    if args.action == "remove-channel":
        playlist.channels.pop(find(args.name))
        playlist.save(path)
        _emit({"removed": args.name, "channels": len(playlist.channels)})
        return 0
    if args.action in ("enable", "disable"):
        playlist.channels[find(args.name)].enabled = \
            args.action == "enable"
        playlist.save(path)
        _emit({args.action + "d": args.name})
        return 0
    if args.action == "set":
        if not args.field or args.value is None:
            raise SystemExit("set needs --field and --value")
        ch = playlist.channels[find(args.name)]
        target, field_name = ch, args.field
        if "." in field_name:
            section, field_name = field_name.split(".", 1)
            target = getattr(ch, section)
        if not hasattr(target, field_name):
            raise SystemExit(f"unknown field {args.field!r}")
        current = getattr(target, field_name)
        value: object = args.value
        if isinstance(current, bool):
            value = args.value.lower() in ("1", "true", "yes", "on")
        elif isinstance(current, float):
            value = float(args.value)
        elif isinstance(current, int):
            value = int(args.value)
        setattr(target, field_name, value)
        playlist.save(path)
        _emit({"set": args.field, "value": value, "channel": args.name})
        return 0
    raise SystemExit(f"unknown action {args.action!r}")


def cmd_import_playlist(args) -> int:
    """Import a reference sdrtrunk playlist.xml (PlaylistV2) into the
    native JSON config (playlist_import.py)."""
    from .playlist_import import import_playlist_xml
    playlist = import_playlist_xml(args.input)
    playlist.save(args.output)
    _emit({"imported": str(args.input), "saved": str(args.output),
           "channels": len(playlist.channels),
           "aliases": len(playlist.aliases),
           "streams": len(playlist.streams)})
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="sdrtrunk_tpu_torch",
        description="CUDA trunked-radio decoder (headless)")
    parser.add_argument(
        "--platform", choices=["cpu", "device"], default=None,
        help="cpu runs the whole command on the CPU (the plain PyTorch "
             "versions of the kernels); device, the default, runs it on "
             "the CUDA card for every command")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("info", help="band summary from an IQ wave")
    p.add_argument("input")
    p.add_argument("--bandwidth", type=float, default=12500.0)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("channelize", help="polyphase channelize an IQ wave")
    p.add_argument("input")
    p.add_argument("--bandwidth", type=float, default=12500.0)
    p.add_argument("--channels", help="comma-separated offsets (Hz) to "
                                      "extract as per-channel IQ wavs")
    p.add_argument("--output", help="output directory")
    p.set_defaults(fn=cmd_channelize)

    p = sub.add_parser("decode", help="decode one channel from an IQ wave")
    p.add_argument("input")
    p.add_argument("--protocol", required=True,
                   choices=["nbfm", "am", "p25p1", "p25p1-lsm", "p25p2",
                            "dmr", "ltr", "ltrnet", "passport", "mpt1327"])
    p.add_argument("--offset", type=float, default=0.0,
                   help="channel offset from capture center (Hz)")
    p.add_argument("--bandwidth", type=float, default=12500.0)
    p.add_argument("--squelch-db", type=float, default=-78.0)
    p.add_argument("--audio", help="write demodulated audio WAV here")
    p.add_argument("--wacn", type=int, default=0)
    p.add_argument("--system", type=int, default=0)
    p.add_argument("--nac", type=int, default=0)
    p.set_defaults(fn=cmd_decode)

    p = sub.add_parser("replay", help="decode playlist channels from a "
                                      "wideband capture")
    p.add_argument("input")
    p.add_argument("--playlist", required=True)
    p.add_argument("--center-frequency", type=float, default=0.0)
    p.add_argument("--bandwidth", type=float, default=12500.0)
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("instrument", help="eye diagram / constellation "
                                          "taps for a channel IQ wave")
    p.add_argument("input")
    p.add_argument("--symbol-rate", type=float, default=4800.0)
    p.add_argument("--output", help="write eye/constellation arrays (.npz)")
    p.set_defaults(fn=cmd_instrument)

    p = sub.add_parser("waterfall", help="frame-rate spectral frames "
                                         "(spectral/waterfall surface)")
    p.add_argument("input")
    p.add_argument("--fft-size", type=int, default=1024)
    p.add_argument("--frame-rate", type=float, default=20.0)
    p.add_argument("--output", help="write frames to .npz")
    p.add_argument("--ascii", action="store_true",
                   help="render an ASCII waterfall preview")
    p.set_defaults(fn=cmd_waterfall)

    p = sub.add_parser("bench", help="throughput benchmark")
    p.add_argument("--small", action="store_true")
    p.add_argument("--trace", action="store_true",
                   help="write a torch.profiler trace alongside the bench")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("monitor", help="LIVE trunked monitoring: "
                       "playlist -> orchestrator with traffic following")
    p.add_argument("--playlist", required=True)
    p.add_argument("--input", help="IQ wave to replay as the tuner "
                                   "(omit to use hardware / --source)")
    p.add_argument("--source", choices=["usb", "test"], default="usb",
                   help="live source when no --input: first USB tuner, "
                        "or the synthetic test tuner")
    p.add_argument("--center-frequency", type=float,
                   help="RF frequency at capture center (Hz)")
    p.add_argument("--sample-rate", type=float,
                   help="tuner sample rate (hardware/test sources)")
    p.add_argument("--audio-dir", help="write completed call audio "
                                       "(WAV + metadata JSON) here")
    p.add_argument("--event-log", help="decode-event log (.csv/.jsonl)")
    p.add_argument("--traffic-slots", type=int, default=4,
                   help="spare slots for granted traffic channels")
    p.add_argument("--bank", action="store_true",
                   help="force bank mode (auto at >=32 slots)")
    p.add_argument("--host-process", action="store_true",
                   help="run the bank host layer in a worker process "
                        "(multi-core hosts; digital bank modes)")
    p.add_argument("--chunk-samples", type=int)
    p.add_argument("--duration", type=float,
                   help="stop after this many seconds of signal")
    p.add_argument("--max-chunks", type=int)
    p.add_argument("--loop", action="store_true",
                   help="loop the --input recording forever")
    p.add_argument("--quiet", action="store_true",
                   help="suppress per-chunk metrics lines")
    p.set_defaults(fn=cmd_monitor)

    p = sub.add_parser("playlist", help="headless playlist editor: "
                       "new/list/add-channel/remove-channel/enable/"
                       "disable/set")
    p.add_argument("action", choices=["new", "list", "add-channel",
                                      "remove-channel", "enable",
                                      "disable", "set"])
    p.add_argument("--playlist", required=True)
    p.add_argument("--name", help="channel name")
    p.add_argument("--frequency", type=float)
    p.add_argument("--decoder")
    p.add_argument("--system")
    p.add_argument("--site")
    p.add_argument("--field", help="e.g. decode.squelch_threshold_db, "
                                   "source.frequency_hz, record.audio")
    p.add_argument("--value")
    p.set_defaults(fn=cmd_playlist)

    p = sub.add_parser("import-playlist",
                       help="import a reference sdrtrunk playlist.xml")
    p.add_argument("input")
    p.add_argument("output", help="native JSON playlist to write")
    p.set_defaults(fn=cmd_import_playlist)

    args = parser.parse_args(argv)
    if args.platform == "cpu":
        from . import use_device
        with use_device("cpu"):
            return args.fn(args)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
