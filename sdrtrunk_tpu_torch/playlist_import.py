"""Import a reference PlaylistV2 XML into this framework's Playlist.

The reference persists channels/aliases/streams as Jackson-XML
(playlist/PlaylistV2.java: <playlist version="2"> with <channel>,
<alias>, <stream>, <channel_map> children; polymorphic nodes carry an
xsi:type attribute — e.g. decode_configuration xsi:type=
"decodeConfigP25Phase1"). Existing sdrtrunk users carry years of
configuration in these files; this importer maps them onto config.py's
dataclasses so a playlist.xml drops straight into the TPU runtime
(PlaylistManager.java:450 load path; the version migration chain of
PlaylistUpdater.java collapses to reading the final V2 shape).
"""
from __future__ import annotations

import xml.etree.ElementTree as ET

from .config import (AliasEntry, ChannelConfig, DecodeConfig,
                     EventLogConfig, Playlist, RecordConfig, SourceConfig,
                     StreamConfigEntry)

__all__ = ["import_playlist_xml", "DECODE_TYPE_MAP"]

_XSI = "{http://www.w3.org/2001/XMLSchema-instance}type"

# reference DecodeConfiguration xsi:type -> our decoder kind
# (module/decode/config/DecodeConfiguration.java JsonSubTypes)
DECODE_TYPE_MAP = {
    "decodeConfigAM": "am",
    "decodeConfigNBFM": "nbfm",
    "decodeConfigP25Phase1": "p25p1",     # modulation CQPSK -> lsm
    "decodeConfigP25Phase2": "p25p2",
    "decodeConfigDMR": "dmr",
    "decodeConfigLTRStandard": "ltr",
    "decodeConfigLTRNet": "ltrnet",
    "decodeConfigPassport": "passport",
    "decodeConfigMPT1327": "mpt1327",
}


def _xsi_type(el) -> str:
    return el.get(_XSI, el.get("type", ""))


def _bool(v: str | None, default: bool = False) -> bool:
    if v is None:
        return default
    return v.strip().lower() in ("true", "1", "yes")


def _decode_config(el) -> DecodeConfig:
    kind = DECODE_TYPE_MAP.get(_xsi_type(el))
    if kind is None:
        kind = "nbfm"
    if kind == "p25p1" and el.get("modulation", "C4FM").upper() == "CQPSK":
        kind = "p25p1-lsm"
    cfg = DecodeConfig(decoder=kind)
    if el.get("bandwidth"):
        # DecodeConfigNBFM bandwidth enum BW_12_5 / BW_25_0
        bw = el.get("bandwidth").replace("BW_", "").replace("_", ".")
        try:
            cfg.bandwidth_hz = float(bw) * 1000.0
        except ValueError:
            pass
    if el.get("squelch"):
        cfg.squelch_threshold_db = float(el.get("squelch"))
    # trunked extras ride child elements in some versions, attrs in others
    for key, attr in (("color_code", "color_code"),
                      ("timeslot", "timeslot")):
        val = el.get(attr)
        if val is None:
            child = el.find(attr)
            val = child.text if child is not None else None
        if val is not None:
            try:
                setattr(cfg, key, int(val))
            except ValueError:
                pass
    return cfg


def _source_config(el) -> SourceConfig:
    kind = _xsi_type(el)
    cfg = SourceConfig()
    if kind == "sourceConfigRecording":
        cfg.source = "wave"
        cfg.path = el.get("path", "") or (el.findtext("path") or "")
    else:
        cfg.source = "tuner"
    freq = el.get("frequency")
    if freq is None:
        # sourceConfigTunerMultipleFrequency carries a frequency list
        freq = el.findtext("frequency")
    if freq is not None:
        cfg.frequency_hz = float(freq)
    return cfg


def _record_config(el) -> RecordConfig:
    cfg = RecordConfig()
    for rec in el.findall("recorder"):
        name = (rec.text or "").strip().upper()
        if name == "AUDIO":
            cfg.audio = True
        elif "BASEBAND" in name:
            cfg.baseband_iq = True
        elif "BIT_STREAM" in name:
            cfg.demodulated_bits = True
    return cfg


def _event_log_config(el) -> EventLogConfig:
    cfg = EventLogConfig(decode_events=False, messages=False)
    for log in el.findall("logger"):
        name = (log.text or "").strip().upper()
        if "DECODE" in name or "CALL" in name:
            cfg.decode_events = True
        elif "MESSAGE" in name:
            cfg.messages = True
    return cfg


def _channel(el) -> ChannelConfig:
    cfg = ChannelConfig(
        name=el.get("name", ""),
        system=el.get("system", ""),
        site=el.get("site", ""),
        enabled=_bool(el.get("enabled"), True),
        alias_list=el.findtext("alias_list_name") or "",
    )
    dec = el.find("decode_configuration")
    if dec is not None:
        cfg.decode = _decode_config(dec)
    src = el.find("source_configuration")
    if src is not None:
        cfg.source = _source_config(src)
    rec = el.find("record_configuration")
    if rec is not None:
        cfg.record = _record_config(rec)
    log = el.find("event_log_configuration")
    if log is not None:
        cfg.event_log = _event_log_config(log)
    aux = el.find("aux_decode_configuration")
    if aux is not None:
        # AuxDecodeConfiguration.java:41 <aux_decoder>FLEETSYNC2</...>
        names = {"FLEETSYNC2": "fleetsync2", "MDC1200": "mdc1200",
                 "LJ1200": "lj1200", "TAIT1200": "tait1200",
                 "TAIT_1200": "tait1200", "MDC_1200": "mdc1200",
                 "LJ_1200": "lj1200", "FLEETSYNC_2": "fleetsync2"}
        for d in aux.findall("aux_decoder"):
            name = names.get((d.text or "").strip().upper())
            if name and name not in cfg.decode.aux:
                cfg.decode.aux.append(name)
    return cfg


def _aliases(el) -> list[AliasEntry]:
    """One reference <alias> can carry several talkgroup ids; each maps
    to one AliasEntry (our flat model)."""
    base = dict(name=el.get("name", ""), list_name=el.get("list", ""),
                group=el.get("group", ""))
    priority = 100
    record = False
    stream = False
    id_entries = []
    for aid in el.findall("id"):
        kind = _xsi_type(aid)
        if kind == "priority":
            priority = int(aid.get("priority", 100))
        elif kind == "record":
            record = True
        elif kind == "broadcastChannel":
            stream = True
        elif kind == "talkgroup":
            id_entries.append(dict(protocol=aid.get("protocol", ""),
                                   talkgroup=int(aid.get("value", 0))))
        elif kind == "talkgroupRange":
            id_entries.append(dict(protocol=aid.get("protocol", ""),
                                   talkgroup_min=int(aid.get("min", 0)),
                                   talkgroup_max=int(aid.get("max", 0))))
        elif kind == "radio":
            id_entries.append(dict(protocol=aid.get("protocol", ""),
                                   talkgroup=int(aid.get("value", 0))))
    if not id_entries:
        id_entries = [{}]
    return [AliasEntry(**base, priority=priority, record=record,
                       stream=stream, **ids) for ids in id_entries]


def _stream(el) -> StreamConfigEntry:
    return StreamConfigEntry(
        name=el.get("name", ""),
        host=el.get("host", "localhost"),
        port=int(el.get("port", 8000)),
        mountpoint=el.get("mount_point", el.get("mountpoint", "/stream")),
        password=el.get("password", ""),
        delay_seconds=float(el.get("delay", 0)) / 1000.0,
    )


def import_playlist_xml(path) -> Playlist:
    """Parse a reference playlist XML file (PlaylistV2) -> Playlist."""
    tree = ET.parse(str(path))
    root = tree.getroot()
    if root.tag != "playlist":
        raise ValueError(f"not a playlist file (root <{root.tag}>)")
    playlist = Playlist()
    for ch in root.findall("channel"):
        playlist.channels.append(_channel(ch))
    for al in root.findall("alias"):
        playlist.aliases.extend(_aliases(al))
    for st in root.findall("stream"):
        playlist.streams.append(_stream(st))
    return playlist
