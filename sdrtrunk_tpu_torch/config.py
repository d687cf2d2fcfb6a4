"""Configuration system (role of the reference's playlist/preference layer,
L8: PlaylistManager XML, Channel.java's aggregation of Source/Decode/
AuxDecode/EventLog/Record configs — re-based on dataclasses + JSON).

A Playlist aggregates channels, aliases and stream configs; versioned
load/save with backup mirrors PlaylistManager.java:450-459's
lock/backup/restore behavior.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["SourceConfig", "DecodeConfig", "RecordConfig", "EventLogConfig",
           "ChannelConfig", "StreamConfigEntry", "AliasEntry", "Playlist",
           "MeshConfig", "PLAYLIST_VERSION"]

PLAYLIST_VERSION = 1

DECODER_TYPES = ("nbfm", "am", "p25p1", "p25p1-lsm", "p25p2", "dmr", "ltr",
                 "ltrnet", "passport", "mpt1327")


@dataclass
class SourceConfig:
    """Where the channel's IQ comes from (SourceConfigTuner /
    SourceConfigRecording analogs)."""
    frequency_hz: float = 0.0
    source: str = "tuner"          # tuner | wave | synthetic
    path: str = ""                 # for wave sources
    sample_rate: float = 0.0       # for raw/wave sources


@dataclass
class DecodeConfig:
    """Per-protocol decode parameters (DecodeConfigP25Phase1 et al.;
    defaults per SURVEY.md section 2.7)."""
    decoder: str = "nbfm"
    bandwidth_hz: float = 12500.0
    squelch_threshold_db: float = -78.0
    # trunked-protocol extras
    nac: int | None = None
    color_code: int | None = None
    wacn: int | None = None
    system: int | None = None
    timeslot: int | None = None
    talkgroups: list = field(default_factory=list)
    # auxiliary decoders running on the channel's demodulated audio
    # (AuxDecodeConfiguration: fleetsync2 / mdc1200 / lj1200 / tait1200)
    aux: list = field(default_factory=list)

    def __post_init__(self):
        if self.decoder not in DECODER_TYPES:
            raise ValueError(f"unknown decoder '{self.decoder}' "
                             f"(choose from {DECODER_TYPES})")


@dataclass
class RecordConfig:
    audio: bool = False
    baseband_iq: bool = False
    demodulated_bits: bool = False
    audio_format: str = "wav"      # wav | mp2 (the MP3-recording
    #  option of the reference's AudioSegmentRecorder)


@dataclass
class EventLogConfig:
    decode_events: bool = True
    messages: bool = False


@dataclass
class ChannelConfig:
    name: str
    system: str = ""
    site: str = ""
    enabled: bool = True
    source: SourceConfig = field(default_factory=SourceConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    record: RecordConfig = field(default_factory=RecordConfig)
    event_log: EventLogConfig = field(default_factory=EventLogConfig)
    alias_list: str = ""


@dataclass
class AliasEntry:
    name: str
    list_name: str = ""
    group: str = ""
    priority: int = 100
    record: bool = False
    stream: bool = False
    protocol: str = ""
    talkgroup: int | None = None
    talkgroup_min: int | None = None
    talkgroup_max: int | None = None


@dataclass
class StreamConfigEntry:
    name: str
    host: str = "localhost"
    port: int = 8000
    mountpoint: str = "/stream"
    password: str = ""
    delay_seconds: float = 0.0


@dataclass
class MeshConfig:
    """Device-mesh / sharding layout (no reference analog — SURVEY.md
    section 2.8 first-class parallelism config)."""
    hosts: int = 1
    chips_per_host: int = 1
    channel_shards: int = 1
    time_shards: int = 1


@dataclass
class Playlist:
    version: int = PLAYLIST_VERSION
    channels: list = field(default_factory=list)
    aliases: list = field(default_factory=list)
    streams: list = field(default_factory=list)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # ---------- persistence ----------

    def save(self, path) -> None:
        """Atomic save with .backup of the previous file
        (PlaylistManager.java backup/restore behavior)."""
        path = Path(path)
        payload = json.dumps(dataclasses.asdict(self), indent=2)
        if path.exists():
            path.with_suffix(path.suffix + ".backup").write_text(
                path.read_text())
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(payload)
        tmp.replace(path)

    @staticmethod
    def load(path) -> "Playlist":
        path = Path(path)
        try:
            data = json.loads(path.read_text())
        except (json.JSONDecodeError, OSError):
            backup = path.with_suffix(path.suffix + ".backup")
            if backup.exists():
                data = json.loads(backup.read_text())
            else:
                raise
        data = _migrate(data)
        return Playlist(
            version=data.get("version", PLAYLIST_VERSION),
            channels=[_channel_from(d) for d in data.get("channels", [])],
            aliases=[AliasEntry(**d) for d in data.get("aliases", [])],
            streams=[StreamConfigEntry(**d) for d in data.get("streams", [])],
            mesh=MeshConfig(**data.get("mesh", {})),
        )

    # ---------- alias bridge ----------

    def alias_list(self, name: str = ""):
        """Materialize a runtime AliasList from the config entries."""
        from .runtime.aliases import Alias, AliasList, TalkgroupMatcher
        out = AliasList(name)
        for e in self.aliases:
            if name and e.list_name and e.list_name != name:
                continue
            matchers = []
            if e.talkgroup is not None:
                matchers.append(TalkgroupMatcher(e.protocol,
                                                 value=e.talkgroup))
            if e.talkgroup_min is not None:
                matchers.append(TalkgroupMatcher(
                    e.protocol, range_min=e.talkgroup_min,
                    range_max=e.talkgroup_max))
            out.add(Alias(name=e.name, group=e.group, priority=e.priority,
                          record=e.record, stream=e.stream,
                          matchers=matchers))
        return out


def _channel_from(d: dict) -> ChannelConfig:
    return ChannelConfig(
        name=d["name"], system=d.get("system", ""), site=d.get("site", ""),
        enabled=d.get("enabled", True),
        source=SourceConfig(**d.get("source", {})),
        decode=DecodeConfig(**d.get("decode", {})),
        record=RecordConfig(**d.get("record", {})),
        event_log=EventLogConfig(**d.get("event_log", {})),
        alias_list=d.get("alias_list", ""))


def _migrate(data: dict) -> dict:
    """Versioned migration hook (PlaylistUpdater analog)."""
    version = data.get("version", 0)
    if version < 1:
        data["version"] = 1
    return data
