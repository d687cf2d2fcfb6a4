"""Audio + bitstream recording (role of record/AudioSegmentRecorder
(WAV with metadata), record/binary/BinaryRecorder.java:51 (.bits
demodulated bitstream) and BinaryReader).

.bits files are byte-packed dibit streams identical to the reference's
format (each byte holds 4 dibits, MSB-first) so recordings interchange as
golden vectors.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..io.wave import read_real_wave, write_real_wave
from .segments import AudioSegment

__all__ = ["write_audio_wave", "write_audio_mpeg", "read_audio_wave",
           "read_wave_list_info", "BitsRecorder", "BitsReader"]


def _list_info_chunk(segment: AudioSegment) -> bytes:
    """RIFF LIST-INFO chunk carrying the call identifiers in-container
    (record/wave/AudioMetadataUtils.java writes the same INFO tags:
    IART = from, INAM = to, ICMT = details, ICRD = time)."""
    frm = [i.value for i in segment.identifiers.all()
           if i.role.value == "FROM"]
    to = [i.value for i in segment.identifiers.all()
          if i.role.value == "TO"]

    def sub(tag: bytes, text: str) -> bytes:
        data = text.encode() + b"\x00"
        if len(data) % 2:
            data += b"\x00"
        return tag + len(data).to_bytes(4, "little") + data

    body = b"INFO"
    if frm:
        body += sub(b"IART", ",".join(str(v) for v in frm))
    if to:
        body += sub(b"INAM", ",".join(str(v) for v in to))
    body += sub(b"ICRD", f"{segment.start_time:.3f}")
    body += sub(b"ICMT", f"timeslot={segment.timeslot} "
                         f"duration={segment.duration:.3f}")
    return b"LIST" + len(body).to_bytes(4, "little") + body


def read_wave_list_info(path) -> dict:
    """Parse a WAV's LIST-INFO chunk -> {tag: text} (test/interop)."""
    raw = Path(path).read_bytes()
    pos = 12
    out: dict[str, str] = {}
    while pos + 8 <= len(raw):
        cid = raw[pos:pos + 4]
        size = int.from_bytes(raw[pos + 4:pos + 8], "little")
        if cid == b"LIST" and raw[pos + 8:pos + 12] == b"INFO":
            sub = pos + 12
            end = pos + 8 + size
            while sub + 8 <= end:
                tag = raw[sub:sub + 4].decode(errors="replace")
                n = int.from_bytes(raw[sub + 4:sub + 8], "little")
                out[tag] = raw[sub + 8:sub + 8 + n].rstrip(
                    b"\x00").decode(errors="replace")
                sub += 8 + n + (n % 2)
        pos += 8 + size + (size % 2)
    return out


def write_audio_wave(path, segment: AudioSegment) -> None:
    """WAV with an in-container LIST-INFO metadata chunk (the
    reference's AudioMetadataUtils LIST tags) plus a sidecar JSON with
    the full typed identifier set."""
    path = Path(path)
    write_real_wave(path, segment.samples, int(segment.sample_rate))
    # append LIST-INFO after the data chunk and patch the RIFF size
    chunk = _list_info_chunk(segment)
    with open(path, "r+b") as f:
        f.seek(0, 2)
        f.write(chunk)
        total = f.tell()
        f.seek(4)
        f.write((total - 8).to_bytes(4, "little"))
    meta = {
        "start_time": segment.start_time,
        "duration": segment.duration,
        "sample_rate": segment.sample_rate,
        "timeslot": segment.timeslot,
        "identifiers": [
            {"class": i.identifier_class.value, "form": i.form.value,
             "role": i.role.value, "value": i.value,
             "protocol": i.protocol}
            for i in segment.identifiers.all()],
    }
    path.with_suffix(path.suffix + ".json").write_text(json.dumps(meta))


def read_audio_wave(path):
    """-> (samples float32, rate, metadata dict | None)."""
    path = Path(path)
    samples, rate = read_real_wave(path)
    meta_path = path.with_suffix(path.suffix + ".json")
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else None
    return samples, rate, meta


def write_audio_mpeg(path, segment: AudioSegment) -> None:
    """Record a call as an MPEG Layer II ('MP2') file + JSON sidecar —
    the role of the reference's MP3 recording format option
    (AudioSegmentRecorder MP3 path via LAME; the in-repo encoder is
    the Layer II sibling, playable by every MPEG audio decoder)."""
    from .mpeg import mpeg_layer2_encoder
    path = Path(path)
    path.write_bytes(mpeg_layer2_encoder(segment))
    meta = {
        "start_time": segment.start_time,
        "duration": segment.duration,
        "sample_rate": segment.sample_rate,
        "timeslot": segment.timeslot,
        "identifiers": [
            {"class": i.identifier_class.value, "form": i.form.value,
             "role": i.role.value, "value": i.value,
             "protocol": i.protocol}
            for i in segment.identifiers.all()],
    }
    path.with_suffix(path.suffix + ".json").write_text(json.dumps(meta))


class BitsRecorder:
    """Append dibits to a .bits file (4 dibits/byte, MSB-first — the
    reference BinaryRecorder byte layout, Dibit.parse(value, x))."""

    def __init__(self, path):
        self.path = Path(path)
        self._pending = np.zeros(0, np.uint8)
        self.path.write_bytes(b"")

    def write(self, dibits: np.ndarray) -> None:
        d = np.concatenate([self._pending, np.asarray(dibits, np.uint8)])
        n = (len(d) // 4) * 4
        chunk, self._pending = d[:n], d[n:]
        if n:
            q = chunk.reshape(-1, 4)
            packed = (q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3]
            with open(self.path, "ab") as fh:
                fh.write(packed.astype(np.uint8).tobytes())

    def close(self) -> None:
        if len(self._pending):
            self.write(np.zeros(4 - len(self._pending) % 4, np.uint8))


class BitsReader:
    @staticmethod
    def read(path) -> np.ndarray:
        """-> dibit array."""
        data = np.frombuffer(Path(path).read_bytes(), np.uint8)
        out = np.empty(4 * len(data), np.uint8)
        out[0::4] = (data >> 6) & 3
        out[1::4] = (data >> 4) & 3
        out[2::4] = (data >> 2) & 3
        out[3::4] = data & 3
        return out
