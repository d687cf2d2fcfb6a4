"""Audio streaming egress (role of audio/broadcast/: AudioStreamingManager
.java:46 delay queues + icecast/IcecastTCPAudioBroadcaster.java:43).

IcecastSourceClient speaks the Icecast2 HTTP PUT source protocol over any
socket-like object (connect/sendall/recv/close) so tests inject a fake
transport; MP3 conversion is a pluggable encoder callable (the reference
shells out to LAME — an external dependency — so PCM16 passthrough is the
default here).
"""
from __future__ import annotations

import base64
from collections import deque
from dataclasses import dataclass
from typing import Callable

import numpy as np

from .segments import AudioSegment

__all__ = ["StreamConfig", "IcecastSourceClient", "ShoutcastV1Client",
           "BroadcastifyCallClient", "AudioStreamingManager"]


@dataclass(frozen=True)
class StreamConfig:
    name: str
    host: str = "localhost"
    port: int = 8000
    mountpoint: str = "/stream"
    username: str = "source"
    password: str = ""
    content_type: str = "audio/mpeg"
    delay_seconds: float = 0.0


class IcecastSourceClient:
    """Minimal Icecast2 source: HTTP PUT + basic auth + raw frame stream."""

    def __init__(self, config: StreamConfig, socket_factory: Callable):
        self.config = config
        self._socket_factory = socket_factory
        self._socket = None
        self.connected = False

    def connect(self) -> bool:
        sock = self._socket_factory(self.config.host, self.config.port)
        auth = base64.b64encode(
            f"{self.config.username}:{self.config.password}".encode()
        ).decode()
        request = (
            f"PUT {self.config.mountpoint} HTTP/1.1\r\n"
            f"Host: {self.config.host}:{self.config.port}\r\n"
            f"Authorization: Basic {auth}\r\n"
            f"User-Agent: sdrtrunk-tpu\r\n"
            f"Content-Type: {self.config.content_type}\r\n"
            f"Ice-Name: {self.config.name}\r\n"
            f"Ice-Public: 0\r\n"
            f"Expect: 100-continue\r\n\r\n")
        sock.sendall(request.encode())
        response = sock.recv(4096).decode(errors="replace")
        if "100 Continue" in response or "200 OK" in response:
            self._socket = sock
            self.connected = True
            return True
        sock.close()
        return False

    def send(self, frames: bytes) -> None:
        if not self.connected:
            raise ConnectionError("not connected")
        self._socket.sendall(frames)

    def close(self) -> None:
        if self._socket is not None:
            self._socket.close()
        self.connected = False


class ShoutcastV1Client:
    """Shoutcast v1 source protocol (audio/broadcast/shoutcast/v1/
    ShoutcastV1AudioBroadcaster.java:210): password line first, then
    icy-* stream headers, server acks with OK2."""

    def __init__(self, config: StreamConfig, socket_factory: Callable,
                 genre: str = "scanner", is_public: bool = False,
                 bitrate_kbps: int = 16):
        self.config = config
        self.genre = genre
        self.is_public = is_public
        self.bitrate_kbps = bitrate_kbps
        self._socket_factory = socket_factory
        self._socket = None
        self.connected = False
        self.last_error = ""

    def connect(self) -> bool:
        # shoutcast v1 sources connect on port+1
        sock = self._socket_factory(self.config.host, self.config.port + 1)
        handshake = (
            f"{self.config.password}\r\n"
            f"icy-name:{self.config.name}\r\n"
            f"icy-pub:{1 if self.is_public else 0}\r\n"
            f"icy-genre:{self.genre}\r\n"
            f"icy-br:{self.bitrate_kbps}\r\n"
            "\r\n")
        sock.sendall(handshake.encode())
        response = sock.recv(4096).decode(errors="replace").strip()
        if response.startswith("OK2") or response.startswith("OK"):
            self._socket = sock
            self.connected = True
            return True
        self.last_error = response or "no response"
        sock.close()
        return False

    def send(self, frames: bytes) -> None:
        if not self.connected:
            raise ConnectionError("not connected")
        self._socket.sendall(frames)

    def close(self) -> None:
        if self._socket is not None:
            self._socket.close()
        self.connected = False


class BroadcastifyCallClient:
    """Broadcastify call-push API client
    (broadcastify/BroadcastifyCallBroadcaster.java:202): two-step —
    multipart metadata POST returns "0 <upload-url>" (or "1 SKIPPED"),
    then the audio file is PUT to that URL.  HTTP is injectable:
    http_post(url, content_type, body) -> str and
    http_put(url, data) -> int status.
    """

    API_URL = "https://api.broadcastify.com/call-upload"
    BOUNDARY = "sdrtrunk-tpu-call-upload"

    def __init__(self, api_key: str, system_id: int,
                 http_post: Callable, http_put: Callable):
        self.api_key = api_key
        self.system_id = system_id
        self.http_post = http_post
        self.http_put = http_put
        self.uploaded = 0
        self.skipped = 0
        self.errors = 0

    def _multipart(self, fields: dict) -> tuple[str, bytes]:
        parts = []
        for name, value in fields.items():
            parts.append(
                f"--{self.BOUNDARY}\r\n"
                f'Content-Disposition: form-data; name="{name}"\r\n\r\n'
                f"{value}\r\n")
        parts.append(f"--{self.BOUNDARY}--\r\n")
        return (f"multipart/form-data; boundary={self.BOUNDARY}",
                "".join(parts).encode())

    def upload(self, audio: bytes, *, talkgroup: int, radio_id: int = 0,
               frequency_hz: float = 0.0, timestamp: float = 0.0,
               duration_s: float = 0.0, encoding: str = "mp3") -> str:
        """Returns "uploaded" | "skipped" | "error"."""
        content_type, body = self._multipart({
            "apiKey": self.api_key,
            "systemId": self.system_id,
            "callDuration": round(duration_s, 2),
            "ts": int(timestamp),
            "tg": talkgroup,
            "src": radio_id,
            "freq": int(frequency_hz),
            "enc": encoding,
        })
        response = str(self.http_post(self.API_URL, content_type, body))
        if response.startswith("1 SKIPPED"):
            self.skipped += 1
            return "skipped"
        if not response.startswith("0 "):
            self.errors += 1
            return "error"
        status = int(self.http_put(response[2:].strip(), audio))
        if 200 <= status < 300:
            self.uploaded += 1
            return "uploaded"
        self.errors += 1
        return "error"


def pcm16_encoder(segment: AudioSegment) -> bytes:
    pcm = np.clip(segment.samples, -1.0, 1.0)
    return (pcm * 32767.0).astype("<i2").tobytes()


class AudioStreamingManager:
    """Per-stream delay queue -> encoder -> client (the reference delays
    segments so streamed audio lags live playback)."""

    def __init__(self, client, encoder: Callable = pcm16_encoder,
                 delay_seconds: float = 0.0, streamable_filter=None):
        self.client = client
        self.encoder = encoder
        self.delay_seconds = delay_seconds
        self.streamable_filter = streamable_filter
        self._queue: deque = deque()
        self.sent_segments = 0

    def receive(self, segment: AudioSegment) -> None:
        if segment.duplicate:
            return
        if self.streamable_filter is not None and \
                not self.streamable_filter(segment):
            return
        self._queue.append(segment)

    def process(self, now: float) -> int:
        """Send all segments older than the delay; returns count sent."""
        sent = 0
        while self._queue and \
                now - self._queue[0].end_time >= self.delay_seconds:
            segment = self._queue.popleft()
            self.client.send(self.encoder(segment))
            self.sent_segments += 1
            sent += 1
        return sent
