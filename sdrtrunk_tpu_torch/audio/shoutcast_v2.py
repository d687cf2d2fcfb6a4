"""Shoutcast v2 source client — the Ultravox 2.1 framed protocol
(audio/broadcast/shoutcast/v2/ShoutcastV2AudioStreamingBroadcaster.java
and ultravox/*.java).

Wire format (UltravoxMessage.java:33-47): every message is
    sync 0x5A (8) | reserved (4) | required-delivery (1) | priority (3)
    | message class+type (16) | payload length (16) | payload bytes
String payloads carry a trailing 0x00 included in the length; server
responses prefix "ACK" (success) or "NAK:" (error) in the payload.

Handshake (broadcaster messageReceived switch, :470-560):
    REQUEST_CIPHER -> server returns the XTEA key seed
    AUTHENTICATE_BROADCAST with "2.1:streamID:xtea(user):xtea(pass)"
    STREAM_MIME_TYPE (audio/mpeg) -> SETUP_BROADCAST (bitrates)
    -> CONFIGURE_ICY_NAME -> STANDBY -> MP3_DATA frames.

Credentials are XTEA-encrypted (util/XTEA.java: standard XTEA, 32
cycles, delta 0x9E3779B9, 128-bit key = first 16 bytes of the cipher
seed zero-padded, big-endian words) with each 8-byte block emitted as
16 lowercase hex characters (AuthenticateBroadcast.encrypt:84-106).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Callable

__all__ = ["UltravoxMessageType", "UltravoxSyncError", "xtea_encrypt_hex",
           "pack_message", "unpack_message", "ShoutcastV2Client"]

_SYNC = 0x5A
_DELTA = 0x9E3779B9
_M = 0xFFFFFFFF


class UltravoxSyncError(ConnectionError, ValueError):
    """Corrupted Ultravox framing (bad 0x5A sync byte) — unrecoverable on
    a byte stream, unlike a merely incomplete frame."""


class UltravoxMessageType:
    AUTHENTICATE_BROADCAST = 0x1001
    SETUP_BROADCAST = 0x1002
    NEGOTIATE_BUFFER_SIZE = 0x1003
    STANDBY = 0x1004
    TERMINATE_BROADCAST = 0x1005
    REQUEST_CIPHER = 0x1009
    STREAM_MIME_TYPE = 0x1040
    CONFIGURE_ICY_NAME = 0x1100
    CONFIGURE_ICY_PUBLIC = 0x1103
    MP3_DATA = 0x7000


def _xtea_subkeys(key: bytes) -> tuple[list[int], list[int]]:
    key = key[:16].ljust(16, b"\x00")
    k = list(struct.unpack(">4I", key))
    s1, s2 = [], []
    total = 0
    for _ in range(32):
        s1.append((total + k[total & 3]) & _M)
        total = (total + _DELTA) & _M
        s2.append((total + k[(total >> 11) & 3]) & _M)
    return s1, s2


def _xtea_block(block: bytes, s1: list[int], s2: list[int]) -> bytes:
    v0, v1 = struct.unpack(">2I", block)
    for i in range(32):
        v0 = (v0 + ((((v1 << 4) ^ (v1 >> 5)) + v1) & _M ^ s1[i])) & _M
        v1 = (v1 + ((((v0 << 4) ^ (v0 >> 5)) + v0) & _M ^ s2[i])) & _M
    return struct.pack(">2I", v0, v1)


def xtea_encrypt_hex(cipher_key: str, value: str) -> str:
    """AuthenticateBroadcast.encrypt: zero-pad to 8-byte blocks, XTEA
    each, hex-concatenate. An empty (non-None) string pads to ONE zero
    block -> 16 hex chars, matching the reference client
    (AuthenticateBroadcast.encrypt:84-106); None means absent -> ""."""
    if value is None:
        return ""
    s1, s2 = _xtea_subkeys(cipher_key.encode())
    data = value.encode()
    pad = (-len(data)) % 8 or (8 if not data else 0)
    data = data + b"\x00" * pad
    return "".join(_xtea_block(data[i:i + 8], s1, s2).hex()
                   for i in range(0, len(data), 8))


def pack_message(msg_type: int, payload: bytes | str,
                 priority: int = 0) -> bytes:
    if isinstance(payload, str):
        payload = payload.encode() + b"\x00"     # trailing 0x00 included
    header = struct.pack(">BBHH", _SYNC, priority & 0x0F, msg_type,
                         len(payload))
    return header + payload


def unpack_message(data: bytes) -> tuple[int, bytes, bytes]:
    """-> (msg_type, payload, remainder) or raises ValueError."""
    if len(data) < 6:
        raise ValueError("short ultravox frame")
    sync, _flags, msg_type, length = struct.unpack(">BBHH", data[:6])
    if sync != _SYNC:
        raise UltravoxSyncError(f"bad ultravox sync 0x{sync:02X}")
    if len(data) < 6 + length:
        raise ValueError("truncated ultravox payload")
    return msg_type, data[6:6 + length], data[6 + length:]


@dataclass(frozen=True)
class ShoutcastV2Config:
    name: str
    host: str = "localhost"
    port: int = 8000
    stream_id: int = 1
    user_id: str = ""
    password: str = ""
    bitrate: int = 192000
    content_type: str = "audio/mpeg"


class ShoutcastV2Client:
    """Blocking-socket Ultravox source client; socket_factory(host, port)
    -> socket-like with sendall/recv/close (testable with a scripted
    fake)."""

    def __init__(self, config: ShoutcastV2Config,
                 socket_factory: Callable):
        self.config = config
        self._socket_factory = socket_factory
        self._socket = None
        self.connected = False
        self._rx = b""

    def _send(self, msg_type: int, payload) -> None:
        self._socket.sendall(pack_message(msg_type, payload))

    def _recv(self) -> tuple[int, bytes]:
        while True:
            try:
                msg_type, payload, rest = unpack_message(self._rx)
                self._rx = rest
                return msg_type, payload
            except UltravoxSyncError:
                raise               # corrupt stream: fail, don't spin
            except ValueError:      # short frame: need more bytes
                chunk = self._socket.recv(4096)
                if not chunk:
                    raise ConnectionError("ultravox peer closed")
                self._rx += chunk

    @staticmethod
    def _ok(payload: bytes) -> bool:
        return payload.startswith(b"ACK")

    def connect(self) -> bool:
        cfg = self.config
        self._socket = self._socket_factory(cfg.host, cfg.port)
        self._send(UltravoxMessageType.REQUEST_CIPHER, "2.1")
        _, payload = self._recv()
        if not self._ok(payload):
            return self._fail()
        cipher = payload.rstrip(b"\x00")[4:].decode()    # "ACK:<key>"
        creds = (f"2.1:{cfg.stream_id}:"
                 f"{xtea_encrypt_hex(cipher, cfg.user_id)}:"
                 f"{xtea_encrypt_hex(cipher, cfg.password)}")
        self._send(UltravoxMessageType.AUTHENTICATE_BROADCAST, creds)
        if not self._ok(self._recv()[1]):
            return self._fail()
        self._send(UltravoxMessageType.STREAM_MIME_TYPE, cfg.content_type)
        if not self._ok(self._recv()[1]):
            return self._fail()
        self._send(UltravoxMessageType.SETUP_BROADCAST,
                   f"{cfg.bitrate}:{cfg.bitrate}")
        if not self._ok(self._recv()[1]):
            return self._fail()
        self._send(UltravoxMessageType.CONFIGURE_ICY_NAME, cfg.name)
        self._recv()
        self._send(UltravoxMessageType.STANDBY, "")
        self._recv()
        self.connected = True
        return True

    def _fail(self) -> bool:
        self._socket.close()
        self._socket = None
        return False

    def send(self, frames: bytes, chunk: int = 16384) -> None:
        """Stream MP3/MPEG frames as MP3_DATA messages."""
        if not self.connected:
            raise ConnectionError("not connected")
        for i in range(0, len(frames), chunk):
            self._send(UltravoxMessageType.MP3_DATA, frames[i:i + chunk])

    def close(self) -> None:
        if self._socket is not None:
            try:
                self._send(UltravoxMessageType.TERMINATE_BROADCAST, "")
            except Exception:
                pass
            self._socket.close()
            self._socket = None
        self.connected = False
