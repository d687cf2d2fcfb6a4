"""P25 Phase 2 decoder state: MAC messages -> per-timeslot channel state,
identifiers, decode events, traffic grants, and scrambler key learning
(role of module/decode/p25/phase2/P25P2DecoderState.java).

The scrambler loop is the structurally interesting part: scrambled
FACCH/SACCH timeslots cannot be read until the WACN/SYS/NAC key is known,
and the key is learned from NETWORK_STATUS_BROADCAST MACs that arrive
UNscrambled — so the state drives the framer's scrambling sequence via
`on_scramble_update` and decoding converges after the first network
status message.
"""
from __future__ import annotations

from typing import Callable

from ..protocol.p25p2.framer import P25P2Fragment
from ..protocol.p25p2.mac import MacPdu, MacStructure
from ..protocol.p25p2.timeslot import MacPduType, Timeslot
from .events import DecodeEvent, DecodeEventHistory, DecodeEventType
from .identifiers import Identifier, IdentifierCollection, IdentifierRole
from .state import ChannelState, StateMachine
from .traffic import FrequencyBand, TrafficChannelManager

__all__ = ["P25P2DecoderState"]

# MAC opcodes (protocol/p25p2/mac.py table)
_GRANT_OPCODES = {64, 192}
_GRANT_UPDATE_OPCODES = {66, 195}
_GRANT_MULTI_OPCODES = {5, 37}
_CHANNEL_USER_OPCODES = {1, 33}
_IDEN_OPCODES = {115, 116, 125}
_NET_STATUS_OPCODES = {123, 251}
_RFSS_STATUS_OPCODES = {122, 250}
_UNENCRYPTED_ALGORITHM = 0x80       # TIA-102: ALGID 0x80 = clear


class P25P2DecoderState:
    """Tracks both TDMA logical channels (timeslot 0/1) of one carrier."""

    def __init__(self, traffic: TrafficChannelManager | None = None,
                 on_scramble_update: Callable[[int, int, int], None]
                 | None = None, audio: list | None = None):
        """audio: optional [MBEAudioModule, MBEAudioModule], one per TDMA
        channel, receiving VOICE_4/VOICE_2 AMBE frames."""
        self.state = [StateMachine(), StateMachine()]
        self.identifiers = IdentifierCollection()
        self.history = DecodeEventHistory()
        self.traffic = traffic or TrafficChannelManager("APCO25-P2")
        self.on_scramble_update = on_scramble_update
        self.audio = audio
        self.current_call: list[DecodeEvent | None] = [None, None]
        self._call_key: list = [None, None]
        self._ids_dirty = True
        self.scramble_key: tuple[int, int, int] | None = None

    # --- entry point -----------------------------------------------------
    def receive_fragment(self, frag: P25P2Fragment, now: float) -> None:
        for ts in frag.timeslots:
            if ts.mac is not None:
                self._mac_pdu(ts, ts.mac, now)
            if (getattr(ts, "voice_frames", None) is not None
                    and self.audio is not None):
                # push identifiers only when the collection changed or
                # a segment opens (per-voice-timeslot list rebuild was
                # a measured cost at 1023-slot bank scale)
                mod = self.audio[ts.channel]
                ids = None
                if self._ids_dirty or mod.segment is None:
                    ids = self.identifiers.all()
                    self._ids_dirty = False
                mod.receive_frames(ts.voice_frames, now,
                                   identifiers=ids)
        for sm in self.state:
            sm.check(now)
        self.traffic.check_teardown(now)

    # --- MAC PDU handling --------------------------------------------------
    def _mac_pdu(self, ts: Timeslot, pdu: MacPdu, now: float) -> None:
        ch = ts.channel
        if pdu.pdu_type == MacPduType.PTT:
            f = pdu.structures[0].fields
            encrypted = f.get("algorithm_id",
                              _UNENCRYPTED_ALGORITHM) != _UNENCRYPTED_ALGORITHM
            self._start_call(ch, now, f.get("group_address"),
                             f.get("source_address"), encrypted)
            return
        if pdu.pdu_type == MacPduType.END_PTT:
            self._end_call(ch, now)
            return
        if pdu.pdu_type == MacPduType.IDLE:
            for s in pdu.structures:
                self._structure(s, ch, now)
            sm = self.state[ch]
            if sm.state in (ChannelState.CALL, ChannelState.ENCRYPTED):
                sm.set_state(ChannelState.FADE, now)
            return
        if pdu.pdu_type in (MacPduType.ACTIVE, MacPduType.HANGTIME):
            for s in pdu.structures:
                self._structure(s, ch, now)

    def _structure(self, s: MacStructure, ch: int, now: float) -> None:
        f = s.fields
        if s.opcode in _NET_STATUS_OPCODES and f:
            wacn, system = f.get("wacn", 0), f.get("system_id", 0)
            nac = f.get("color_code", 0)
            key = (wacn, system, nac)
            if key != self.scramble_key:
                self.scramble_key = key
                if self.on_scramble_update is not None:
                    self.on_scramble_update(*key)
            self.identifiers.update(Identifier.nac(nac))
            self._ids_dirty = True
            return
        if s.opcode in _RFSS_STATUS_OPCODES and f:
            self.identifiers.update(
                Identifier.site(f["site_id"], "APCO25-P2"))
            self._ids_dirty = True
            return
        if s.opcode in _IDEN_OPCODES and f:
            self.traffic.update_band(FrequencyBand(
                identifier=f["identifier"],
                base_frequency_hz=f["base_frequency_mhz"] * 1e6,
                channel_spacing_hz=f["channel_spacing_khz"] * 1e3))
            return
        if s.opcode in _GRANT_OPCODES and f:
            self.traffic.process_grant(
                band_id=f["frequency_band"],
                channel_number=f["channel_number"], now=now,
                group=f.get("group_address"),
                source=f.get("source_address"))
            return
        if s.opcode in _GRANT_UPDATE_OPCODES and f:
            if "group_address" in f:       # explicit single-grant form
                self.traffic.process_grant(
                    band_id=f["frequency_band"],
                    channel_number=f["channel_number"], now=now,
                    group=f["group_address"])
            else:
                for n in ("1", "2"):
                    if f.get(f"group_address_{n}"):
                        self.traffic.process_grant(
                            band_id=f[f"frequency_band_{n}"],
                            channel_number=f[f"channel_number_{n}"],
                            now=now, group=f[f"group_address_{n}"])
            return
        if s.opcode in _GRANT_MULTI_OPCODES and f:
            for n in ("1", "2", "3"):
                if f.get(f"group_address_{n}"):
                    self.traffic.process_grant(
                        band_id=f[f"frequency_band_{n}"],
                        channel_number=f[f"channel_number_{n}"],
                        now=now, group=f[f"group_address_{n}"])
            return
        if s.opcode in _CHANNEL_USER_OPCODES and f:
            encrypted = bool(f.get("service_options", 0) & 0x40)
            self._start_call(ch, now, f.get("group_address"),
                             f.get("source_address"), encrypted)
            return
        if s.opcode == 49:  # MAC_RELEASE: forced call preemption
            self._end_call(ch, now)

    # --- call lifecycle ----------------------------------------------------
    def _start_call(self, ch: int, now: float, group, source,
                    encrypted: bool) -> None:
        # repeated PTT/channel-user MACs of an ongoing call carry the
        # same addresses every superframe — refresh timers without
        # rebuilding identifier objects (~7k PTTs/chunk at bank scale)
        call = self.current_call[ch]
        if call is not None and self._call_key[ch] == (group, source,
                                                       encrypted):
            self.state[ch].set_state(
                ChannelState.ENCRYPTED if encrypted
                else ChannelState.CALL, now)
            call.update(now)
            return
        self._call_key[ch] = (group, source, encrypted)
        idents = IdentifierCollection()
        if group:
            idents.update(Identifier.talkgroup(
                group, IdentifierRole.TO, "APCO25-P2"))
        if source:
            idents.update(Identifier.radio(
                source, IdentifierRole.FROM, "APCO25-P2"))
        self.state[ch].set_state(
            ChannelState.ENCRYPTED if encrypted else ChannelState.CALL, now)
        call = self.current_call[ch]
        if call is None:
            call = DecodeEvent(
                event_type=(DecodeEventType.CALL_GROUP_ENCRYPTED
                            if encrypted else DecodeEventType.CALL_GROUP),
                time_start=now, protocol="APCO25-P2", timeslot=ch,
                identifiers=idents)
            self.current_call[ch] = call
            self.history.receive(call)
        else:
            call.identifiers.update_all(idents.all())
            call.update(now)
        self.identifiers.update_all(idents.all())
        self._ids_dirty = True

    def _end_call(self, ch: int, now: float) -> None:
        call = self.current_call[ch]
        self._call_key[ch] = None
        if call is not None:
            call.end(now)
            self.current_call[ch] = None
        if self.audio is not None:
            self.audio[ch].end_call(now)
        self.state[ch].set_state(ChannelState.FADE, now)
