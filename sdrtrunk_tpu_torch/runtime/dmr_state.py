"""DMR decoder state: burst frames -> per-timeslot channel state,
identifiers, decode events, voice audio, and packet data.

Role of module/decode/dmr/DMRDecoderState.java: each of the two TDMA
timeslots runs its own call state; voice headers / embedded LC open
group or unit calls, terminators close them, CSBK grants feed the
traffic manager (Capacity Plus / Tier III channel numbers), and the
data path (header + blocks) assembles packet sequences into IP/LRRP/ARS
messages that surface as DATA_PACKET / GPS events.
"""
from __future__ import annotations

import numpy as np

from ..audio.mbe import MBEAudioModule, MBEFrameType
from ..protocol.dmr.framer import DMRBurstFrame
from ..protocol.dmr.lc import embedded_lc_decode_frags
from ..protocol.dmr.packet import PacketSequenceAssembler
from .events import DecodeEvent, DecodeEventHistory, DecodeEventType
from .identifiers import Identifier, IdentifierCollection, IdentifierRole
from .state import ChannelState, StateMachine
from .traffic import TrafficChannelManager

__all__ = ["DMRDecoderState"]

_VOICE_GRANT_OPCODES = (0x30, 0x31)
_ALOHA = 0x19
_PREAMBLE = 0x3D


class _SlotState:
    def __init__(self, timeslot: int, codec):
        self.timeslot = timeslot
        self.machine = StateMachine()
        self.identifiers = IdentifierCollection()
        self.audio = MBEAudioModule(codec=codec,
                                    frame_type=MBEFrameType.AMBE_72,
                                    timeslot=timeslot)
        self.call: DecodeEvent | None = None
        self.lc_fragments: list = []
        self.last_lc = None         # interned LC applied to identifiers
        self.ids_dirty = True      # identifiers changed since last push


class DMRDecoderState:
    def __init__(self, traffic: TrafficChannelManager | None = None,
                 codec=None, channel: str = ""):
        self.traffic = traffic or TrafficChannelManager("DMR")
        self.history = DecodeEventHistory()
        self.channel = channel
        self.slots = {1: _SlotState(1, codec), 2: _SlotState(2, codec)}
        self.packets = PacketSequenceAssembler()
        self._packets_emitted = 0

    # ------------------------------------------------------------ intake

    def receive(self, frame: DMRBurstFrame, now: float) -> None:
        slot = self.slots.get(frame.timeslot, self.slots[1])
        kind = frame.content_kind
        if kind == "voice":
            self._voice(slot, frame, now)
        elif kind == "voice_header":
            self._call_start(slot, frame.content, now)
        elif kind == "terminator":
            self._call_end(slot, now)
        elif kind == "csbk":
            self._csbk(slot, frame, now)
        elif kind == "idle":
            slot.machine.set_state(ChannelState.IDLE, now)
        elif kind == "data_header" and frame.content is not None:
            self.packets.on_header(frame.timeslot, frame.content)
            self._drain_packets(slot, now)
        elif kind == "data_block" and frame.content is not None:
            self.packets.on_block(frame.timeslot, frame.content)
            self._drain_packets(slot, now)
        slot.machine.check(now)

    # ------------------------------------------------------------ voice

    def _lc_identifiers(self, lc) -> IdentifierCollection:
        ids = IdentifierCollection()
        f = getattr(lc, "fields", None) or {}
        if "source_address" in f:
            ids.update(Identifier.radio(f["source_address"],
                                        IdentifierRole.FROM))
        if "group_address" in f:
            ids.update(Identifier.talkgroup(f["group_address"]))
        elif "target_address" in f:
            ids.update(Identifier.radio(f["target_address"],
                                        IdentifierRole.TO))
        return ids

    def _call_start(self, slot: _SlotState, lc, now: float) -> None:
        ids = self._lc_identifiers(lc) if lc is not None \
            else IdentifierCollection()
        group_call = lc is not None and lc.flco == 0x00
        slot.identifiers = ids
        slot.machine.set_state(ChannelState.CALL, now)
        if slot.call is None:
            slot.call = DecodeEvent(
                event_type=(DecodeEventType.CALL_GROUP if group_call
                            else DecodeEventType.CALL_UNIT_TO_UNIT),
                time_start=now, protocol="DMR", channel=self.channel,
                timeslot=slot.timeslot, identifiers=ids)
            self.history.receive(slot.call)

    def _voice(self, slot: _SlotState, frame: DMRBurstFrame,
               now: float) -> None:
        slot.machine.set_state(ChannelState.CALL, now)
        if slot.call is None:
            self._call_start(slot, None, now)
        frames = frame.content.get("ambe_frames") \
            if isinstance(frame.content, dict) else None
        if frames is None:
            frames = frame.voice_frames()
        # identifier refresh only when the collection changed or a new
        # segment opens — rebuilding + merging the list per burst was a
        # measured hot spot at 1000-carrier bank scale (~14k voice
        # bursts/chunk); the segment's final identifier set is the same
        ids = None
        if slot.ids_dirty or slot.audio.segment is None:
            ids = list(slot.identifiers.identifiers.values())
            slot.ids_dirty = False
        slot.audio.receive_frames(frames, now, identifiers=ids)
        # embedded LC: 32-bit fragments ride frames B..E of the
        # superframe; frame A (sync, emb None) restarts collection
        if frame.emb is None:
            slot.lc_fragments = []
        else:
            slot.lc_fragments.append(frame.embedded_lc_fragment())
            if len(slot.lc_fragments) == 4:
                lc = embedded_lc_decode_frags(slot.lc_fragments)
                slot.lc_fragments = []
                # decode results are interned (lc.py _LC_CACHE), so an
                # ongoing call's repeated LC is the SAME object — skip
                # the per-superframe identifier rebuild when unchanged
                if lc is not None and lc is not slot.last_lc:
                    slot.last_lc = lc
                    slot.identifiers.update_all(
                        self._lc_identifiers(lc).identifiers.values())
                    slot.ids_dirty = True
        if slot.call is not None:
            slot.call.update(now)

    def _call_end(self, slot: _SlotState, now: float) -> None:
        slot.machine.set_state(ChannelState.FADE, now)
        if slot.call is not None:
            slot.call.end(now)
            slot.call = None
        slot.audio.end_call(now)

    # ------------------------------------------------------------ control

    def _csbk(self, slot: _SlotState, frame: DMRBurstFrame,
              now: float) -> None:
        from ..protocol.dmr.csbk_vendor import (FID_CAPACITY_PLUS,
                                                FID_CONNECT_PLUS)
        csbk = frame.content
        if csbk is None:
            return
        f = csbk.fields or {}
        if csbk.fid == FID_CONNECT_PLUS:
            if csbk.opcode == 3 and f:      # CONPLUS_VOICE_CHANNEL_USER
                # the Con+ control channel's grant: logical channel =
                # repeater number (ConnectPlusVoiceChannelUser.java)
                self.traffic.process_grant(
                    band_id=0, channel_number=f.get("repeater", 0),
                    now=now, group=f.get("group_address"),
                    source=f.get("source_address"),
                    timeslot=f.get("timeslot", slot.timeslot))
            elif csbk.opcode == 1:          # CONPLUS_NEIGHBOR_REPORT
                slot.machine.set_state(ChannelState.CONTROL, now)
            return
        if csbk.fid == FID_CAPACITY_PLUS:
            if csbk.opcode == 62:           # CAPPLUS_SYSTEM_STATUS: the
                # rest-channel marker doubles as the control beacon
                slot.machine.set_state(ChannelState.CONTROL, now)
            return
        if csbk.fid != 0:
            return
        if csbk.opcode == _ALOHA:
            slot.machine.set_state(ChannelState.CONTROL, now)
        elif csbk.opcode in _VOICE_GRANT_OPCODES and f:
            # Tier III logical channel number grant; the traffic
            # manager maps it through its band plan when one is loaded
            self.traffic.process_grant(
                band_id=0, channel_number=f.get("channel", 0), now=now,
                group=f.get("target_address"),
                source=f.get("source_address"),
                timeslot=f.get("timeslot", slot.timeslot))

    # ------------------------------------------------------------ data

    def _drain_packets(self, slot: _SlotState, now: float) -> None:
        while self._packets_emitted < len(self.packets.messages):
            msg = self.packets.messages[self._packets_emitted]
            self._packets_emitted += 1
            ids = IdentifierCollection()
            ids.update(Identifier.radio(msg.header.src,
                                        IdentifierRole.FROM))
            ids.update(Identifier.talkgroup(msg.header.dst)
                       if msg.header.dst_is_talkgroup
                       else Identifier.radio(msg.header.dst,
                                             IdentifierRole.TO))
            etype = DecodeEventType.DATA_PACKET
            details = msg.describe()
            location = None
            app = getattr(msg.packet, "application", None) \
                if msg.packet is not None else None
            if app is None and msg.packet is not None \
                    and hasattr(msg.packet, "tokens"):
                app = msg.packet     # bare LRRP over proprietary header
            if app is not None and hasattr(app, "token"):
                point = app.token("POINT_2D") or app.token("POINT_3D")
                if point is not None:
                    etype = DecodeEventType.GPS
                    details = (f"lat={point.fields.get('latitude')} "
                               f"lon={point.fields.get('longitude')}")
                    location = (point.fields.get("latitude"),
                                point.fields.get("longitude"))
            self.history.receive(DecodeEvent(
                event_type=etype, time_start=now, protocol="DMR",
                channel=self.channel, timeslot=msg.timeslot,
                identifiers=ids, details=details, location=location))

    # ------------------------------------------------------------ audio

    def drain_audio(self):
        out = []
        for slot in self.slots.values():
            out.extend(slot.audio.completed)
            slot.audio.completed = []
        return out
