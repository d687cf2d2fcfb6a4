"""P25 Phase 1 decoder state: typed messages -> channel state, identifiers,
decode events, traffic grants (role of
module/decode/p25/phase1/P25P1DecoderState.java).
"""
from __future__ import annotations


from ..protocol.p25p1.duid import DUID
from ..protocol.p25p1.messages import P25P1Message
from .events import DecodeEvent, DecodeEventHistory, DecodeEventType
from .identifiers import Identifier, IdentifierCollection, IdentifierRole
from .state import ChannelState, StateMachine
from .traffic import FrequencyBand, TrafficChannelManager

__all__ = ["P25P1DecoderState"]


class P25P1DecoderState:
    def __init__(self, traffic: TrafficChannelManager | None = None,
                 audio=None):
        """audio: optional MBEAudioModule receiving LDU voice frames
        (the P25P1AudioModule wiring of DecoderFactory.java:185-232)."""
        self.state_machine = StateMachine()
        self.identifiers = IdentifierCollection()
        self.history = DecodeEventHistory()
        self.traffic = traffic or TrafficChannelManager("APCO25")
        self.audio = audio
        self.current_call: DecodeEvent | None = None
        self._last_nac: int | None = None
        self._last_lc: tuple | None = None
        self._idents_dirty = True

    _HANDLERS = {
        DUID.TSBK: "_tsbk",
        DUID.PDU: "_pdu",
        DUID.HDU: "_hdu",
        DUID.LDU1: "_ldu1",
        DUID.LDU2: "_ldu2",
        DUID.TDU: "_terminator",
        DUID.TDULC: "_terminator",
    }

    def receive(self, message: P25P1Message, now: float) -> None:
        if not message.valid:
            return
        if message.nac != self._last_nac:
            self.identifiers.update(Identifier.nac(message.nac))
            self._last_nac = message.nac
        handler = self._HANDLERS.get(message.duid)
        if handler is not None:
            getattr(self, handler)(message, now)
        self.state_machine.check(now)

    # --- handlers ---

    def _tsbk(self, message: P25P1Message, now: float) -> None:
        self.state_machine.set_state(ChannelState.CONTROL, now)
        t = message.content
        f = t.fields
        if t.mfid not in (0x00, 0x01):
            self._vendor_tsbk(t, now)
            return
        if t.opcode in (0x34, 0x3D) and f:      # IDEN_UP / IDEN_UP_VU
            self.traffic.update_band(FrequencyBand(
                identifier=f["identifier"],
                base_frequency_hz=f["base_frequency_mhz"] * 1e6,
                channel_spacing_hz=f["channel_spacing_khz"] * 1e3))
        elif t.opcode == 0x00 and f:            # group voice grant
            self.traffic.process_grant(
                band_id=f["frequency_band"],
                channel_number=f["channel_number"], now=now,
                group=f["group_address"], source=f["source_address"])
        elif t.opcode == 0x02 and f:            # grant update (2 grants)
            for n in ("1", "2"):
                if f.get(f"group_address_{n}"):
                    self.traffic.process_grant(
                        band_id=f[f"frequency_band_{n}"],
                        channel_number=f[f"channel_number_{n}"], now=now,
                        group=f[f"group_address_{n}"])
        elif t.opcode == 0x3A and f:            # RFSS status
            self.identifiers.update(Identifier.site(f["site_id"], "APCO25"))
        self.traffic.check_teardown(now)

    def _pdu(self, message: P25P1Message, now: float) -> None:
        """PDU sequences on the control/data path: AMBTC trunking
        control routes grants/broadcasts like their TSBK twins
        (PDUMessageFactory.createAMBTC:208); packet-data PDUs assemble
        into IP payloads surfaced as DATA_PACKET / GPS events (the
        reference's PacketMessageFactory -> module/decode/ip path)."""
        from ..protocol.p25p1.ambtc import parse_ambtc
        from ..protocol.p25p1.pdu import assemble_packet, pdu_dispatch
        seq = message.content
        if seq is None:
            return
        h = seq.header
        if h.format == 23:                   # AMBTC
            m = parse_ambtc(seq)
            if m is None or not m.outbound:
                return
            f = m.fields
            self.state_machine.set_state(ChannelState.CONTROL, now)
            if m.opcode in (0, 17) and f:     # group voice/data grant
                self.traffic.process_grant(
                    band_id=f["frequency_band"],
                    channel_number=f["channel_number"], now=now,
                    group=f["group_address"],
                    source=f.get("source_address"))
            elif m.opcode == 4 and f:         # unit-to-unit grant
                self.traffic.process_grant(
                    band_id=f["frequency_band"],
                    channel_number=f["channel_number"], now=now,
                    group=f.get("target_address"),
                    source=f.get("source_address"))
            elif m.opcode == 58 and f:        # RFSS status
                self.identifiers.update(
                    Identifier.site(f["site_id"], "APCO25"))
            self.traffic.check_teardown(now)
            return
        if h.format == 21:                   # UMBTC: typed, ISP-only
            from ..protocol.p25p1.ambtc import parse_umbtc
            parse_umbtc(seq)
            return
        if not seq.complete:
            return
        packed = assemble_packet(seq)
        if packed is None:
            return
        payload, crc_ok = packed
        if not crc_ok:
            return
        parsed = pdu_dispatch(h, payload)
        if parsed is None:
            return
        ids = IdentifierCollection()
        ids.update(Identifier.radio(h.llid, IdentifierRole.TO
                                    if h.outbound else IdentifierRole.FROM))
        self.history.receive(DecodeEvent(
            event_type=DecodeEventType.DATA_PACKET, time_start=now,
            protocol="APCO25", identifiers=ids,
            details=type(parsed).__name__))

    def _vendor_tsbk(self, t, now: float) -> None:
        """Motorola OSP handling (tsbk_vendor): patch-group channel
        grants follow the same traffic path as standard group grants —
        a patch group IS a super-talkgroup
        (motorola/osp/PatchGroupVoiceChannelGrant.java)."""
        from ..protocol.p25p1.tsbk_vendor import MFID_MOTOROLA
        f = t.fields
        if t.mfid != MFID_MOTOROLA or not f:
            return
        if t.opcode == 0x02:        # patch group voice channel grant
            self.traffic.process_grant(
                band_id=f["frequency_band"],
                channel_number=f["channel_number"], now=now,
                group=f["patch_group"], source=f.get("source_address"))
        elif t.opcode == 0x03:      # patch group grant update (2 grants)
            for n in ("1", "2"):
                if f.get(f"patch_group_{n}"):
                    self.traffic.process_grant(
                        band_id=f[f"frequency_band_{n}"],
                        channel_number=f[f"channel_number_{n}"],
                        now=now, group=f[f"patch_group_{n}"])
        self.traffic.check_teardown(now)

    def _hdu(self, message: P25P1Message, now: float) -> None:
        h = message.content
        self.identifiers.update(
            Identifier.talkgroup(h.talkgroup, IdentifierRole.TO, "APCO25"))
        state = (ChannelState.ENCRYPTED if h.encrypted else ChannelState.CALL)
        self.state_machine.set_state(state, now)
        self._start_call(now, encrypted=h.encrypted)

    def _ldu1(self, message: P25P1Message, now: float) -> None:
        lc = message.content.link_control
        lc_changed = False
        if lc is not None and lc.fields:
            key = (lc.fields.get("group_address"),
                   lc.fields.get("source_address"))
            if key != self._last_lc:       # identifier churn only on change
                self._last_lc = key
                lc_changed = True
                self._idents_dirty = True
                if key[0] is not None:
                    self.identifiers.update(Identifier.talkgroup(
                        key[0], IdentifierRole.TO, "APCO25"))
                if key[1] is not None:
                    self.identifiers.update(Identifier.radio(
                        key[1], IdentifierRole.FROM, "APCO25"))
        self.state_machine.set_state(ChannelState.CALL, now)
        started = self.current_call is None
        self._start_call(now)
        if self.current_call is not None:
            if started or lc_changed:
                self.current_call.identifiers.update_all(
                    self.identifiers.all())
            self.current_call.update(now)
        self._voice(message, now)

    def _ldu2(self, message: P25P1Message, now: float) -> None:
        l2 = message.content
        state = (ChannelState.ENCRYPTED if l2.encrypted
                 else ChannelState.CALL)
        self.state_machine.set_state(state, now)
        self._start_call(now, encrypted=l2.encrypted)
        if self.current_call is not None:
            self.current_call.update(now)
        self._voice(message, now)

    def _voice(self, message: P25P1Message, now: float) -> None:
        if self.audio is None:
            return
        frames = getattr(message.content, "voice_frames", None)
        if frames is not None:
            # identifier attach only when the segment is fresh (segment
            # identifier merges are per-call metadata, not per-LDU work)
            idents = None
            if self.audio.segment is None or self._idents_dirty:
                idents = self.identifiers.all()
                self._idents_dirty = False
            self.audio.receive_frames(frames, now, identifiers=idents)

    def _terminator(self, message: P25P1Message, now: float) -> None:
        if self.current_call is not None:
            self.current_call.end(now)
            self.current_call = None
        if self.audio is not None:
            self.audio.end_call(now)
        self.state_machine.set_state(ChannelState.FADE, now)

    def _start_call(self, now: float, encrypted: bool = False) -> None:
        if self.current_call is None:
            self.current_call = DecodeEvent(
                event_type=(DecodeEventType.CALL_GROUP_ENCRYPTED if encrypted
                            else DecodeEventType.CALL_GROUP),
                time_start=now, protocol="APCO25",
                identifiers=self.identifiers.copy())
            self.history.receive(self.current_call)
