"""Per-slot host-side channel processors + the protocol registry.

Role of the reference's DecoderFactory dispatch
(module/decode/DecoderFactory.java:117-183): every protocol gets the same
shaped module list — framer, decoder state, audio module(s), optional
traffic manager — wired into a ProcessingChain. Here a ChannelProcessor
is that module list for one slot of the orchestrator's slot bank: it
consumes the DEVICE-produced outputs for its slot (dense dibits for
digital protocols; squelch-gated audio for analog) and produces decode
events, identifier updates, and AudioSegments.

Processors implement:
    process(dibits, now) -> frames      (digital protocols)
    process_audio(audio, gate, now)     (analog protocols)
    drain_audio() -> [AudioSegment]
    flush(now)
    frame_count / protocol attributes
"""
from __future__ import annotations

import numpy as np

from ..audio.mbe import MBEAudioModule, MBECodec, MBEFrameType
from ..audio.segments import AudioSegment
from ..protocol.dmr.framer import DMRFramer
from ..protocol.p25p1.framer import P25P1Framer
from ..protocol.p25p1.messages import decode_frame
from ..protocol.p25p2.framer import P25P2Framer
from .identifiers import (Identifier, IdentifierCollection,
                          IdentifierRole)
from .metrics import ChannelMetrics
from .dmr_state import DMRDecoderState
from .p25_state import P25P1DecoderState
from .p25p2_state import P25P2DecoderState
from .traffic import TrafficChannelManager

__all__ = ["P25P1ChannelProcessor", "DMRChannelProcessor",
           "P25P2ChannelProcessor", "NBFMChannelProcessor",
           "AnalogAudioModule", "make_channel_processor",
           "PROCESSOR_REGISTRY"]


class P25P1ChannelProcessor:
    """Host-side per-slot pipeline: dibits -> frames -> messages ->
    decoder state -> audio segments (the message half of a reference
    ProcessingChain for a P25P1 channel, DecoderFactory.java:185-232)."""

    protocol = "APCO25"

    def __init__(self, traffic: TrafficChannelManager | None = None,
                 codec: MBECodec | None = None,
                 preload: IdentifierCollection | None = None):
        self.framer = P25P1Framer()
        self.audio = MBEAudioModule(codec=codec)
        self.metrics = ChannelMetrics()
        self.state = P25P1DecoderState(traffic=traffic, audio=self.audio)
        if preload is not None:
            # Traffic-channel preload data: the grant's identifiers are
            # known before the first frame decodes
            # (ChannelProcessingManager.java:403-468 preload posts).
            self.state.identifiers.update_all(preload.all())
        self.messages: list = []
        self.frame_count = 0

    def process(self, dibits: np.ndarray, now: float) -> int:
        """Consume one chunk of recovered dibits; returns frames decoded."""
        frames = self.framer.process(dibits)
        self.metrics.update(len(dibits), frames)
        for frame in frames:
            msg = decode_frame(frame)
            self.messages.append(msg)
            self.metrics.message(msg.valid)
            self.state.receive(msg, now)
        self.frame_count += len(frames)
        return len(frames)

    def drain_audio(self):
        done = self.audio.completed
        self.audio.completed = []
        return done

    def flush(self, now: float) -> None:
        if self.audio.segment is not None:
            self.audio.end_call(now)

    def channel_state(self):
        return self.state.state_machine.state


class DMRChannelProcessor:
    """DMR slot pipeline: dibits -> burst framer -> two-timeslot decoder
    state (runtime/dmr_state.py) -> AMBE audio per timeslot (the module
    list DecoderFactory.java:345-392 builds for a DMR channel)."""

    protocol = "DMR"

    def __init__(self, traffic: TrafficChannelManager | None = None,
                 codec: MBECodec | None = None,
                 preload: IdentifierCollection | None = None,
                 channel: str = ""):
        self.framer = DMRFramer()
        self.metrics = ChannelMetrics()
        self.state = DMRDecoderState(traffic=traffic, codec=codec,
                                     channel=channel)
        if preload is not None:
            for slot in self.state.slots.values():
                slot.identifiers.update_all(preload.all())
        self.frame_count = 0

    def process(self, dibits: np.ndarray, now: float) -> int:
        frames = self.framer.process(dibits)
        self.metrics.update(len(dibits), frames)
        for frame in frames:
            self.state.receive(frame, now)
        self.frame_count += len(frames)
        return len(frames)

    def drain_audio(self):
        return self.state.drain_audio()

    def flush(self, now: float) -> None:
        for slot in self.state.slots.values():
            if slot.audio.segment is not None:
                slot.audio.end_call(now)

    def channel_state(self):
        from .state import ChannelState
        states = [s.machine.state for s in self.state.slots.values()]
        if ChannelState.CONTROL in states:
            return ChannelState.CONTROL
        return states[0]


class P25P2ChannelProcessor:
    """P25 Phase 2 slot pipeline: dibits -> superframe framer (with the
    scrambler feedback loop) -> MAC decoder state -> AMBE audio per TDMA
    channel. The decoder state learns WACN/SYS/NAC from unscrambled
    network-status MACs and drives the framer's scrambling sequence
    (P25P2DecoderState.java / P25P2SuperFrameDetector pairing); traffic
    channels receive the key as preload instead (scramble_key), the
    ChannelProcessingManager.java:403-468 preload-data analog."""

    protocol = "APCO25-P2"

    def __init__(self, traffic: TrafficChannelManager | None = None,
                 codec: MBECodec | None = None,
                 preload: IdentifierCollection | None = None,
                 scramble_key: tuple[int, int, int] | None = None):
        self.framer = P25P2Framer()
        self.metrics = ChannelMetrics()
        self.audio = [MBEAudioModule(codec=codec,
                                     frame_type=MBEFrameType.AMBE_72,
                                     timeslot=ts) for ts in (0, 1)]
        self.state = P25P2DecoderState(
            traffic=traffic,
            on_scramble_update=self.framer.set_scramble_parameters,
            audio=self.audio)
        if scramble_key is not None:
            self.framer.set_scramble_parameters(*scramble_key)
            self.state.scramble_key = tuple(scramble_key)
        if preload is not None:
            self.state.identifiers.update_all(preload.all())
        self.frame_count = 0

    def process(self, dibits: np.ndarray, now: float) -> int:
        frags = self.framer.process(dibits)
        self.metrics.update(len(dibits), frags)
        for frag in frags:
            self.state.receive_fragment(frag, now)
        self.frame_count += len(frags)
        return len(frags)

    def drain_audio(self):
        done = []
        for module in self.audio:
            done.extend(module.completed)
            module.completed = []
        return done

    def flush(self, now: float) -> None:
        for module in self.audio:
            if module.segment is not None:
                module.end_call(now)

    def channel_state(self):
        from .state import ChannelState
        states = [sm.state for sm in self.state.state]
        if ChannelState.CONTROL in states:
            return ChannelState.CONTROL
        return states[0]


class AnalogAudioModule:
    """Squelch-gated analog audio -> AudioSegment assembly: the role of
    audio/AudioModule.java:44 (pass audio through while squelch is open)
    plus AbstractAudioModule.java:85-120 (segment assembly). The NBFM/AM
    decoders emit per-sample `audio` and `audio_gate` at 8 kHz; gate
    rising edges open a segment, audio passes while open, and a gate that
    stays closed for `hang_seconds` closes it (the reference's squelch
    ramp-down). `max_seconds` force-splits marathon segments the way
    AbstractAudioModule caps its sample count."""

    def __init__(self, sample_rate: float = 8000.0,
                 hang_seconds: float = 0.5, max_seconds: float = 30.0,
                 identifiers=None):
        self.sample_rate = float(sample_rate)
        self.hang_samples = int(hang_seconds * sample_rate)
        self.max_samples = int(max_seconds * sample_rate)
        self.identifiers = list(identifiers) if identifiers else []
        self.segment: AudioSegment | None = None
        self.completed: list[AudioSegment] = []
        self._closed_run = 0
        self._segment_samples = 0

    def receive(self, audio: np.ndarray, gate: np.ndarray,
                now: float) -> None:
        """One chunk of 8 kHz audio + per-sample squelch gate; `now` is
        the sample-clock time of the END of the chunk."""
        audio = np.asarray(audio, np.float32)
        gate = np.asarray(gate, bool)
        n = len(audio)
        if n == 0:
            return
        t0 = now - n / self.sample_rate
        # walk gate runs: contiguous open runs append; closed runs age
        # the hang timer
        edges = np.flatnonzero(np.diff(gate.astype(np.int8)))
        starts = np.concatenate([[0], edges + 1])
        ends = np.concatenate([edges + 1, [n]])
        for s, e in zip(starts, ends):
            if gate[s]:
                if self.segment is None:
                    self.segment = AudioSegment(
                        start_time=t0 + s / self.sample_rate,
                        sample_rate=self.sample_rate)
                    self.segment.add_identifiers(self.identifiers)
                    self._segment_samples = 0
                self._closed_run = 0
                self.segment.add_audio(audio[s:e])
                self._segment_samples += e - s
                if self._segment_samples >= self.max_samples:
                    self._complete()
            else:
                self._closed_run += e - s
                if self.segment is not None \
                        and self._closed_run >= self.hang_samples:
                    self._complete()

    def _complete(self) -> None:
        if self.segment is not None:
            self.segment.complete_segment()
            self.completed.append(self.segment)
            self.segment = None
            self._segment_samples = 0

    def end_call(self, now: float) -> None:
        self._complete()


class NBFMChannelProcessor:
    """Analog slot pipeline: the device graph already produced squelched
    8 kHz audio + gate (decoders/nbfm.py); this host side only assembles
    AudioSegments (the DecoderFactory.java:307-321 NBFM module list)."""

    protocol = "NBFM"

    def __init__(self, traffic=None, codec=None,
                 preload: IdentifierCollection | None = None,
                 sample_rate: float = 8000.0, aux=None):
        from .events import DecodeEventHistory
        self.audio = AnalogAudioModule(
            sample_rate=sample_rate,
            identifiers=preload.all() if preload is not None else None)
        self.metrics = ChannelMetrics()
        self.frame_count = 0
        # auxiliary AFSK decoders over the same demodulated audio
        # (DecoderFactory.java:398-425 aux module list)
        self.aux: list = []
        self.aux_messages: list = []
        self.history = DecodeEventHistory()
        for name in (aux or []):
            self.add_aux(name)

    def add_aux(self, protocol: str) -> None:
        from ..decoders.auxdec import AuxDecoder
        self.aux.append(AuxDecoder(protocol))

    def process_audio(self, audio: np.ndarray, gate: np.ndarray,
                      now: float) -> int:
        self.audio.receive(audio, gate, now)
        n = 0
        if self.aux:
            from .events import DecodeEvent, DecodeEventType
            blk = np.asarray(audio)[: len(audio) // 10 * 10]
            for dec in self.aux:
                for msg in dec.process(blk):
                    self.aux_messages.append((dec.protocol, msg))
                    n += 1
                    mtype = getattr(msg, "message_type", None)
                    ids = IdentifierCollection()
                    for attr, role in (
                            ("ident_from", IdentifierRole.FROM),
                            ("from_id", IdentifierRole.FROM),
                            ("ident_to", IdentifierRole.TO),
                            ("to_id", IdentifierRole.TO),
                            ("unit_id", IdentifierRole.FROM)):
                        v = getattr(msg, attr, None)
                        if v is not None:
                            ids.update(Identifier.radio(v, role))
                    self.history.receive(DecodeEvent(
                        event_type=DecodeEventType.PAGE,
                        time_start=now,
                        protocol=dec.protocol.upper(),
                        identifiers=ids,
                        details=(mtype.value if hasattr(mtype, "value")
                                 else str(mtype))))
        self.metrics.update(len(audio), ())
        self.frame_count += n
        return n

    def drain_audio(self):
        done = self.audio.completed
        self.audio.completed = []
        return done

    def flush(self, now: float) -> None:
        self.audio.end_call(now)

    def channel_state(self):
        from .state import ChannelState
        return (ChannelState.CALL if self.audio.segment is not None
                else ChannelState.IDLE)


# decoder kind (receiver.make_channel_decoder names) -> processor class;
# the dispatch table DecoderFactory.java:117-183 switches on DecoderType
PROCESSOR_REGISTRY = {
    "c4fm": P25P1ChannelProcessor,
    "p25p1": P25P1ChannelProcessor,
    "lsm": P25P1ChannelProcessor,          # same framing, Gardner demod
    "p25p1-lsm": P25P1ChannelProcessor,
    "dmr": DMRChannelProcessor,
    "p25p2": P25P2ChannelProcessor,
    "nbfm": NBFMChannelProcessor,
    "am": NBFMChannelProcessor,            # same gated-audio assembly
}
# the analog-trunking families (DecoderFactory.java:398-425) register
# below their class definitions at the end of this module


def make_channel_processor(kind: str, **kwargs):
    """Build the host-side processor for a decoder kind. kwargs pass
    through to the processor (traffic/codec/preload/...)."""
    try:
        cls = PROCESSOR_REGISTRY[kind]
    except KeyError:
        raise ValueError(f"no channel processor for decoder {kind!r}")
    import inspect
    accepted = inspect.signature(cls.__init__).parameters
    return cls(**{k: v for k, v in kwargs.items() if k in accepted})


class _AnalogTrunkProcessorBase:
    """Shared shape of the analog-trunking slot processors (LTR family,
    MPT1327): sliced sub-audible/AFSK bits + squelch-gated voice from
    the SAME device slot (decoders/ltr.py LTRLiveDecoder outputs),
    producing decode events + AudioSegments — the module lists
    DecoderFactory.java:398-425 builds for these protocols."""

    def __init__(self, preload: IdentifierCollection | None = None):
        from .events import DecodeEventHistory
        self.audio = AnalogAudioModule(
            identifiers=preload.all() if preload is not None else None)
        self.metrics = ChannelMetrics()
        self.history = DecodeEventHistory()
        self.messages: list = []
        self.frame_count = 0

    def process_mixed(self, bits: np.ndarray, audio: np.ndarray,
                      gate: np.ndarray, now: float) -> int:
        msgs = self._frame(bits)
        self.metrics.update(len(bits), msgs)
        for m in msgs:
            self.messages.append(m)
            self.metrics.message(True)
            self._receive(m, now)
        self.audio.receive(audio, gate, now)
        self.frame_count += len(msgs)
        return len(msgs)

    def drain_audio(self):
        done = self.audio.completed
        self.audio.completed = []
        return done

    def flush(self, now: float) -> None:
        self.audio.end_call(now)

    def channel_state(self):
        from .state import ChannelState
        return (ChannelState.CALL if self.audio.segment is not None
                else ChannelState.IDLE)


class LTRChannelProcessor(_AnalogTrunkProcessorBase):
    """LTR standard slot: OSW words -> group-call decode events
    (ltrstandard/LTRStandardDecoderState.java role). A CALL word opens
    (or refreshes) a group-call event; CALL_END or idle closes it."""

    protocol = "LTR"

    def __init__(self, traffic=None, codec=None,
                 preload: IdentifierCollection | None = None,
                 direction: str = "OSW"):
        from ..protocol.ltr import LTRFramer
        super().__init__(preload)
        self.framer = LTRFramer(direction)
        self._open: dict[int, object] = {}      # talkgroup -> DecodeEvent

    def _frame(self, bits):
        return self.framer.process(bits)

    def _receive(self, m, now: float) -> None:
        from ..protocol.ltr.messages import LTRMessageType
        from .events import DecodeEvent, DecodeEventType
        if m.message_type == LTRMessageType.CALL:
            tg = (m.area << 13) | (m.home << 8) | m.group
            ev = self._open.get(tg)
            if ev is None:
                idents = IdentifierCollection()
                idents.update(Identifier.talkgroup(
                    tg, IdentifierRole.TO, self.protocol))
                ev = DecodeEvent(
                    event_type=DecodeEventType.CALL_GROUP,
                    time_start=now, protocol=self.protocol,
                    identifiers=idents,
                    details=f"LCN {m.channel} home {m.home}")
                self._open[tg] = ev
                self.history.receive(ev)
            ev.duration = max(ev.duration, now - ev.time_start)
        elif m.message_type == LTRMessageType.CALL_END:
            tg_keys = [k for k in self._open
                       if (k >> 8) & 0x1F == m.home]
            for k in tg_keys:
                self._open.pop(k, None)

    @property
    def events(self):
        return list(self.history.events)


class LTRNetChannelProcessor(_AnalogTrunkProcessorBase):
    """LTR-Net slot: OSW stream through the LtrNetTracker site state
    (ltrnet/LTRNetDecoderState.java role)."""

    protocol = "LTR-Net"

    def __init__(self, traffic=None, codec=None,
                 preload: IdentifierCollection | None = None,
                 direction: str = "OSW"):
        from ..protocol.ltr import LtrNetFramer, LtrNetTracker
        super().__init__(preload)
        self.framer = LtrNetFramer(direction)
        self.tracker = LtrNetTracker()

    def _frame(self, bits):
        return self.framer.process(bits)

    def _receive(self, m, now: float) -> None:
        from .events import DecodeEvent, DecodeEventType
        before = len(self.tracker.events)
        self.tracker.process(m)
        for ev in self.tracker.events[before:]:
            if ev.get("type") == "call":
                idents = IdentifierCollection()
                idents.update(Identifier.talkgroup(
                    ev.get("talkgroup", 0), IdentifierRole.TO,
                    self.protocol))
                self.history.receive(DecodeEvent(
                    event_type=DecodeEventType.CALL_GROUP,
                    time_start=now, protocol=self.protocol,
                    identifiers=idents,
                    details=f"LCN {ev.get('lcn')}"))


class PassportChannelProcessor(_AnalogTrunkProcessorBase):
    """Passport slot (passport/PassportDecoderState.java role)."""

    protocol = "Passport"

    def __init__(self, traffic=None, codec=None,
                 preload: IdentifierCollection | None = None):
        from ..protocol.passport import PassportFramer
        super().__init__(preload)
        self.framer = PassportFramer()

    def _frame(self, bits):
        return self.framer.process(bits)

    def _receive(self, m, now: float) -> None:
        from ..protocol.passport import PassportMessageType
        from .events import DecodeEvent, DecodeEventType
        if m.message_type == PassportMessageType.CALL_START:
            idents = IdentifierCollection()
            idents.update(Identifier.talkgroup(
                m.group, IdentifierRole.TO, self.protocol))
            self.history.receive(DecodeEvent(
                event_type=DecodeEventType.CALL_GROUP, time_start=now,
                protocol=self.protocol, identifiers=idents,
                details=f"LCN {m.lcn} site {m.site}"))


class MPT1327ChannelProcessor(_AnalogTrunkProcessorBase):
    """MPT1327 control slot: AFSK codewords -> GTC grants driving the
    traffic manager (mpt1327/MPT1327DecoderState.java +
    MPT1327TrafficChannelManager.java role). channel_map: FrequencyBand
    mapping traffic channel numbers to frequencies (the reference's
    user-configured channel map, controller/config channel maps)."""

    protocol = "MPT1327"

    def __init__(self, traffic: TrafficChannelManager | None = None,
                 codec=None, preload: IdentifierCollection | None = None,
                 channel_map=None, channel_type: str = "control"):
        from ..protocol.mpt1327 import MPT1327Framer
        super().__init__(preload)
        self.framer = MPT1327Framer(channel_type)
        self.traffic = traffic
        if traffic is not None and channel_map is not None:
            traffic.update_band(channel_map)
        self._now = 0.0

    def _frame(self, bits):
        return self.framer.process(bits)

    def _receive(self, m, now: float) -> None:
        from ..protocol.mpt1327 import MPT1327MessageType
        if m.message_type == MPT1327MessageType.GTC \
                and self.traffic is not None:
            f = m.fields
            ident = f.get("ident1")
            self.traffic.process_grant(
                band_id=0, channel_number=f.get("channel", 0), now=now,
                group=((f.get("prefix", 0) << 13) | ident)
                if ident is not None else None)
            self.traffic.check_teardown(now)


# analog trunking: each runs live as an audio+bits slot
# (decoders/ltr.py live decoders + the processors above)
PROCESSOR_REGISTRY.update({
    "ltr": LTRChannelProcessor,
    "ltrnet": LTRNetChannelProcessor,
    "passport": PassportChannelProcessor,
    "mpt1327": MPT1327ChannelProcessor,
})
