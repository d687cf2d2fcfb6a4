"""Bank-scale host processing: the per-slot message half of the live
loop, vectorized across a whole slot bank.

Role: at the ~1000-channel target, the per-slot ChannelProcessor path
(runtime/processors.py) costs ~1 ms of Python per slot-chunk — 2.5x
real time on its own. A BankProcessor owns ALL slots of one protocol:
one P25P1BankFramer call per chunk frames every slot at once, and only
the decoded messages (a few thousand per second, not a few thousand
Python calls per chunk) touch per-slot decoder states.

Device packing contract (runtime/orchestrator.py bank-mode live step):
  dib4:   (C, cap//4) uint8 — compacted dibits, 4 per byte, little
          2-bit groups (dibit j of byte = (b >> 2j) & 3)
  counts: (C,) int32 — valid symbols per slot this chunk
  hits:   (C, cap//8) uint8 — sync-hit bitmask, MSB-first per byte
          (np.unpackbits order); bit i = candidate sync at compact lag i
"""
from __future__ import annotations

import numpy as np

from ..audio.mbe import MBEAudioModule, MBECodec
from ..protocol.p25p1.bankframer import P25P1BankFramer
from .identifiers import IdentifierCollection
from .metrics import ChannelMetrics
from .p25_state import P25P1DecoderState
from .traffic import TrafficChannelManager

__all__ = ["unpack_dibits", "unpack_hits", "P25P1BankProcessor",
           "AnalogBankProcessor"]


def unpack_dibits(packed: np.ndarray) -> np.ndarray:
    """(C, cap//4) uint8 -> (C, cap) uint8 dibits."""
    c, q = packed.shape
    out = np.empty((c, q * 4), np.uint8)
    out[:, 0::4] = packed & 3
    out[:, 1::4] = (packed >> 2) & 3
    out[:, 2::4] = (packed >> 4) & 3
    out[:, 3::4] = (packed >> 6) & 3
    return out


def unpack_hits(packed: np.ndarray) -> np.ndarray:
    """(C, cap//8) uint8 -> (C, cap) bool hit mask."""
    return np.unpackbits(np.asarray(packed, np.uint8), axis=1).astype(bool)


class P25P1BankProcessor:
    """All P25P1 slots of a live receiver: bank framer + per-slot decoder
    states + MBE audio. The orchestrator routes activation/teardown and
    reads events through the control slot's TrafficChannelManager exactly
    as with per-slot processors."""

    protocol = "APCO25"

    def __init__(self, channels: int, control_slots: set[int],
                 traffic: TrafficChannelManager | None = None,
                 codec: MBECodec | None = None, retain: int = 1024):
        # retain 1024 covers every fixed-span frame (LDU spans 890
        # transmitted dibits) at half the per-chunk tail-gather cost;
        # raise it for captures carrying long multi-block PDUs
        self.c = channels
        self.control_slots = set(control_slots)
        self.traffic = traffic
        self.codec = codec
        self.framer = P25P1BankFramer(channels, retain=retain)
        self.states: list[P25P1DecoderState | None] = [None] * channels
        self.audio: list[MBEAudioModule | None] = [None] * channels
        self.metrics = [ChannelMetrics() for _ in range(channels)]
        self.frame_counts = np.zeros(channels, np.int64)
        for s in self.control_slots:
            self.reset_slot(s)

    def reset_slot(self, slot: int,
                   preload: IdentifierCollection | None = None) -> None:
        """Fresh decoder state for a slot (grant activation / control
        start) — the host half of the device-side reset_slot scatter."""
        audio = MBEAudioModule(codec=self.codec)
        state = P25P1DecoderState(
            traffic=self.traffic if slot in self.control_slots else None,
            audio=audio)
        if preload is not None:
            state.identifiers.update_all(preload.all())
        self.states[slot] = state
        self.audio[slot] = audio
        self.frame_counts[slot] = 0

    def frame_chunk(self, dib4: np.ndarray, counts: np.ndarray,
                    hits: np.ndarray) -> list:
        """Unpack + bank-frame one chunk -> [(slot, P25P1Message)].

        Stateful but single-threaded: the orchestrator's download worker
        calls this in chunk order, overlapping the main thread's route()
        of the previous chunk (the two touch disjoint state)."""
        dib = unpack_dibits(np.asarray(dib4))
        hitmask = unpack_hits(np.asarray(hits))[:, : dib.shape[1]]
        return self.framer.process(dib, counts, device_hits=hitmask)

    def route(self, msgs: list, counts: np.ndarray, active: np.ndarray,
              now: float) -> np.ndarray:
        """Feed framed messages into per-slot decoder states; returns
        per-slot frame counts for this chunk."""
        frames = np.zeros(self.c, np.int64)
        for slot, msg in msgs:
            if not active[slot] or self.states[slot] is None:
                continue
            frames[slot] += 1
            m = self.metrics[slot]
            m.message(msg.valid)
            m.content(msg.content)
            self.states[slot].receive(msg, now)
        for s in np.nonzero(active)[0]:
            self.metrics[s].update(int(counts[s]), range(int(frames[s])))
        self.frame_counts += frames
        return frames

    def process_bank(self, dib4: np.ndarray, counts: np.ndarray,
                     hits: np.ndarray, active: np.ndarray, now: float
                     ) -> np.ndarray:
        """One chunk for the whole bank (frame + route in one call).
        active: (C,) bool — messages on inactive slots are discarded
        (their device stream still flows)."""
        return self.route(self.frame_chunk(dib4, counts, hits),
                          counts, active, now)

    def drain_audio(self, slot: int) -> list:
        module = self.audio[slot]
        if module is None:
            return []
        done = module.completed
        module.completed = []
        return done

    def flush(self, slot: int, now: float) -> None:
        module = self.audio[slot]
        if module is not None and module.segment is not None:
            module.end_call(now)

    def channel_state(self, slot: int):
        state = self.states[slot]
        return state.state_machine.state if state is not None else None


class AnalogBankProcessor:
    """All NBFM/AM slots of a live receiver: per-slot squelch-gated
    AudioSegment assembly fed from the device's int16 PCM + packed gate
    transfer (the analog leg of the 1000-channel target; audio itself
    is already produced on device, so the host work is only segment
    bookkeeping)."""

    protocol = "NBFM"

    def __init__(self, channels: int, sample_rate: float = 8000.0):
        from .processors import AnalogAudioModule
        self.c = channels
        self.sample_rate = sample_rate
        self._module_cls = AnalogAudioModule
        self.modules = [AnalogAudioModule(sample_rate=sample_rate)
                        for _ in range(channels)]
        self.metrics = [ChannelMetrics() for _ in range(channels)]
        self.frame_counts = np.zeros(channels, np.int64)

    def reset_slot(self, slot: int,
                   preload: IdentifierCollection | None = None) -> None:
        self.modules[slot] = self._module_cls(
            sample_rate=self.sample_rate,
            identifiers=preload.all() if preload is not None else None)

    def route_audio(self, audio: np.ndarray, gate: np.ndarray,
                    active: np.ndarray, now: float) -> np.ndarray:
        n = audio.shape[1]
        for s in np.nonzero(active)[0]:
            self.modules[s].receive(audio[s], gate[s], now)
            self.metrics[s].update(n, ())
        return np.zeros(self.c, np.int64)

    def drain_audio(self, slot: int) -> list:
        module = self.modules[slot]
        done = module.completed
        module.completed = []
        return done

    def flush(self, slot: int, now: float) -> None:
        self.modules[slot].end_call(now)

    def channel_state(self, slot: int):
        from .state import ChannelState
        return (ChannelState.CALL
                if self.modules[slot].segment is not None
                else ChannelState.IDLE)

    @property
    def states(self):           # orchestrator event-logger hook parity
        return self.modules


class MixedBankProcessor:
    """All analog-trunking slots (LTR / LTR-Net / Passport / MPT1327)
    of a live receiver: the device ships companded voice + squelch
    gates + COMPACTED sub-audible/AFSK bit decisions per slot, and each
    slot's proven per-slot processor (runtime/processors.py analog
    trunk family) consumes them. No vectorized framer is needed at
    bank scale: the bit rate is 300-1200 baud, so the per-slot host
    work is ~100x lighter than P25/DMR framing
    (DecoderFactory.java:398-425 module lists at scale)."""

    def __init__(self, channels: int, control_slots: set[int],
                 traffic: TrafficChannelManager | None = None,
                 kind: str = "ltr", channel_map=None):
        self.c = channels
        self.control_slots = set(control_slots)
        self.traffic = traffic
        self.kind = kind
        self.channel_map = channel_map
        self.protocol = {"ltr": "LTR", "ltrnet": "LTR-Net",
                         "passport": "Passport",
                         "mpt1327": "MPT1327"}.get(kind, kind.upper())
        self.procs: list = [None] * channels
        self.metrics = [ChannelMetrics() for _ in range(channels)]
        self.frame_counts = np.zeros(channels, np.int64)
        for s in self.control_slots:
            self.reset_slot(s)

    def reset_slot(self, slot: int,
                   preload: IdentifierCollection | None = None) -> None:
        from .processors import make_channel_processor
        self.procs[slot] = make_channel_processor(
            self.kind,
            traffic=self.traffic if slot in self.control_slots else None,
            preload=preload, channel_map=self.channel_map)
        self.frame_counts[slot] = 0

    def route_mixed(self, audio: np.ndarray, gate: np.ndarray,
                    bits: np.ndarray, counts: np.ndarray,
                    active: np.ndarray, now: float) -> np.ndarray:
        frames = np.zeros(self.c, np.int64)
        for s in np.nonzero(active)[0]:
            s = int(s)
            proc = self.procs[s]
            if proc is None:
                continue
            n = proc.process_mixed(bits[s][: int(counts[s])],
                                   audio[s], gate[s], now)
            frames[s] = n
            self.metrics[s].update(audio.shape[1], range(int(n)))
        self.frame_counts += frames
        return frames

    def drain_audio(self, slot: int) -> list:
        proc = self.procs[slot]
        return proc.drain_audio() if proc is not None else []

    def flush(self, slot: int, now: float) -> None:
        proc = self.procs[slot]
        if proc is not None:
            proc.flush(now)

    def channel_state(self, slot: int):
        proc = self.procs[slot]
        return proc.channel_state() if proc is not None else None

    @property
    def states(self):            # event-logger hook parity
        return self.procs


class P25P2BankProcessor:
    """All P25 Phase 2 slots of a live receiver: P25P2BankFramer +
    per-slot two-TDMA-channel decoder states + AMBE audio (the P25P2
    sibling of P25P1BankProcessor; the superframe detector + decoder
    state pairing of P25P2SuperFrameDetector.java:51 at bank scale).

    Each slot's decoder state drives that slot's scrambling sequence in
    the bank framer (on_scramble_update), and traffic slots can be
    preloaded with the control channel's learned key
    (ChannelProcessingManager.java:403-468 preload-data analog)."""

    protocol = "APCO25-P2"

    def __init__(self, channels: int, control_slots: set[int],
                 traffic: TrafficChannelManager | None = None,
                 codec: MBECodec | None = None, retain: int = 2048):
        from ..audio.mbe import MBEFrameType
        from ..protocol.p25p2.bankframer import P25P2BankFramer
        from .p25p2_state import P25P2DecoderState
        self.c = channels
        self.control_slots = set(control_slots)
        self.traffic = traffic
        self.codec = codec
        self._state_cls = P25P2DecoderState
        self._frame_type = MBEFrameType.AMBE_72
        self.framer = P25P2BankFramer(channels, retain=retain)
        self.states: list = [None] * channels
        self.audio: list = [None] * channels
        self.metrics = [ChannelMetrics() for _ in range(channels)]
        self.frame_counts = np.zeros(channels, np.int64)
        for s in self.control_slots:
            self.reset_slot(s)

    def reset_slot(self, slot: int,
                   preload: IdentifierCollection | None = None,
                   scramble_key: tuple | None = None) -> None:
        audio = [MBEAudioModule(codec=self.codec,
                                frame_type=self._frame_type,
                                timeslot=ts) for ts in (0, 1)]
        state = self._state_cls(
            traffic=self.traffic if slot in self.control_slots else None,
            on_scramble_update=(
                lambda w, s, n, _slot=slot:
                self.framer.set_scramble_parameters(_slot, w, s, n)),
            audio=audio)
        if scramble_key is not None:
            self.framer.set_scramble_parameters(slot, *scramble_key)
            state.scramble_key = tuple(scramble_key)
        if preload is not None:
            state.identifiers.update_all(preload.all())
        self.states[slot] = state
        self.audio[slot] = audio
        self.frame_counts[slot] = 0

    def frame_chunk(self, dib4: np.ndarray, counts: np.ndarray,
                    hits: np.ndarray) -> list:
        dib = unpack_dibits(np.asarray(dib4))
        hitmask = unpack_hits(np.asarray(hits))[:, : dib.shape[1]]
        return self.framer.process(dib, counts, device_hits=hitmask)

    def route(self, msgs: list, counts: np.ndarray, active: np.ndarray,
              now: float) -> np.ndarray:
        frames = [0] * self.c
        act = active.tolist()
        states = self.states
        for slot, frag in msgs:
            if not act[slot] or states[slot] is None:
                continue
            frames[slot] += 1
            m = self.metrics[slot]
            m.message(True)
            for ts in frag.timeslots:
                if ts.mac is not None:
                    for s in ts.mac.structures:
                        m.content(s)
            states[slot].receive_fragment(frag, now)
        frames = np.asarray(frames, np.int64)
        for s in np.nonzero(active)[0]:
            self.metrics[s].update(int(counts[s]), range(int(frames[s])))
        self.frame_counts += frames
        return frames

    def process_bank(self, dib4, counts, hits, active, now):
        return self.route(self.frame_chunk(dib4, counts, hits),
                          counts, active, now)

    def drain_audio(self, slot: int) -> list:
        modules = self.audio[slot]
        if modules is None:
            return []
        done = []
        for mdl in modules:
            done.extend(mdl.completed)
            mdl.completed = []
        return done

    def flush(self, slot: int, now: float) -> None:
        modules = self.audio[slot]
        if modules is None:
            return
        for mdl in modules:
            if mdl.segment is not None:
                mdl.end_call(now)

    def channel_state(self, slot: int):
        from .state import ChannelState
        state = self.states[slot]
        if state is None:
            return None
        sts = [sm.state for sm in state.state]
        return (ChannelState.CONTROL if ChannelState.CONTROL in sts
                else sts[0])

    def scramble_key(self) -> tuple | None:
        """The first learned WACN/SYS/NAC among control slots (traffic
        preload source)."""
        for s in self.control_slots:
            state = self.states[s]
            if state is not None and state.scramble_key is not None:
                return state.scramble_key
        return None


class DMRBankProcessor:
    """All DMR slots of a live receiver: DMRBankFramer + per-slot
    two-timeslot decoder states + AMBE audio (the DMR sibling of
    P25P1BankProcessor; module list of DecoderFactory.java:345-392 at
    bank scale)."""

    protocol = "DMR"

    def __init__(self, channels: int, control_slots: set[int],
                 traffic: TrafficChannelManager | None = None,
                 codec: MBECodec | None = None, retain: int = 1024):
        from ..protocol.dmr.bankframer import DMRBankFramer
        from .dmr_state import DMRDecoderState
        self.c = channels
        self.control_slots = set(control_slots)
        self.traffic = traffic
        self.codec = codec
        self._state_cls = DMRDecoderState
        self.framer = DMRBankFramer(channels, retain=retain)
        self.states: list = [None] * channels
        self.metrics = [ChannelMetrics() for _ in range(channels)]
        self.frame_counts = np.zeros(channels, np.int64)
        for s in self.control_slots:
            self.reset_slot(s)

    def reset_slot(self, slot: int,
                   preload: IdentifierCollection | None = None) -> None:
        state = self._state_cls(
            traffic=self.traffic if slot in self.control_slots else None,
            codec=self.codec)
        if preload is not None:
            for ts in state.slots.values():
                ts.identifiers.update_all(preload.all())
        self.states[slot] = state
        self.frame_counts[slot] = 0

    def frame_chunk(self, dib4: np.ndarray, counts: np.ndarray,
                    hits: np.ndarray) -> list:
        dib = unpack_dibits(np.asarray(dib4))
        hitmask = unpack_hits(np.asarray(hits))[:, : dib.shape[1]]
        return self.framer.process(dib, counts, device_hits=hitmask)

    def route(self, msgs: list, counts: np.ndarray, active: np.ndarray,
              now: float) -> np.ndarray:
        # plain-int frame counters + pre-listed actives: per-message
        # numpy scalar indexing is ~10x a list index at ~14k bursts/chunk
        frames = [0] * self.c
        act = active.tolist()
        states = self.states
        metrics = self.metrics
        for slot, burst in msgs:
            if not act[slot] or states[slot] is None:
                continue
            frames[slot] += 1
            m = metrics[slot]
            m.message(True)
            if burst.content_kind == "csbk":
                m.content(burst.content)
            states[slot].receive(burst, now)
        frames = np.asarray(frames, np.int64)
        for s in np.nonzero(active)[0]:
            self.metrics[s].update(int(counts[s]), range(int(frames[s])))
        self.frame_counts += frames
        return frames

    def process_bank(self, dib4, counts, hits, active, now):
        return self.route(self.frame_chunk(dib4, counts, hits),
                          counts, active, now)

    def drain_audio(self, slot: int) -> list:
        state = self.states[slot]
        return state.drain_audio() if state is not None else []

    def flush(self, slot: int, now: float) -> None:
        state = self.states[slot]
        if state is None:
            return
        for ts in state.slots.values():
            if ts.audio.segment is not None:
                ts.audio.end_call(now)

    def channel_state(self, slot: int):
        from .state import ChannelState
        state = self.states[slot]
        if state is None:
            return None
        sts = [s.machine.state for s in state.slots.values()]
        return (ChannelState.CONTROL if ChannelState.CONTROL in sts
                else sts[0])
