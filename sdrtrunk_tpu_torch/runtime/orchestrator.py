"""Live bank-mode orchestrator (port of sdrtrunk_tpu/runtime/orchestrator.py).

The continuous ring -> decode -> events -> traffic-following loop for one
decoder kind, in bank mode: one slot-bank step on the device demodulates
every slot of a chunk. For a digital kind (P25 Phase 1 C4FM or LSM, P25
Phase 2, DMR) the step then compacts the symbol streams, correlates them
against the protocol's sync patterns and packs the result into one flat
uint8 transfer; the host frames the whole bank with the protocol's bank
processor (``P25P1BankProcessor``, ``P25P2BankProcessor``,
``DMRBankProcessor``) and routes messages into per-slot decoder states and
the ``TrafficChannelManager``, which starts and stops traffic slots
mid-stream. For an analog kind (NBFM, AM) the step packs companded 8-bit
(or int16) PCM and the squelch gate bits into the transfer, and
``AnalogBankProcessor`` assembles each slot's AudioSegments. For an
analog-trunking kind (LTR, LTR-Net, Passport, MPT1327: the mixed bank) the
step packs companded voice, gate bits and the compacted sub-audible or
AFSK bit decisions, and ``MixedBankProcessor`` hands each slot's share to
its per-slot processor (framer, decode events, AudioSegments; MPT1327's
GTC grants drive the traffic manager through the ``channel_map``).
"Starting a channel" is a write of (bin, mixer step) into the slot plan
plus an in-place reset of that slot's device state.

The host layer (``runtime`` bank processors, decoder states and traffic,
``audio.mbe``, ``protocol``) is the port's byte-for-byte copy of the JAX
package's (tests/test_torch_host_copy.py holds the copies equal).
Time is the sample clock (samples processed / sample rate), so runs are
deterministic and replayable.
"""
from __future__ import annotations

import json
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..audio.mbe import FakeMBECodec, MBECodec
from ..protocol.dmr.bankframer import DMR_SYNC_DIBIT_PATTERNS
from ..protocol.dmr.framer import MAX_SYNC_BIT_ERRORS as _DMR_SYNC_MAX_ERRORS
from ..protocol.p25p1.bankframer import SYNC_DIBIT_PATTERNS
from ..protocol.p25p2.bankframer import P25P2_SYNC_DIBITS
from ..receiver import WidebandReceiver
from .bank_processor import (AnalogBankProcessor, DMRBankProcessor,
                             MixedBankProcessor, P25P1BankProcessor,
                             P25P2BankProcessor)
from .events import DecodeEvent
from .identifiers import IdentifierCollection
from .metrics import FrequencyErrorMonitor
from .traffic import TrafficChannelManager

__all__ = ["ChannelSlot", "Orchestrator", "compact_and_correlate", "ingest",
           "pack_audio", "pack_mixed", "sync_patterns"]

_P25P1_SYNC_MAX_ERRORS = 9          # bit errors over the 24-dibit sync
_P25P2_SYNC_MAX_ERRORS = 4          # over the 20-dibit sync (P25P2SyncPattern)

# decoder kind -> traffic-manager protocol label (reference
# orchestrator.py:42-47); every kind here runs in bank mode
_PROTOCOL_LABELS = {"c4fm": "APCO25", "p25p1": "APCO25", "lsm": "APCO25",
                    "p25p1-lsm": "APCO25", "dmr": "DMR", "p25p2": "APCO25-P2",
                    "nbfm": "NBFM", "am": "AM", "ltr": "LTR",
                    "ltrnet": "LTR-Net", "passport": "Passport",
                    "mpt1327": "MPT1327"}
_ANALOG_KINDS = ("nbfm", "am")
_MIXED_KINDS = ("ltr", "ltrnet", "passport", "mpt1327")


@dataclass
class ChannelSlot:
    """One retunable channel slot of the running receiver."""
    index: int
    frequency_hz: float = 0.0
    is_control: bool = False
    active: bool = False
    activated_at: float = 0.0


def ingest(x: torch.Tensor) -> torch.Tensor:
    """Wire format -> float: int8 IQ pairs scale by 1/127; float pairs and
    complex pass through."""
    if x.dtype == torch.int8:
        return x.to(torch.float32) * (1.0 / 127.0)
    return x


def sync_patterns(decoder: str) -> tuple[np.ndarray, int]:
    """(dibit patterns, max bit errors) the tail correlates for a decoder
    kind: P25P1 (C4FM, LSM) its 4 rotation images of the 24-dibit sync at
    <= 9 bit errors; P25P2 its one 20-dibit pattern at <= 4; DMR its 7
    24-dibit patterns at <= 4 (the DMRSyncDetector threshold)."""
    if decoder == "p25p2":
        return P25P2_SYNC_DIBITS[None, :], _P25P2_SYNC_MAX_ERRORS
    if decoder == "dmr":
        return DMR_SYNC_DIBIT_PATTERNS, _DMR_SYNC_MAX_ERRORS
    return SYNC_DIBIT_PATTERNS, _P25P1_SYNC_MAX_ERRORS


def compact_and_correlate(dib: torch.Tensor, valid: torch.Tensor, cap: int,
                          patterns: np.ndarray, max_errors: int):
    """On-device symbol compaction, sync correlation and packing.

    dib (C, K) dibits, valid (C, K) bool. Valid dibits are compacted to
    the front of a (C, cap) row by cumsum + scatter. Entries at or beyond
    counts[c] are zero here, where the reference's sort leaves the dibits
    of samples with no symbol; no bank framer reads them: P25P1's reads
    dibits below counts and hits at lags below counts - 23
    (protocol/p25p1/bankframer.py:149-175), P25P2's dibits below counts
    and hits at lags below counts - 19 (protocol/p25p2/bankframer.py:
    154-170), and DMR's hits at lags below counts - 23 (protocol/dmr/
    bankframer.py:138), bursts only where they end below counts (:235,
    :255; its batched EMB pre-decode, :287-316, may read further, but a
    decode is used only behind those checks) and its carried tail below
    counts (:279-280), so a sync window that reaches past counts is
    never used. The P25P1 and DMR framers also rescan the 23 lags that
    straddle the chunk boundary in their own window (p25p1 :189-193, dmr
    :141-145), which reads the first 23 compacted dibits: below counts
    whenever a slot has 23 symbols in the chunk (a live chunk of K
    channel samples has about K / 5.2).
    Each compact lag is tested against every pattern (``sync_patterns``)
    by XOR-popcount; a hit is a lag whose best pattern has <= max_errors
    bit errors. Returns (dib4 (C, cap/4) uint8,
    counts (C,) int32, hits (C, cap/8) uint8) in the bank processor's
    packing contract (runtime/bank_processor.py).
    """
    c = dib.shape[0]
    dev = dib.device
    sdib, counts = _compact(dib, valid, cap)
    d4 = sdib.reshape(c, cap // 4, 4)
    dib4 = d4[..., 0] | (d4[..., 1] << 2) | (d4[..., 2] << 4) | (d4[..., 3] << 6)

    pats = torch.as_tensor(np.asarray(patterns, np.uint8), device=dev)
    npat, plen = pats.shape
    lags = cap - (plen - 1)
    err = torch.zeros((c, npat, lags), dtype=torch.int16, device=dev)
    for j in range(plen):
        diff = sdib[:, None, j:j + lags] ^ pats[None, :, j, None]
        err += (diff & 1) + (diff >> 1)
    hits = torch.zeros((c, cap), dtype=torch.uint8, device=dev)
    hits[:, :lags] = err.amin(dim=1) <= max_errors
    return dib4, counts, _packbits(hits)


def _compact(values: torch.Tensor, valid: torch.Tensor, cap: int):
    """The valid entries of each row of (C, K) values, in order, at the
    front of a (C, cap) uint8 row, by cumsum + scatter (entries past cap
    are dropped, those at or beyond a row's count are 0), and the rows'
    counts (C,) int32 (not clipped to cap)."""
    c = values.shape[0]
    counts = valid.sum(dim=1, dtype=torch.int32)
    pos = torch.cumsum(valid, dim=1) - 1
    idx = torch.where(valid, pos.clamp(max=cap), cap)       # cap = dump
    out = torch.zeros((c, cap + 1), dtype=torch.uint8, device=values.device)
    out.scatter_(1, idx, values.to(torch.uint8))
    return out[:, :cap], counts


def _packbits(bits: torch.Tensor) -> torch.Tensor:
    """(C, 8n) uint8 0/1 -> (C, n) uint8, 8 a byte, MSB first (the order
    of np.packbits and np.unpackbits)."""
    b8 = bits.reshape(bits.shape[0], -1, 8)
    out = b8[..., 0] << 7
    for i in range(1, 8):
        out = out | (b8[..., i] << (7 - i))
    return out


def pack_audio(audio: torch.Tensor, gate: torch.Tensor,
               audio_format: str) -> torch.Tensor:
    """On-device packing of the analog bank: (C, Ka) float audio and
    (C, Ka) bool gate -> ONE flat uint8 tensor, PCM | gate bits.

    The audio is clipped to [-1, 1]. ``int16`` is a * 32767 truncated,
    little-endian; ``mulaw8`` is the level clip(int(log1p(255|a|) /
    log(256) * 127 + 0.5), 0, 127), plus 128 when a < 0. The gate is
    packed 8 samples a byte, MSB first (np.unpackbits order), each row
    zero-padded to a whole byte."""
    a = torch.clamp(audio, -1.0, 1.0)
    if audio_format == "int16":
        pcm = torch.clamp(a * 32767.0, -32768, 32767).to(torch.int16)
        pcm_bytes = pcm.reshape(-1).view(torch.uint8)
    else:
        pcm_bytes = _mulaw8(a)
    return torch.cat([pcm_bytes, _gate_bytes(gate)])


def _mulaw8(a: torch.Tensor) -> torch.Tensor:
    """(C, Ka) audio in [-1, 1] -> flat mu-law bytes (``pack_audio``)."""
    comp = torch.log1p(255.0 * torch.abs(a)) * (1.0 / np.log(256.0))
    level = torch.clamp((comp * 127.0 + 0.5).to(torch.int32), 0, 127)
    return (torch.where(a < 0, 128, 0) + level).to(torch.uint8).reshape(-1)


def _gate_bytes(gate: torch.Tensor) -> torch.Tensor:
    """(C, Ka) bool gate -> flat bytes, 8 samples a byte MSB first, each
    row zero-padded to a whole byte."""
    return _packbits(torch.nn.functional.pad(
        gate.to(torch.uint8), (0, (-gate.shape[1]) % 8))).reshape(-1)


def pack_mixed(audio: torch.Tensor, gate: torch.Tensor, bits: torch.Tensor,
               valid: torch.Tensor, cap: int) -> torch.Tensor:
    """On-device packing of the mixed analog-trunking bank: (C, Ka) float
    audio and bool gate, (C, Kb) bit decisions and their valid mask -> ONE
    flat uint8 tensor, mu-law PCM | gate bits | compacted bits | counts.

    PCM and gate as ``pack_audio``'s "mulaw8". The valid bits of each slot
    are compacted in order to the front of a row of ``cap`` (a multiple of
    8) and packed 8 a byte, MSB first; counts are the slots' valid bits,
    clipped to cap, as little-endian int32. Entries at or beyond counts[c]
    are 0 here, where the reference's sort leaves the votes of samples
    with no symbol; the host reads bits[c][:counts[c]] only
    (runtime/bank_processor.py ``MixedBankProcessor.route_mixed``)."""
    sbits, counts = _compact(bits, valid, cap)
    return torch.cat([
        _mulaw8(torch.clamp(audio, -1.0, 1.0)), _gate_bytes(gate),
        _packbits(sbits).reshape(-1),
        counts.clamp(max=cap).view(torch.uint8)])


class Orchestrator:
    """Continuous bank-mode decode loop with dynamic traffic following.

    source: callable read(num_samples) -> NumPy IQ (int8 (n, 2) pairs,
            float32 (n, 2) pairs or complex), shorter or None at the end.
    center_frequency_hz: RF frequency at baseband 0.
    control_offsets_hz: baseband offsets of the control channel(s); each
            gets a pinned slot whose TrafficChannelManager activates and
            tears down the remaining slots (an analog bank's pinned slot
            has no control channel: its slots are activated directly).
    chunk_samples: wideband samples a chunk, a multiple of the bin count
            M; for nbfm, am and the analog-trunking kinds, K = 2 *
            chunk_samples / M must also be a multiple of the resampler's
            ``down`` (25 at a 25 kHz channel rate), and for mpt1327 the
            audio length Ka = K * 8 / 25 a multiple of 10 (the AFSK
            resampler's; the rest of a chunk's audio would be dropped).
            The default is 16 * M, the smallest such chunk for nbfm and
            am, and 125 * M (K = 250, Ka = 80) for the analog-trunking
            kinds.
    audio_format: the analog bank's PCM transfer, "mulaw8" or "int16"
            (the mixed bank always sends mu-law).
    channel_map: FrequencyBand that maps MPT1327 traffic channel numbers
            to frequencies (the reference's user channel map).
    device: where the slot bank runs ("cuda" by default; no fallback).
    """

    def __init__(self, source, sample_rate: float,
                 center_frequency_hz: float,
                 control_offsets_hz, slots: int = 8,
                 channel_bandwidth: float = 12500.0,
                 decoder: str = "c4fm",
                 codec: MBECodec | None = None,
                 chunk_samples: int | None = None,
                 idle_teardown_seconds: float = 2.0,
                 metrics_sink=None,
                 ppm_correction: bool = True,
                 ppm_threshold: float = 0.4,
                 ppm_observation_seconds: float = 30.0,
                 control_rotation=None,
                 rotation_delay: float = 0.5,
                 event_log_path=None,
                 bank_mode: bool | None = None,
                 banks=None,
                 channel_map=None,
                 ingest_format: str = "auto",
                 audio_format: str = "mulaw8",
                 host_process: bool = False,
                 device="cuda"):
        if banks is not None:
            raise NotImplementedError(
                "heterogeneous banks are not ported yet (ROADMAP Queue 1 "
                "item 14, slice F)")
        if decoder not in _PROTOCOL_LABELS:
            raise ValueError(f"unknown decoder kind {decoder!r}")
        if ingest_format == "int4":
            raise NotImplementedError(
                "the int4 wire format is not ported: it was a slow-link "
                "compromise (ROADMAP, what the port does not copy)")
        if ingest_format != "auto":
            raise ValueError(f"unknown ingest_format {ingest_format!r}")
        if audio_format not in ("mulaw8", "int16"):
            raise ValueError(f"unknown audio_format {audio_format!r}")
        if host_process:
            raise NotImplementedError(
                "host_process (the bank worker process) is not ported yet "
                "(ROADMAP Queue 1 item 15)")
        if isinstance(control_offsets_hz, (int, float, np.floating)):
            control_offsets_hz = [control_offsets_hz]
        # an entry may be an (offset_hz, kind) pair; the kind names the
        # bank of a heterogeneous mix (banks=, not ported), so here it is
        # ignored, as the reference ignores it without banks
        control_offsets_hz = [float(e[0]) if isinstance(e, tuple)
                              else float(e) for e in control_offsets_hz]
        if slots < len(control_offsets_hz) + 1:
            raise ValueError("need at least one traffic slot")
        if bank_mode is None:
            bank_mode = slots >= 32
        if not bank_mode:
            raise NotImplementedError(
                "the per-slot (non-bank) path is not ported yet (ROADMAP "
                "Queue 1 item 15); pass bank_mode=True")
        self.device = resolve_device(device)
        self.source = source
        self.sample_rate = float(sample_rate)
        self.center_frequency_hz = float(center_frequency_hz)
        self.decoder_name = decoder
        self.audio_format = audio_format
        self.codec = codec if codec is not None else FakeMBECodec()
        self.metrics_sink = metrics_sink
        self.channel_map = channel_map
        self.channel_bandwidth = float(channel_bandwidth)
        self.banks = None
        self.ingest_format = ingest_format
        self.bank_mode = True

        self.rx = WidebandReceiver(sample_rate, [0.0] * slots,
                                   channel_bandwidth=channel_bandwidth,
                                   decoder=decoder, device=self.device)
        m = self.rx.channelizer.channels
        self.bank_analog = decoder in _ANALOG_KINDS
        self.bank_mixed = decoder in _MIXED_KINDS
        self.chunk_samples = (chunk_samples if chunk_samples is not None
                              else self._default_chunk(m))
        if self.chunk_samples % m != 0:
            raise ValueError(f"chunk_samples must be a multiple of {m}")
        self._bank_cap = None
        self._bank_ka = None
        self._bank_bit_cap = None
        if self.bank_analog or self.bank_mixed:
            # 8 kHz audio samples per slot per chunk; the resampler's
            # phase pattern must repeat whole within a chunk
            k = 2 * self.chunk_samples // m
            up, down = self.rx.decoder.up, self.rx.decoder.down
            if (k * up) % down:
                raise ValueError(
                    f"chunk gives non-integral audio length: per-channel "
                    f"block {k} must be a multiple of {down}")
            self._bank_ka = k * up // down
            if self.bank_mixed:
                # sub-audible/AFSK bit budget per chunk: baud * chunk
                # seconds + margin (the timing loop emits about one bit a
                # symbol period, whatever the noise)
                baud = 1200.0 if decoder == "mpt1327" else 300.0
                secs = self.chunk_samples / self.sample_rate
                self._bank_bit_cap = int(
                    np.ceil((secs * baud * 1.25 + 16) / 32)) * 32
        else:
            # symbols per slot per chunk at the fastest tracked timing,
            # plus margin, rounded to the packing granule
            k = 2 * self.chunk_samples // m * self.rx.decoder.upsample
            demod = self.rx.decoder.demod
            sps_min = demod.samples_per_symbol * (1.0 - demod.max_deviation)
            self._bank_cap = int(np.ceil((k / sps_min + 8) / 64)) * 64

        self.step = self._build_live_step()
        self.state = self.rx.init_state()

        self.bins = np.zeros((slots, 2), np.int32)
        self.steps = np.zeros(slots, np.float32)
        self._plan_dev = None
        self.slots = [ChannelSlot(i) for i in range(slots)]

        self.correction_ppm = 0.0
        self.event_logger = None
        if event_log_path is not None:
            from .eventlog import DecodeEventLogger
            self.event_logger = DecodeEventLogger(event_log_path)
        self.traffic = TrafficChannelManager(
            _PROTOCOL_LABELS[decoder],
            idle_teardown_seconds=idle_teardown_seconds,
            on_activate=self._activate, on_teardown=self._teardown)
        if self.event_logger is not None:
            self.traffic.event_sink = self.event_logger.receive
        if self.bank_mixed:
            self.bank_proc = MixedBankProcessor(
                slots, control_slots=set(range(len(control_offsets_hz))),
                traffic=self.traffic, kind=decoder,
                channel_map=self.channel_map)
        elif self.bank_analog:
            self.bank_proc = AnalogBankProcessor(slots)
        else:
            bank_cls = {"dmr": DMRBankProcessor,
                        "p25p2": P25P2BankProcessor}.get(decoder,
                                                         P25P1BankProcessor)
            self.bank_proc = bank_cls(
                slots, control_slots=set(range(len(control_offsets_hz))),
                traffic=self.traffic, codec=self.codec)
        for slot, off in zip(self.slots, control_offsets_hz):
            slot.is_control = True
            slot.active = True
            slot.frequency_hz = self.center_frequency_hz + off
            self._tune(slot.index, off)
        self.rotation = None
        if control_rotation:
            from .rotation import ChannelRotationMonitor
            self.rotation = ChannelRotationMonitor(
                control_rotation, self._rotate_control,
                rotation_delay=rotation_delay)

        self.now = 0.0
        self.samples_processed = 0
        self._last_upload: tuple[float, int] | None = None
        self._pinned: dict = {}
        self.audio_segments: list = []
        self.skipped_grants: list[float] = []
        self.error_state: str | None = None

        self.ppm_monitor = None
        if ppm_correction and self.slots[0].is_control \
                and self.slots[0].frequency_hz > 0:
            self.ppm_monitor = FrequencyErrorMonitor(
                self.slots[0].frequency_hz, threshold_ppm=ppm_threshold,
                observation_seconds=ppm_observation_seconds,
                on_correct=self._apply_ppm)

    # --- control plane -------------------------------------------------

    def _default_chunk(self, m: int) -> int:
        """Default wideband chunk: 16 * M; for the analog kinds the
        smallest chunk whose per-channel block K = 2 * chunk / M is a
        multiple of the resampler's ``down``; for the analog-trunking
        kinds 125 * M: K = 250 satisfies the 8 kHz resampler (K % 25) and
        the AFSK correlator's audio step (Ka % 10)."""
        if self.bank_mixed:
            return m * 125
        if self.bank_analog:
            down = self.rx.decoder.down
            return m * down if down % 2 else m * down // 2
        return 16 * m

    def _build_live_step(self):
        """Live step = the receiver's dynamic step + on-device packing
        into ONE flat uint8 tensor. Digital kinds: compaction and sync
        correlation, then dib4 | hits | counts (le int32) | pll (le f32
        of slot 0). Analog kinds: PCM | gate bits (``pack_audio``).
        Analog-trunking kinds: mu-law PCM | gate bits | compacted bits |
        counts (``pack_mixed``)."""
        base = self.rx.build_dynamic()
        if self.bank_mixed:
            bit_cap = self._bank_bit_cap

            def fused_mixed(x, state, bins, steps):
                out, st = base(ingest(x), state, bins, steps)
                return {"packed_mixed": pack_mixed(
                    out["audio"], out["audio_gate"], out["bits"],
                    out["valid"], bit_cap)}, st

            return fused_mixed
        if self.bank_analog:
            audio_format = self.audio_format

            def fused_audio(x, state, bins, steps):
                out, st = base(ingest(x), state, bins, steps)
                return {"packed_audio": pack_audio(
                    out["audio"], out["audio_gate"], audio_format)}, st

            return fused_audio
        cap = self._bank_cap
        sync = sync_patterns(self.decoder_name)

        def fused(x, state, bins, steps):
            out, st = base(ingest(x), state, bins, steps)
            dib4, counts, hbits = compact_and_correlate(
                out["dibits"], out["valid"], cap, *sync)
            packed = torch.cat([
                dib4.reshape(-1), hbits.reshape(-1),
                counts.view(torch.uint8),
                out["pll_freq"][:1].contiguous().view(torch.uint8)])
            return {"packed": packed}, st

        return fused

    def _tune(self, slot: int, offset_hz: float) -> None:
        # tuner ppm error shifts every RF frequency by f*ppm/1e6; the
        # correction is applied at the slot mixer
        f_abs = self.center_frequency_hz + offset_hz
        offset_hz = offset_hz + self.correction_ppm * 1e-6 * f_abs
        ch = self.rx.channelizer
        if self.decoder_name == "p25p2":
            # P25 Phase 2 gets the reference's wide channel (50 kHz minimum
            # rate): the straddling bin pair (m, m+1), joined by the PR
            # synthesizer, serves a flat 25 kHz passband anywhere, bin
            # centers included; floor keeps the residual in [-spacing/2,
            # spacing/2) (reference orchestrator.py:609-631)
            spacing = ch.channel_spacing
            mbin = int(np.floor(offset_hz / spacing))
            residual = offset_hz - (ch.center_frequency(mbin) + spacing / 2.0)
            if abs(residual) > spacing / 2 + 1e-6:
                raise ValueError(f"offset {offset_hz} outside coverage")
            self.bins[slot] = (mbin % ch.channels, (mbin + 1) % ch.channels)
        else:
            b = ch.channel_for_frequency(offset_hz)
            if not 0 <= b < ch.channels:
                raise ValueError(f"offset {offset_hz} outside coverage")
            residual = offset_hz - ch.center_frequency(b)
            self.bins[slot] = (b, b)
        self.steps[slot] = 2.0 * np.pi * residual / ch.channel_sample_rate
        self._plan_dev = None
        self.state = self.rx.reset_slot(self.state, slot)   # in place

    def _bank_reset_slot(self, index: int, preload=None, **extra) -> None:
        self.bank_proc.reset_slot(index, preload=preload, **extra)
        state = self.bank_proc.states[index]
        if self.event_logger is not None and hasattr(state, "history"):
            state.history.add_listener(self.event_logger.receive)

    def _slot_flush_drain(self, slot) -> None:
        """Flush open calls on a slot and collect its audio segments."""
        self.bank_proc.flush(slot.index, self.now)
        self.audio_segments.extend(self.bank_proc.drain_audio(slot.index))

    def _rotate_control(self, frequency_hz: float) -> None:
        """Move the control slot to the next candidate frequency."""
        slot = next(s for s in self.slots if s.is_control)
        offset = frequency_hz - self.center_frequency_hz
        ch = self.rx.channelizer
        if abs(offset) > ch.channels * ch.channel_spacing / 2:
            return
        slot.frequency_hz = frequency_hz
        self._tune(slot.index, offset)

    def _apply_ppm(self, ppm: float) -> None:
        """Sustained PLL error -> global tuner correction + retune."""
        self.correction_ppm += ppm
        for slot in self.slots:
            if slot.active:
                self._tune(slot.index,
                           slot.frequency_hz - self.center_frequency_hz)

    def stop_all(self, reason: str = "") -> None:
        """Tuner error state: stop every running channel, flushing open
        calls to AudioSegments."""
        self.error_state = reason or "error"
        for slot in self.slots:
            if not slot.active:
                continue
            self._slot_flush_drain(slot)
            slot.active = False
        self.traffic.active.clear()

    def retune(self, new_center_frequency_hz: float) -> None:
        """Tuner moved: remap active slots; those outside coverage are
        torn down."""
        self.center_frequency_hz = float(new_center_frequency_hz)
        ch = self.rx.channelizer
        half_span = ch.channels * ch.channel_spacing / 2
        for slot in self.slots:
            if not slot.active:
                continue
            offset = slot.frequency_hz - self.center_frequency_hz
            if abs(offset) > half_span:
                if slot.is_control:
                    raise ValueError(
                        f"retune to {new_center_frequency_hz} drops the "
                        f"control channel at {slot.frequency_hz}")
                self._slot_flush_drain(slot)
                slot.active = False
                self.skipped_grants.append(slot.frequency_hz)
                continue
            self._tune(slot.index, offset)

    def _free_slot(self) -> ChannelSlot | None:
        for slot in self.slots:
            if not slot.active and not slot.is_control:
                return slot
        return None

    def _activate(self, frequency_hz: float,
                  identifiers: IdentifierCollection) -> None:
        """Traffic grant -> start decoding the granted frequency."""
        offset = frequency_hz - self.center_frequency_hz
        ch = self.rx.channelizer
        if abs(offset) > ch.channels * ch.channel_spacing / 2:
            self.skipped_grants.append(frequency_hz)
            return
        for slot in self.slots:
            if slot.active and slot.frequency_hz == frequency_hz:
                return
        slot = self._free_slot()
        if slot is None:
            self.skipped_grants.append(frequency_hz)
            return
        self._tune(slot.index, offset)
        slot.frequency_hz = frequency_hz
        slot.active = True
        slot.activated_at = self.now
        # P25P2 traffic channels need the scramble key the control channel
        # learned (preload data, ChannelProcessingManager:403)
        extra = {}
        key_fn = getattr(self.bank_proc, "scramble_key", None)
        key = key_fn() if key_fn is not None else None
        if key is not None:
            extra["scramble_key"] = key
        self._bank_reset_slot(slot.index, preload=identifiers, **extra)

    def _teardown(self, frequency_hz: float) -> None:
        for slot in self.slots:
            if slot.active and not slot.is_control \
                    and slot.frequency_hz == frequency_hz:
                self._slot_flush_drain(slot)
                slot.active = False

    # --- data plane ----------------------------------------------------

    def _prepare(self, iq: np.ndarray) -> np.ndarray:
        """Host-side wire format: int8 (n, 2) passes raw, complex becomes
        float32 (n, 2) pairs."""
        iq = np.asarray(iq)
        if np.iscomplexobj(iq):
            iq = np.stack([iq.real, iq.imag], -1).astype(np.float32)
        return iq

    def _upload(self, iq: np.ndarray) -> torch.Tensor:
        """Host->device transfer of a prepared chunk (runs on the
        pipeline's upload thread in run()). On CUDA it stages through one
        of two page-locked buffers and copies asynchronously; a buffer is
        refilled only after its previous copy has finished."""
        t0 = time.perf_counter()
        src = torch.from_numpy(np.ascontiguousarray(iq))
        if self.device.type == "cuda":
            key = (tuple(src.shape), src.dtype)
            if key not in self._pinned:
                self._pinned[key] = [
                    [torch.empty(src.shape, dtype=src.dtype,
                                 pin_memory=True), None] for _ in range(2)]
            ring = self._pinned[key]
            ring.append(ring.pop(0))
            buf, done = ring[-1]
            if done is not None:
                done.synchronize()
            buf.copy_(src)
            dev = buf.to(self.device, non_blocking=True)
            ring[-1][1] = torch.cuda.Event()
            ring[-1][1].record()
        else:
            dev = src
        self._last_upload = (time.perf_counter() - t0, iq.nbytes)
        return dev

    def _dispatch(self, dev_iq: torch.Tensor):
        """Queue the live step for an already-uploaded chunk."""
        if self._plan_dev is None:
            self._plan_dev = (
                torch.as_tensor(self.bins, dtype=torch.long,
                                device=self.device),
                torch.as_tensor(self.steps, device=self.device))
        out, self.state = self.step(dev_iq, self.state, *self._plan_dev)
        self.samples_processed += dev_iq.shape[0]
        return out, self.samples_processed / self.sample_rate

    def run_chunk(self, iq: np.ndarray) -> dict:
        """Process one wideband chunk through the slot bank + host layer."""
        out, now = self._dispatch(self._upload(self._prepare(iq)))
        return self._process(out, now)

    def _split_packed(self, buf: np.ndarray):
        """Parse the flat uint8 transfer (dib4 | hits | counts | pll)."""
        c = len(self.slots)
        cap = self._bank_cap
        q, h = cap // 4, cap // 8
        dib4 = buf[: c * q].reshape(c, q)
        hits = buf[c * q: c * (q + h)].reshape(c, h)
        counts = buf[c * (q + h): c * (q + h) + 4 * c].view(np.int32)
        pll_raw = float(buf[-4:].view(np.float32)[0])
        return dib4, hits, counts, pll_raw

    # mu-law expansion LUT for the analog bank transfer (the inverse of
    # pack_audio's companding; 256 entries)
    _MULAW_LUT = None

    @classmethod
    def _mulaw_lut(cls) -> np.ndarray:
        if cls._MULAW_LUT is None:
            level = np.arange(128, dtype=np.float32)
            mag = (np.power(256.0, level / 127.0) - 1.0) / 255.0
            cls._MULAW_LUT = np.concatenate([mag, -mag]).astype(np.float32)
        return cls._MULAW_LUT

    def _split_packed_audio(self, buf: np.ndarray):
        """Parse the analog bank transfer (PCM | packed gate)."""
        c = len(self.slots)
        ka = self._bank_ka
        if self.audio_format == "int16":
            n = c * ka * 2
            audio = (buf[:n].view("<i2").astype(np.float32)
                     / 32767.0).reshape(c, ka)
            rest = buf[n:]
        else:
            audio = self._mulaw_lut()[buf[: c * ka]].reshape(c, ka)
            rest = buf[c * ka:]
        nb = (ka + 7) // 8
        gate = np.unpackbits(rest.reshape(c, nb),
                             axis=1)[:, :ka].astype(bool)
        return audio, gate

    def _split_packed_mixed(self, buf: np.ndarray):
        """Parse the mixed analog-trunking transfer (mu-law PCM | gates |
        compacted bits | counts)."""
        c = len(self.slots)
        ka = self._bank_ka
        cap = self._bank_bit_cap
        audio = self._mulaw_lut()[buf[: c * ka]].reshape(c, ka)
        pos = c * ka
        nb = (ka + 7) // 8
        gate = np.unpackbits(buf[pos: pos + c * nb].reshape(c, nb),
                             axis=1)[:, :ka].astype(bool)
        pos += c * nb
        bits = np.unpackbits(
            buf[pos: pos + c * (cap // 8)].reshape(c, cap // 8), axis=1)
        pos += c * (cap // 8)
        counts = buf[pos: pos + 4 * c].view(np.int32)
        return audio, gate, bits, counts

    def _pull_bank(self, out: dict, now: float) -> dict:
        """Download-worker half of a chunk: transfer + unpack (+ bank-frame
        for the digital kinds; stateful, strictly in chunk order on the one
        download thread)."""
        if self.bank_mixed:
            return {"bank_mixed": self._split_packed_mixed(
                out["packed_mixed"].cpu().numpy())}
        if self.bank_analog:
            audio, gate = self._split_packed_audio(
                out["packed_audio"].cpu().numpy())
            return {"bank_audio": audio, "bank_gate": gate}
        dib4, hits, counts, pll_raw = self._split_packed(
            out["packed"].cpu().numpy())
        msgs = self.bank_proc.frame_chunk(dib4, counts, hits)
        return {"bank_msgs": msgs, "counts": counts, "pll_raw": pll_raw}

    def _process(self, out: dict, now: float) -> dict:
        self.now = now
        if "packed" in out or "packed_audio" in out \
                or "packed_mixed" in out:
            out = self._pull_bank(out, now)        # un-pipelined path
        pll_raw = out.get("pll_raw")

        pll_err_hz = None
        if self.ppm_monitor is not None and pll_raw is not None:
            # loop freq (rad/sample at channel rate) -> Hz; positive loop
            # freq means the PLL mixes UP for a signal below expectation
            rate = self.rx.channelizer.channel_sample_rate
            pll_err_hz = float(-pll_raw * rate / (2.0 * np.pi))
            self.ppm_monitor.update(pll_err_hz, self.now)

        active = np.array([s.active for s in self.slots])
        if self.bank_mixed:
            per_slot = self.bank_proc.route_mixed(*out["bank_mixed"], active,
                                                  self.now)
        elif self.bank_analog:
            per_slot = self.bank_proc.route_audio(
                out["bank_audio"], out["bank_gate"], active, self.now)
        else:
            per_slot = self.bank_proc.route(out["bank_msgs"], out["counts"],
                                            active, self.now)
        frames = int(per_slot.sum())
        for slot in self.slots:
            if not slot.active:
                continue
            if per_slot[slot.index] and not slot.is_control:
                self.traffic.process_activity(slot.frequency_hz, self.now)
            self.audio_segments.extend(
                self.bank_proc.drain_audio(slot.index))
        self.traffic.check_teardown(self.now)

        if self.rotation is not None:
            ctrl = next(s for s in self.slots if s.is_control)
            self.rotation.state(self.bank_proc.channel_state(ctrl.index),
                                self.now)
            self.rotation.check(self.now)

        metrics = {
            "t": round(self.now, 6),
            "samples": self.samples_processed,
            "active_channels": sum(s.active for s in self.slots),
            "frames": frames,
            "events": len(self.traffic.events),
            "audio_segments": len(self.audio_segments),
        }
        if self._last_upload is not None:
            dt, nbytes = self._last_upload
            metrics["upload_ms"] = round(dt * 1e3, 1)
            if dt > 0:
                metrics["upload_mbps"] = round(nbytes / dt / 1e6, 1)
        framer = getattr(self.bank_proc, "framer", None)
        if framer is not None:
            for key in ("deferred_hard_bch", "expired_pending",
                        "dropped_hard_rs"):
                v = getattr(framer, key, 0)
                if v:
                    metrics[key] = int(v)
            if framer.pending:
                metrics["pending_frames"] = len(framer.pending)
        unk = sum(m.unknown_opcodes for m in self.bank_proc.metrics)
        if unk:
            metrics["unknown_opcodes"] = int(unk)
        if pll_err_hz is not None:
            metrics["pll_error_hz"] = round(pll_err_hz, 1)
            metrics["correction_ppm"] = round(self.correction_ppm, 3)
        if self.metrics_sink is not None:
            self.metrics_sink(json.dumps(metrics))
        return metrics

    def run(self, max_chunks: int | None = None,
            pipelined: bool = True) -> dict:
        """Drain the source to exhaustion (or max_chunks) and return the
        final metrics line. A bounded run consumes exactly max_chunks
        chunks from the source; a short read or an error state ends it.

        pipelined: an upload thread stages chunk n+1 while the device
        computes chunk n and a download thread pulls and bank-frames
        chunk n-1; control-plane writes from chunk n (grants, retunes)
        take effect from chunk n+2. Otherwise each chunk goes through
        ``run_chunk`` in turn and its writes take effect from chunk n+1."""
        metrics = {}
        chunks = 0
        pending = None
        if not pipelined:
            while max_chunks is None or chunks < max_chunks:
                if self.error_state is not None:
                    break
                iq = self.source(self.chunk_samples)
                if iq is None or len(iq) < self.chunk_samples:
                    break
                metrics = self.run_chunk(iq)
                chunks += 1
            return metrics

        def next_prepared():
            if self.error_state is not None:
                return None
            iq = self.source(self.chunk_samples)
            if iq is None or len(iq) < self.chunk_samples:
                return None
            return self._prepare(iq)

        def may_read(done: int) -> bool:
            # prefetching past the budget would drop a chunk of IQ on
            # every bounded run() call
            return max_chunks is None or done < max_chunks

        with ThreadPoolExecutor(1) as up_pool, \
                ThreadPoolExecutor(1) as down_pool:
            prep = next_prepared() if may_read(0) else None
            fut = up_pool.submit(self._upload, prep) if prep is not None \
                else None
            while fut is not None and \
                    (max_chunks is None or chunks < max_chunks):
                if self.error_state is not None:
                    break
                dev_iq = fut.result()
                out, now = self._dispatch(dev_iq)
                prep = next_prepared() if may_read(chunks + 1) else None
                fut = up_pool.submit(self._upload, prep) \
                    if prep is not None else None
                cur = (down_pool.submit(self._pull_bank, out, now), now)
                if pending is not None:
                    metrics = self._process(pending[0].result(),
                                            pending[1])
                pending = cur
                chunks += 1
            if fut is not None:
                fut.result()
        if pending is not None:
            metrics = self._process(pending[0].result(), pending[1])
        return metrics

    # --- introspection ---------------------------------------------------

    @property
    def events(self) -> list[DecodeEvent]:
        return self.traffic.events

    def close(self) -> None:
        """Release the bank worker process, the one resource the reference
        frees here. The port runs the bank host layer in-process
        (host_process=True raises: ROADMAP Queue 1 item 9 + 15c), so there
        is nothing to release; calling it again is harmless."""

    def channel_status(self) -> list[dict]:
        return [{
            "slot": s.index, "active": s.active,
            "control": s.is_control, "frequency_hz": s.frequency_hz,
            "frames": int(self.bank_proc.frame_counts[s.index]),
            "metrics": self.bank_proc.metrics[s.index].as_dict(),
        } for s in self.slots]
