"""Live orchestrator (port of sdrtrunk_tpu/runtime/orchestrator.py).

The continuous ring -> decode -> events -> traffic-following loop. One
device step demodulates every slot of a chunk; the host layer frames and
decodes, and the ``TrafficChannelManager`` starts and stops traffic slots
mid-stream. "Starting a channel" is a write of (bin, mixer step) into the
slot plan plus an in-place reset of that slot's device state. Three tiers,
as in the reference:

* the bank tier (``bank_mode``, by default at 32 slots or more), for one
  decoder kind. For a digital kind (P25 Phase 1 C4FM or LSM, P25 Phase 2,
  DMR) the step compacts the symbol streams, correlates them against the
  protocol's sync patterns and packs the result into one flat uint8
  transfer; the host frames the whole bank with the protocol's bank
  processor (``P25P1BankProcessor``, ``P25P2BankProcessor``,
  ``DMRBankProcessor``), in-process or, with ``host_process=True``, in a
  worker process (``bank_worker.ProcessBankHost``). For an analog kind
  (NBFM, AM) the step packs companded 8-bit (or int16) PCM and the squelch
  gate bits, and ``AnalogBankProcessor`` assembles each slot's
  AudioSegments. For an analog-trunking kind (LTR, LTR-Net, Passport,
  MPT1327: the mixed bank) the step packs companded voice, gate bits and
  the compacted sub-audible or AFSK bit decisions, and
  ``MixedBankProcessor`` hands each slot's share to its per-slot
  processor (MPT1327's GTC grants drive the traffic manager through the
  ``channel_map``);
* the per-slot path (below 32 slots), for one digital or analog kind: the
  step returns each slot's dibits with their valid flags (or audio and
  gate), and one channel processor a slot (``runtime/processors.py``)
  frames and decodes them on the host;
* ``banks=``: a heterogeneous mix behind one channelizer
  (``MultibankReceiver``), served per slot as above, each bank's outputs
  under its own key.

The host layer (``runtime`` processors, bank processors, bank worker,
decoder states and traffic, ``audio``, ``protocol``) is the port's
byte-for-byte copy of the JAX package's (tests/test_torch_host_copy.py
holds the copies equal). Time is the sample clock (samples processed /
sample rate), so runs are deterministic and replayable.
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
from ..receiver import MultibankReceiver, WidebandReceiver
from . import tracing
from .bank_processor import (AnalogBankProcessor, DMRBankProcessor,
                             MixedBankProcessor, P25P1BankProcessor,
                             P25P2BankProcessor, unpack_dibits)
from .events import DecodeEvent
from .identifiers import IdentifierCollection
from .metrics import FrequencyErrorMonitor
from .processors import (P25P1ChannelProcessor, P25P2ChannelProcessor,
                         make_channel_processor)
from .traffic import TrafficChannelManager

__all__ = ["ChannelSlot", "P25P1ChannelProcessor", "Orchestrator",
           "compact_and_correlate", "ingest", "pack_audio", "pack_mixed",
           "pack_sym", "sync_patterns"]

_P25P1_SYNC_MAX_ERRORS = 9          # bit errors over the 24-dibit sync
_P25P2_SYNC_MAX_ERRORS = 4          # over the 20-dibit sync (P25P2SyncPattern)

# decoder kind -> traffic-manager protocol label (reference
# orchestrator.py:42-47); every kind here has a bank tier
_PROTOCOL_LABELS = {"c4fm": "APCO25", "p25p1": "APCO25", "lsm": "APCO25",
                    "p25p1-lsm": "APCO25", "dmr": "DMR", "p25p2": "APCO25-P2",
                    "nbfm": "NBFM", "am": "AM", "ltr": "LTR",
                    "ltrnet": "LTR-Net", "passport": "Passport",
                    "mpt1327": "MPT1327"}
_ANALOG_KINDS = ("nbfm", "am")
_MIXED_KINDS = ("ltr", "ltrnet", "passport", "mpt1327")
# the spans of a chunk that the metrics line's ``stages_ms`` gives while
# the tracer is on (each span's own ms, its children's included)
_STAGES_MS = ("prepare", "upload.stage", "upload.ring_wait", "upload.copy",
              "dispatch", "h2d", "pull.download", "pull.frame", "process")


@dataclass
class ChannelSlot:
    """One retunable channel slot of the running receiver."""
    index: int
    frequency_hz: float = 0.0
    name: str | None = None      # playlist channel name (pinned slots)
    processor: object | None = None     # per-slot host processor
    is_control: bool = False
    active: bool = False
    activated_at: float = 0.0
    kind: str | None = None      # decoder kind (banks=)
    bank_key: str | None = None  # the bank's output and state key
    local: int = 0               # index within the bank


def ingest(x: torch.Tensor) -> torch.Tensor:
    """Wire format -> float: int8 IQ pairs scale by 1/127; uint8 (N,) is
    packed 4-bit IQ (high nibble I, low nibble Q, two's complement; the
    ``ingest_format="int4"`` wire format), each nibble scaled by 16/127;
    float pairs and complex pass through."""
    if x.dtype == torch.uint8:
        xi = x.to(torch.int32)
        i4 = (((xi >> 4) + 8) & 15) - 8
        q4 = (((xi & 15) + 8) & 15) - 8
        return torch.stack([i4, q4], -1).to(torch.float32) * (16.0 / 127.0)
    if x.dtype == torch.int8:
        return x.to(torch.float32) * (1.0 / 127.0)
    return x


def _ingest(x: torch.Tensor) -> torch.Tensor:
    with tracing.span("step.channelize"):
        return ingest(x)


def pack_sym(symbols: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(C, K) symbols (dibits, or bits) and their valid mask -> int8
    symbol | valid << 2, the per-slot path's transfer."""
    return (symbols.to(torch.int32)
            | (valid.to(torch.int32) << 2)).to(torch.int8)


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
    Each compact lag is tested against every pattern (``sync_patterns``,
    copied to the device on first use by ``tracing.h2d_once``)
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

    host = np.asarray(patterns, np.uint8)
    pats = tracing.h2d_once(("sync_patterns", host.tobytes(), host.shape),
                            host.copy, device=dev)
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


# The reference writes the level as log1p(255|a|) * (1 / log 256) * 127;
# XLA folds the two constants into this one float32 factor, so the product
# is rounded once. Two roundings give the level below on samples whose
# level + 0.5 falls within an ulp of an integer (a 700 Hz tone hits one
# every 80 samples on some channels).
_MULAW_SCALE = float(np.float32(np.float32(1.0 / np.log(256.0)) * 127.0))


def _mulaw8(a: torch.Tensor) -> torch.Tensor:
    """(C, Ka) audio in [-1, 1] -> flat mu-law bytes (``pack_audio``)."""
    comp = torch.log1p(255.0 * torch.abs(a)) * _MULAW_SCALE
    level = torch.clamp((comp + 0.5).to(torch.int32), 0, 127)
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
    """Continuous decode loop with dynamic traffic-channel following.

    source: callable read(num_samples) -> NumPy IQ (int8 (n, 2) pairs,
            float32 (n, 2) pairs or complex), shorter or None at the end.
    center_frequency_hz: RF frequency at baseband 0.
    control_offsets_hz: baseband offsets of the control channel(s); each
            gets a pinned slot whose TrafficChannelManager activates and
            tears down the remaining slots (an analog bank's pinned slot
            has no control channel: its slots are activated directly). An
            entry may be an (offset_hz, kind) pair: with ``banks`` it pins
            its slot in the bank of that kind.
    bank_mode: None (the default) runs the bank tier at 32 slots or more
            and the per-slot path below that (reference orchestrator.py:
            181-190); True or False forces one.
    banks: ordered [(kind, n_slots), ...]: a heterogeneous mix behind one
            channelizer (``MultibankReceiver``), served per slot; the
            control slots live in the first bank unless an (offset, kind)
            entry names another. Exclusive with bank_mode=True.
    chunk_samples: wideband samples a chunk, a multiple of the bin count
            M; for nbfm, am and the analog-trunking kinds, K = 2 *
            chunk_samples / M must also be a multiple of the resampler's
            ``down`` (25 at a 25 kHz channel rate), and for mpt1327 the
            audio length Ka = K * 8 / 25 a multiple of 10 (the AFSK
            resampler's; the rest of a chunk's audio would be dropped).
            The default is 16 * M, the smallest such chunk for nbfm and
            am, and 125 * M (K = 250, Ka = 80) for the analog-trunking
            kinds and for ``banks``.
    audio_format: the analog bank's PCM transfer, "mulaw8" or "int16"
            (the mixed bank always sends mu-law).
    ingest_format: "auto" passes the source's samples on as they come
            (int8 pairs, float pairs, complex); "int4" packs each sample
            into one byte of 4-bit I and Q on the host (``_prepare``),
            unpacked on the device (``ingest``): the reference's
            slow-link wire format, whose quantization floor costs about a
            third of DMR frames at 1023 carriers (README).
    channel_map: FrequencyBand that maps MPT1327 traffic channel numbers
            to frequencies (the reference's user channel map).
    host_process: run a digital single-kind bank's host layer (framer,
            decoder states, traffic manager) in a worker process
            (``runtime/bank_worker.py``), which gets NumPy buffers only.
    device: where the slot bank runs; None (the default) is
            ``default_device()``, the card unless a ``use_device`` block
            says otherwise (no fallback).
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
                 device=None):
        if isinstance(control_offsets_hz, (int, float, np.floating)):
            control_offsets_hz = [control_offsets_hz]
        control_entries = [
            (float(e[0]), e[1]) if isinstance(e, tuple) else (float(e), None)
            for e in control_offsets_hz]
        self.banks = ([(kind, int(n)) for kind, n in banks]
                      if banks is not None else None)
        if self.banks is not None:
            if bank_mode:
                raise ValueError("banks and bank_mode are exclusive")
            bank_mode = False
            slots = sum(n for _, n in self.banks)
            decoder = self.banks[0][0]
        for kind in {decoder, *(k for k, _ in self.banks or ())}:
            if kind not in _PROTOCOL_LABELS:
                raise ValueError(f"unknown decoder kind {kind!r}")
        if ingest_format not in ("auto", "int4"):
            raise ValueError(f"unknown ingest_format {ingest_format!r}")
        if audio_format not in ("mulaw8", "int16"):
            raise ValueError(f"unknown audio_format {audio_format!r}")
        if slots < len(control_entries) + 1:
            raise ValueError("need at least one traffic slot")
        if bank_mode is None:
            bank_mode = slots >= 32          # every kind has a bank tier
        if not bank_mode and self.banks is None and decoder in _MIXED_KINDS:
            # the reference's per-slot leg sends these kinds' audio alone
            # to a processor that only takes process_mixed
            raise ValueError(
                f"decoder {decoder!r} runs per slot only inside banks=: pass "
                f"banks=[({decoder!r}, {slots})] or bank_mode=True")
        self.bank_mode = bool(bank_mode)
        self.bank_analog = self.bank_mode and decoder in _ANALOG_KINDS
        self.bank_mixed = self.bank_mode and decoder in _MIXED_KINDS
        if host_process and (not self.bank_mode or self.bank_analog
                             or self.bank_mixed or self.banks is not None):
            raise ValueError("host_process requires a digital single-kind "
                             "bank mode")
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
        self.ingest_format = ingest_format

        self.rx = self._make_receiver(slots)
        m = self.rx.channelizer.channels
        self.chunk_samples = (chunk_samples if chunk_samples is not None
                              else self._default_chunk(m))
        if self.chunk_samples % m != 0:
            raise ValueError(f"chunk_samples must be a multiple of {m}")
        self._size_bank(m)
        self.step = self._build_live_step()
        self.state = self.rx.init_state()

        self.bins = np.zeros((slots, 2), np.int32)
        self.steps = np.zeros(slots, np.float32)
        self._plan_dev = None
        self.slots = [ChannelSlot(i) for i in range(slots)]
        if self.banks is not None:
            for s in self.slots:
                s.bank_key, s.local = self.rx.slot_key(s.index)
                s.kind = s.bank_key.split("_", 1)[1]

        self.correction_ppm = 0.0
        self.event_logger = None
        if event_log_path is not None:
            from .eventlog import DecodeEventLogger
            self.event_logger = DecodeEventLogger(event_log_path)
        label = _PROTOCOL_LABELS[decoder]
        self.traffic = TrafficChannelManager(
            label, idle_teardown_seconds=idle_teardown_seconds,
            on_activate=self._activate, on_teardown=self._teardown)
        if self.event_logger is not None:
            self.traffic.event_sink = self.event_logger.receive
        control_slots = set(range(len(control_entries)))
        self.bank_proc = None
        self.bank_host = None
        if self.bank_mixed:
            self.bank_proc = MixedBankProcessor(
                slots, control_slots=control_slots, traffic=self.traffic,
                kind=decoder, channel_map=self.channel_map)
        elif self.bank_analog:
            self.bank_proc = AnalogBankProcessor(slots)
        elif self.bank_mode and host_process:
            # the worker is spawned: a fresh interpreter that imports this
            # package (and torch) but is handed NumPy buffers only, so it
            # never creates a CUDA context
            from .bank_worker import ProcessBankHost
            self.bank_host = ProcessBankHost(
                decoder, slots, control_slots=control_slots,
                codec=self.codec, protocol_label=label,
                idle_teardown=idle_teardown_seconds,
                bank_cap=self._bank_cap)
            self._worker_events: list = []
            self._worker_reply: dict = {}
        elif self.bank_mode:
            bank_cls = {"dmr": DMRBankProcessor,
                        "p25p2": P25P2BankProcessor}.get(decoder,
                                                         P25P1BankProcessor)
            self.bank_proc = bank_cls(
                slots, control_slots=control_slots, traffic=self.traffic,
                codec=self.codec)
        claimed: set[int] = set()
        for off, want_kind in control_entries:
            slot = next(s for s in self.slots if s.index not in claimed
                        and (want_kind is None or self.banks is None
                             or s.kind == want_kind))
            claimed.add(slot.index)
            slot.is_control = True
            slot.active = True
            slot.frequency_hz = self.center_frequency_hz + off
            if not self.bank_mode:
                slot.processor = make_channel_processor(
                    slot.kind or decoder, traffic=self.traffic,
                    codec=self.codec, channel_map=self.channel_map)
                self._wire_logger(slot.processor)
            self._tune(slot.index, off)
        self.rotation = None
        if control_rotation:
            from .rotation import ChannelRotationMonitor
            self.rotation = ChannelRotationMonitor(
                control_rotation, self._rotate_control,
                rotation_delay=rotation_delay)

        self.now = 0.0
        self.samples_processed = 0
        # calls of each stage so far: a chunk's number in each (tracing)
        self._calls = dict.fromkeys(
            ("prepare", "upload", "dispatch", "pull", "process"), 0)
        # upload number -> (copy's start and end events, bytes) on CUDA,
        # (host seconds, bytes) on the CPU; read by _process
        self._uploads: dict = {}
        self._pinned: dict = {}
        # live recording taps: the wideband IQ and per-slot dibits can
        # start and stop mid-run
        self._iq_writer = None
        self._bits_recorders: dict[int, object] = {}
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

    def _make_receiver(self, slots: int):
        if self.banks is not None:
            return MultibankReceiver(self.sample_rate, self.banks,
                                     channel_bandwidth=self.channel_bandwidth,
                                     device=self.device)
        return WidebandReceiver(self.sample_rate, [0.0] * slots,
                                channel_bandwidth=self.channel_bandwidth,
                                decoder=self.decoder_name, device=self.device)

    def _size_bank(self, m: int) -> None:
        """The bank transfer's sizes a chunk: ``_bank_cap`` symbols a slot
        (digital), ``_bank_ka`` audio samples a slot (analog and mixed) and
        ``_bank_bit_cap`` bits a slot (mixed); None where not used."""
        self._bank_cap = self._bank_ka = self._bank_bit_cap = None
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
                baud = 1200.0 if self.decoder_name == "mpt1327" else 300.0
                secs = self.chunk_samples / self.sample_rate
                self._bank_bit_cap = int(
                    np.ceil((secs * baud * 1.25 + 16) / 32)) * 32
        elif self.bank_mode:
            # symbols per slot per chunk at the fastest tracked timing,
            # plus margin, rounded to the packing granule
            k = 2 * self.chunk_samples // m * self.rx.decoder.upsample
            demod = self.rx.decoder.demod
            sps_min = demod.samples_per_symbol * (1.0 - demod.max_deviation)
            self._bank_cap = int(np.ceil((k / sps_min + 8) / 64)) * 64

    def _default_chunk(self, m: int) -> int:
        """Default wideband chunk (reference orchestrator.py:579-598): 16 *
        M; for nbfm and am the smallest chunk whose per-channel block K =
        2 * chunk / M is a multiple of the resampler's ``down``; for the
        analog-trunking kinds and for ``banks`` 125 * M: K = 250 satisfies
        the 8 kHz resampler (K % 25) and the AFSK correlator's audio step
        (Ka % 10)."""
        if self.banks is not None or self.decoder_name in _MIXED_KINDS:
            return m * 125
        if self.decoder_name in _ANALOG_KINDS:
            down = self.rx.decoder.down
            return m * down if down % 2 else m * down // 2
        return 16 * m

    def _build_live_step(self):
        """Live step = the receiver's dynamic step + on-device packing.
        Bank tier, ONE flat uint8 tensor: digital kinds compaction and sync
        correlation, then dib4 | hits | counts (le int32) | pll (le f32 of
        slot 0); analog kinds PCM | gate bits (``pack_audio``);
        analog-trunking kinds mu-law PCM | gate bits | compacted bits |
        counts (``pack_mixed``). Per-slot path: digital kinds ``sym`` =
        dibit | valid << 2 as int8 (C, K) and ``pll_freq`` (C,); analog
        kinds float32 ``audio`` and an int8 ``audio_gate``. ``banks``: per
        bank, "<key>/sym" and "<key>/pll" (digital), "<key>/audio" and
        "<key>/gate" (analog), or all of sym, audio and gate (the bits of
        an analog-trunking bank ride in sym)."""
        base = self.rx.build_dynamic()
        if self.banks is not None:
            def fused_banks(x, state, bins, steps):
                out, st = base(_ingest(x), state, bins, steps)
                flat = {}
                for key, outs in out.items():
                    if "dibits" in outs:
                        with tracing.span("step.compact"):
                            flat[f"{key}/sym"] = pack_sym(outs["dibits"],
                                                          outs["valid"])
                        # a copy: pll_freq is the decoder state's own
                        # tensor, which a retune resets in place while
                        # this chunk may still be pulled
                        flat[f"{key}/pll"] = outs["pll_freq"].clone()
                        continue
                    if "bits" in outs:
                        flat[f"{key}/sym"] = pack_sym(outs["bits"],
                                                      outs["valid"])
                    flat[f"{key}/audio"] = outs["audio"].to(torch.float32)
                    flat[f"{key}/gate"] = outs["audio_gate"].to(torch.int8)
                return flat, st

            return fused_banks
        if not self.bank_mode:
            def fused_slots(x, state, bins, steps):
                out, st = base(_ingest(x), state, bins, steps)
                if "dibits" in out:
                    with tracing.span("step.compact"):
                        sym = pack_sym(out["dibits"], out["valid"])
                    return {"sym": sym,
                            "pll_freq": out["pll_freq"].clone()}, st
                return {"audio": out["audio"].to(torch.float32),
                        "audio_gate": out["audio_gate"].to(torch.int8)}, st

            return fused_slots
        if self.bank_mixed:
            bit_cap = self._bank_bit_cap

            def fused_mixed(x, state, bins, steps):
                out, st = base(_ingest(x), state, bins, steps)
                return {"packed_mixed": pack_mixed(
                    out["audio"], out["audio_gate"], out["bits"],
                    out["valid"], bit_cap)}, st

            return fused_mixed
        if self.bank_analog:
            audio_format = self.audio_format

            def fused_audio(x, state, bins, steps):
                out, st = base(_ingest(x), state, bins, steps)
                with tracing.span("step.pack_audio"):
                    packed = pack_audio(out["audio"], out["audio_gate"],
                                        audio_format)
                return {"packed_audio": packed}, st

            return fused_audio
        cap = self._bank_cap
        sync = sync_patterns(self.decoder_name)

        def fused(x, state, bins, steps):
            out, st = base(_ingest(x), state, bins, steps)
            with tracing.span("step.compact"):
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
        if (self.slots[slot].kind or self.decoder_name) == "p25p2":
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

    def _wire_logger(self, processor) -> None:
        """Route a processor's decode-event history into the event-log
        sink."""
        if self.event_logger is None:
            return
        hist = getattr(getattr(processor, "state", None), "history",
                       None) or getattr(processor, "history", None)
        if hist is not None and hasattr(hist, "add_listener"):
            hist.add_listener(self.event_logger.receive)

    def _bank_reset_slot(self, index: int, preload=None, **extra) -> None:
        if self.bank_host is not None:
            self.bank_host.reset_slot(
                index, preload=preload, extra=extra or None,
                frequency=self.slots[index].frequency_hz)
            return
        self.bank_proc.reset_slot(index, preload=preload, **extra)
        state = self.bank_proc.states[index]
        if self.event_logger is not None and hasattr(state, "history"):
            state.history.add_listener(self.event_logger.receive)

    def _slot_flush_drain(self, slot) -> None:
        """Flush open calls on a slot and collect its audio segments."""
        if self.bank_host is not None:
            self.audio_segments.extend(
                self.bank_host.flush(slot.index, self.now))
        elif self.bank_mode:
            self.bank_proc.flush(slot.index, self.now)
            self.audio_segments.extend(self.bank_proc.drain_audio(slot.index))
        elif slot.processor is not None:
            slot.processor.flush(self.now)
            self.audio_segments.extend(slot.processor.drain_audio())

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

    def on_source_event(self, event) -> None:
        """Tuner notification: a center-frequency change retunes, a
        sample-rate change rebuilds the receiver, an error state stops
        every channel."""
        from ..sources.tuner import SourceEventType
        if event.type == SourceEventType.FREQUENCY_CHANGE:
            self.retune(float(event.value))
        elif event.type == SourceEventType.SAMPLE_RATE_CHANGE:
            self.set_sample_rate(float(event.value))
        elif event.type == SourceEventType.ERROR_STATE:
            self.stop_all(reason=str(event.value))

    def stop_all(self, reason: str = "") -> None:
        """Tuner error state: stop every running channel, flushing open
        calls to AudioSegments."""
        self.error_state = reason or "error"
        for slot in self.slots:
            if not slot.active:
                continue
            if not self.bank_mode and slot.processor is None:
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

    def set_sample_rate(self, new_sample_rate: float) -> None:
        """Tuner sample rate changed: rebuild the receiver and the live
        step on ``self.device`` for the new bin grid with the default chunk
        and a fresh state, then remap the active slots. An analog or
        analog-trunking bank raises ``ValueError`` first, nothing changed:
        the reference sizes a rebuilt bank from its decoder's demodulator,
        which these decoders lack, so it cannot run this either."""
        if self.bank_analog or self.bank_mixed:
            raise ValueError(
                f"a sample-rate change cannot rebuild a {self.decoder_name!r} "
                f"bank: an analog or analog-trunking bank_mode=True bank is "
                f"sized from the rate it was built at; the per-slot path and "
                f"banks= rebuild")
        slots = len(self.slots)
        self.sample_rate = float(new_sample_rate)
        self.rx = self._make_receiver(slots)
        m = self.rx.channelizer.channels
        self.chunk_samples = self._default_chunk(m)
        self._size_bank(m)
        self.step = self._build_live_step()
        self.state = self.rx.init_state()
        self.bins = np.zeros((slots, 2), np.int32)
        self.steps = np.zeros(slots, np.float32)
        self._plan_dev = None
        self._pinned = {}           # the upload ring's chunk shape changed
        self.retune(self.center_frequency_hz)

    def _free_slot(self, kind: str | None = None) -> ChannelSlot | None:
        for slot in self.slots:
            if not slot.active and not slot.is_control \
                    and (kind is None or slot.kind == kind):
                return slot
        return None

    def _activate(self, frequency_hz: float,
                  identifiers: IdentifierCollection,
                  kind: str | None = None) -> None:
        """Traffic grant -> start decoding the granted frequency. With
        ``banks``, ``kind`` picks the bank (default: the first bank's
        kind, whose control channel granted it)."""
        offset = frequency_hz - self.center_frequency_hz
        ch = self.rx.channelizer
        if abs(offset) > ch.channels * ch.channel_spacing / 2:
            self.skipped_grants.append(frequency_hz)
            return
        for slot in self.slots:
            if slot.active and slot.frequency_hz == frequency_hz:
                return
        if kind is None and self.banks is not None:
            kind = self.decoder_name
        slot = self._free_slot(kind)
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
        if self.bank_host is not None:
            key = (self.bank_host.scramble_key()
                   if self.decoder_name == "p25p2" else None)
        elif self.bank_mode:
            key_fn = getattr(self.bank_proc, "scramble_key", None)
            key = key_fn() if key_fn is not None else None
        else:
            key = next((s.processor.state.scramble_key for s in self.slots
                        if s.is_control
                        and isinstance(s.processor, P25P2ChannelProcessor)
                        and s.processor.state.scramble_key is not None),
                       None)
        if key is not None:
            extra["scramble_key"] = key
        if self.bank_mode:
            self._bank_reset_slot(slot.index, preload=identifiers, **extra)
            return
        slot.processor = make_channel_processor(
            slot.kind or self.decoder_name, traffic=None, codec=self.codec,
            preload=identifiers, **extra)
        self._wire_logger(slot.processor)

    def _teardown(self, frequency_hz: float) -> None:
        for slot in self.slots:
            if slot.active and not slot.is_control \
                    and slot.frequency_hz == frequency_hz:
                self._slot_flush_drain(slot)
                slot.active = False

    # --- live recording taps -------------------------------------------

    def start_iq_recording(self, path) -> None:
        """Record the wideband capture as an IQ wave while running; the
        tap sits at ingest (``_prepare``), int8 scaled by 1/127."""
        from ..io.wave import ComplexWaveWriter
        self.stop_iq_recording()
        self._iq_writer = ComplexWaveWriter(path, int(self.sample_rate))

    def stop_iq_recording(self) -> None:
        if self._iq_writer is not None:
            self._iq_writer.close()
            self._iq_writer = None

    def start_bits_recording(self, slot_index: int, path) -> None:
        """Record a slot's demodulated dibit stream mid-run as a
        reference-format .bits file."""
        from ..audio.recorder import BitsRecorder
        self.stop_bits_recording(slot_index)
        self._bits_recorders[slot_index] = BitsRecorder(path)

    def stop_bits_recording(self, slot_index: int) -> None:
        rec = self._bits_recorders.pop(slot_index, None)
        if rec is not None:
            rec.close()

    def _tap_bits_bank(self, dib4: np.ndarray, counts: np.ndarray) -> None:
        for idx, rec in list(self._bits_recorders.items()):
            row = unpack_dibits(dib4[idx:idx + 1])[0]
            rec.write(row[: int(counts[idx])])

    # --- data plane ----------------------------------------------------

    def _chunk(self, stage: str) -> int:
        """This call's number among the stage's calls: its chunk's number
        in the tracer's spans."""
        n = self._calls[stage]
        self._calls[stage] = n + 1
        return n

    def _prepare(self, iq: np.ndarray) -> np.ndarray:
        """Host-side wire format: int8 (n, 2) passes raw, complex becomes
        float32 (n, 2) pairs; with ``ingest_format="int4"`` either becomes
        packed 4-bit uint8 (n,), one byte a sample (``ingest`` unpacks it
        on the device). The IQ recording tap writes here."""
        with tracing.span("prepare", self._chunk("prepare")):
            iq = np.asarray(iq)
            if self._iq_writer is not None:
                self._iq_writer.write(iq.astype(np.float32) / 127.0
                                      if iq.dtype == np.int8 else iq)
            if np.iscomplexobj(iq):
                iq = np.stack([iq.real, iq.imag], -1).astype(np.float32)
            if self.ingest_format == "int4":
                if iq.dtype == np.int8:
                    v = np.clip(np.round(iq.astype(np.float32) / 16.0),
                                -8, 7).astype(np.int32)
                else:
                    v = np.clip(np.round(iq * 7.0), -8, 7).astype(np.int32)
                return (((v[:, 0] & 15) << 4)
                        | (v[:, 1] & 15)).astype(np.uint8)
            return iq

    def _upload(self, iq: np.ndarray) -> torch.Tensor:
        """Host->device transfer of a prepared chunk (runs on the
        pipeline's upload thread in run()). On CUDA it stages through one
        of two page-locked buffers and copies asynchronously; a buffer is
        refilled only after its previous copy has finished. The copy's
        two timing events (the second is the buffer's) or, on the CPU, the
        call's host seconds wait for the chunk's metrics line. The events
        time the copy alone where no other thread queues work on the
        stream between them: run() queues the next step only once this
        call has returned."""
        n = self._chunk("upload")
        with tracing.span("upload", n):
            t0 = time.perf_counter()
            src = torch.from_numpy(np.ascontiguousarray(iq))
            if self.device.type == "cuda":
                dev, timing = self._upload_cuda(src)
            else:
                dev, timing = src, time.perf_counter() - t0
        self._uploads[n] = (timing, iq.nbytes)
        self._uploads.pop(n - 8, None)       # chunks never processed
        return dev

    def _upload_cuda(self, src: torch.Tensor):
        """(the chunk on the card, its copy's start and end events)."""
        key = (tuple(src.shape), src.dtype)
        if key not in self._pinned:
            self._pinned[key] = [
                [torch.empty(src.shape, dtype=src.dtype,
                             pin_memory=True), None] for _ in range(2)]
        ring = self._pinned[key]
        ring.append(ring.pop(0))
        buf, done = ring[-1]
        if done is not None:
            with tracing.span("upload.ring_wait"):
                if tracing.enabled() and not done.query():
                    tracing.count("upload.ring_waits")
                done.synchronize()
        with tracing.span("upload.stage"):
            buf.copy_(src)
        with tracing.span("upload.copy"):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            dev = buf.to(self.device, non_blocking=True)
            done = ring[-1][1] = torch.cuda.Event(enable_timing=True)
            done.record()
        return dev, (start, done)

    def _dispatch(self, dev_iq: torch.Tensor):
        """Queue the live step for an already-uploaded chunk."""
        with tracing.span("dispatch", self._chunk("dispatch")):
            if self._plan_dev is None:
                self._plan_dev = (
                    tracing.h2d(self.bins, dtype=torch.long,
                                device=self.device),
                    tracing.h2d(self.steps, device=self.device))
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

    def _pull(self, out: dict, now: float) -> dict:
        """Download-worker half of a chunk (runs on the download thread of
        run(), strictly in chunk order): the bank tier's transfer, unpack
        and framing (``_pull_bank``), or the per-slot outputs to the
        host."""
        with tracing.span("pull", self._chunk("pull")):
            if self.bank_mode:
                return self._pull_bank(out, now)
            with tracing.span("pull.download"):
                return {key: v.cpu().numpy() for key, v in out.items()}

    def _pull_bank(self, out: dict, now: float) -> dict:
        """Transfer + unpack (+ bank-frame for the digital kinds, or the
        worker process's round trip; stateful, in chunk order)."""
        if self.bank_host is not None:
            # the slots' mask as the pull starts, before the transfer
            active = np.array([s.active for s in self.slots])
            control_index = next(s.index for s in self.slots if s.is_control)
        key = ("packed_mixed" if self.bank_mixed else
               "packed_audio" if self.bank_analog else "packed")
        with tracing.span("pull.download"):
            buf = out[key].cpu().numpy()
        with tracing.span("pull.frame"):
            if self.bank_host is not None:
                reply = self.bank_host.process_chunk(buf, active, now,
                                                     control_index)
                return {"worker_reply": reply}
            if self.bank_mixed:
                return {"bank_mixed": self._split_packed_mixed(buf)}
            if self.bank_analog:
                audio, gate = self._split_packed_audio(buf)
                return {"bank_audio": audio, "bank_gate": gate}
            dib4, hits, counts, pll_raw = self._split_packed(buf)
            if self._bits_recorders:
                self._tap_bits_bank(dib4, counts)
            msgs = self.bank_proc.frame_chunk(dib4, counts, hits)
            return {"bank_msgs": msgs, "counts": counts, "pll_raw": pll_raw}

    def _process(self, out: dict, now: float) -> dict:
        """The host layer of a chunk whose outputs are on the host (or
        pulled here): route, follow traffic, and emit the metrics line.
        While the tracer is on the line also gives the chunk's host ms by
        span (``stages_ms``), its host arrays copied to the device
        (``h2d_copies``) and its constants served from their kept device
        copies (``h2d_cached``)."""
        n = self._chunk("process")
        with tracing.span("process", n):
            metrics = self._metrics_of(out, now, n)
        if tracing.enabled():
            spans = tracing.take_chunk(n)
            metrics["stages_ms"] = {name: round(spans[name][0] * 1e3, 3)
                                    for name in _STAGES_MS if name in spans}
            metrics["h2d_copies"] = spans.get("h2d", (0.0, 0))[1]
            metrics["h2d_cached"] = spans.get("h2d.cached", (0.0, 0))[1]
        if self.metrics_sink is not None:
            self.metrics_sink(json.dumps(metrics))
        return metrics

    def _metrics_of(self, out: dict, now: float, n: int) -> dict:
        self.now = now
        if any(isinstance(v, torch.Tensor) for v in out.values()):
            out = self._pull(out, now)                 # un-pipelined path
        pll_raw = out.get("pll_raw")
        if self.banks is not None:
            ctrl = self.slots[0]
            if f"{ctrl.bank_key}/pll" in out:
                pll_raw = float(out[f"{ctrl.bank_key}/pll"][ctrl.local])
        elif "worker_reply" in out:
            pll_raw = out["worker_reply"].get("pll")
        elif "pll_freq" in out:
            pll_raw = float(out["pll_freq"][0])

        pll_err_hz = None
        if self.ppm_monitor is not None and pll_raw is not None:
            # loop freq (rad/sample at channel rate) -> Hz; positive loop
            # freq means the PLL mixes UP for a signal below expectation
            rate = self.rx.channelizer.channel_sample_rate
            pll_err_hz = float(-pll_raw * rate / (2.0 * np.pi))
            self.ppm_monitor.update(pll_err_hz, self.now)

        if self.bank_host is not None:
            frames = self._apply_worker_reply(out["worker_reply"])
        elif self.bank_mode:
            frames = self._route_bank(out)
        else:
            frames = self._route_slots(out)
        if self.bank_host is None:
            self.traffic.check_teardown(self.now)

        if self.rotation is not None:
            ctrl = next(s for s in self.slots if s.is_control)
            if self.bank_host is not None:
                self.rotation.state(self._worker_reply.get("control_state"),
                                    self.now)
            elif self.bank_mode:
                self.rotation.state(self.bank_proc.channel_state(ctrl.index),
                                    self.now)
            elif hasattr(ctrl.processor, "channel_state"):
                self.rotation.state(ctrl.processor.channel_state(), self.now)
            self.rotation.check(self.now)

        metrics = {
            "t": round(self.now, 6),
            "samples": self.samples_processed,
            "active_channels": sum(s.active for s in self.slots),
            "frames": frames,
            "events": len(self.traffic.events),
            "audio_segments": len(self.audio_segments),
        }
        upload = self._uploads.pop(n, None)
        if upload is not None:
            # on CUDA the copy's device time: the chunk is on the host, so
            # its copy has ended and reading the events does not wait
            timing, nbytes = upload
            dt = (timing[0].elapsed_time(timing[1]) * 1e-3
                  if isinstance(timing, tuple) else timing)
            metrics["upload_ms"] = round(dt * 1e3, 3)
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
        if self.bank_proc is not None:
            unk = sum(m.unknown_opcodes for m in self.bank_proc.metrics)
            if unk:
                metrics["unknown_opcodes"] = int(unk)
        if self.bank_host is not None:
            metrics.update(self._worker_reply.get("degraded", {}))
            if self._worker_reply.get("unknown_opcodes"):
                metrics["unknown_opcodes"] = int(
                    self._worker_reply["unknown_opcodes"])
        if pll_err_hz is not None:
            metrics["pll_error_hz"] = round(pll_err_hz, 1)
            metrics["correction_ppm"] = round(self.correction_ppm, 3)
        return metrics

    def _route_bank(self, out: dict) -> int:
        """The bank tier's host half: route the chunk's messages, audio or
        mixed share to the slots' states; returns the frames."""
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
        for slot in self.slots:
            if not slot.active:
                continue
            if per_slot[slot.index] and not slot.is_control:
                self.traffic.process_activity(slot.frequency_hz, self.now)
            self.audio_segments.extend(
                self.bank_proc.drain_audio(slot.index))
        return int(per_slot.sum())

    def _route_slots(self, out: dict) -> int:
        """The per-slot host half: each active slot's processor takes its
        share of the chunk (dibits; audio and gate; or, in an
        analog-trunking bank, the sliced bits beside them); returns the
        frames."""
        frames = 0
        for slot in self.slots:
            if not slot.active:
                continue
            i = slot.index
            if self.banks is not None:
                key, i = slot.bank_key, slot.local
                sym = out.get(f"{key}/sym")
                audio = out.get(f"{key}/audio")
                gate = out.get(f"{key}/gate")
            else:
                sym, audio, gate = (out.get("sym"), out.get("audio"),
                                    out.get("audio_gate"))
            if sym is not None and audio is not None:
                p = sym[i]
                n = slot.processor.process_mixed(
                    (p & 1)[(p >> 2) > 0], audio[i], gate[i] > 0, self.now)
            elif sym is not None:
                p = sym[i]
                slot_dib = (p & 3)[(p >> 2) > 0]
                rec = self._bits_recorders.get(slot.index)
                if rec is not None:
                    rec.write(slot_dib)
                n = slot.processor.process(slot_dib, self.now)
            else:
                n = slot.processor.process_audio(audio[i], gate[i] > 0,
                                                 self.now)
            frames += n
            if n and not slot.is_control:
                # frames on a traffic channel = teardown-aging activity
                self.traffic.process_activity(slot.frequency_hz, self.now)
            self.audio_segments.extend(slot.processor.drain_audio())
        return frames

    def _apply_worker_reply(self, reply: dict) -> int:
        """The worker process framed and routed the chunk: collect its
        events and audio, and apply its traffic actions to the device
        plan (one chunk of grant latency, as in-process pipelined)."""
        self._worker_events.extend(reply["events"])
        if self.event_logger is not None:
            for e in reply["events"]:
                self.event_logger.receive(e)
        self.audio_segments.extend(reply["audio"])
        self._worker_reply = reply
        for action in reply["actions"]:
            if action[0] == "activate":
                _, freq, ids, kind = action
                self._activate(freq, ids, kind)
            else:
                self._teardown(action[1])
        return int(reply["per_slot"].sum())

    def run(self, max_chunks: int | None = None,
            pipelined: bool = True) -> dict:
        """Drain the source to exhaustion (or max_chunks) and return the
        final metrics line. A bounded run consumes exactly max_chunks
        chunks from the source; a short read or an error state ends it.

        pipelined: an upload thread stages chunk n+1 while the device
        computes chunk n and a download thread pulls (and bank-frames)
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
                cur = (down_pool.submit(self._pull, out, now), now)
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
        if self.bank_host is not None:
            return self._worker_events
        return self.traffic.events

    def close(self) -> None:
        """Stop the bank worker process, if there is one; calling it again
        is harmless."""
        if self.bank_host is not None:
            self.bank_host.close()
            self.bank_host = None

    def channel_status(self) -> list[dict]:
        if self.bank_host is not None:
            return [{
                "slot": s.index, "active": s.active,
                "control": s.is_control, "frequency_hz": s.frequency_hz,
                "frames": int(self.bank_host.frame_counts[s.index]),
                "metrics": None,
            } for s in self.slots]
        if self.bank_mode:
            return [{
                "slot": s.index, "active": s.active,
                "control": s.is_control, "frequency_hz": s.frequency_hz,
                "frames": int(self.bank_proc.frame_counts[s.index]),
                "metrics": self.bank_proc.metrics[s.index].as_dict(),
            } for s in self.slots]
        return [{
            "slot": s.index, "active": s.active, "control": s.is_control,
            "frequency_hz": s.frequency_hz,
            "frames": s.processor.frame_count if s.processor else 0,
            "metrics": (s.processor.metrics.as_dict()
                        if s.processor is not None
                        and hasattr(s.processor, "metrics") else None),
        } for s in self.slots]
