"""RTL-SDR live streaming tuner: control plane + bulk ingest glued into
the TunerController read interface.

Composes the pieces that already exist — RTL2832Controller/R820T
register control (sources/rtl2832.py), BulkStreamer stall-recovering
bulk reads (sources/libusb.py), the overflow ring (io/native.py
IqRingBuffer) and the u8 IQ converter — into the live-source role of
the reference's RTL2832TunerController + USBTransferProcessor pair
(source/tuner/rtl/RTL2832TunerController.java,
source/tuner/usb/USBTransferProcessor.java:46): a producer thread
pushes converted complex64 into a drop-on-overflow ring, and the
Orchestrator's source callable pulls fixed-size chunks from it.

No SDR hardware exists in CI, so tests drive this with a fake transport
whose bulk_read serves synthetic u8 IQ (tests/test_sources.py pattern);
on a real host pass a LibUsbTransport for a discovered RTL dongle.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from ..io.native import IqRingBuffer, convert_u8_iq
from .libusb import BulkStreamer
from .rtl2832 import (R820T_MAX_FREQUENCY, R820T_MIN_FREQUENCY,
                      R820TController, RTL2832Controller,
                      SAMPLE_RATE_RATIOS)
from .tuner import SourceEvent, SourceEventType, TunerController, TunerSpec

__all__ = ["RtlLiveTuner", "RTL_BULK_ENDPOINT"]

RTL_BULK_ENDPOINT = 0x81        # bulk IN endpoint of the RTL2832


class RtlLiveTuner(TunerController):
    """Streaming RTL2832/R820T source.

    transport: UsbTransport with bulk_read (LibUsbTransport on real
    hardware; any fake in tests). The ring holds `ring_seconds` of
    samples — overflow drops at the producer exactly like the
    reference's OverflowableTransferQueue, with the drop count exposed
    for metrics.
    """

    def __init__(self, transport, sample_rate: int = 2_400_000,
                 frequency: float = 450_000_000.0,
                 ring_seconds: float = 2.0,
                 transfer_bytes: int = 262_144,
                 tuner_chip: str = "r820t"):
        self.transport = transport
        self.rtl = RTL2832Controller(transport)
        if tuner_chip == "e4k":
            from .e4k import (E4K_MAX_FREQUENCY, E4K_MIN_FREQUENCY,
                              E4KController)
            self.tuner_chip = E4KController(self.rtl)
            fmin, fmax = float(E4K_MIN_FREQUENCY), float(E4K_MAX_FREQUENCY)
            name = "RTL-2832/E4000"
        else:
            self.tuner_chip = R820TController(self.rtl)
            fmin, fmax = (float(R820T_MIN_FREQUENCY),
                          float(R820T_MAX_FREQUENCY))
            name = "RTL-2832/R820T"
        self.r820t = self.tuner_chip     # backward-compatible alias
        spec = TunerSpec(
            name=name,
            minimum_frequency=fmin,
            maximum_frequency=fmax,
            sample_rates=tuple(float(r)
                               for r in sorted(SAMPLE_RATE_RATIOS)),
            usable_fraction=0.8,    # edge rolloff of the resampler
            dc_spike_hz=3000.0)
        super().__init__(spec, frequency=frequency,
                         sample_rate=float(sample_rate))
        # hardware bring-up: demod reset, FIR, rate, tuner registers,
        # initial PLL program (RTL2832TunerController start sequence)
        self.rtl.reset_demod()
        self.rtl.write_fir()
        actual = self.rtl.set_sample_rate(int(sample_rate))
        self._sample_rate = float(actual)
        if tuner_chip == "e4k":
            self.tuner_chip.init_tuner()
        else:
            self.tuner_chip.init_registers()
        self.tuner_chip.set_frequency(int(frequency))
        self.ring = IqRingBuffer(int(ring_seconds * actual))
        self._dropped_total = 0
        self._started = False
        self._eos = threading.Event()
        self.streamer = BulkStreamer(
            transport, RTL_BULK_ENDPOINT, self._on_bytes,
            transfer_bytes=transfer_bytes)

    # -- producer ---------------------------------------------------------

    def _on_bytes(self, raw: bytes) -> None:
        pairs = convert_u8_iq(raw)           # float32 interleaved I,Q
        n = (len(pairs) // 2) * 2
        self.ring.write(pairs[:n].reshape(-1, 2))

    # -- TunerController overrides ---------------------------------------

    @TunerController.frequency.setter
    def frequency(self, hz: float) -> None:
        TunerController.frequency.fset(self, hz)
        self.r820t.set_frequency(int(hz))

    @TunerController.sample_rate.setter
    def sample_rate(self, rate: float) -> None:
        actual = self.rtl.set_sample_rate(int(rate))
        self._sample_rate = float(actual)
        self._broadcast(SourceEvent(SourceEventType.SAMPLE_RATE_CHANGE,
                                    float(actual), self.spec.name))

    def start(self) -> None:
        if not self._started:
            self._started = True
            self.streamer.start()
        self._running = True

    def stop(self) -> None:
        self._running = False
        self._started = False
        self._eos.set()
        self.streamer.stop()

    def _read_chunk(self, num_samples: int) -> np.ndarray | None:
        """Block until num_samples are available (live source), drain
        the ring, and surface overflow drops as an event. Returns None
        once stopped AND drained (end of stream)."""
        from .usb import TransferState
        if not self._started:
            self.start()
        out = np.empty(num_samples, np.complex64)
        got = 0
        while got < num_samples:
            pairs = self.ring.read(num_samples - got)   # (n, 2) float32
            if len(pairs):
                n = len(pairs)
                out.view(np.float32).reshape(-1, 2)[got:got + n] = pairs
                got += n
                continue
            if self._eos.is_set() or \
                    self.streamer.processor.state == TransferState.ERROR:
                if self.streamer.processor.state == TransferState.ERROR:
                    self._broadcast(SourceEvent(
                        SourceEventType.ERROR_STATE,
                        "usb transfer error", self.spec.name))
                return out[:got] if got else None
            time.sleep(0.002)       # producer thread owns the cadence
        dropped = self.ring.dropped
        if dropped > self._dropped_total:
            self._dropped_total = dropped
            self._broadcast(SourceEvent(SourceEventType.OVERFLOW,
                                        dropped, self.spec.name))
        return out
