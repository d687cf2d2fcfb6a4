"""Decode metrics + tuner frequency-error auto-correction.

Roles of the reference's per-channel observability pieces (SURVEY.md §5
metrics note): sync/frame counters with corrected-bit-error totals (the
BER surface the reference lacks but its bit_errors fields enable), and
the CostasLoop per-second PLL frequency-error broadcast
(dsp/psk/pll/CostasLoop.java:205-218) feeding automatic tuner PPM
correction (source/tuner/FrequencyErrorCorrectionManager.java:32-143).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["ChannelMetrics", "FrequencyErrorMonitor"]


@dataclass
class ChannelMetrics:
    """Per-channel decode quality counters, updated by the host framing
    layer (frames carry the EDAC-corrected bit counts)."""
    dibits: int = 0
    frames: int = 0
    valid_frames: int = 0
    corrected_bits: int = 0
    unknown_opcodes: int = 0   # messages whose opcode had no named
    #  structure (coverage gauge; content classes expose .known)

    def update(self, n_dibits: int, frames) -> None:
        self.dibits += int(n_dibits)
        for f in frames:
            self.frames += 1
            self.corrected_bits += int(getattr(f, "bit_errors", 0))

    def message(self, valid: bool) -> None:
        if valid:
            self.valid_frames += 1

    def content(self, content) -> None:
        """Track opcode coverage for control-message contents."""
        if content is not None \
                and getattr(content, "known", True) is False:
            self.unknown_opcodes += 1

    @property
    def sync_rate(self) -> float:
        """Frames per 1000 dibits — a sync-acquisition health measure."""
        return 1000.0 * self.frames / self.dibits if self.dibits else 0.0

    @property
    def corrected_ber(self) -> float:
        """Corrected channel bits per decoded payload bit (lower bound on
        raw BER; exact when EDAC fully corrects)."""
        return (self.corrected_bits / (2.0 * self.dibits)
                if self.dibits else 0.0)

    def as_dict(self) -> dict:
        return {"dibits": self.dibits, "frames": self.frames,
                "valid_frames": self.valid_frames,
                "corrected_bits": self.corrected_bits,
                "sync_rate": round(self.sync_rate, 3),
                "corrected_ber": round(self.corrected_ber, 6)}


class FrequencyErrorMonitor:
    """PPM auto-correction (FrequencyErrorCorrectionManager.java:32-143).

    Feed per-update PLL frequency error measurements in Hz (the
    CostasLoop broadcast: error_hz = fs/(2*pi) * loop_frequency at the
    channel rate); when |error| exceeds `threshold_ppm` of the RF
    frequency with the SAME POLARITY for a full `observation_seconds`
    window, `on_correct(ppm)` fires with the correction to subtract and
    the monitor resets. Opposite-polarity readings restart the window,
    exactly like the reference's timer logic.

    Time is the caller's clock (the orchestrator's sample clock — the
    reference uses wall time, which is the same thing for a live tuner).
    """

    def __init__(self, frequency_hz: float, threshold_ppm: float = 0.4,
                 observation_seconds: float = 30.0, on_correct=None):
        if frequency_hz <= 0:
            raise ValueError("need a positive RF frequency for ppm")
        self.frequency_hz = frequency_hz
        self.threshold_ppm = threshold_ppm
        self.observation_seconds = observation_seconds
        self.on_correct = on_correct
        self.applied_ppm = 0.0
        self.corrections: list[tuple[float, float]] = []
        self._window_start: float | None = None
        self._ppm_required = 0.0

    def reset(self) -> None:
        self._window_start = None
        self._ppm_required = 0.0

    def update(self, error_hz: float, now: float) -> None:
        ppm = 1e6 * error_hz / self.frequency_hz
        if abs(ppm) <= self.threshold_ppm:
            return
        same_polarity = (self._ppm_required > 0) == (ppm > 0)
        if self._window_start is None or not same_polarity:
            self._window_start = now
            self._ppm_required = ppm
            return
        self._ppm_required = ppm
        if now >= self._window_start + self.observation_seconds:
            self._apply(ppm, now)

    def _apply(self, ppm: float, now: float) -> None:
        self.applied_ppm -= ppm
        self.corrections.append((now, -ppm))
        if self.on_correct is not None:
            self.on_correct(ppm)
        self.reset()

    @property
    def correction_hz(self) -> float:
        """Current total correction in Hz at the monitored frequency."""
        return self.applied_ppm * self.frequency_hz / 1e6
