"""``fm_tone``: narrowband FM of a seeded voice-band tone, one a slot,
drawn within ``tone_hz``, at ``level`` of ``deviation_hz``, from a seeded
phase."""
from __future__ import annotations

import torch

from ...reference import dsp


def make(entry: dict, rows: list, rng, rate: float, samples: int,
         device) -> dict:
    lo, hi = entry["tone_hz"]
    tone = rng.uniform(lo, hi, len(rows))
    return {"rate": rate,
            "tone": torch.as_tensor(tone, device=device),
            "beta": torch.as_tensor(
                entry["level"] * entry["deviation_hz"] / tone, device=device),
            "phi": torch.as_tensor(rng.uniform(0.0, dsp.TWO_PI, len(rows)),
                                   device=device)}


def fill(part: dict, n: torch.Tensor) -> torch.Tensor:
    ph = part["beta"][:, None] * torch.sin(
        dsp.TWO_PI * part["tone"][:, None] * n[None, :] / part["rate"]
        + part["phi"][:, None])
    return torch.polar(torch.ones_like(ph), ph)
