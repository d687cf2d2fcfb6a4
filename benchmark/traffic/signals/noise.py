"""``noise``: nothing but the channel noise every slot gets."""
from __future__ import annotations


def make(entry: dict, rows: list, rng, rate: float, samples: int,
         device) -> None:
    return None


def fill(part, n) -> None:
    return None
