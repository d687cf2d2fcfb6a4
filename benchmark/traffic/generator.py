"""The one traffic generator: a mix file (``traffic/<name>.json``) and a
configuration give a replay set of int8 wideband chunks, made from the
seed.

A mix places ``slots`` channels on the configuration's bin grid
("all": every usable bin, lowest first, as a full bank; "spread": evenly
over the span) and gives each slot a signal from its ``signals`` list.
An entry's ``signal`` names its kind, the module ``signals/<kind>.py``
(the contract is in ``signals/__init__.py``), which makes the slots'
baseband; a new kind is a new module there.

An entry takes ``count`` slots (the first free ones), a seeded ``share``
of the free ones, or the ``rest``. Every slot gets a seeded carrier offset
within +/-``carrier_offset_hz``, a seeded phase and white noise at
``snr_db`` below a unit carrier. The synthesis bank (the exact dual of an
M/2 polyphase channelizer over the configuration's prototype, designed
again in ``reference/dsp.py``) multiplexes the slots into one wideband
stream of ``replay_chunks`` chunks of ``chunk_blocks`` x M samples,
filter state carried across the chunk seams; the whole set is scaled to
a peak of ``peak`` and rounded to int8 I/Q pairs, the capture format.
Random draws come from NumPy (per-slot parameters) and one seeded
``torch.Generator`` on the device (the noise), so one seed gives one set
of bytes on one device type.
"""
from __future__ import annotations

import importlib
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..reference import dsp

HERE = Path(__file__).resolve().parent


@dataclass
class Replay:
    """A replay set: int8 (n, 2) chunks in order, and the slots' baseband
    offsets, bins and residual mixer steps (0: every slot sits at its
    bin's centre)."""
    chunks: list
    offsets_hz: np.ndarray
    bins: np.ndarray
    step_rad: np.ndarray
    chunk_samples: int
    channel_samples: int


def read_dibits(name: str) -> np.ndarray:
    """A dibit sequence from a data file beside the mixes: one digit
    0-3 a dibit."""
    text = (HERE / name).read_text().strip()
    return np.frombuffer(text.encode(), np.uint8) - ord("0")


def signal_kind(name: str):
    """The module of a signal kind, ``signals/<name>.py``."""
    path = HERE / "signals" / f"{name}.py"
    full = f"{__package__}.signals.{name}"
    if not name.isidentifier():
        raise ValueError(f"unknown signal {name!r}: no {path}")
    try:
        return importlib.import_module(full)
    except ModuleNotFoundError as e:
        if e.name != full:
            raise
        raise ValueError(f"unknown signal {name!r}: no {path}") from None


def slot_offsets(config: dict, mix: dict) -> np.ndarray:
    """Baseband offsets of the mix's slots on the configuration's grid."""
    m = config["channels"]
    spacing = config["sample_rate_hz"] / m
    slots = mix["slots"]
    if slots > m - 1:
        raise ValueError(f"{slots} slots on {m - 1} usable bins")
    if mix["placement"] == "all":
        pos = np.arange(slots)
    elif mix["placement"] == "spread":
        pos = np.round(np.linspace(0, m - 2, slots)).astype(np.int64)
    else:
        raise ValueError(f"unknown placement {mix['placement']!r}")
    return (pos - m // 2 + 1) * spacing


def assign(mix: dict, rng: np.random.Generator) -> list:
    """The index of each slot's entry in ``signals``."""
    slots = mix["slots"]
    owner = [-1] * slots
    free = list(range(slots))
    entries = list(enumerate(mix["signals"]))
    for key in ("count", "share", "rest"):
        for i, e in entries:
            if key not in e:
                continue
            if key == "count":
                take = free[:e["count"]]
            elif key == "share":
                n = int(round(e["share"] * slots))
                take = sorted(rng.choice(free, n, replace=False).tolist())
            else:
                take = list(free)
            for s in take:
                owner[s] = i
            free = [s for s in free if s not in set(take)]
    if free:
        raise ValueError(f"slots {free[:5]}... carry no signal")
    return owner


class _Rows:
    """Each slot's complex baseband, chunk by chunk, on the device."""

    def __init__(self, config: dict, mix: dict, rng, owner, k: int, device):
        self.rate = 2.0 * config["sample_rate_hz"] / config["channels"]
        self.k = k
        self.device = device
        slots = mix["slots"]
        chunks = mix["replay_chunks"]
        off = mix.get("carrier_offset_hz", 0.0)
        self.freq = rng.uniform(-off, off, slots)
        self.theta = rng.uniform(0.0, dsp.TWO_PI, slots)
        self.parts = []
        for i, e in enumerate(mix["signals"]):
            rows = [s for s in range(slots) if owner[s] == i]
            if not rows:
                continue
            kind = signal_kind(e["signal"])
            self.parts.append((kind, rows, kind.make(
                e, rows, rng, self.rate, chunks * k, device)))
        self.noise = 10.0 ** (-mix["snr_db"] / 20.0) / math.sqrt(2.0)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(mix["seed"]) % (2 ** 63))
        self.slots = slots

    def chunk(self, j: int) -> torch.Tensor:
        """(slots, k) complex128 rows of chunk j."""
        dev = self.device
        n = j * self.k + torch.arange(self.k, device=dev, dtype=torch.float64)
        rows = torch.zeros((self.slots, self.k), dtype=torch.complex128,
                           device=dev)
        for kind, idx, part in self.parts:
            v = kind.fill(part, n)
            if v is not None:
                rows[torch.as_tensor(idx, device=dev)] = v
        freq = torch.as_tensor(self.freq, device=dev)[:, None]
        theta = torch.as_tensor(self.theta, device=dev)[:, None]
        turn = torch.remainder(dsp.TWO_PI * freq * n[None, :] / self.rate
                               + theta, dsp.TWO_PI)
        rows = rows * torch.polar(torch.ones_like(turn), turn)
        noise = torch.randn((2, self.slots, self.k), generator=self.gen,
                            device=dev, dtype=torch.float64) * self.noise
        return rows + torch.complex(noise[0], noise[1])


def synthesize(u: torch.Tensor, hmat: torch.Tensor) -> torch.Tensor:
    """The M/2 polyphase synthesis bank: (K, M) per-bin streams at the
    channel rate -> (K M / 2 + (2T - 1) M / 2,) wideband samples, the
    overlap-add tail kept; analysis of the result returns u delayed by
    T - 1 blocks at about unit gain."""
    t, m = hmat.shape
    k = u.shape[0]
    half = m // 2
    v = torch.fft.ifft(u.to(torch.complex64), dim=1) * (m * (m / 2.0))
    odd = (torch.arange(k, device=u.device) & 1)[:, None] == 1
    v = torch.where(odd, torch.roll(v, -half, dims=1), v)
    g = hmat.reshape(-1).to(torch.float32)
    acc = torch.zeros((k + 2 * t, half), dtype=torch.complex128,
                      device=u.device)
    for b in range(2 * t):
        lo = (b % 2) * half
        acc[b:b + k] += v[:, lo:lo + half] * g[b * half:(b + 1) * half]
    return acc.reshape(-1)


def build(config: dict, mix: dict, seed: int, device) -> Replay:
    """The replay set of a mix under a configuration, from the seed."""
    mix = {**mix, "seed": seed}
    rng = np.random.default_rng(seed)
    m = config["channels"]
    fs = config["sample_rate_hz"]
    spacing = fs / m
    chunk = m * mix["chunk_blocks"]
    k = 2 * chunk // m
    offsets = slot_offsets(config, mix)
    bins = np.round(offsets / spacing).astype(np.int64) % m
    owner = assign(mix, rng)
    rows = _Rows(config, mix, rng, owner, k, device)
    hmat = torch.as_tensor(dsp.channelizer_prototype(
        m, config["taps_per_branch"]).reshape(-1, m), device=device)
    pad = 2 * hmat.shape[0]
    half = m // 2
    sel = torch.as_tensor(bins, device=device)
    tail = torch.zeros((pad, m), dtype=torch.complex64, device=device)
    xs = []
    for j in range(mix["replay_chunks"]):
        u = torch.zeros((pad + k, m), dtype=torch.complex64, device=device)
        u[:pad] = tail
        u[pad:, sel] = rows.chunk(j).T.to(torch.complex64)
        tail = u[-pad:].clone()
        xs.append(synthesize(u, hmat)[pad * half:pad * half + chunk])
    peak = max(float(torch.view_as_real(x).abs().max()) for x in xs)
    scale = mix["peak"] / peak
    chunks = [torch.clamp(torch.round(torch.view_as_real(x) * scale),
                          -127, 127).to(torch.int8).cpu().numpy()
              for x in xs]
    return Replay(chunks, offsets, bins, np.zeros(len(offsets)), chunk, k)
