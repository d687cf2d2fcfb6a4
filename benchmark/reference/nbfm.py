"""Plain reference of the narrowband FM chain and its judge.

After the channelizer (sdrtrunk's NBFMDecoder at 12.5 kHz): the 63-tap
equiripple baseband low-pass (pass 0.40, stop 0.56 of the bandwidth),
the power squelch (one-pole average of |x|^2, alpha 0.0004, open above
-78 dB), the quadrature discriminator scaled so that half the bandwidth
reads 1, de-emphasis (one pole, tau 750 us, unity gain at 1 kHz, clipped
at 0.95), and the rational resampler to 8 kHz audio, the gate taken at
the nearest earlier sample. The bank's transfer is mu-law 8-bit PCM,
then the gate packed 8 samples a byte, most significant first, each row
padded to a whole byte.
"""
from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

from . import dsp


class Chain:
    """The decoder's constants from the configuration's ``decoder``
    block."""

    def __init__(self, dec: dict, channel_rate: float):
        bw = dec["bandwidth_hz"]
        self.rate = channel_rate
        self.taps = dsp.remez_lowpass(dec["baseband_taps"], bw * 0.40,
                                      bw * 0.56, channel_rate, 0.01, 0.01)
        self.threshold_db = dec["squelch_threshold_db"]
        self.squelch_alpha = dec["squelch_alpha"]
        self.fm_gain = channel_rate / (dsp.TWO_PI * bw / 2.0)
        a = 1.0 - math.exp(-1.0 / (channel_rate * dec["deemphasis_tau_s"]))
        self.deemph_alpha = a
        w = dsp.TWO_PI * 1000.0 / channel_rate
        self.makeup = math.hypot(1.0 - (1.0 - a) * math.cos(w),
                                 (1.0 - a) * math.sin(w)) / a
        frac = Fraction(int(dec["audio_rate"]), int(channel_rate))
        self.up, self.down = frac.numerator, frac.denominator
        self.resampler = dsp.resample_taps(self.up, self.down)

    def audio_len(self, k: int) -> int:
        return k * self.up // self.down


# each leaf of the chain's carried state and how the check measures its
# gap (``check.leaf_gaps``): the filter's history and the squelch power
# over each slot's own level, the discriminator's last sample over the
# largest of the slots', the audio (clipped at 0.95) as it is
STATE = {"fir": "lane", "prev": "leaf", "power": "lane", "deemph": "abs",
         "resamp": "abs"}
# the audio after the discriminator: in a slot of noise alone a phase step
# within rounding of +/-pi reads +pi on one side and -pi on the other
# (2 pi times the gain apart) and the de-emphasis carries the gap for some
# 20 samples, so the check compares these leaves in the slots whose
# squelch is open at the chunk's end (``guard``), where a carrier holds
# the steps far inside +/-pi
GUARDED = ("deemph", "resamp")


def guard(got: dict, want: dict) -> np.ndarray:
    """Per checked slot: whether the reference's squelch is open at the
    chunk's last audio sample."""
    return np.asarray(want["gate"][:, -1], bool)


def fresh(chain: Chain, lanes: int) -> dict:
    """The chain's state before its first sample, per lane."""
    z = np.zeros(lanes)
    return {"fir": np.zeros((lanes, len(chain.taps) - 1), np.complex128),
            "prev": z.astype(np.complex128), "power": z.copy(),
            "deemph": z.copy(),
            "resamp": np.zeros((lanes, len(chain.resampler) // chain.up))}


def decode(chain: Chain, streams: torch.Tensor, state: dict,
           p: dsp.Precision):
    """(L, k) channel streams of one chunk from ``state`` -> ({pcm: mu-law
    codes (L, ka), gate: (L, ka) bool}, the state after the chunk)."""
    f = dsp.fir(streams, chain.taps, state["fir"], p)
    power = dsp.one_pole((f.real ** 2 + f.imag ** 2).cpu().numpy(),
                         chain.squelch_alpha, state["power"], p)
    gate = 10.0 * np.log10(np.maximum(power, 1e-20)) > chain.threshold_db
    prev = torch.as_tensor(state["prev"], device=f.device).to(f.dtype)
    prod = f * torch.conj(torch.cat([prev[:, None], f[:, :-1]], dim=1))
    fm = (torch.atan2(prod.imag, prod.real) * chain.fm_gain).cpu().numpy()
    y = dsp.one_pole(fm, chain.deemph_alpha, state["deemph"], p)
    full = np.clip(y * chain.makeup, -0.95, 0.95)
    audio = dsp.resample(torch.as_tensor(full, device=f.device),
                         chain.resampler, chain.up, chain.down,
                         state["resamp"], p).cpu().numpy()
    idx = np.minimum(np.arange(audio.shape[1]) * chain.down // chain.up,
                     gate.shape[1] - 1)
    tpp = state["resamp"].shape[1]
    ntap = state["fir"].shape[1]
    rows = np.concatenate([state["fir"], streams.cpu().numpy()], axis=1)
    return ({"pcm": mulaw(audio), "gate": gate[:, idx]},
            {"fir": rows[:, rows.shape[1] - ntap:],
             "prev": f[:, -1].cpu().numpy().astype(np.complex128),
             "power": power[:, -1].astype(np.float64),
             "deemph": y[:, -1].astype(np.float64),
             "resamp": full[:, -tpp:].astype(np.float64)})


def mulaw(audio: np.ndarray) -> np.ndarray:
    """mu-law codes (mu = 255) of audio clipped to [-1, 1]: the level
    floor(log1p(255 |a|) / log(256) * 127 + 0.5), 128 added below 0."""
    a = np.clip(audio, -1.0, 1.0)
    level = np.clip(np.floor(np.log1p(255.0 * np.abs(a)) / np.log(256.0)
                             * 127.0 + 0.5), 0, 127).astype(np.int64)
    return (np.where(a < 0, 128, 0) + level).astype(np.uint8)


def symbols(chain: Chain, tier: str, outputs: dict, slots, k: int) -> dict:
    """What the program's bank transfer (mu-law PCM (C, ka) | gate bits
    (C, ceil(ka / 8)) most significant first) says for the checked
    slots."""
    if tier != "bank":
        raise ValueError("the NBFM judge reads the bank tier's transfer")
    ka = chain.audio_len(k)
    c = outputs["slots"]
    buf = outputs["packed_audio"]
    nb = (ka + 7) // 8
    pcm = buf[:c * ka].reshape(c, ka)
    gate = np.unpackbits(buf[c * ka:c * ka + c * nb].reshape(c, nb),
                         axis=1)[:, :ka].astype(bool)
    sel = np.asarray(slots)
    return {"pcm": pcm[sel], "gate": gate[sel]}


def readings(chain: Chain, got: dict, want: dict, want_state: dict) -> dict:
    """Per-lane readings of one checked chunk's outputs: mu-law codes and
    gate bits that differ, and the codes compared."""
    bad = got["pcm"] != want["pcm"]
    return {"pcm_errors": np.count_nonzero(bad, axis=1).tolist(),
            "samples": [got["pcm"].shape[1]] * len(bad),
            "gate_errors": np.count_nonzero(got["gate"] != want["gate"],
                                            axis=1).tolist()}


def expected(chain: Chain, tier: str, decoded: dict, state: dict,
             k: int) -> dict:
    """A reference run's chunk in ``symbols``' form: as decoded."""
    return decoded


def summarize(r: dict) -> dict:
    """The numbers of the outputs' readings: the share of mu-law codes
    that differ (%) and the most gate bits that differ in a lane."""
    return {"pcm_differ_pct": 100.0 * sum(r["pcm_errors"])
            / max(sum(r["samples"]), 1),
            "gate_errors": max(r["gate_errors"], default=0)}
