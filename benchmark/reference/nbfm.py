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
        self.flip_window = math.ceil(math.log(FLIP_DECAY)
                                     / math.log(1.0 - a))
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
# the audio after the discriminator. Two rounding effects there move
# these leaves of the float32 program far from the reference's, both
# sides sound; each in a slot whose squelch is open, as noise 30 dB down
# keeps it in slots of noise alone too (on an H100, every checked slot of
# the NBFM bank was open at a chunk's end, and every such gap was in a
# slot of noise alone):
# * a step within rounding of +/-pi reads +pi on one side and -pi on the
#   other, 2 pi times the gain apart, and the de-emphasis carries the gap
#   on, shrinking it by 1 - alpha a sample: set aside where a reference
#   step lies within FLIP_RADIUS of +/-pi (the program flipped steps
#   within 3e-5 of it) over the chunk's last ``Chain.flip_window``
#   samples, the span over which the de-emphasis shrinks the jump to
#   FLIP_DECAY of itself (260 samples at 25 kHz, tau 750 us);
# * where the filtered stream passes near zero, its angle there rests on
#   the float32 sums' last bits (5e-3 rad apart at 5e-4 and 1.3e-3 of the
#   slot's rms); that sample's step and the next carry the error with
#   opposite signs, so the de-emphasis cancels it but for alpha squared,
#   and only the resampler's history keeps it, one sample each: set aside
#   where the magnitude falls below DIP_FLOOR of the slot's rms over the
#   chunk at the history's samples or the one before them.
# A slot with a carrier comes near neither (its magnitude stays above 0.8
# of its rms), and a slot set aside is still held by its mu-law codes, its
# gate and its other leaves.
GUARDED = ("deemph", "resamp")
FLIP_RADIUS = 1e-3
FLIP_DECAY = 1e-6
DIP_FLOOR = 0.02


def guard(got: dict, want: dict) -> np.ndarray:
    """Per checked slot: whether the reference's squelch is open at the
    chunk's last audio sample and its discriminator is well conditioned
    near the chunk's end (``decode``'s ``unsure``)."""
    return np.asarray(want["gate"][:, -1], bool) & ~want["unsure"]


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
    codes (L, ka), gate: (L, ka) bool, unsure: (L,) bool, a discriminator
    step near +/-pi or a magnitude near zero at the chunk's end
    (``guard``)}, the state after the chunk)."""
    f = dsp.fir(streams, chain.taps, state["fir"], p)
    power = dsp.one_pole((f.real ** 2 + f.imag ** 2).cpu().numpy(),
                         chain.squelch_alpha, state["power"], p)
    gate = 10.0 * np.log10(np.maximum(power, 1e-20)) > chain.threshold_db
    prev = torch.as_tensor(state["prev"], device=f.device).to(f.dtype)
    prod = f * torch.conj(torch.cat([prev[:, None], f[:, :-1]], dim=1))
    step = torch.atan2(prod.imag, prod.real).cpu().numpy()
    amp = torch.abs(f).cpu().numpy()
    rms = np.sqrt((amp ** 2).mean(axis=1, keepdims=True))
    tpp = state["resamp"].shape[1]
    unsure = (np.pi - np.abs(step[:, -chain.flip_window:])
              < FLIP_RADIUS).any(axis=1) \
        | (amp[:, -(tpp + 1):] < DIP_FLOOR * rms).any(axis=1)
    fm = step * chain.fm_gain
    y = dsp.one_pole(fm, chain.deemph_alpha, state["deemph"], p)
    full = np.clip(y * chain.makeup, -0.95, 0.95)
    audio = dsp.resample(torch.as_tensor(full, device=f.device),
                         chain.resampler, chain.up, chain.down,
                         state["resamp"], p).cpu().numpy()
    idx = np.minimum(np.arange(audio.shape[1]) * chain.down // chain.up,
                     gate.shape[1] - 1)
    ntap = state["fir"].shape[1]
    rows = np.concatenate([state["fir"], streams.cpu().numpy()], axis=1)
    return ({"pcm": mulaw(audio), "gate": gate[:, idx], "unsure": unsure},
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
    gate bits that differ, the codes compared, and whether ``guard`` set
    the lane's audio leaves aside for its discriminator alone."""
    bad = got["pcm"] != want["pcm"]
    return {"pcm_errors": np.count_nonzero(bad, axis=1).tolist(),
            "samples": [got["pcm"].shape[1]] * len(bad),
            "gate_errors": np.count_nonzero(got["gate"] != want["gate"],
                                            axis=1).tolist(),
            "set_aside": (want["gate"][:, -1] & want["unsure"]).tolist()}


def expected(chain: Chain, tier: str, decoded: dict, state: dict,
             k: int) -> dict:
    """A reference run's chunk in ``symbols``' form: as decoded."""
    return decoded


def summarize(r: dict) -> dict:
    """The numbers of the outputs' readings: the share of mu-law codes
    that differ (%), the most gate bits that differ in a lane, and (read,
    not compared) the checked lanes and those ``guard`` set aside for
    their discriminator."""
    return {"pcm_differ_pct": 100.0 * sum(r["pcm_errors"])
            / max(sum(r["samples"]), 1),
            "gate_errors": max(r["gate_errors"], default=0),
            "lanes_checked": len(r["set_aside"]),
            "lanes_set_aside": int(sum(r["set_aside"]))}
