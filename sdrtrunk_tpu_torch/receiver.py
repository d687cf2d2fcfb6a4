"""WidebandReceiver slot bank (port of sdrtrunk_tpu/receiver.py:26-82,
:171-331).

Wideband IQ -> polyphase channelize (all M bins) -> per-slot bin select,
two-bin join and residual mix -> batched decoder chain. Only the parts the
live bank step uses are ported: ``init_state``, ``build_dynamic`` and
``reset_slot``, for the DQPSK chain decoders (P25 Phase 1 C4FM and LSM,
P25 Phase 2, DMR), the analog ones (NBFM, AM) and the analog-trunking ones
(LTR, LTR-Net, Passport, MPT1327).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from . import resolve_device
from .convert import tree_map
from .dsp.channelizer import Channelizer, channelize_core
from .dsp.synthesizer import rot4

__all__ = ["WidebandReceiver", "make_channel_decoder", "dynamic_select_mix"]

_TWO_PI = 2.0 * math.pi


def make_channel_decoder(kind: str, sample_rate: float,
                         channel_bandwidth: float = 12500.0, device="cuda"):
    """Per-channel decoder for a channelizer output stream."""
    if kind == "nbfm":
        from .decoders.nbfm import NBFMConfig, NBFMDecoder
        return NBFMDecoder(NBFMConfig(sample_rate=sample_rate,
                                      bandwidth=channel_bandwidth),
                           device=device)
    if kind == "am":
        from .decoders.am import AMConfig, AMDecoder
        return AMDecoder(AMConfig(sample_rate=sample_rate), device=device)
    if kind in ("c4fm", "p25p1"):
        from .decoders.c4fm import C4FMConfig, C4FMDecoder
        return C4FMDecoder(C4FMConfig(sample_rate=sample_rate), device=device)
    if kind == "dmr":
        from .decoders.dmr import DMRConfig, DMRDecoder
        return DMRDecoder(DMRConfig(sample_rate=sample_rate), device=device)
    if kind in ("lsm", "p25p1-lsm"):
        from .decoders.lsm import LSMConfig, LSMDecoder
        return LSMDecoder(LSMConfig(sample_rate=sample_rate), device=device)
    if kind == "p25p2":
        from .decoders.p25p2 import P25P2Config, P25P2Decoder
        return P25P2Decoder(P25P2Config(sample_rate=sample_rate),
                            device=device)
    if kind in ("ltr", "ltrnet", "passport"):
        from .decoders.ltr import LTRLiveDecoder
        return LTRLiveDecoder(sample_rate, channel_bandwidth, device=device)
    if kind == "mpt1327":
        from .decoders.ltr import MPT1327LiveDecoder
        return MPT1327LiveDecoder(sample_rate, channel_bandwidth,
                                  device=device)
    raise ValueError(f"unknown decoder kind {kind!r}")


def dynamic_select_mix(y: torch.Tensor, rot: torch.Tensor,
                       mixer_phase: torch.Tensor, bins: torch.Tensor,
                       step_rad: torch.Tensor, rot_table: torch.Tensor):
    """Bin select by index, PR two-bin join and residual mix.

    y (K, M) channelizer output; bins (C, 2) [lower, upper] per slot
    (equal for single-bin slots); step_rad (C,) residual mixer step.
    Returns (streams (C, K) complex64, new mixer phase (C,)).
    """
    k = y.shape[0]
    lo = y[:, bins[:, 0]]                                  # (K, C)
    hi = y[:, bins[:, 1]]
    r = rot_table[(rot + torch.arange(k, device=y.device)) % 4][:, None]
    z = r * lo - torch.conj(r) * hi
    streams = torch.where((bins[:, 0] != bins[:, 1])[None, :], z, lo).T
    n = torch.arange(k, dtype=torch.float32, device=y.device)[None, :]
    angles = mixer_phase[:, None] + step_rad[:, None] * n
    streams = streams * torch.complex(torch.cos(angles), -torch.sin(angles))
    new_phase = torch.remainder(mixer_phase + step_rad * k, _TWO_PI)
    return streams, new_phase


class WidebandReceiver(nn.Module):
    """Channelize + demodulate C slots from wideband IQ.

    Buffers: ``channelizer.hmat``, ``decoder.baseband_taps`` and
    ``decoder.demod.bank`` (DQPSK chains) or ``decoder.resampler_taps``
    (analog; under ``decoder.nbfm`` for the analog-trunking decoders,
    beside ``decoder.fsk.taps`` or ``decoder.afsk``'s ``rtaps``,
    ``tone_taps`` and ``avg_taps``); ``.to(device)`` moves them. State is
    a dict in the reference's layout: ``chan`` (T*M,) complex64,
    ``mixer_phase`` (C,), ``rot`` () int32, ``dec`` = the decoder's state
    tree ({fir, agc, power, psk}; NBFM {fir, prev, power, deemph, resamp};
    AM {fir, power, dc, resamp}; LTR family {nbfm, fsk: LTRFSKState};
    MPT1327 {nbfm, afsk: AFSKState}) with a leading C axis.
    """

    def __init__(self, sample_rate: float, channel_offsets,
                 channel_bandwidth: float = 12500.0,
                 taps_per_channel: int = 9, decoder: str = "c4fm",
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.channelizer = Channelizer.design(
            sample_rate, channel_bandwidth, taps_per_channel, device=device)
        self.num_channels = len(channel_offsets)
        self.decoder = make_channel_decoder(
            decoder, self.channelizer.channel_sample_rate,
            channel_bandwidth, device=device)
        self.register_buffer("rot4", rot4(device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.channelizer.hmat.device

    def init_state(self) -> dict:
        c = self.num_channels
        dev = self.device
        dec = tree_map(lambda a: a.expand((c,) + a.shape).clone(),
                       self.decoder.init_state())
        return {
            "chan": self.channelizer.init_state(),
            "mixer_phase": torch.zeros((c,), dtype=torch.float32, device=dev),
            "rot": torch.zeros((), dtype=torch.int32, device=dev),
            "dec": dec,
        }

    def build_dynamic(self):
        """step(x, state, bins (C, 2) int, step_rad (C,) float32) ->
        (outputs, new state). x is (N,) complex64 or (N, 2) float32 I/Q
        pairs. Retuning a slot is a write into ``bins``/``step_rad``."""
        hmat = self.channelizer.hmat
        decode = self.decoder.batched_call
        rot_table = self.rot4

        def step(x, state, bins, step_rad):
            if x.dim() == 2:
                x = torch.view_as_complex(x.to(torch.float32).contiguous())
            chan = state["chan"]
            xp = torch.cat([chan, x.to(torch.complex64)])
            y = channelize_core(xp, hmat)                  # (K, M)
            k = y.shape[0]
            streams, new_phase = dynamic_select_mix(
                y, state["rot"], state["mixer_phase"], bins, step_rad,
                rot_table)
            outputs, dec_state = decode(streams, state["dec"])
            return outputs, {
                "chan": xp[xp.shape[0] - chan.shape[0]:],
                "mixer_phase": new_phase,
                "rot": (state["rot"] + k) % 4,
                "dec": dec_state,
            }

        return step

    def reset_slot(self, state: dict, slot: int) -> dict:
        """Fresh decoder and mixer state for one slot, written IN PLACE
        into ``state``'s tensors (returned for convenience)."""
        dec0 = self.decoder.init_state()

        def write(full, init):
            full[slot] = init

        tree_map(write, state["dec"], dec0)
        state["mixer_phase"][slot] = 0.0
        return state
