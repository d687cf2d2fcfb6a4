"""WidebandReceiver and MultibankReceiver slot banks (port of
sdrtrunk_tpu/receiver.py:26-168, :171-331).

Wideband IQ -> polyphase channelize (all M bins) -> per-slot bin select,
two-bin join and residual mix -> batched decoder chain(s), for the DQPSK
chain decoders (P25 Phase 1 C4FM and LSM, P25 Phase 2, DMR), the analog
ones (NBFM, AM) and the analog-trunking ones (LTR, LTR-Net, Passport,
MPT1327). ``WidebandReceiver.build_dynamic`` takes the slot plan as data
on every call (the live step); ``build`` fixes a channel plan at
construction and runs the same step over it. ``MultibankReceiver`` runs
several decoders side by side, each over its own slice of the slot axis,
behind one channelizer pass. The reference's ``build_safe`` and
``build_dynamic_safe`` (complex-safe wrappers for the TPU backend) are
not ported.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from . import resolve_device
from .dsp.channelizer import Channelizer, channelize_core
from .dsp.extract import plan_channels
from .dsp.synthesizer import rot4
from .runtime import tracing
from .tree import tree_map

__all__ = ["MultibankReceiver", "WidebandReceiver", "dynamic_select_mix",
           "make_channel_decoder"]

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


def _channelize_select(x, state: dict, hmat: torch.Tensor, bins, step_rad,
                       rot_table: torch.Tensor):
    """The front both receivers share: channelize x ((N,) complex64 or (N,
    2) float32 I/Q pairs) behind the carried history, then select, join
    and mix every slot. Returns (streams (C, K) complex64, the new
    ``chan``, ``mixer_phase`` and ``rot`` entries)."""
    with tracing.span("step.channelize"):
        if x.dim() == 2:
            x = torch.view_as_complex(x.to(torch.float32).contiguous())
        chan = state["chan"]
        xp = torch.cat([chan, x.to(torch.complex64)])
        y = channelize_core(xp, hmat)                      # (K, M)
    k = y.shape[0]
    with tracing.span("step.select_mix"):
        streams, new_phase = dynamic_select_mix(
            y, state["rot"], state["mixer_phase"], bins, step_rad, rot_table)
    return streams, {"chan": xp[xp.shape[0] - chan.shape[0]:],
                     "mixer_phase": new_phase,
                     "rot": (state["rot"] + k) % 4}


def _write_row(tree, init, row: int) -> None:
    """Write one slot's state tree `init` into row `row` of `tree`'s
    tensors, in place."""
    def write(full, one):
        full[row] = one

    tree_map(write, tree, init)


class _SlotReceiver(nn.Module):
    """What both receivers hold: the channelizer, the two-bin join's rot4
    table and the slot front's state (``chan``, ``mixer_phase``, ``rot``)."""

    def __init__(self, sample_rate: float, channel_bandwidth: float,
                 taps_per_channel: int, device):
        super().__init__()
        self.channelizer = Channelizer.design(
            sample_rate, channel_bandwidth, taps_per_channel, device=device)
        self.register_buffer("rot4", rot4(device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.channelizer.hmat.device

    def _front_state(self, slots: int) -> dict:
        dev = self.device
        return {
            "chan": self.channelizer.init_state(),
            "mixer_phase": torch.zeros((slots,), dtype=torch.float32,
                                       device=dev),
            "rot": torch.zeros((), dtype=torch.int32, device=dev),
        }


class WidebandReceiver(_SlotReceiver):
    """Channelize + demodulate C channels from wideband IQ.

    ``plan`` (``dsp/extract.py::plan_channels`` of the offsets and
    ``channel_bandwidths``) maps each channel to its bin, or, for a
    channel wider than one bin, to the adjacent pair joined by the
    two-bin synthesizer; ``num_channels`` is its count. ``decoder`` is a
    kind (``make_channel_decoder``) or a decoder object with
    ``init_state`` and ``batched_call``.

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
                 taps_per_channel: int = 9, decoder="nbfm",
                 channel_bandwidths=None, device="cuda"):
        device = resolve_device(device)
        super().__init__(sample_rate, channel_bandwidth, taps_per_channel,
                         device)
        self.plan = plan_channels(self.channelizer, channel_offsets,
                                  channel_bandwidths)
        if isinstance(decoder, str):
            decoder = make_channel_decoder(
                decoder, self.channelizer.channel_sample_rate,
                channel_bandwidth, device=device)
        self.decoder = decoder

    @property
    def num_channels(self) -> int:
        return self.plan.count

    def init_state(self) -> dict:
        c = self.num_channels
        dec = tree_map(lambda a: a.expand((c,) + a.shape).clone(),
                       self.decoder.init_state())
        return {**self._front_state(c), "dec": dec}

    def build(self):
        """step(x, state) -> (outputs, new state) over ``plan``: the
        plan's bins (a single-bin channel takes its bin, a wide one the
        two-bin join) and residual mixer steps fixed here, then
        ``build_dynamic``'s step. x is (N,) complex64 or (N, 2) float32
        I/Q pairs."""
        plan = self.plan
        bins = torch.as_tensor(plan.bins, device=self.device)
        step_rad = torch.as_tensor(
            (2.0 * np.pi * plan.offsets / plan.rate).astype(np.float32),
            device=self.device)
        dynamic = self.build_dynamic()

        def step(x, state):
            return dynamic(x, state, bins, step_rad)

        return step

    def build_dynamic(self):
        """step(x, state, bins (C, 2) int, step_rad (C,) float32) ->
        (outputs, new state). x is (N,) complex64 or (N, 2) float32 I/Q
        pairs. Retuning a slot is a write into ``bins``/``step_rad``."""
        hmat = self.channelizer.hmat
        decode = self.decoder.batched_call
        rot_table = self.rot4

        def step(x, state, bins, step_rad):
            streams, new_state = _channelize_select(x, state, hmat, bins,
                                                    step_rad, rot_table)
            outputs, new_state["dec"] = decode(streams, state["dec"])
            return outputs, new_state

        return step

    def reset_slot(self, state: dict, slot: int) -> dict:
        """Fresh decoder and mixer state for one slot, written IN PLACE
        into ``state``'s tensors (returned for convenience)."""
        _write_row(state["dec"], self.decoder.init_state(), slot)
        state["mixer_phase"][slot] = 0.0
        return state


class MultibankReceiver(_SlotReceiver):
    """Heterogeneous slot banks behind one channelizer: each bank runs its
    own decoder kind over its slice of the slot axis (reference
    receiver.py:85-168).

    banks: ordered [(kind, n_slots), ...]; the slot index is bank-major.
    Each bank's decoder is the submodule ``decoders[key]`` under its key
    ``b<i>_<kind>``, so ``.to(device)`` moves its buffers and the state
    dict names them ``decoders.<key>.<buffer>``. State is a dict: ``chan``,
    ``mixer_phase`` (over all slots), ``rot`` and, under each bank's key,
    that decoder's state tree with a leading axis of the bank's slots.
    """

    def __init__(self, sample_rate: float, banks,
                 channel_bandwidth: float = 12500.0,
                 taps_per_channel: int = 9, device="cuda"):
        device = resolve_device(device)
        super().__init__(sample_rate, channel_bandwidth, taps_per_channel,
                         device)
        rate = self.channelizer.channel_sample_rate
        self.decoders = nn.ModuleDict()
        self.banks = []
        for i, (kind, n) in enumerate(banks):
            key = f"b{i}_{kind}"
            self.decoders[key] = make_channel_decoder(
                kind, rate, channel_bandwidth, device=device)
            self.banks.append((key, kind, int(n), self.decoders[key]))
        self.num_slots = sum(n for _, _, n, _ in self.banks)

    def decoder_for(self, key: str):
        return self.decoders[key]

    def slot_key(self, index: int) -> tuple[str, int]:
        """Global slot index -> (bank key, index within the bank)."""
        off = 0
        for key, _, n, _ in self.banks:
            if index < off + n:
                return key, index - off
            off += n
        raise IndexError(index)

    def init_state(self) -> dict:
        state = self._front_state(self.num_slots)
        for key, _, n, dec in self.banks:
            state[key] = tree_map(lambda a, n=n: a.expand((n,) + a.shape)
                                  .clone(), dec.init_state())
        return state

    def build_dynamic(self):
        """step(x, state, bins (C, 2), step_rad (C,)) -> ({bank key:
        outputs}, new state): one channelizer pass and slot select for all
        C slots, then each bank's ``batched_call`` over its rows."""
        hmat = self.channelizer.hmat
        rot_table = self.rot4
        banks = self.banks

        def step(x, state, bins, step_rad):
            streams, new_state = _channelize_select(x, state, hmat, bins,
                                                    step_rad, rot_table)
            outputs = {}
            off = 0
            for key, _, n, dec in banks:
                outputs[key], new_state[key] = dec.batched_call(
                    streams[off:off + n], state[key])
                off += n
            return outputs, new_state

        return step

    def reset_slot(self, state: dict, slot: int) -> dict:
        """Fresh decoder and mixer state for one slot, written IN PLACE
        into its bank's tensors (returned for convenience)."""
        key, local = self.slot_key(slot)
        _write_row(state[key], self.decoders[key].init_state(), local)
        state["mixer_phase"][slot] = 0.0
        return state
