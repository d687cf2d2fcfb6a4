"""State and parameters carried between the JAX reference and the port.

The system has no learned weights: what stands in for them is the design
arrays (the channelizer's polyphase branches, the baseband FIR taps, the
interpolator bank, the audio resampler's prototype) and the carried
receiver state. Both cross as NumPy.
"""
from __future__ import annotations

import numpy as np
import torch

from .dsp.afsk import AFSKState
from .dsp.fsk import LTRFSKState
from .dsp.psk import DQPSKState, GardnerState
from .tree import tree_map

__all__ = ["tree_map", "receiver_state_from_numpy", "receiver_state_to_numpy",
           "params_from_numpy", "multibank_params_from_numpy"]


_STATE_TYPES = {cls._fields: cls for cls in (DQPSKState, GardnerState,
                                             LTRFSKState, AFSKState)}


def _from_numpy(tree, device):
    """A NumPy tree -> tensors on device; a named tuple becomes the port's
    state type with the same field names."""
    if isinstance(tree, dict):
        return {key: _from_numpy(v, device) for key, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        leaves = [_from_numpy(v, device) for v in tree]
        fields = getattr(tree, "_fields", None)
        return _STATE_TYPES[fields](*leaves) if fields else tuple(leaves)
    return torch.as_tensor(np.array(tree), device=device)


def receiver_state_from_numpy(tree: dict, device) -> dict:
    """The JAX receiver state as NumPy (``jax.tree.map(np.asarray, state)``
    of ``WidebandReceiver.init_state()``'s structure: chan, mixer_phase,
    rot, dec; or of ``MultibankReceiver.init_state()``'s, where each bank's
    decoder state stands under its key ``b<i>_<kind>`` in place of dec)
    -> the port's tensors on device. ``dec`` (a bank's tree) is any decoder's
    state tree ({fir, agc, power, psk} for the DQPSK chains, {fir, prev,
    power, deemph, resamp} for NBFM, {fir, power, dc, resamp} for AM,
    {nbfm, fsk} for the LTR family, {nbfm, afsk} for MPT1327); a named
    tuple becomes the port's state type with the same field names (a
    DQPSKState, GardnerState, LTRFSKState or AFSKState) and a plain tuple
    stays a tuple."""
    state = _from_numpy(tree, device)
    state["rot"] = state["rot"].to(torch.int32)
    return state


def receiver_state_to_numpy(state: dict) -> dict:
    """The port's receiver state -> NumPy in the same structure (a named
    tuple stays the port's state type, of arrays)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), state)


def params_from_numpy(hmat, baseband_taps, interp_bank=None,
                      resampler_taps=None, nested=None,
                      slicer_taps=None) -> dict:
    """Design arrays of the JAX objects as a state dict for
    ``WidebandReceiver.load_state_dict``: ``Channelizer.hmat``, the
    decoder's ``baseband_taps``, and either the DQPSK chain demodulator's
    interpolator ``bank`` (C4FM, DMR, LSM, P25P2) or the analog decoder's
    ``resampler_taps`` (NBFM, AM). For a decoder that nests an NBFM
    decoder beside a bit slicer with its own taps (LTRLiveDecoder,
    MPT1327LiveDecoder), ``nested`` names the attribute that holds the
    analog decoder ("nbfm") and ``slicer_taps`` maps the slicer's buffers
    to their arrays ({"fsk.taps": ...}, or {"afsk.rtaps": ...,
    "afsk.tone_taps": ..., "afsk.avg_taps": ...})."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    dec = "decoder." + (f"{nested}." if nested else "")
    params = {"channelizer.hmat": f32(hmat),
              dec + "baseband_taps": f32(baseband_taps)}
    if interp_bank is not None:
        params[dec + "demod.bank"] = f32(interp_bank)
    if resampler_taps is not None:
        params[dec + "resampler_taps"] = f32(resampler_taps)
    for name, taps in (slicer_taps or {}).items():
        params["decoder." + name] = f32(taps)
    return params


def multibank_params_from_numpy(hmat, banks: dict) -> dict:
    """Design arrays of a JAX ``MultibankReceiver`` as a state dict for the
    port's ``MultibankReceiver.load_state_dict``: ``banks`` maps each bank
    key (``b<i>_<kind>``) to that decoder's arrays as ``params_from_numpy``
    gives them for a single-bank receiver (their ``decoder.`` names become
    ``decoders.<key>.``); the one ``channelizer.hmat`` is ``hmat``."""
    params = {"channelizer.hmat": torch.as_tensor(np.asarray(hmat,
                                                             np.float32))}
    for key, dec_params in banks.items():
        for name, value in dec_params.items():
            if name.startswith("decoder."):
                params[f"decoders.{key}." + name[len("decoder."):]] = value
    return params
