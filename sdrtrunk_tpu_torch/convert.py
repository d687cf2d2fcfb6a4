"""State and parameters carried between the JAX reference and the port.

The system has no learned weights: what stands in for them is the design
arrays (the channelizer's polyphase branches, the baseband FIR taps, the
interpolator bank) and the carried receiver state. Both cross as NumPy.
"""
from __future__ import annotations

import numpy as np
import torch

from .dsp.psk import DQPSKState, GardnerState

__all__ = ["tree_map", "receiver_state_from_numpy", "receiver_state_to_numpy",
           "params_from_numpy"]


_PSK_STATES = {cls._fields: cls for cls in (DQPSKState, GardnerState)}


def tree_map(fn, tree, *rest):
    """Map fn over the leaves of nested dicts / DQPSKStates / GardnerStates
    (the receiver state's structure); ``rest`` are trees of the same
    structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *[r[key] for r in rest])
                for key in tree}
    if isinstance(tree, (DQPSKState, GardnerState)):
        return type(tree)(*[tree_map(fn, *leaves)
                            for leaves in zip(tree, *rest)])
    return fn(tree, *rest)


def receiver_state_from_numpy(tree: dict, device) -> dict:
    """The JAX receiver state as NumPy (``jax.tree.map(np.asarray, state)``
    of ``WidebandReceiver.init_state()``'s structure: chan, mixer_phase,
    rot, dec = {fir, agc, power, psk}) -> the port's tensors on device.
    The psk leaf becomes the state type with the same field names (a
    DQPSKState or a GardnerState)."""
    def leaf(a):
        return torch.as_tensor(np.array(a), device=device)

    dec = tree["dec"]
    psk = dec["psk"]
    return {
        "chan": leaf(tree["chan"]),
        "mixer_phase": leaf(tree["mixer_phase"]),
        "rot": leaf(np.asarray(tree["rot"], np.int32)),
        "dec": {"fir": leaf(dec["fir"]), "agc": leaf(dec["agc"]),
                "power": leaf(dec["power"]),
                "psk": _PSK_STATES[psk._fields](*[leaf(a) for a in psk])},
    }


def receiver_state_to_numpy(state: dict) -> dict:
    """The port's receiver state -> NumPy in the same structure (the psk
    leaf stays a DQPSKState or GardnerState of arrays)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), state)


def params_from_numpy(hmat, baseband_taps, interp_bank) -> dict:
    """Design arrays of the JAX objects (``Channelizer.hmat``, the DQPSK
    chain decoder's ``baseband_taps`` — C4FM, LSM or P25P2 — and its
    demodulator's interpolator ``bank``) as a state dict for
    ``WidebandReceiver.load_state_dict``."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    return {"channelizer.hmat": f32(hmat),
            "decoder.baseband_taps": f32(baseband_taps),
            "decoder.demod.bank": f32(interp_bank)}
