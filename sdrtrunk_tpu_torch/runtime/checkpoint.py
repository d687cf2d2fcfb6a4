"""Carry-state checkpoint and resume for streaming decode chains (port of
sdrtrunk_tpu/runtime/checkpoint.py).

Every decoder and DSP stage carries its state as an explicit tree of
tensors (dicts, tuples and the state named tuples), so a checkpoint is
exact by construction: snapshot the tree, restore it, and chunked decode
continues bit for bit.

Format: one ``.npz`` holding the leaves in the JAX package's flatten
order (dict keys sorted, tuple and named-tuple fields in order) plus a
structure fingerprint. Restoring needs a template state (normally
``decoder.init_state()``) of the same structure; the fingerprint guards
against loading a checkpoint into the wrong decoder or configuration.
The leaves are restored on the template's devices.
"""
from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from ..tree import tree_leaves, tree_structure, tree_unflatten

__all__ = ["state_fingerprint", "save_state", "load_state",
           "StateCheckpointError"]


class StateCheckpointError(ValueError):
    pass


def _host(leaf) -> np.ndarray:
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) \
        else np.asarray(leaf)


def _leaf_spec(leaf) -> list:
    a = _host(leaf)
    return [str(a.dtype), list(a.shape)]


def state_fingerprint(state) -> str:
    """Hash of the tree structure + leaf dtypes/shapes (not values)."""
    desc = json.dumps([tree_structure(state)]
                      + [_leaf_spec(leaf) for leaf in tree_leaves(state)])
    return hashlib.sha256(desc.encode()).hexdigest()[:16]


def save_state(path: str, state, metadata: dict | None = None) -> None:
    """Snapshot a carry-state tree to ``path`` (.npz)."""
    arrays = {f"leaf_{i:04d}": _host(leaf)
              for i, leaf in enumerate(tree_leaves(state))}
    meta = dict(metadata or {})
    meta["fingerprint"] = state_fingerprint(state)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_state(path: str, template):
    """Restore a tree saved by save_state: (state, metadata).

    ``template`` supplies the tree structure and each leaf's device (e.g.
    ``init_state()``); its leaves are replaced by the checkpointed arrays.
    Raises StateCheckpointError on a structure mismatch.
    """
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        t_leaves = tree_leaves(template)
        expected = state_fingerprint(template)
        if meta.get("fingerprint") != expected:
            raise StateCheckpointError(
                f"checkpoint fingerprint {meta.get('fingerprint')} does "
                f"not match template {expected} — wrong decoder/config?")
        keys = sorted(k for k in data.files if k.startswith("leaf_"))
        if len(keys) != len(t_leaves):
            raise StateCheckpointError(
                f"checkpoint has {len(keys)} leaves, template has "
                f"{len(t_leaves)}")
        leaves = [torch.as_tensor(data[k], device=t.device)
                  for k, t in zip(keys, t_leaves)]
    return tree_unflatten(template, leaves), meta
