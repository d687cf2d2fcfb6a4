"""The port's state trees: nested dicts, tuples and the state named tuples
(``DQPSKState``, ``GardnerState``, ``LTRFSKState``, ``AFSKState``) whose
leaves are tensors. The JAX package carries the same structures as
pytrees; this module gives them the few tree operations the port needs.
"""
from __future__ import annotations

__all__ = ["tree_map", "tree_leaves", "tree_unflatten", "tree_structure",
           "per_channel"]


def tree_map(fn, tree, *rest):
    """Map fn over the leaves of nested dicts, tuples and named tuples;
    ``rest`` are trees of the same structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *[r[key] for r in rest])
                for key in tree}
    if isinstance(tree, tuple):
        leaves = [tree_map(fn, *leaves) for leaves in zip(tree, *rest)]
        return type(tree)(*leaves) if hasattr(tree, "_fields") \
            else tuple(leaves)
    return fn(tree, *rest)


def _children(tree):
    """A node's children in ``jax.tree_util``'s order (dict keys sorted,
    tuple and named-tuple fields in order), or None for a leaf."""
    if isinstance(tree, dict):
        return [tree[key] for key in sorted(tree)]
    if isinstance(tree, tuple):
        return list(tree)
    return None


def tree_leaves(tree) -> list:
    """The leaves in ``jax.tree_util.tree_flatten``'s order."""
    children = _children(tree)
    if children is None:
        return [tree]
    return [leaf for child in children for leaf in tree_leaves(child)]


def tree_unflatten(template, leaves):
    """``template``'s structure with its leaves replaced, in
    ``tree_leaves`` order, by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {key: build(node[key]) for key in sorted(node)}
            return {key: built[key] for key in node}
        if isinstance(node, tuple):
            children = [build(v) for v in node]
            return type(node)(*children) if hasattr(node, "_fields") \
                else tuple(children)
        return next(it)

    return build(template)


def tree_structure(tree) -> str:
    """The structure as text (dict keys, named-tuple types and fields,
    tuple arity), leaves as ``*``."""
    if isinstance(tree, dict):
        return "{" + ",".join(f"{key!r}:{tree_structure(tree[key])}"
                              for key in sorted(tree)) + "}"
    if hasattr(tree, "_fields"):
        return type(tree).__name__ + "(" + ",".join(
            f"{field}={tree_structure(v)}"
            for field, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, tuple):
        return "(" + ",".join(map(tree_structure, tree)) + ")"
    return "*"


def per_channel(batched, x, state):
    """One channel through a call batched over channels: the 1-D block x
    and each leaf of ``state`` (no channel axis, the layout ``init_state``
    returns) gain a leading axis of 1, ``batched`` runs, and every tensor
    of its result loses that axis again. On a CUDA tensor the batched call
    launches its kernel at C = 1, as it would at any C."""
    result = batched(x[None], tree_map(lambda a: a[None], state))
    return tree_map(lambda a: a[0], result)
