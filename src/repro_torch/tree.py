"""Nested containers of tensors flattened in the reference's leaf order.

``jax.tree`` flattens a dict by its sorted keys and a tuple or NamedTuple
by position; the port's optimizer and checkpoints keep that order, so a
step written by the reference restores into the port leaf for leaf.
``None`` holds no leaf, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

_LEAF = "leaf"


def flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves in the reference's order, structure for ``unflatten``)."""
    leaves: List[Any] = []

    def walk(t):
        if isinstance(t, dict):
            return dict, tuple((k, walk(t[k])) for k in sorted(t))
        if isinstance(t, (tuple, list)):
            return type(t), tuple(walk(v) for v in t)
        if t is None:
            return None
        leaves.append(t)
        return _LEAF
    return leaves, walk(tree)


def unflatten(structure: Any, leaves) -> Any:
    """The tree of ``structure`` holding ``leaves`` in flattening order."""
    it = iter(leaves)

    def build(s):
        if s is None:
            return None
        if s == _LEAF:
            return next(it)
        kind, children = s
        if kind is dict:
            return {k: build(c) for k, c in children}
        values = [build(c) for c in children]
        if hasattr(kind, "_fields"):            # NamedTuple
            return kind(*values)
        return kind(values)
    out = build(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def map_leaves(fn: Callable, tree: Any) -> Any:
    leaves_, structure = flatten(tree)
    return unflatten(structure, [fn(t) for t in leaves_])


def meta_like(t: torch.Tensor) -> torch.Tensor:
    """A ``meta`` tensor of ``t``'s shape and dtype (no storage)."""
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def eval_shape(fn: Callable, *args, **kwargs) -> Any:
    """``fn(*args, **kwargs)``'s output tree as ``meta`` tensors (the
    counterpart of ``jax.eval_shape``): ``fn`` runs under
    ``FakeTensorMode``, which allocates no storage and draws no number."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        out = fn(*args, **kwargs)
    return map_leaves(meta_like, out)
