"""Sharding rules per architecture family (port of
``repro.launch.sharding``), over the port's own ``PSpec``.

Conventions, as in the reference:

* ``dp`` — batch-parallel axes: ('data',) single-pod, ('pod', 'data')
  multi-pod; also the FSDP axis for parameter storage (ZeRO-3 style:
  weights gathered on use);
* ``tp`` — the 'model' axis: tensor-parallel heads / d_ff / experts /
  vocab / embedding-table rows.

A ``PSpec`` holds one entry per tensor dim: ``None`` (replicated), an
axis name, or a tuple of axis names (the dim split over those mesh axes,
major to minor).  ``to_placements`` turns one into DTensor placements on
a ``DeviceMesh``, and ``distribute`` places a tree of tensors by a tree
of specs.  The rules read only a mesh's axis names and sizes, so they run
on a ``mesh.MeshShape`` as well.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

from repro_torch.configs.registry import ARCHS
from repro_torch.launch.mesh import axis_names, axis_sizes, dp_axes


class PSpec(tuple):
    """``PSpec(None, ("pod", "data"), "model")``: one entry per dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PSpec{tuple.__repr__(self)}"


def map_with_path(fn: Callable, tree: Any, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a tree of dicts, tuples, lists and
    NamedTuples; ``path`` is the keys (and NamedTuple field names) from
    the root.  ``None`` stays ``None``; a ``PSpec`` is a leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PSpec):
        return type(tree)(map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

def lm_param_pspec(path, leaf, dp, tp, tp_size) -> PSpec:
    name = path[-1]
    if name == "embed":
        return PSpec(dp, tp)
    if name == "unembed":
        return PSpec(dp, tp)
    if name in ("final_norm", "ln1", "ln2", "q_norm", "k_norm"):
        return PSpec()
    if name in ("wq", "wk", "wv"):
        return PSpec(None, dp, tp)
    if name == "wo":
        return PSpec(None, tp, dp)
    if name == "router":
        return PSpec(None, dp, None)
    if name in ("wg", "wu", "wd"):
        if leaf.ndim == 4:  # MoE (L, E, D, F) / (L, E, F, D)
            e = leaf.shape[1]
            if e % tp_size == 0:
                return PSpec(None, tp, dp, None)   # EP over experts
            return PSpec(None, None, dp, tp)       # few experts: shard D×F
        if name == "wd":                            # dense (L, F, D)
            return PSpec(None, tp, dp)
        return PSpec(None, dp, tp)                  # dense (L, D, F)
    return PSpec()


def gnn_param_pspec(path, leaf, dp, tp, tp_size) -> PSpec:
    # GNN parameters are tiny (≤ a few M) — replicate everything.
    return PSpec()


def recsys_param_pspec(path, leaf, dp, tp, tp_size) -> PSpec:
    if "table" in path:
        return PSpec(tp, None)  # DRHM-permuted rows over the model axis
    return PSpec()              # MLPs are small — replicate


def param_pspecs(arch_id: str, param_tree, mesh) -> Any:
    dp = dp_axes(mesh)
    tp = "model"
    tp_size = axis_sizes(mesh)["model"]
    fam = ARCHS[arch_id].family
    rule = {"lm": lm_param_pspec, "gnn": gnn_param_pspec,
            "recsys": recsys_param_pspec}[fam]
    return map_with_path(lambda path, leaf: rule(path, leaf, dp, tp,
                                                 tp_size), param_tree)


# ---------------------------------------------------------------------------
# Input rules
# ---------------------------------------------------------------------------

def _multi_pod(mesh) -> bool:
    return "pod" in axis_names(mesh)


def lm_input_pspecs(shape, specs, mesh) -> Dict[str, Any]:
    dp = dp_axes(mesh)
    out: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        out["tokens"] = PSpec(dp, None)
        return out
    # decode
    if shape.batch >= 8:
        out["tokens"] = PSpec(dp, None)
        cache_spec = PSpec(None, dp, "model", None, None)  # seq over model
    else:  # long_500k: batch 1 — shard the cache sequence over everything
        out["tokens"] = PSpec(None, None)
        cache_spec = PSpec(None, None, dp + ("model",), None, None)
    out["cache"] = map_with_path(lambda _p, _l: cache_spec, specs["cache"])
    out["cache_index"] = PSpec()
    return out


def gnn_input_pspecs(arch_id, shape, specs, mesh) -> Dict[str, Any]:
    dp = dp_axes(mesh)
    out: Dict[str, Any] = {}
    edge_keys = ("senders", "receivers", "edge_valid", "edge_weight")
    node_keys = ("labels", "label_mask", "species", "graph_ids")
    for k in specs:
        if k in edge_keys:
            out[k] = PSpec(dp)
        elif k in node_keys:
            out[k] = PSpec(dp)
        elif k == "x":
            out[k] = PSpec(dp, None)
        elif k == "pos":
            out[k] = PSpec(dp, None)
        elif k in ("t_in", "t_out", "t_valid"):
            out[k] = PSpec(dp)
        elif k == "targets":
            out[k] = PSpec(dp) if specs[k].shape[0] % (
                2 * 16 if _multi_pod(mesh) else 16) == 0 else PSpec()
        else:
            out[k] = PSpec()
    return out


def recsys_input_pspecs(shape, specs, mesh) -> Dict[str, Any]:
    dp = dp_axes(mesh)
    out: Dict[str, Any] = {}
    batch_shardable = shape.batch % (32 if _multi_pod(mesh) else 16) == 0
    bspec = dp if batch_shardable else None
    for k in specs:
        if k == "dense":
            out[k] = PSpec(bspec, None)
        elif k == "sparse_ids":
            out[k] = PSpec(bspec, None, None)
        elif k == "labels":
            out[k] = PSpec(bspec)
        elif k == "candidates":
            out[k] = PSpec(dp + ("model",), None)
    return out


def input_pspecs(arch_id: str, shape, specs, mesh) -> Dict[str, Any]:
    fam = ARCHS[arch_id].family
    if fam == "lm":
        return lm_input_pspecs(shape, specs, mesh)
    if fam == "gnn":
        return gnn_input_pspecs(arch_id, shape, specs, mesh)
    return recsys_input_pspecs(shape, specs, mesh)


def opt_state_pspecs(param_pspec_tree):
    """AdamW state: step replicated; m/v mirror parameter specs."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(step=PSpec(), m=param_pspec_tree, v=param_pspec_tree)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def to_placements(pspec, mesh) -> tuple:
    """DTensor placements of ``pspec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` on each mesh axis that tensor dim d is split over,
    ``Replicate()`` on the others.  A dim split over several axes lists
    them major to minor, which must be the mesh's own order (DTensor
    splits a dim by its mesh dims left to right)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    placements = [Replicate()] * len(names)
    for d, entry in enumerate(pspec):
        axes = entry_axes(entry)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"{pspec}: dim {d} lists mesh axes {axes} "
                             f"out of the mesh's order {names}")
        for i in dims:
            if placements[i] != Replicate():
                raise ValueError(f"{pspec}: mesh axis {names[i]!r} shards "
                                 "two dims")
            placements[i] = Shard(d)
    return tuple(placements)


def distribute(tree, pspecs, mesh):
    """``tree``'s tensors as DTensors on ``mesh``, each placed by its spec
    in ``pspecs`` (a tree of ``PSpec`` with ``tree``'s structure)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch import tree as T
    leaves, structure = T.flatten(tree)
    specs = spec_leaves(pspecs)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(leaves)} tensors, {len(specs)} specs")
    return T.unflatten(structure, [
        distribute_tensor(t, mesh, to_placements(s, mesh))
        for t, s in zip(leaves, specs)])


def spec_leaves(pspecs) -> list:
    """The ``PSpec`` leaves of a spec tree in ``tree.flatten``'s order
    (dicts by sorted key)."""
    out: list = []

    def walk(t):
        if isinstance(t, PSpec):
            out.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (tuple, list)):
            for v in t:
                walk(v)
        elif t is not None:
            raise TypeError(f"not a spec tree leaf: {t!r}")
    walk(pspecs)
    return out
