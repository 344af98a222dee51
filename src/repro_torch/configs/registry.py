"""Architecture registry (port of ``repro.configs.registry``): id →
family, config module and, for a GNN, its kind: ``conv`` (gcn/gat, node
features on a graph) or ``geom`` (schnet/dimenet, species and positions);
each family's shape set, the 40 (arch, shape) cells, and each cell's
inputs as ``meta`` tensors with its statics (``input_specs``: shapes and
dtypes without storage, what the dry run distributes).  Every arch of the
reference is ported; ``NOT_PORTED`` would list an arch still queued, with
the ROADMAP item that ports it, and asking for one raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Iterator, Tuple

import torch

from repro_torch.configs import shapes as S

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    family: str           # "lm" | "gnn" | "recsys"
    module: str
    gnn_kind: str = ""    # "" | "conv" (gcn/gat) | "geom" (schnet/dimenet)


ARCHS: Dict[str, ArchEntry] = {
    "llama4-maverick-400b-a17b": ArchEntry(
        "llama4-maverick-400b-a17b", "lm",
        "repro_torch.configs.llama4_maverick_400b_a17b"),
    "grok-1-314b": ArchEntry("grok-1-314b", "lm",
                             "repro_torch.configs.grok_1_314b"),
    "gemma-7b": ArchEntry("gemma-7b", "lm", "repro_torch.configs.gemma_7b"),
    "qwen3-0.6b": ArchEntry("qwen3-0.6b", "lm",
                            "repro_torch.configs.qwen3_0_6b"),
    "deepseek-67b": ArchEntry("deepseek-67b", "lm",
                              "repro_torch.configs.deepseek_67b"),
    "schnet": ArchEntry("schnet", "gnn", "repro_torch.configs.schnet",
                        "geom"),
    "gcn-cora": ArchEntry("gcn-cora", "gnn", "repro_torch.configs.gcn_cora",
                          "conv"),
    "dimenet": ArchEntry("dimenet", "gnn", "repro_torch.configs.dimenet",
                         "geom"),
    "gat-cora": ArchEntry("gat-cora", "gnn", "repro_torch.configs.gat_cora",
                          "conv"),
    "dlrm-rm2": ArchEntry("dlrm-rm2", "recsys",
                          "repro_torch.configs.dlrm_rm2"),
}

# the reference's archs that the port does not have yet → ROADMAP item
NOT_PORTED: Dict[str, str] = {}


def entry(arch_id: str) -> ArchEntry:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ROADMAP queue "
            f"{NOT_PORTED[arch_id]}); ported: {sorted(ARCHS)}")
    try:
        return ARCHS[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; ported: "
                       f"{sorted(ARCHS)}") from None


def shapes_for(arch_id: str) -> Dict[str, Any]:
    fam = entry(arch_id).family
    return {"lm": S.LM_SHAPES, "gnn": S.GNN_SHAPES,
            "recsys": S.RECSYS_SHAPES}[fam]


def all_cells() -> Iterator[Tuple[str, str]]:
    """All 40 (arch, shape) cells, in the reference's order."""
    for arch_id in ARCHS:
        for shape_name in shapes_for(arch_id):
            yield arch_id, shape_name


def get_config(arch_id: str, reduced: bool = False, shape=None):
    """The FULL (or reduced) config; a conv GNN at a full ``shape`` takes
    its input width and class count from the shape's dataset."""
    mod = importlib.import_module(entry(arch_id).module)
    cfg = mod.reduced() if reduced else mod.FULL
    if ARCHS[arch_id].gnn_kind == "conv" and shape is not None \
            and not reduced:
        cfg = dataclasses.replace(cfg, d_in=shape.d_feat,
                                  n_classes=shape.n_classes)
    return cfg


# ---------------------------------------------------------------------------
# Input specs (meta tensors: shapes and dtypes, no storage)
# ---------------------------------------------------------------------------

def spec(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _lm_specs(cfg, shape: S.LMShape):
    from repro_torch.models.lm import transformer as T
    if shape.kind in ("train", "prefill"):
        return {"tokens": spec((shape.batch, shape.seq_len),
                               torch.int32)}, {}
    # decode: one token + cache
    cache = T.cache_specs(cfg, shape.batch, shape.seq_len, dtype=cfg.adt)
    return {
        "tokens": spec((shape.batch, 1), torch.int32),
        "cache": cache,
        "cache_index": spec((), torch.int32),
    }, {}


def _gnn_specs(arch_id: str, cfg, shape: S.GNNShape):
    kind = ARCHS[arch_id].gnn_kind
    if shape.kind == "minibatch":
        n_pad = S.pad_to_multiple(S.minibatch_node_budget(shape) + 1)
        e_pad = S.pad_to_multiple(S.minibatch_edge_budget(shape))
    elif shape.kind == "molecule":
        n_pad = S.pad_to_multiple(shape.batch * shape.n_nodes + 1)
        e_pad = S.pad_to_multiple(shape.batch * shape.n_edges)
    else:
        n_pad, e_pad = shape.n_nodes_pad, shape.n_edges_pad
    n_graphs = shape.batch if shape.kind == "molecule" else 1
    base = {
        "senders": spec((e_pad,), torch.int32),
        "receivers": spec((e_pad,), torch.int32),
        "edge_valid": spec((e_pad,), torch.bool),
    }
    statics = {"n_nodes_pad": n_pad, "n_edges_pad": e_pad,
               "n_graphs": n_graphs}
    if kind == "conv":
        base["x"] = spec((n_pad, shape.d_feat), torch.float32)
        base["labels"] = spec((n_pad,), torch.int32)
        base["label_mask"] = spec((n_pad,), torch.bool)
        if arch_id.startswith("gcn"):
            base["edge_weight"] = spec((e_pad,), torch.float32)
        return base, statics
    # geometric models (schnet / dimenet): positions are synthesized for
    # non-molecular graphs
    base["species"] = spec((n_pad,), torch.int32)
    base["pos"] = spec((n_pad, 3), torch.float32)
    base["graph_ids"] = spec((n_pad,), torch.int32)
    base["targets"] = spec((n_graphs,), torch.float32)
    if arch_id == "dimenet":
        t_pad = e_pad * shape.triplet_cap
        base["t_in"] = spec((t_pad,), torch.int32)
        base["t_out"] = spec((t_pad,), torch.int32)
        base["t_valid"] = spec((t_pad,), torch.bool)
    return base, statics


def _recsys_specs(cfg, shape: S.RecSysShape):
    base = {
        "dense": spec((shape.batch, cfg.n_dense), torch.float32),
        "sparse_ids": spec((shape.batch, cfg.n_sparse, cfg.multi_hot),
                           torch.int32),
    }
    if shape.kind == "train":
        base["labels"] = spec((shape.batch,), torch.float32)
    if shape.kind == "retrieval":
        c_pad = 1 << 20        # 1,048,576 ≥ 1M candidates, mesh-divisible
        base["candidates"] = spec((c_pad, cfg.embed_dim), torch.float32)
    return base, {}


def input_specs(arch_id: str, shape_name: str, reduced: bool = False
                ) -> Tuple[dict, dict]:
    """(the cell's inputs as ``meta`` tensors, statics): the reference's
    shapes, dtypes and statics dict."""
    shape = shapes_for(arch_id)[shape_name]
    return specs_for(arch_id, get_config(arch_id, reduced=reduced,
                                         shape=shape), shape)


def specs_for(arch_id: str, cfg, shape) -> Tuple[dict, dict]:
    """``input_specs`` at any shape object of the arch's family."""
    fam = ARCHS[arch_id].family
    if fam == "lm":
        return _lm_specs(cfg, shape)
    if fam == "gnn":
        return _gnn_specs(arch_id, cfg, shape)
    return _recsys_specs(cfg, shape)
