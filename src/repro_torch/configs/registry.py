"""Architecture registry of the ported archs (the part of
``repro.configs.registry`` that ``launch/train.py`` reads): id → family,
config module and, for a GNN, its kind: ``conv`` (gcn/gat, node features
on a graph) or ``geom`` (schnet/dimenet, species and positions).  The
reference's other archs are listed with the ROADMAP queue item that ports
them; asking for one raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    family: str           # "lm" | "gnn" | "recsys"
    module: str
    gnn_kind: str = ""    # "" | "conv" (gcn/gat) | "geom" (schnet/dimenet)


ARCHS: Dict[str, ArchEntry] = {
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
NOT_PORTED: Dict[str, str] = {
    "llama4-maverick-400b-a17b": "A8", "grok-1-314b": "A8",
    "gemma-7b": "A8", "qwen3-0.6b": "A8", "deepseek-67b": "A8",
}


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


def get_config(arch_id: str, reduced: bool = False):
    mod = importlib.import_module(entry(arch_id).module)
    return mod.reduced() if reduced else mod.FULL
