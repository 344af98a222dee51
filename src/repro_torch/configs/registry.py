"""Architecture registry (the part of ``repro.configs.registry`` that the
launchers read): id → family, config module and, for a GNN, its kind:
``conv`` (gcn/gat, node features on a graph) or ``geom`` (schnet/dimenet,
species and positions).  Every arch of the reference is ported;
``NOT_PORTED`` would list an arch still queued, with the ROADMAP item that
ports it, and asking for one raises ``NotImplementedError``.
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


def get_config(arch_id: str, reduced: bool = False):
    mod = importlib.import_module(entry(arch_id).module)
    return mod.reduced() if reduced else mod.FULL
