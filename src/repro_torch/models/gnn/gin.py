"""GIN (Xu et al., arXiv:1810.00826) — sum-aggregation isomorphism network;
port of ``repro.models.gnn.gin``.

    h_i' = MLP((1 + ε) · h_i + Σ_{j∈N(i)} h_j)

The neighbor sum is the plain decoupled SpMM (edge values ≡ validity)
through ``sparse.backend.aggregate``; ``graph_readout`` sum-pools node
embeddings per graph with an order-fixed segment sum.  Parameters are
``{"layer{i}": {"mlp": {"w0", "b0", "w1", "b1"}, "eps": ()}}`` as in the
reference (``eps`` a 0-d tensor).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import mlp_apply, mlp_init
from repro_torch.sparse import backend as sb
from repro_torch.sparse.plan import AggregationPlan, edge_plan
from repro_torch.sparse.segment_ops import segment_sum

Params = Dict[str, Dict[str, object]]


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str = "gin"
    n_layers: int = 3
    d_in: int = 64
    d_hidden: int = 64
    n_classes: int = 4
    train_eps: bool = True
    param_dtype: str = "float32"
    # aggregate over the Â² two-hop neighborhood: the step builder
    # precomputes A·A once through the SpGEMM engine and passes its plan in
    two_hop: bool = False


def init_params(cfg: GINConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Per layer a two-layer MLP (d_in → d_hidden → d_out) with the
    reference's initializer and ``eps`` = 0."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    params = {}
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        d_out = cfg.n_classes if i == cfg.n_layers - 1 else cfg.d_hidden
        params[f"layer{i}"] = {
            "mlp": mlp_init(generator, [d_in, cfg.d_hidden, d_out], dt, dev),
            "eps": torch.zeros((), dtype=dt, device=dev),
        }
        d_in = d_out
    return params


def forward(params: Params, cfg: GINConfig, x: torch.Tensor,
            senders: torch.Tensor = None, receivers: torch.Tensor = None,
            edge_valid: torch.Tensor = None, backend: str = "dense",
            plan: Optional[AggregationPlan] = None) -> torch.Tensor:
    pl = plan if plan is not None else edge_plan(
        senders, receivers, x.shape[0], edge_valid=edge_valid)
    h = x
    for i in range(cfg.n_layers):
        p = params[f"layer{i}"]
        agg = sb.aggregate(pl, None, h, backend=backend)
        h = mlp_apply(p["mlp"], (1.0 + p["eps"]) * h + agg, act=torch.relu)
        if i < cfg.n_layers - 1:
            h = torch.relu(h)
    return h


def graph_readout(h: torch.Tensor, graph_ids: torch.Tensor,
                  n_graphs: int) -> torch.Tensor:
    """Sum-pool node embeddings per graph (ids ≥ ``n_graphs`` dropped)."""
    return segment_sum(h, graph_ids, n_graphs)


def loss_fn(params: Params, cfg: GINConfig, x, senders, receivers,
            edge_valid, graph_ids, n_graphs: int, labels,
            backend: str = "dense",
            plan: Optional[AggregationPlan] = None) -> torch.Tensor:
    """Graph-classification cross-entropy, mean over the graphs."""
    h = forward(params, cfg, x, senders, receivers, edge_valid,
                backend=backend, plan=plan)
    logits = graph_readout(h, graph_ids, n_graphs).float()
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(1, labels.to(torch.int64)[:, None])[:, 0]
    return -ll.mean()
