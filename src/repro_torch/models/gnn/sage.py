"""GraphSAGE (Hamilton et al., arXiv:1706.02216), mean aggregator; port of
``repro.models.gnn.sage``.

    h_i' = act(h_i · W_self + mean_{j∈N(i)} h_j · W_nbr + b)

The neighbor sum goes through ``sparse.backend.aggregate``; the mean's
denominator is the in-degree over valid edges, counted once per forward
from the plan (a sum of ones, exact in f32).  Parameters are
``{"layer{i}": {"w_self", "w_nbr": (d_in, d_out), "b": (d_out,)}}``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sparse import backend as sb
from repro_torch.sparse.plan import AggregationPlan, edge_plan
from repro_torch.sparse.segment_ops import segment_sum

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    name: str = "graphsage"
    n_layers: int = 2
    d_in: int = 602
    d_hidden: int = 64
    n_classes: int = 41
    param_dtype: str = "float32"


def init_params(cfg: SAGEConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Gaussian weights scaled by 1/√d_in, zero biases (the reference's)."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    params = {}
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        d_out = cfg.n_classes if i == cfg.n_layers - 1 else cfg.d_hidden
        w = [torch.randn((d_in, d_out), generator=generator, dtype=dt)
             / d_in ** 0.5 for _ in range(2)]
        params[f"layer{i}"] = {
            "w_self": w[0].to(dev), "w_nbr": w[1].to(dev),
            "b": torch.zeros((d_out,), dtype=dt, device=dev)}
        d_in = d_out
    return params


def forward(params: Params, cfg: SAGEConfig, x: torch.Tensor,
            senders: torch.Tensor = None, receivers: torch.Tensor = None,
            edge_valid: torch.Tensor = None, backend: str = "dense",
            plan: Optional[AggregationPlan] = None) -> torch.Tensor:
    pl = plan if plan is not None else edge_plan(
        senders, receivers, x.shape[0], edge_valid=edge_valid)
    deg = segment_sum(pl.valid.to(x.dtype), pl.rows, pl.n_rows,
                      pl.order("rows"))
    inv_deg = (1.0 / torch.clamp(deg, min=1.0))[:, None]
    h = x
    for i in range(cfg.n_layers):
        p = params[f"layer{i}"]
        nbr = sb.aggregate(pl, None, h, backend=backend) * inv_deg
        h = (h @ p["w_self"].to(h.dtype) + nbr @ p["w_nbr"].to(h.dtype)
             + p["b"].to(h.dtype))
        if i < cfg.n_layers - 1:
            h = torch.relu(h)
    return h


def loss_fn(params: Params, cfg: SAGEConfig, x, senders, receivers,
            edge_valid, labels, label_mask, backend: str = "dense",
            plan: Optional[AggregationPlan] = None) -> torch.Tensor:
    """Masked node-classification cross-entropy, as ``gcn.loss_fn``."""
    from repro_torch.models.gnn.gcn import masked_xent
    logits = forward(params, cfg, x, senders, receivers, edge_valid,
                     backend=backend, plan=plan)
    return masked_xent(logits, labels, label_mask)
