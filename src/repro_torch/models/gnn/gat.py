"""GAT (Veličković et al.) — edge scores → segment softmax → SpMM; port of
``repro.models.gnn.gat``.

The score stage gathers per-node scalars (``e_src[senders] +
e_dst[receivers]``), as the reference does; the softmax merges them per
receiver (``sparse.segment_ops.segment_softmax``).  The weighted
aggregation is one ``sparse.backend.aggregate`` per head with the traced
attention weights as its edge values, so on ``cuda``/``cuda_q8`` each head
re-values the plan's coefficient tiles through its slot map and runs B1 or
B4; the last layer averages its heads.

Every sum on the path is order-fixed on the card (the segment ops, the tile
scatter, B1), so a training run repeats bit for bit.

Parameters are ``{"layer{i}": {"w": (d_in, heads, d_out), "a_src": (heads,
d_out), "a_dst": (heads, d_out), "b": (heads·d_out,)}}`` as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import pin_rows
from repro_torch.sparse import backend as sb
from repro_torch.sparse.plan import AggregationPlan, edge_plan
from repro_torch.sparse.segment_ops import gather, segment_softmax

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat-cora"
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 8
    n_heads: int = 8
    n_classes: int = 7
    negative_slope: float = 0.2
    param_dtype: str = "float32"
    # node/edge-dim sharding constraint axes (empty ⇒ no constraints)
    dp_axes: tuple = ()


def init_params(cfg: GATConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """The reference's initializer: ``w`` ~ N(0, 1/d_in), the attention
    vectors ~ N(0, 0.01), zero biases; one head on the last layer."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)

    def randn(*shape):
        return torch.randn(shape, generator=generator, dtype=dt)

    params = {}
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        heads = 1 if last else cfg.n_heads
        d_out = cfg.n_classes if last else cfg.d_hidden
        params[f"layer{i}"] = {
            "w": (randn(d_in, heads, d_out) / d_in ** 0.5).to(dev),
            "a_src": (randn(heads, d_out) * 0.1).to(dev),
            "a_dst": (randn(heads, d_out) * 0.1).to(dev),
            "b": torch.zeros((heads * d_out,), dtype=dt, device=dev),
        }
        d_in = heads * d_out
    return params


def gat_layer(p, cfg: GATConfig, x: torch.Tensor, pl: AggregationPlan,
              average_heads: bool, backend: str = "dense") -> torch.Tensor:
    n = x.shape[0]
    d_in, heads, d_out = p["w"].shape
    w = p["w"].to(x.dtype).reshape(d_in, heads * d_out)
    h = pin_rows((x @ w).reshape(n, heads, d_out), cfg.dp_axes)  # (N,H,F)
    # score stage: per-edge attention logits
    e_src = (h * p["a_src"].to(x.dtype)).sum(-1)            # (N, H)
    e_dst = (h * p["a_dst"].to(x.dtype)).sum(-1)
    by_rows = pl.order("rows")
    logits = F.leaky_relu(gather(e_src, pl.cols, pl.order("cols"))
                          + gather(e_dst, pl.rows, by_rows),
                          cfg.negative_slope).float()        # (E, H)
    valid = pl.valid[:, None]
    logits = pin_rows(torch.where(valid, logits, -1e30), cfg.dp_axes)
    alpha = segment_softmax(logits, pl.rows, n, by_rows).to(x.dtype)
    alpha = pin_rows(torch.where(valid, alpha, 0), cfg.dp_axes)
    # one decoupled SpMM per head, the attention weights as edge values
    agg = torch.stack([sb.aggregate(pl, alpha[:, hd], h[:, hd, :],
                                    backend=backend)
                       for hd in range(heads)], dim=1)
    agg = pin_rows(agg, cfg.dp_axes)
    if average_heads:
        return pin_rows(agg.mean(dim=1), cfg.dp_axes)
    return pin_rows(agg.reshape(n, -1) + p["b"].to(x.dtype), cfg.dp_axes)


def forward(params: Params, cfg: GATConfig, x: torch.Tensor,
            senders: torch.Tensor = None, receivers: torch.Tensor = None,
            edge_valid: torch.Tensor = None, backend: str = "dense",
            plan: Optional[AggregationPlan] = None) -> torch.Tensor:
    """x: (N_pad, d_in) → logits (N_pad, n_classes); ELU between layers."""
    pl = plan if plan is not None else edge_plan(
        senders, receivers, x.shape[0], edge_valid=edge_valid)
    h = x
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        h = gat_layer(params[f"layer{i}"], cfg, h, pl, average_heads=last,
                      backend=backend)
        if not last:
            h = F.elu(h)
    return h


def loss_fn(params: Params, cfg: GATConfig, x: torch.Tensor, senders,
            receivers, edge_valid, labels: torch.Tensor,
            label_mask: torch.Tensor, backend: str = "dense",
            plan: Optional[AggregationPlan] = None) -> torch.Tensor:
    """Masked node-classification cross-entropy, as ``gcn.loss_fn``."""
    from repro_torch.models.gnn.gcn import masked_xent
    logits = forward(params, cfg, x, senders, receivers, edge_valid,
                     backend=backend, plan=plan)
    return masked_xent(logits, labels, label_mask)
