"""GCN (Kipf & Welling) on the decoupled SpMM core — port of
``repro.models.gnn.gcn``.

Aggregation goes through the backend registry (``repro_torch.sparse
.backend``): ``backend="dense"|"chunked"|"cuda"``.  ``dense``/``chunked`` can
run off an inline plan built from edge tensors; ``cuda`` needs a host-built
``make_plan(..., backends=("cuda",))`` passed as ``plan=``.

``loss_fn`` is the training objective (masked cross-entropy).

Parameters are a dict ``{"layer{i}": {"w": (d_in, d_out), "b": (d_out,)}}``
in the reference's ``(d_in, d_out)`` weight layout, so ``h @ w`` reads the
same on both sides.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import pin_rows
from repro_torch.sparse import backend as sb
from repro_torch.sparse.plan import AggregationPlan, edge_plan

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 16
    n_classes: int = 7
    param_dtype: str = "float32"
    # node-dim sharding constraint axes (empty ⇒ no constraints)
    dp_axes: tuple = ()

    @property
    def dims(self):
        return ([self.d_in] + [self.d_hidden] * (self.n_layers - 1)
                + [self.n_classes])


def init_params(cfg: GCNConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Gaussian weights scaled by 1/√fan_in, zero biases — the reference's
    initializer, drawn from ``generator`` (a CPU generator) and placed on
    ``device``."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    dims = cfg.dims
    return {
        f"layer{i}": {
            "w": (torch.randn((dims[i], dims[i + 1]), generator=generator,
                              dtype=dt) / dims[i] ** 0.5).to(dev),
            "b": torch.zeros((dims[i + 1],), dtype=dt, device=dev),
        }
        for i in range(cfg.n_layers)
    }


def forward(params: Params, cfg: GCNConfig, x: torch.Tensor,
            senders: torch.Tensor = None, receivers: torch.Tensor = None,
            edge_weight: Optional[torch.Tensor] = None,
            edge_valid: torch.Tensor = None, backend: str = "dense",
            plan: Optional[AggregationPlan] = None) -> torch.Tensor:
    """x: (N_pad, d_in) — returns logits (N_pad, n_classes).

    Per layer: combination ``h @ W`` (``torch.matmul``), aggregation on the
    named backend (receivers accumulate sender features), bias, and ReLU on
    every layer but the last.
    """
    pl = plan if plan is not None else edge_plan(
        senders, receivers, x.shape[0], edge_weight, edge_valid)
    h = x
    for i in range(cfg.n_layers):
        p = params[f"layer{i}"]
        h = pin_rows(torch.matmul(h, p["w"].to(h.dtype)),  # combination
                     cfg.dp_axes)
        h = sb.aggregate(pl, None, h, backend=backend)    # aggregation
        h = pin_rows(h, cfg.dp_axes) + p["b"].to(h.dtype)
        if i < cfg.n_layers - 1:
            h = torch.relu(h)
    return pin_rows(h, cfg.dp_axes)


def loss_fn(params: Params, cfg: GCNConfig, x: torch.Tensor, senders,
            receivers, edge_weight, edge_valid, labels: torch.Tensor,
            label_mask: torch.Tensor, backend: str = "dense",
            plan: Optional[AggregationPlan] = None) -> torch.Tensor:
    """Masked node-classification cross-entropy: f32 logits,
    ``log_softmax``, the label's log-probability, mean over the labelled
    nodes (``max(mask.sum(), 1)``)."""
    logits = forward(params, cfg, x, senders, receivers, edge_weight,
                     edge_valid, backend=backend, plan=plan)
    return masked_xent(logits, labels, label_mask)


def masked_xent(logits: torch.Tensor, labels: torch.Tensor,
                label_mask: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of f32 ``logits`` against ``labels``, averaged over the
    nodes ``label_mask`` selects (at least one)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(1, labels.to(torch.int64)[:, None])[:, 0]
    m = label_mask.to(torch.float32)
    return -(ll * m).sum() / torch.clamp(m.sum(), min=1.0)
