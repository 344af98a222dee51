"""SchNet (Schütt et al., arXiv:1706.08566) — continuous-filter
convolutions; port of ``repro.models.gnn.schnet``.

cfconv is the decoupled pipeline with a *computed* adjacency value: the
filter W(d_ij) from the RBF expansion plays the role of A's nonzeros
(multiply stage), then a segment accumulation (accumulate stage).  The
multiply stage is vector-valued (the filter scales each channel), so the
aggregation goes through the backend registry's accumulate-only entry
(``sparse.backend.accumulate``): on every executor, ``cuda`` and
``cuda_q8`` included, the chunked schedule, as in the reference.

Flat node/edge tensors with a ``graph_ids`` readout segment, so one code
path serves batched molecules and single graphs (serving reads per-node
energies with ``graph_ids = arange(n)``).

Every sum that carries a gradient is order-fixed on the card: the species
lookup and the sender gather add their backward in a kept order
(``segment_ops.take``, the plan's ``order("cols")``), the accumulation and
the readout are ordered segment sums.  Parameters are ``{"embed": (S, d),
"atomwise": mlp, "int{i}": {"w_in", "filter": mlp, "w_out1", "w_out2"}}``
as in the reference.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import mlp_apply, mlp_init, shifted_softplus
from repro_torch.sparse import backend as sb
from repro_torch.sparse.plan import AggregationPlan, edge_plan
from repro_torch.sparse.segment_ops import (gather, kept_order, segment_sum,
                                            take)

Params = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_species: int = 100
    param_dtype: str = "float32"


@functools.lru_cache(maxsize=16)
def _centers(n: int, cutoff: float, device: torch.device) -> torch.Tensor:
    """``jnp.linspace(0, cutoff, n, dtype=float32)`` bit for bit: XLA
    computes it as ``i · (cutoff · f32(1/(n − 1)))`` in f32 with the last
    entry ``cutoff`` (``torch.linspace`` differs by an ulp in ~40% of the
    entries at n = 300)."""
    f32 = np.float32
    if n == 1:
        c = np.zeros(1, f32)
    else:
        step = f32(cutoff) * (f32(1) / f32(n - 1))
        c = np.append(np.arange(n - 1, dtype=f32) * step, f32(cutoff))
    return torch.from_numpy(c.astype(f32)).to(device)


def rbf_expand(d: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Gaussian radial basis on [0, cutoff] (SchNet §3, 0.1Å-spaced γ)."""
    # a shape-only trace (FakeTensorMode) must not leave its fake centres
    # in the cache for later calls
    centers = (_centers.__wrapped__ if is_fake(d) else _centers)(
        n_rbf, float(cutoff), d.device)
    gamma = (n_rbf / cutoff) ** 2 * 0.5      # 1/(2Δ²)
    return torch.exp(-gamma * (d[:, None] - centers[None, :]) ** 2)


def cosine_cutoff(d: torch.Tensor, cutoff: float) -> torch.Tensor:
    return torch.where(d < cutoff,
                       0.5 * (torch.cos(math.pi * d / cutoff) + 1.0), 0.0)


def init_params(cfg: SchNetConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """The reference's initializer: embeddings ~ N(0, 0.01), weights
    ~ N(0, 1/d), the MLPs' (``mlp_init``); drawn from ``generator`` (a CPU
    generator) and placed on ``device``."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    d = cfg.d_hidden

    def randn(*shape):
        return torch.randn(shape, generator=generator, dtype=dt)

    params = {"embed": (randn(cfg.n_species, d) * 0.1).to(dev),
              "atomwise": mlp_init(generator, [d, d // 2, 1], dt, dev)}
    for i in range(cfg.n_interactions):
        params[f"int{i}"] = {
            "w_in": (randn(d, d) / math.sqrt(d)).to(dev),
            "filter": mlp_init(generator, [cfg.n_rbf, d, d], dt, dev),
            "w_out1": (randn(d, d) / math.sqrt(d)).to(dev),
            "w_out2": (randn(d, d) / math.sqrt(d)).to(dev),
        }
    return params


def forward(params: Params, cfg: SchNetConfig, species: torch.Tensor,
            pos: torch.Tensor, senders: torch.Tensor = None,
            receivers: torch.Tensor = None, edge_valid: torch.Tensor = None,
            graph_ids: torch.Tensor = None, n_graphs: int = 1,
            backend: str = "dense",
            plan: Optional[AggregationPlan] = None) -> torch.Tensor:
    """species (N,), pos (N, 3), edges (E,), graph_ids (N,) → energies
    (n_graphs,); the plan's edges, when one is given, are the edges."""
    n = species.shape[0]
    pl = plan if plan is not None else edge_plan(
        senders, receivers, n, edge_valid=edge_valid)
    senders, receivers = pl.cols, pl.rows
    x = take(params["embed"], species)
    d_vec = pos.index_select(0, senders) - pos.index_select(0, receivers)
    dist = torch.sqrt((d_vec * d_vec).sum(-1) + 1e-12)
    rbf = rbf_expand(dist, cfg.n_rbf, cfg.cutoff).to(x.dtype)
    fcut = (cosine_cutoff(dist, cfg.cutoff) * pl.valid).to(x.dtype)
    by_senders = pl.order("cols")

    for i in range(cfg.n_interactions):
        p = params[f"int{i}"]
        h = x @ p["w_in"].to(x.dtype)
        w_filt = mlp_apply(p["filter"], rbf, act=shifted_softplus,
                           final_act=True)                    # (E, d)
        msg = gather(h, senders, by_senders) * w_filt * fcut[:, None]
        agg = sb.accumulate(pl, msg, backend=backend)
        v = shifted_softplus(agg @ p["w_out1"].to(x.dtype))
        x = x + v @ p["w_out2"].to(x.dtype)

    atom_e = mlp_apply(params["atomwise"], x, act=shifted_softplus)[:, 0]
    return segment_sum(atom_e, graph_ids, n_graphs,
                       kept_order(graph_ids, n_graphs))


def loss_fn(params: Params, cfg: SchNetConfig, species, pos, senders,
            receivers, edge_valid, graph_ids, n_graphs: int, targets,
            backend: str = "dense",
            plan: Optional[AggregationPlan] = None) -> torch.Tensor:
    """Mean squared error of the per-graph energies."""
    e = forward(params, cfg, species, pos, senders, receivers, edge_valid,
                graph_ids, n_graphs, backend=backend, plan=plan)
    return ((e.float() - targets) ** 2).mean()
