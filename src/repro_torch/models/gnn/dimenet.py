"""DimeNet (Gasteiger et al., arXiv:2003.03123) — directional message
passing; port of ``repro.models.gnn.dimenet``.

Messages live on *edges*; each interaction block aggregates over triplets
(k→j→i) with a joint radial × angular basis and the paper's bilinear
layer.  Two chained decoupled stages: edge gather → triplet partial
products → accumulate back to edges (the triplet plan: ``t_in`` → ``t_out``
over the edge domain), then edges → nodes (the edge plan).  Both are
vector-valued, so they go through ``sparse.backend.accumulate``: the
chunked schedule on every executor, ``cuda`` and ``cuda_q8`` included, as
in the reference.  With a ``two_hop_plan`` (Â², built once by the step
builder through the SpGEMM engine) the output block adds one SpMM over
it through ``sparse.backend.aggregate``: B1 on ``cuda`` (and B1 on the
transpose layout as its backward), B4 on ``cuda_q8``.

Basis simplification as in the reference (its DESIGN.md §8): the radial
form ``sin(nπd/c)/d`` for every order and the Chebyshev angular basis
``cos(lθ)``, in the paper's (n_spherical × n_radial) layout.

The blocks run one after another, each under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` when a gradient
is to flow (the reference's ``lax.scan(jax.checkpoint(block))``): only the
(E, d) edge messages are kept between blocks and the (T, d) triplet
intermediates are recomputed in the backward.  Every sum that carries a
gradient is order-fixed on the card: the species lookup, the sender,
receiver and ``t_in`` gathers (the plans' kept orders), the two
accumulations and the readout.

Parameters are ``{"embed", "rbf_embed", "edge_embed": mlp, "output": mlp,
"blocks": {...}}`` with the per-block weights stacked on a leading
``n_blocks`` axis, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import mlp_apply, mlp_init, pin_rows
from repro_torch.sparse import backend as sparse_backend
from repro_torch.sparse.plan import AggregationPlan, edge_plan
from repro_torch.sparse.segment_ops import (gather, kept_order, segment_sum,
                                            take)

Params = Dict[str, object]
BLOCK_KEYS = ("w_src", "w_rbf_gate", "w_sbf", "w_bilinear", "w_self",
              "w_out1", "w_out2", "rbf_out")


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    envelope_p: int = 6
    n_species: int = 100
    max_triplets_per_edge: int = 8
    param_dtype: str = "float32"
    # node/edge-dim sharding constraint axes (empty ⇒ no constraints)
    dp_axes: tuple = ()
    # mix the Â² two-hop node aggregation into the output block: the step
    # builder precomputes A·A once through the SpGEMM engine and passes its
    # plan as ``two_hop_plan``
    two_hop: bool = False


def _ipow(x: torch.Tensor, y: int) -> torch.Tensor:
    """``x ** y`` for an integer ``y`` ≥ 1 by XLA's ``integer_pow``
    (square and multiply), so the f32 products round as the reference's."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def envelope(d_scaled: torch.Tensor, p: int) -> torch.Tensor:
    """Smooth polynomial cutoff envelope u(d) (DimeNet eq. 8)."""
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2.0)
    c = -p * (p + 1) / 2.0
    env = (1.0 / torch.clamp_min(d_scaled, 1e-6)
           + a * _ipow(d_scaled, p - 1) + b * _ipow(d_scaled, p)
           + c * _ipow(d_scaled, p + 1))
    return torch.where(d_scaled < 1.0, env, 0.0)


def _radial(ds: torch.Tensor, cfg: DimeNetConfig) -> torch.Tensor:
    n = torch.arange(1, cfg.n_radial + 1, dtype=torch.float32,
                     device=ds.device)
    env = envelope(ds, cfg.envelope_p)
    return env[:, None] * torch.sin(n[None, :] * math.pi * ds[:, None])


def radial_basis(d: torch.Tensor, cfg: DimeNetConfig) -> torch.Tensor:
    """(E, n_radial): u(d) · sin(nπ d/c) / d."""
    return _radial(d / cfg.cutoff, cfg)


def angular_basis(d_kj: torch.Tensor, cos_theta: torch.Tensor,
                  cfg: DimeNetConfig) -> torch.Tensor:
    """(T, n_spherical · n_radial) joint radial × angular basis."""
    rad = _radial(d_kj / cfg.cutoff, cfg)                             # (T, R)
    theta = torch.arccos(torch.clamp(cos_theta, -1.0 + 1e-6, 1.0 - 1e-6))
    l = torch.arange(cfg.n_spherical, dtype=torch.float32,
                     device=d_kj.device)
    ang = torch.cos(l[None, :] * theta[:, None])                      # (T, L)
    return (ang[:, :, None] * rad[:, None, :]).reshape(
        d_kj.shape[0], cfg.n_spherical * cfg.n_radial)


def init_params(cfg: DimeNetConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """The reference's initializer (its scales, the per-block weights
    stacked on a leading ``n_blocks`` axis), drawn from ``generator`` (a CPU
    generator) and placed on ``device``."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    d = cfg.d_hidden
    n_sbf = cfg.n_spherical * cfg.n_radial

    def randn(*shape):
        return torch.randn(shape, generator=generator, dtype=dt)

    params = {
        "embed": (randn(cfg.n_species, d) * 0.1).to(dev),
        "rbf_embed": (randn(cfg.n_radial, d) * 0.3).to(dev),
        "edge_embed": mlp_init(generator, [3 * d, d], dt, dev),
        "output": mlp_init(generator, [d, d, 1], dt, dev),
    }
    nb = cfg.n_blocks
    s = 1.0 / math.sqrt(d)
    params["blocks"] = {k: v.to(dev) for k, v in {
        "w_src": randn(nb, d, d) * s,
        "w_rbf_gate": randn(nb, cfg.n_radial, d) * 0.3,
        "w_sbf": randn(nb, n_sbf, cfg.n_bilinear) * 0.3,
        "w_bilinear": randn(nb, cfg.n_bilinear, d, d) * s * 0.2,
        "w_self": randn(nb, d, d) * s,
        "w_out1": randn(nb, d, d) * s,
        "w_out2": randn(nb, d, d) * s,
        "rbf_out": randn(nb, cfg.n_radial, d) * 0.3,
    }.items()}
    return params


def build_triplet_plan(t_in: torch.Tensor, t_out: torch.Tensor,
                 t_valid: torch.Tensor, n_edges: int) -> AggregationPlan:
    """The triplet plan over the edge domain: rows ``t_out``, cols
    ``t_in``, valid ``t_valid``, as the reference's inline ``edge_plan``,
    but with each padding slot pointed at edge ``slot mod n_edges`` instead
    of edge 0.  A padding slot's values are zero either way (masked), so
    every sum is the same; but the plan's ordered sums add a segment's
    entries one after another, and ``build_triplets`` gives most slots of
    a sparse batch (~75% on the molecule shape) the id 0: one segment, and
    one thread, would take them all.  Build it once for a static batch and
    pass it to ``forward`` as ``triplet_plan`` (``build_gnn_step``'s
    ``triplet_plan``): its orders are kept."""
    spread = torch.arange(t_in.shape[0], device=t_in.device) % max(n_edges, 1)
    valid = torch.as_tensor(t_valid, device=t_in.device)
    return edge_plan(torch.where(valid, t_in.to(torch.int64), spread),
                     torch.where(valid, t_out.to(torch.int64), spread),
                     n_edges, edge_valid=valid)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(v, axis=-1)``: √Σ v²."""
    return torch.sqrt((v * v).sum(-1))


def forward(params: Params, cfg: DimeNetConfig, species: torch.Tensor,
            pos: torch.Tensor, senders: torch.Tensor = None,
            receivers: torch.Tensor = None, edge_valid: torch.Tensor = None,
            t_in: torch.Tensor = None, t_out: torch.Tensor = None,
            t_valid: torch.Tensor = None, graph_ids: torch.Tensor = None,
            n_graphs: int = 1, backend: str = "dense",
            plan: Optional[AggregationPlan] = None,
            triplet_plan: Optional[AggregationPlan] = None,
            two_hop_plan: Optional[AggregationPlan] = None) -> torch.Tensor:
    """Edge-message DimeNet → energies (n_graphs,).  ``t_in``/``t_out``
    index the edge list (triplets); a given ``plan`` (``triplet_plan``,
    from ``build_triplet_plan``) holds the edges (triplets) themselves, as
    its rows, cols and valid."""
    n = species.shape[0]
    act = F.silu
    pl = plan if plan is not None else edge_plan(
        senders, receivers, n, edge_valid=edge_valid)
    e = pl.rows.shape[0]
    pt = triplet_plan if triplet_plan is not None else build_triplet_plan(
        t_in, t_out, t_valid, e)
    senders, receivers, t_in = pl.cols, pl.rows, pt.cols

    h = take(params["embed"], species)
    dt = h.dtype
    d_vec = pos.index_select(0, senders) - pos.index_select(0, receivers)
    dist = torch.sqrt((d_vec * d_vec).sum(-1) + 1e-12)
    rbf = radial_basis(dist, cfg).to(dt)                           # (E, R)

    # triplet geometry: angle at j between (k→j) and (j→i)
    v_in = -d_vec.index_select(0, t_in)
    v_out = d_vec.index_select(0, pt.rows)
    cosang = (v_in * v_out).sum(-1) / torch.clamp_min(
        _norm(v_in) * _norm(v_out), 1e-9)
    d_kj = dist.index_select(0, t_in)
    sbf = angular_basis(d_kj, cosang, cfg).to(dt)                  # (T, L·R)
    sbf = pin_rows(sbf * pt.valid[:, None].to(dt), cfg.dp_axes)

    # embedding block: m_ji = W [h_j || h_i || rbf_emb]
    m = mlp_apply(params["edge_embed"], torch.cat([
        gather(h, senders, pl.order("cols")),
        gather(h, receivers, pl.order("rows")),
        rbf @ params["rbf_embed"].to(dt)], dim=-1), act=act)
    ev = pl.valid[:, None].to(dt)
    m = pin_rows(m * ev, cfg.dp_axes)
    rbf = pin_rows(rbf, cfg.dp_axes)
    by_t_in = pt.order("cols")

    def block(m, p):
        x_kj = act(m @ p["w_src"].to(dt))
        x_kj = pin_rows(x_kj * (rbf @ p["w_rbf_gate"].to(dt)), cfg.dp_axes)
        x_t = pin_rows(gather(x_kj, t_in, by_t_in), cfg.dp_axes)   # (T, d)
        sb = pin_rows(sbf @ p["w_sbf"].to(dt), cfg.dp_axes)        # (T, nb)
        # bilinear Σ_b sb[:, b] · (x_t @ W_b), in the reference's order:
        # the reassociated form peaks at one (T, d) product
        w_bil = p["w_bilinear"].to(dt)
        contrib = torch.zeros_like(x_t)
        for b in range(cfg.n_bilinear):
            contrib = contrib + sb[:, b:b + 1] * (x_t @ w_bil[b])
        contrib = pin_rows(contrib, cfg.dp_axes)
        agg = pin_rows(sparse_backend.accumulate(pt, contrib,
                                                 backend=backend),
                       cfg.dp_axes)
        m = act(m @ p["w_self"].to(dt)) + agg
        m = m + act(m @ p["w_out1"].to(dt)) @ p["w_out2"].to(dt)
        return pin_rows(m * ev, cfg.dp_axes)

    blocks = params["blocks"]
    for i in range(cfg.n_blocks):
        p = {k: blocks[k][i] for k in BLOCK_KEYS}
        if torch.is_grad_enabled():
            m = checkpoint(block, m, p, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            m = block(m, p)

    # output block: edges → nodes → graphs
    per_edge = m * (rbf @ blocks["rbf_out"][-1].to(dt))
    node_h = sparse_backend.accumulate(pl, per_edge, backend=backend)
    if two_hop_plan is not None:
        # Â²-powered long-range mixing: one SpMM over the precomputed
        # two-hop plan (path-count weighted), added to the one-hop readout
        node_h = node_h + sparse_backend.aggregate(two_hop_plan, None,
                                                   node_h, backend=backend)
    atom_e = mlp_apply(params["output"], node_h, act=act)[:, 0]
    return segment_sum(atom_e, graph_ids, n_graphs,
                       kept_order(graph_ids, n_graphs))


def loss_fn(params: Params, cfg: DimeNetConfig, species, pos, senders,
            receivers, edge_valid, t_in, t_out, t_valid, graph_ids,
            n_graphs: int, targets, backend: str = "dense",
            plan: Optional[AggregationPlan] = None,
            triplet_plan: Optional[AggregationPlan] = None,
            two_hop_plan: Optional[AggregationPlan] = None) -> torch.Tensor:
    """Mean squared error of the per-graph energies."""
    e = forward(params, cfg, species, pos, senders, receivers, edge_valid,
                t_in, t_out, t_valid, graph_ids, n_graphs, backend=backend,
                plan=plan, triplet_plan=triplet_plan,
                two_hop_plan=two_hop_plan)
    return ((e.float() - targets) ** 2).mean()
