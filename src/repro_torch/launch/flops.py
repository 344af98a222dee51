"""Analytic MODEL_FLOPS per (arch × shape) — the "useful work" yardstick
for the roofline's useful_ratio (port of ``repro.launch.flops``): counted
operations past these are recomputation or redundancy.

LM: 6·N_active·T (train) / 2·N_active·T (fwd-only) plus explicit attention
terms; MoE counts only routed-expert params (the paper's a17b = active 17B
idea).  Plain Python over the configs: the same floats as the reference.
"""
from __future__ import annotations

from repro_torch.configs import shapes as S
from repro_torch.configs.registry import ARCHS, get_config, shapes_for


def lm_matmul_params(cfg) -> tuple:
    """(dense_params_per_token, attn_dims) — params participating per token."""
    d, hd, h, kv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    dense_mlp = 3 * cfg.d_ff * d
    n_active = 0.0
    pattern = cfg.layer_pattern
    n_super = cfg.n_layers // len(pattern)
    for kind in pattern:
        n_active += attn
        if kind == "moe":
            n_active += cfg.d_model * cfg.n_experts          # router
            n_active += cfg.top_k * dense_mlp                # routed experts
        else:
            n_active += dense_mlp
    n_active *= n_super
    n_active += d * cfg.vocab                                # unembed matmul
    return n_active


def lm_model_flops(cfg, shape: S.LMShape) -> float:
    b, s = shape.batch, shape.seq_len
    n_act = lm_matmul_params(cfg)
    hd, h, L = cfg.head_dim, cfg.n_heads, cfg.n_layers
    if shape.kind == "train":
        t = b * s
        dense = 6.0 * n_act * t
        attn = 12.0 * L * b * s * s * h * hd / 2.0        # causal ½
        return dense + attn
    if shape.kind == "prefill":
        t = b * s
        return 2.0 * n_act * t + 4.0 * L * b * s * s * h * hd / 2.0
    # decode: one token, attention reads the full cache
    t = b * 1
    return 2.0 * n_act * t + 4.0 * L * b * shape.seq_len * h * hd


def gnn_model_flops(arch_id: str, cfg, shape: S.GNNShape, statics) -> float:
    n, e = statics["n_nodes_pad"], statics["n_edges_pad"]
    if arch_id.startswith("gcn"):
        f = 0.0
        dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
        for i in range(cfg.n_layers):
            f += 2.0 * n * dims[i] * dims[i + 1] + 2.0 * e * dims[i + 1]
        return 3.0 * f                                     # fwd + bwd
    if arch_id.startswith("gat"):
        f = 0.0
        d_in = cfg.d_in
        for i in range(cfg.n_layers):
            last = i == cfg.n_layers - 1
            heads = 1 if last else cfg.n_heads
            d_out = cfg.n_classes if last else cfg.d_hidden
            f += 2.0 * n * d_in * heads * d_out            # projection
            f += 4.0 * e * heads                            # sddmm scores
            f += 2.0 * e * heads * d_out                    # weighted spmm
            d_in = heads * d_out
        return 3.0 * f
    if arch_id == "schnet":
        d, r = cfg.d_hidden, cfg.n_rbf
        per = 2.0 * e * (r * d + d * d) + 2.0 * e * d + 3 * 2.0 * n * d * d
        return 3.0 * (cfg.n_interactions * per + 2.0 * e * r)
    # dimenet
    d, nb = cfg.d_hidden, cfg.n_bilinear
    t = e * shape.triplet_cap
    n_sbf = cfg.n_spherical * cfg.n_radial
    per = (2.0 * t * n_sbf * nb                 # sbf projection
           + 2.0 * t * nb * d * d               # bilinear einsum
           + 4.0 * 2.0 * e * d * d)             # per-edge MLPs
    return 3.0 * cfg.n_blocks * per


def recsys_model_flops(cfg, shape: S.RecSysShape) -> float:
    b = shape.batch
    bot = sum(2.0 * cfg.bot_mlp[i] * cfg.bot_mlp[i + 1]
              for i in range(len(cfg.bot_mlp) - 1))
    top_dims = [cfg.top_mlp_in] + list(cfg.top_mlp_hidden)
    top = sum(2.0 * top_dims[i] * top_dims[i + 1]
              for i in range(len(top_dims) - 1))
    fp1 = cfg.n_sparse + 1
    inter = 2.0 * fp1 * fp1 * cfg.embed_dim
    lookup = cfg.n_sparse * cfg.multi_hot * cfg.embed_dim
    fwd = b * (bot + top + inter + lookup)
    if shape.kind == "train":
        return 3.0 * fwd
    if shape.kind == "retrieval":
        return fwd + 2.0 * b * (1 << 20) * cfg.embed_dim
    return fwd


def model_flops(arch_id: str, shape, statics=None, cfg=None) -> float:
    """``shape`` is a registry shape name or a shape object (an
    ``LMShape``/``GNNShape``/``RecSysShape`` a caller runs); ``cfg``
    defaults to the FULL config at that shape.  GNN cells need
    ``statics`` (``n_nodes_pad``, ``n_edges_pad``)."""
    if isinstance(shape, str):
        shape = shapes_for(arch_id)[shape]
    if cfg is None:
        cfg = get_config(arch_id, shape=shape)
    fam = ARCHS[arch_id].family
    if fam == "lm":
        return lm_model_flops(cfg, shape)
    if fam == "gnn":
        return gnn_model_flops(arch_id, cfg, shape, statics)
    return recsys_model_flops(cfg, shape)
