"""The paper-technique GCN training step on SPMD ranks (port of
``repro.launch.variants``).

``gcn_drhm``: GCN training whose aggregation runs on the DRHM-sharded
decoupled SpMM (``core.distributed``) — the paper's C1+C2 as the
distribution policy; ``ring=True`` uses the ring-pipelined
rolling-eviction schedule (C3).  Every rank of the mesh calls the step
with the whole (permuted) batch, as the reference's jitted step takes
global arrays; each rank aggregates its DRHM row block, and the loss and
gradients are those of the global function, so every rank takes the same
AdamW step.

Edge budgets for the shape-only specs come from the DRHM balance bound:
per-shard edge counts concentrate within ±5% of E/P, and per ring cell
within ±10% of E/P².
"""
from __future__ import annotations

import torch

from repro_torch.configs import shapes as S
from repro_torch.core import distributed
from repro_torch.launch.mesh import dp_axes
from repro_torch.models.gnn.gcn import masked_xent
from repro_torch.optim import adamw

META = torch.device("meta")


def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def gcn_drhm_specs(shape: S.GNNShape, n_shards: int, ring: bool):
    """The DRHM-sharded GCN step's inputs as ``meta`` tensors, and
    ``n_pad``."""
    n_pad = ((shape.n_nodes + 1 + n_shards * 2048 - 1)
             // (n_shards * 2048)) * (n_shards * 2048)
    e_per = int((shape.n_edges / n_shards) * 1.05 // 8 + 1) * 8
    specs = {
        "x_perm": _spec((n_pad, shape.d_feat), torch.float32),
        "labels_perm": _spec((n_pad,), torch.int32),
        "mask_perm": _spec((n_pad,), torch.bool),
    }
    if ring:
        e_blk = int((shape.n_edges / n_shards**2) * 1.1 // 8 + 1) * 8
        for k in ("ring_rows", "ring_cols"):
            specs[k] = _spec((n_shards, n_shards, e_blk), torch.int32)
        specs["ring_vals"] = _spec((n_shards, n_shards, e_blk),
                                   torch.float32)
    else:
        for k in ("rows_local", "cols_perm"):
            specs[k] = _spec((n_shards * e_per,), torch.int32)
        specs["vals"] = _spec((n_shards * e_per,), torch.float32)
    return specs, n_pad


def build_gcn_drhm_step(cfg, mesh, n_pad: int, ring: bool, opt_cfg=None):
    """Train step of a GCN whose aggregation is the DRHM decoupled SpMM:
    ``step(params, opt_state, batch) -> (params, opt_state, metrics)``.
    ``batch`` holds the permuted inputs (``gcn_drhm_specs``' keys) as
    tensors, the same on every rank."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    dp = dp_axes(mesh)
    n_shards = distributed.axis_size(mesh, dp)
    r_per = n_pad // n_shards
    if ring:
        spmm = distributed.make_ring_spmm_dims(mesh, r_per, n_shards,
                                               data_axis=dp, model_axis=None)
    else:
        spmm = distributed.make_allgather_spmm_dims(mesh, r_per,
                                                    data_axis=dp,
                                                    model_axis=None)

    def agg(b, h):
        if ring:
            return spmm(h, b["ring_rows"], b["ring_cols"], b["ring_vals"])
        return spmm(h, b["rows_local"], b["cols_perm"], b["vals"])

    def loss_fn(params, b):
        h = distributed.constrain(b["x_perm"], (dp, None))
        for i in range(cfg.n_layers):
            p = params[f"layer{i}"]
            h = h @ p["w"].to(h.dtype)
            h = agg(b, h)
            h = h + p["b"].to(h.dtype)
            if i < cfg.n_layers - 1:
                h = torch.relu(h)
        return masked_xent(h.float(), b["labels_perm"], b["mask_perm"])

    def step(params, opt_state, batch):
        from repro_torch import tree
        leaves, structure = tree.flatten(params)
        live = [p.detach().requires_grad_() for p in leaves]
        loss = loss_fn(tree.unflatten(structure, live), batch)
        grads = torch.autograd.grad(loss, live)
        new_p, new_s, gnorm = adamw.apply_updates(
            params, tree.unflatten(structure, list(grads)), opt_state,
            opt_cfg)
        return new_p, new_s, {"loss": loss.detach(), "grad_norm": gnorm}

    return step


def gcn_drhm_input_pspecs(specs, mesh):
    """Each input's spec: row arrays over the batch axes, the ring arrays
    by owner."""
    dp = dp_axes(mesh)
    out = {}
    for k, v in specs.items():
        if k.startswith("ring"):
            out[k] = (dp, None, None)
        else:
            out[k] = (dp,) if v.ndim == 1 else (dp, None)
    return out
