"""Step builders per architecture family (port of ``repro.launch.steps``).

Train steps take (params, opt_state, batch) and return (params,
opt_state, metrics); serve steps take (params, batch) and return outputs.
Batches are dicts of tensors on the parameters' device.

* LM: ``build_lm_step`` — ``train`` → (params, opt_state, metrics) over
  ``loss_fn`` (blocked attention: B8 has no backward), ``prefill`` →
  (last-token logits, cache) with B8 (``attention="flash"``), ``decode``
  → (logits, cache) (``tokens`` (B, S) or (B, 1) int32, ``cache``,
  ``cache_index``).

* GNN: ``build_gnn_step`` builds the training step of gcn, gat, gin,
  schnet and dimenet on any aggregation executor (``dense``, ``chunked``,
  ``cuda``, ``cuda_q8``), gcn and gin optionally over the
  SpGEMM-precomputed Â² (``two_hop``), dimenet with an Â² stage added to
  its output block.
* RecSys: ``build_recsys_step`` — ``train`` → (params, opt_state,
  metrics), ``serve`` → logits, ``retrieval`` → candidate scores
  (``dense`` (B, 13) f32, ``sparse_ids`` (B, 26, M) int32, ``labels`` (B,)
  f32, ``candidates`` (C, D)).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree
from repro_torch.configs.shapes import RecSysShape
from repro_torch.models.recsys import dlrm
from repro_torch.optim import adamw


def _train_wrap(loss_fn: Callable, opt_cfg: adamw.AdamWConfig):
    """(params, opt_state, batch) → (params, opt_state, {loss,
    grad_norm}): the loss, its gradients over every parameter leaf (zero
    for a leaf the loss does not read, as ``jax.grad`` gives: GAT's last
    bias), one AdamW update."""
    def step(params, opt_state, batch):
        leaves, structure = tree.flatten(params)
        live = [p.detach().requires_grad_() for p in leaves]
        loss = loss_fn(tree.unflatten(structure, live), batch)
        grads = torch.autograd.grad(loss, live, materialize_grads=True)
        new_p, new_s, gnorm = adamw.apply_updates(
            params, tree.unflatten(structure, list(grads)), opt_state,
            opt_cfg)
        return new_p, new_s, {"loss": loss.detach(), "grad_norm": gnorm}
    return step


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

def build_lm_step(cfg, shape, opt_cfg=None):
    """The LM step of ``shape.kind``; the prefill runs ``T.prefill``'s
    default attention (B8)."""
    from repro_torch.models.lm import transformer as T
    if shape.kind == "train":
        return _train_wrap(lambda p, b: T.loss_fn(p, cfg, b["tokens"]),
                           opt_cfg or adamw.AdamWConfig())
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            with torch.no_grad():
                return T.prefill(params, cfg, batch["tokens"])
        return prefill_step
    if shape.kind == "decode":
        def serve_step(params, batch):
            with torch.no_grad():
                return T.decode_step(params, cfg, batch["tokens"],
                                     batch["cache"], batch["cache_index"])
        return serve_step
    raise ValueError(f"unknown LM shape kind {shape.kind!r}")


# ---------------------------------------------------------------------------
# GNN
# ---------------------------------------------------------------------------

def resolve_gnn_plan(graph, backend: str, two_hop: bool = False):
    """Host plan for ``graph`` through the plan cache, on every executor:
    repeated step builds against a static graph re-pack no layouts, and
    the plan keeps the orders of its ordered sums (``AggregationPlan
    .order``) from step to step, so ``dense``/``chunked`` sort nothing per
    step.  Under ``two_hop`` the aggregation graph is the
    SpGEMM-precomputed Â² (one sparse×sparse product per static graph,
    through its own cache): f32 on B2 under the kernel executors (``cuda``
    and ``cuda_q8`` alike, as the reference builds one f32 Â² for every
    executor), on the ``reference`` executor otherwise."""
    if graph is None:
        return None
    host = backend in ("cuda", "cuda_q8")
    if two_hop:
        from repro_torch.sparse.spgemm import cached_two_hop_graph
        graph = cached_two_hop_graph(
            graph, backend="cuda" if host else "reference")
    from repro_torch.sparse.plan import cached_plan_from_graph
    return cached_plan_from_graph(
        graph, backends=(backend,) if host else ("dense", "chunked"))


# archs whose aggregation plan can be swapped for the Â² two-hop plan
# wholesale (sum aggregators over plan-carried weights); gat, schnet and
# dimenet compute per-edge quantities from the batch edge arrays, so only
# dimenet's dedicated ``two_hop_plan`` extra stage applies there
_TWO_HOP_MAIN = ("gin", "gcn")


def build_gnn_step(arch_id: str, cfg, opt_cfg=None, backend: str = "dense",
                   plan=None, graph=None, two_hop=None, n_graphs: int = 1,
                   triplet_plan=None):
    """The training step of gcn, gat, gin, schnet or dimenet on the
    executor ``backend``; ``plan`` is a host-built ``make_plan`` —
    required for ``cuda``/``cuda_q8`` — or pass ``graph`` and the plan
    comes from the plan cache (``resolve_gnn_plan``); with neither,
    ``dense``/``chunked`` build an inline COO plan from each batch's edge
    arrays.  ``two_hop`` (default: the config's ``two_hop`` field, if any)
    precomputes Â² once through the SpGEMM engine and aggregates over it
    (gcn and gin), or adds an SpMM over it to dimenet's output block.
    ``n_graphs`` is the number of graphs in a batch of gin, schnet or
    dimenet (``graph_ids`` ≥ it are dropped from the readout).
    ``triplet_plan`` is dimenet's ``build_triplet_plan(t_in, t_out,
    t_valid, E)``: built once for a static batch, it keeps its sums'
    orders from step to step (without it, each step builds one)."""
    gcn_like = arch_id.startswith("gcn")
    if not (gcn_like or arch_id in ("gin", "schnet", "dimenet")
            or arch_id.startswith("gat")):
        raise KeyError(f"unknown GNN arch {arch_id!r}")
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    if two_hop is None:
        two_hop = getattr(cfg, "two_hop", False)
    main_two_hop = two_hop and any(arch_id.startswith(p)
                                   for p in _TWO_HOP_MAIN)
    if two_hop and not main_two_hop and arch_id != "dimenet":
        raise ValueError(
            f"two_hop aggregation is not defined for {arch_id!r}: the "
            "model derives per-edge values from the batch edge arrays")
    # two_hop must never silently degrade to one-hop aggregation
    if two_hop and graph is None:
        raise ValueError(
            "two_hop=True needs graph=<Graph> so the step builder can "
            "precompute Â² through the SpGEMM engine")
    if main_two_hop and plan is not None:
        raise ValueError(
            "pass graph=, not plan=, with two_hop=True — the Â² plan is "
            "derived from the graph (an explicit plan would aggregate "
            "one-hop)")
    if plan is None:
        plan = resolve_gnn_plan(graph, backend, two_hop=main_two_hop)
    bk = {"backend": backend, "plan": plan}

    if arch_id == "gin":
        from repro_torch.models.gnn import gin

        def loss(p, b):
            return gin.loss_fn(p, cfg, b["x"], b["senders"], b["receivers"],
                               b["edge_valid"], b["graph_ids"], n_graphs,
                               b["labels"], **bk)
    elif arch_id == "schnet":
        from repro_torch.models.gnn import schnet

        def loss(p, b):
            return schnet.loss_fn(p, cfg, b["species"], b["pos"],
                                  b["senders"], b["receivers"],
                                  b["edge_valid"], b["graph_ids"], n_graphs,
                                  b["targets"], **bk)
    elif arch_id == "dimenet":
        from repro_torch.models.gnn import dimenet
        two_hop_plan = (resolve_gnn_plan(graph, backend, two_hop=True)
                        if two_hop else None)

        def loss(p, b):
            return dimenet.loss_fn(p, cfg, b["species"], b["pos"],
                                   b["senders"], b["receivers"],
                                   b["edge_valid"], b["t_in"], b["t_out"],
                                   b["t_valid"], b["graph_ids"], n_graphs,
                                   b["targets"], **bk,
                                   triplet_plan=triplet_plan,
                                   two_hop_plan=two_hop_plan)
    elif gcn_like:
        from repro_torch.models.gnn import gcn

        def loss(p, b):
            return gcn.loss_fn(p, cfg, b["x"], b["senders"], b["receivers"],
                               b["edge_weight"], b["edge_valid"], b["labels"],
                               b["label_mask"], **bk)
    else:
        from repro_torch.models.gnn import gat

        def loss(p, b):
            return gat.loss_fn(p, cfg, b["x"], b["senders"], b["receivers"],
                               b["edge_valid"], b["labels"], b["label_mask"],
                               **bk)
    return _train_wrap(loss, opt_cfg)


# ---------------------------------------------------------------------------
# RecSys
# ---------------------------------------------------------------------------

def build_recsys_step(cfg: dlrm.DLRMConfig, shape: RecSysShape,
                      opt_cfg=None):
    """The step of ``shape.kind``.  ``train`` differentiates the lookup
    through ``kernels/embedding_bag/ops.lookup``'s Function: B6 forward,
    an order-fixed scatter-add of the bags' cotangents backward."""
    if shape.kind == "train":
        return _train_wrap(
            lambda p, b: dlrm.loss_fn(p, cfg, b["dense"], b["sparse_ids"],
                                      b["labels"]),
            opt_cfg or adamw.AdamWConfig())
    if shape.kind == "retrieval":
        def retrieval(params, batch):
            return dlrm.retrieval_step(params, cfg, batch["dense"],
                                       batch["sparse_ids"],
                                       batch["candidates"])
        return retrieval
    if shape.kind == "serve":
        def serve(params, batch):
            return dlrm.forward(params, cfg, batch["dense"],
                                batch["sparse_ids"])
        return serve
    raise ValueError(f"unknown RecSys shape kind {shape.kind!r}")
