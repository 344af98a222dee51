"""Step builders (the GNN and RecSys parts of ``repro.launch.steps``).

Train steps take (params, opt_state, batch) and return (params,
opt_state, metrics); serve steps take (params, batch) and return outputs.
Batches are dicts of tensors on the parameters' device.

* GNN: ``build_gnn_step`` builds gcn's training step on any aggregation
  executor (``dense``, ``chunked``, ``cuda``, ``cuda_q8``), optionally over
  the SpGEMM-precomputed Â² (``two_hop``).  The other GNNs are ROADMAP
  queue A2.
* RecSys: ``build_recsys_step`` — ``serve`` → logits, ``retrieval`` →
  candidate scores (``dense`` (B, 13) f32, ``sparse_ids`` (B, 26, M) int32,
  ``candidates`` (C, D)).  DLRM training is ROADMAP queue A1.
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
    grad_norm}): the loss, its gradients over every parameter leaf, one
    AdamW update."""
    def step(params, opt_state, batch):
        leaves, structure = tree.flatten(params)
        live = [p.detach().requires_grad_() for p in leaves]
        loss = loss_fn(tree.unflatten(structure, live), batch)
        grads = torch.autograd.grad(loss, live)
        new_p, new_s, gnorm = adamw.apply_updates(
            params, tree.unflatten(structure, list(grads)), opt_state,
            opt_cfg)
        return new_p, new_s, {"loss": loss.detach(), "grad_norm": gnorm}
    return step


# ---------------------------------------------------------------------------
# GNN
# ---------------------------------------------------------------------------

def resolve_gnn_plan(graph, backend: str, two_hop: bool = False):
    """Host plan for ``graph`` through the plan cache — repeated step
    builds against a static graph re-pack no layouts.  ``dense``/``chunked``
    run off the inline COO plan the models build, so they need none —
    except under ``two_hop``, where the aggregation graph is the
    SpGEMM-precomputed Â² (one sparse×sparse product per static graph,
    through its own cache, on its default executor), whose edges differ
    from the batch arrays, so every backend needs the host plan."""
    if graph is None:
        return None
    if two_hop:
        from repro_torch.sparse.spgemm import cached_two_hop_graph
        graph = cached_two_hop_graph(graph)
    host = backend in ("cuda", "cuda_q8")
    if not (host or two_hop):
        return None
    from repro_torch.sparse.plan import cached_plan_from_graph
    return cached_plan_from_graph(
        graph, backends=(backend,) if host else ("dense", "chunked"))


def build_gnn_step(arch_id: str, cfg, opt_cfg=None, backend: str = "dense",
                   plan=None, graph=None, two_hop=None):
    """gcn's training step on the executor ``backend``; ``plan`` is a
    host-built ``make_plan`` — required for ``cuda``/``cuda_q8`` (or pass
    ``graph`` and the layouts come from the plan cache), optional (inline
    COO plan) for ``dense``/``chunked``.  ``two_hop`` (default: the
    config's ``two_hop`` field, if any) precomputes Â² once through the
    SpGEMM engine and aggregates over it."""
    if not arch_id.startswith("gcn"):
        raise NotImplementedError(
            f"training {arch_id!r} is not ported yet: the GNNs other than "
            "gcn are ROADMAP queue A2")
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    if two_hop is None:
        two_hop = getattr(cfg, "two_hop", False)
    # two_hop must never silently degrade to one-hop aggregation
    if two_hop and graph is None:
        raise ValueError(
            "two_hop=True needs graph=<Graph> so the step builder can "
            "precompute Â² through the SpGEMM engine")
    if two_hop and plan is not None:
        raise ValueError(
            "pass graph=, not plan=, with two_hop=True — the Â² plan is "
            "derived from the graph (an explicit plan would aggregate "
            "one-hop)")
    if plan is None:
        plan = resolve_gnn_plan(graph, backend, two_hop=two_hop)
    from repro_torch.models.gnn import gcn

    def loss(p, b):
        return gcn.loss_fn(p, cfg, b["x"], b["senders"], b["receivers"],
                           b["edge_weight"], b["edge_valid"], b["labels"],
                           b["label_mask"], backend=backend, plan=plan)
    return _train_wrap(loss, opt_cfg)


# ---------------------------------------------------------------------------
# RecSys
# ---------------------------------------------------------------------------

def build_recsys_step(cfg: dlrm.DLRMConfig, shape: RecSysShape):
    if shape.kind == "train":
        raise NotImplementedError(
            "DLRM training is not ported yet (ROADMAP queue A1, its DLRM "
            "item: whether the lookup trains through B6, which then needs "
            "a backward kernel)")
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
