"""Step builders (the RecSys part of ``repro.launch.steps``).

``build_recsys_step(cfg, shape)`` returns the function a DLRM server calls
per batch: ``serve`` → logits, ``retrieval`` → candidate scores.  Batches
are dicts of tensors on the parameters' device: ``dense`` (B, 13) f32,
``sparse_ids`` (B, 26, M) int32 and, for retrieval, ``candidates`` (C, D).
"""
from __future__ import annotations

from repro_torch.configs.shapes import RecSysShape
from repro_torch.models.recsys import dlrm


def build_recsys_step(cfg: dlrm.DLRMConfig, shape: RecSysShape):
    if shape.kind == "train":
        raise NotImplementedError(
            "DLRM training is not ported yet: it comes with AdamW and the "
            "train loop (ROADMAP queue A1)")
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
