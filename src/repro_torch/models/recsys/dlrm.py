"""DLRM (Naumov et al., arXiv:1906.00091), RM2-class config — port of
``repro.models.recsys.dlrm``.

All 26 tables are fused into one ``(padded_vocab, D)`` table with per-field
offsets.  The lookup goes through the EmbeddingBag kernel
(``kernels/embedding_bag``, B6): on the card it is the hand-written CUDA
kernel, on CPU tensors its plain version; in training its backward is an
order-fixed scatter of the bags' cotangents into the table's gradient
(``kernels/embedding_bag/ops.lookup``).  The dot interaction is a batched
Gram matrix (``torch.bmm``) and its upper triangle; the MLPs are plain
``x @ w + b`` products.  Parameters are ``{"table", "bot": {w_i, b_i},
"top": {w_i, b_i}}`` as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.embedding_bag import lookup
from repro_torch.models.common import mlp_apply, mlp_init

Params = Dict[str, object]

# RM2-scale per-field vocab sizes (Criteo-like mix of huge and small tables).
DEFAULT_VOCABS: Tuple[int, ...] = (
    9980333, 36084, 17217, 7378, 20134, 3, 7112, 1442, 61, 9758201, 1333352,
    313829, 10, 2208, 11156, 122, 4, 970, 14, 9994222, 7267859, 9946608,
    415421, 12420, 101, 36,
)


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    bot_mlp: Tuple[int, ...] = (13, 512, 256, 64)
    top_mlp_hidden: Tuple[int, ...] = (512, 512, 256, 1)
    vocab_sizes: Tuple[int, ...] = DEFAULT_VOCABS
    multi_hot: int = 1
    param_dtype: str = "float32"

    @property
    def total_vocab(self) -> int:
        return int(sum(self.vocab_sizes))

    @property
    def padded_vocab(self) -> int:
        """Fused-table rows padded to a multiple of 2048, as the reference
        pads them for its row shards."""
        return ((self.total_vocab + 2047) // 2048) * 2048

    @property
    def field_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.vocab_sizes)[:-1]]).astype(
            np.int32)

    @property
    def n_interactions(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2

    @property
    def top_mlp_in(self) -> int:
        return self.n_interactions + self.bot_mlp[-1]


def init_params(cfg: DLRMConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Table ~ N(0, 0.01²), MLP weights ~ N(0, 1/fan_in), zero biases — the
    reference's initializer, drawn from ``generator`` on its own device and
    placed on ``device``.  Pass a CUDA generator for the full table
    (12.6 GB at dlrm-rm2): it is then drawn on the card in place."""
    if cfg.bot_mlp[-1] != cfg.embed_dim:
        raise ValueError("bottom-MLP output width must equal embed_dim "
                         "(DLRM dot interaction)")
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    table = torch.randn((cfg.padded_vocab, cfg.embed_dim),
                        generator=generator, dtype=dt,
                        device=generator.device).mul_(0.01).to(dev)
    return {
        "table": table,
        "bot": mlp_init(generator, list(cfg.bot_mlp), dt, dev),
        "top": mlp_init(generator, [cfg.top_mlp_in]
                        + list(cfg.top_mlp_hidden), dt, dev),
    }


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  field_offsets: torch.Tensor,
                  use_kernel: bool = True) -> torch.Tensor:
    """ids (B, F, M) local int32 ids → (B, F, D) sum-bags, after offsetting
    each field into the fused table.  One B6 launch on the card; the
    kernel's batch tile is its own, so the reference's ``batch_tile`` check
    is given the largest tile ≤ 8 that divides B."""
    global_ids = ids + field_offsets.to(ids.dtype)[None, :, None]
    return lookup(global_ids, table, batch_tile=math.gcd(ids.shape[0], 8),
                  use_kernel=use_kernel)


def interact(dense_out: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Dot-product feature interaction (DLRM 'dot'): upper triangle of the
    (F+1)×(F+1) Gram matrix of field vectors, row-major."""
    z = torch.cat([dense_out[:, None, :], emb], dim=1)        # (B, F+1, D)
    gram = torch.bmm(z, z.transpose(1, 2))
    f = z.shape[1]
    iu, ju = torch.triu_indices(f, f, offset=1, device=z.device)
    # ``gram[:, iu, ju]`` as one ``index_select`` of the flat Gram rows (the
    # same values; each index once, so the backward's scatter is exact)
    return gram.reshape(gram.shape[0], f * f).index_select(1, iu * f + ju)


def _offsets(cfg: DLRMConfig, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(cfg.field_offsets).to(like.device)


def forward(params: Params, cfg: DLRMConfig, dense: torch.Tensor,
            sparse_ids: torch.Tensor, use_kernel: bool = True
            ) -> torch.Tensor:
    """dense (B, 13), sparse_ids (B, 26, M) → logits (B,).
    ``use_kernel=False`` runs the lookup's plain version (the check the
    card's run is held against)."""
    x = mlp_apply(params["bot"], dense, act=torch.relu, final_act=True)
    emb = embedding_bag(params["table"], sparse_ids,
                        _offsets(cfg, sparse_ids), use_kernel=use_kernel)
    feats = torch.cat([interact(x, emb), x], dim=-1)
    return mlp_apply(params["top"], feats, act=torch.relu)[:, 0]


def loss_fn(params: Params, cfg: DLRMConfig, dense: torch.Tensor,
            sparse_ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on the logits, in its stable form; its
    gradient reaches the table through the lookup's Function."""
    logits = forward(params, cfg, dense, sparse_ids).float()
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


def retrieval_step(params: Params, cfg: DLRMConfig, dense: torch.Tensor,
                   sparse_ids: torch.Tensor, candidates: torch.Tensor,
                   use_kernel: bool = True) -> torch.Tensor:
    """Score each query against (C, D) candidate embeddings → (B, C): one
    batched product, not a loop."""
    x = mlp_apply(params["bot"], dense, act=torch.relu, final_act=True)
    emb = embedding_bag(params["table"], sparse_ids,
                        _offsets(cfg, sparse_ids), use_kernel=use_kernel)
    q = x + emb.mean(dim=1)                                    # (B, D)
    return q @ candidates.T                                    # (B, C)
