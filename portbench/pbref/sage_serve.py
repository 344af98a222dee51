"""Plain reference of sampled GraphSAGE-mean inference (Hamilton et al.,
arXiv:1706.02216): each seed's answer from its own fanout tree,

    h_i ← act(h_i W_self + mean_{valid children j} h_j W_nbr + b),

layer ``l`` of ``L`` at the tree's levels ``0 … L-1-l``, ReLU between the
layers, the seed's row of the last one returned.  The trees come from the
frozen copy of the sampler's rule (``pbref.sampler``); the features are
the benchmark's table, an invalid node reading zeros.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from pbref import sampler
from pbref.precision import matmul_precision, mm


def forward(x: torch.Tensor, params: Dict[str, torch.Tensor],
            levels: List[np.ndarray], valid: List[np.ndarray],
            fanouts: Sequence[int], precision: str = "float32"
            ) -> torch.Tensor:
    """(T, classes) answers of T trees; ``x`` (N, D) on the device."""
    dev = x.device
    n_layers = len(fanouts)
    t = levels[0].shape[0]
    masks = [torch.from_numpy(v).to(dev) for v in valid]
    h = []
    for ids, ok in zip(levels, masks):
        idx = torch.from_numpy(np.where(ids >= 0, ids, 0)).to(dev)
        rows = x.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + (x.shape[1],))
        h.append(torch.where(ok[..., None], rows, 0.0))
    with matmul_precision(precision):
        for layer in range(n_layers):
            p = {k: params[f"layer{layer}.{k}"]
                 for k in ("w_self", "w_nbr", "b")}
            new = []
            for j in range(n_layers - layer):
                kids = h[j + 1].reshape(t, h[j].shape[1], fanouts[j], -1)
                ok = masks[j + 1].reshape(t, h[j].shape[1], fanouts[j], 1)
                count = ok.sum(dim=2).to(torch.float32)
                mean = (kids * ok).sum(dim=2) / torch.clamp(count, min=1.0)
                out = (mm(h[j], p["w_self"], precision)
                       + mm(mean, p["w_nbr"], precision) + p["b"])
                new.append(torch.relu(out) if layer < n_layers - 1
                           else out)
            h = new
    return h[0][:, 0]


def answers(indptr: np.ndarray, indices: np.ndarray, x: torch.Tensor,
            params: Dict[str, torch.Tensor], fanouts: Sequence[int],
            key: int, requests, precision: str = "float32"
            ) -> List[torch.Tensor]:
    """Each request's (seeds, classes) answers; ``requests`` is a list of
    (request id, seeds)."""
    out = []
    for rid, seeds in requests:
        levels, valid = sampler.sample(
            indptr, indices, seeds, fanouts, key,
            sampler.tree_keys(rid, len(seeds)))
        out.append(forward(x, params, levels, valid, fanouts, precision))
    return out
