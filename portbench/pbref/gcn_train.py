"""Plain reference of full-graph GCN training (Kipf & Welling, as OGB's
``examples/nodeproppred/arxiv/gnn.py`` builds it): the symmetric
normalisation with self loops, three layers ``h ← Â·(h W) + b`` with ReLU
between them, masked cross-entropy, and Adam(W) with an optional
global-norm clip.  Plain PyTorch: the aggregation is ``index_add_`` over
the edge list, the gradients are autograd's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pbref.precision import matmul_precision, mm

Leaves = Dict[str, torch.Tensor]


def sym_norm(senders: np.ndarray, receivers: np.ndarray, n: int):
    """``D^-1/2 (A + I) D^-1/2`` as (senders, receivers, weights): self
    loops appended, each receiver's in-degree counted with its loop."""
    loops = np.arange(n, dtype=np.int64)
    s = np.concatenate([np.asarray(senders, np.int64), loops])
    r = np.concatenate([np.asarray(receivers, np.int64), loops])
    deg = np.bincount(r, minlength=n).astype(np.float64)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    return s, r, (dinv[s] * dinv[r]).astype(np.float32)


def _aggregate(h: torch.Tensor, s: torch.Tensor, r: torch.Tensor,
               w: torch.Tensor, chunk: int = 1 << 22) -> torch.Tensor:
    out = h.new_zeros(h.shape)
    for lo in range(0, s.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        out = out.index_add(0, r[sl], h.index_select(0, s[sl]) * w[sl, None])
    return out


def loss(params: Leaves, n_layers: int, x, s, r, w, labels, mask,
         precision: str) -> torch.Tensor:
    h = x
    for i in range(n_layers):
        h = _aggregate(mm(h, params[f"layer{i}.w"], precision), s, r, w)
        h = h + params[f"layer{i}.b"]
        if i < n_layers - 1:
            h = torch.relu(h)
    logp = torch.log_softmax(h, dim=-1)
    ll = logp.gather(1, labels[:, None])[:, 0]
    m = mask.to(torch.float32)
    return -(ll * m).sum() / torch.clamp(m.sum(), min=1.0)


def adam_step(params: Leaves, grads: Leaves, state: dict, opt: dict):
    """One Adam(W) step as the configuration states it: the gradients
    clipped to a global norm of ``grad_clip`` (0: no clip), then
    ``m̂ / (√v̂ + eps)`` plus decoupled weight decay.  Returns the new
    parameters and the gradients as the optimizer took them."""
    clip = float(opt.get("grad_clip", 0.0))
    if clip > 0:
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        scale = torch.clamp(clip / torch.clamp(norm, min=1e-9), max=1.0)
        grads = {k: g * scale for k, g in grads.items()}
    t = state["t"] = state["t"] + 1
    b1, b2 = opt["b1"], opt["b2"]
    new = {}
    for k, p in params.items():
        g = grads[k]
        m = state["m"][k] = b1 * state["m"][k] + (1 - b1) * g
        v = state["v"][k] = b2 * state["v"][k] + (1 - b2) * g * g
        upd = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t))
                                      + opt["eps"])
        new[k] = p - opt["lr"] * (upd + opt["weight_decay"] * p)
    return new, grads


def train(params0: Leaves, n_layers: int, x, senders: np.ndarray,
          receivers: np.ndarray, n: int, labels, mask, opt: dict,
          n_steps: int, precision: str = "float32",
          state0: Optional[dict] = None
          ) -> Tuple[List[float], Leaves, Leaves]:
    """``n_steps`` steps from ``params0``: (each step's loss, the first
    step's gradients as the optimizer took them, the parameters after the
    last step).  ``x`` holds the ``n`` real nodes' features.  The
    optimizer starts from ``state0`` (``{"t": steps taken, "m": …, "v":
    …}``) where given, else from zero moments."""
    dev = x.device
    s, r, w = sym_norm(senders, receivers, n)
    s = torch.from_numpy(s).to(dev)
    r = torch.from_numpy(r).to(dev)
    w = torch.from_numpy(w).to(dev)
    params = {k: v.detach().clone() for k, v in params0.items()}
    if state0 is None:
        state = {"t": 0,
                 "m": {k: torch.zeros_like(v) for k, v in params.items()},
                 "v": {k: torch.zeros_like(v) for k, v in params.items()}}
    else:
        state = {"t": int(state0["t"]),
                 "m": {k: state0["m"][k].detach().clone() for k in params},
                 "v": {k: state0["v"][k].detach().clone() for k in params}}
    losses, first = [], None
    with matmul_precision(precision):
        for _ in range(n_steps):
            live = {k: v.requires_grad_() for k, v in params.items()}
            val = loss(live, n_layers, x, s, r, w, labels, mask, precision)
            grads = torch.autograd.grad(val, list(live.values()))
            grads = dict(zip(live, grads))
            with torch.no_grad():
                params, taken = adam_step(
                    {k: v.detach() for k, v in live.items()}, grads, state,
                    opt)
            first = taken if first is None else first
            losses.append(float(val.detach()))
    return losses, first, params
