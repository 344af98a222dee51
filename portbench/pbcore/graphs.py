"""The benchmark's input graphs: fixed stand-ins for public datasets, each
drawn from a seed its configuration states, as a real dataset is fixed.

Both laws are the port's ``data/synthetic.powerlaw_graph``, copied here so
that the inputs do not move when the program does: each edge's sender is
drawn with weight ``i^(-alpha/2)`` over node ids ``i = 1 … N`` and its
receiver uniformly, self loops dropped.

Both draw on the device from a ``torch.Generator`` there, so a graph is
fixed for a given kind of device, and is drawn in a second or less.

* ``powerlaw_exact``: exactly ``n_edges`` distinct directed edges;
  ``symmetrize`` then makes the graph undirected with every pair once in
  each direction, as OGB's ``to_symmetric`` does.
* ``powerlaw_csr_device`` (for graphs of 10⁸ edges): ``n_edges / 2``
  draws, each stored in both directions, so the in-degrees are power-law
  too; a pair drawn twice stays twice, and the count is exact.  Returns
  the CSR whose rows are receivers.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _weights(n: int, alpha: float) -> np.ndarray:
    w = np.arange(1, n + 1, dtype=np.float64) ** (-alpha / 2.0)
    return w / w.sum()


def _draw(n_nodes: int, count: int, alpha: float, gen: torch.Generator,
          device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``count`` edges of the law: (senders by weight, receivers uniform
    and other than the sender), int64 on ``device``."""
    cdf = torch.from_numpy(np.cumsum(_weights(n_nodes, alpha))).to(device)
    u = torch.rand(count, generator=gen, device=device, dtype=torch.float64)
    s = torch.searchsorted(cdf, u).clamp_(max=n_nodes - 1)
    r = (s + torch.randint(1, n_nodes, (count,), generator=gen,
                           device=device)) % n_nodes
    return s, r


def powerlaw_exact(n_nodes: int, n_edges: int, alpha: float, seed: int,
                   device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """(senders, receivers) int64 on ``device``: ``n_edges`` distinct
    directed edges without self loops, the first drawn of each pair kept,
    in the order first drawn."""
    gen = torch.Generator(device=device).manual_seed(seed)
    keys = torch.zeros(0, dtype=torch.int64, device=device)
    while keys.numel() < n_edges:
        s, r = _draw(n_nodes, int((n_edges - keys.numel()) * 1.2) + 1024,
                     alpha, gen, device)
        keys = torch.cat([keys, s * n_nodes + r])
        uniq, inv = torch.unique(keys, return_inverse=True)
        first = torch.full_like(uniq, keys.numel()).scatter_reduce_(
            0, inv, torch.arange(keys.numel(), device=device), "amin")
        keys = keys[torch.sort(first).values]
    keys = keys[:n_edges]
    return keys // n_nodes, keys % n_nodes


def symmetrize(senders: torch.Tensor, receivers: torch.Tensor,
               n_nodes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every pair in both directions, once, sorted by (sender, receiver)."""
    a = torch.cat([senders, receivers]).to(torch.int64)
    b = torch.cat([receivers, senders]).to(torch.int64)
    keys = torch.unique(a * n_nodes + b)
    return keys // n_nodes, keys % n_nodes


def degree_percentiles(deg: np.ndarray) -> dict:
    q = np.percentile(deg, [0, 50, 90, 99, 100])
    return {f"p{p}": float(v) for p, v in zip((0, 50, 90, 99, 100), q)}


def powerlaw_csr_device(n_nodes: int, n_edges: int, alpha: float,
                        seed: int, device) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(indptr (N+1,), indices (E,)) int64 on ``device``: row ``i`` lists
    the senders of the edges into ``i``."""
    if n_edges % 2:
        raise ValueError(f"{n_edges} edges: an undirected graph stores "
                         "each pair twice")
    half = n_edges // 2
    gen = torch.Generator(device=device).manual_seed(seed)
    s, r = _draw(n_nodes, half, alpha, gen, device)
    rows = torch.cat([r, s])
    cols = torch.cat([s, r])
    del s, r
    rows, order = torch.sort(rows, stable=True)
    cols = cols[order]
    del order
    counts = torch.bincount(rows, minlength=n_nodes)
    indptr = torch.zeros(n_nodes + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(counts, 0)
    return indptr, cols
