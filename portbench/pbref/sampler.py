"""A frozen copy of the serving sampler's hashing rule, for the reference.

Each served seed grows a tree of fixed fanouts.  The draw for (tree, hop,
lane) is ``mix64(mix64(key) ⊕ tree_key·C₁ ⊕ (hop+1)·C₂ ⊕ lane·C₃) mod deg``
(splitmix64's finalizer, wrapping uint64 arithmetic), the neighbour is
``indices[indptr[node] + draw]``, and a request's trees are keyed
``(request id << 16) + i`` for its i-th seed.  A node without neighbours
ends its lane: its children are invalid (``-1``), and so is every node
below an invalid one.  Copied here so that a change to the program's
sampler shows as a wrong answer, not as a new reference.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
K_TREE = np.uint64(0xD1B54A32D192ED03)
K_HOP = np.uint64(0x8CB92BA72F3D8DD7)
K_LANE = np.uint64(0x2545F4914F6CDD1D)


def mix64(z):
    with np.errstate(over="ignore"):
        z = np.asarray(z, np.uint64) + _GAMMA
        z = (z ^ (z >> np.uint64(30))) * _M1
        z = (z ^ (z >> np.uint64(27))) * _M2
        return z ^ (z >> np.uint64(31))


def tree_keys(request_id: int, n_seeds: int) -> np.ndarray:
    return ((np.uint64(request_id) << np.uint64(16))
            + np.arange(n_seeds, dtype=np.uint64))


def sample(indptr: np.ndarray, indices: np.ndarray, seeds: np.ndarray,
           fanouts: Sequence[int], key: int, keys: np.ndarray
           ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """The trees of ``seeds``: ``levels[l]`` (T, Πfanouts[:l]) node ids
    (``-1`` invalid) and ``valid[l]`` the same shape, level 0 the seeds."""
    seeds = np.asarray(seeds, np.int64)
    t = seeds.shape[0]
    key_c = mix64(np.uint64(int(key) % (1 << 64)))
    keys = np.asarray(keys, np.uint64)
    frontier = seeds.reshape(t, 1)
    live = np.ones((t, 1), bool)
    levels, valid = [frontier.copy()], [live.copy()]
    for h, f in enumerate(fanouts):
        lanes = frontier.shape[1] * f
        start = indptr[frontier]
        deg = indptr[frontier + 1] - start
        lane = np.arange(lanes, dtype=np.uint64)
        with np.errstate(over="ignore"):
            z = (key_c ^ (keys[:, None] * K_TREE)
                 ^ (np.uint64(h + 1) * K_HOP) ^ (lane[None, :] * K_LANE))
        draw = (mix64(z).reshape(t, -1, f)
                % np.maximum(deg, 1)[:, :, None].astype(np.uint64)
                ).astype(np.int64)
        ok = np.repeat(live & (deg > 0), f, axis=1)
        at = np.minimum(start[:, :, None] + draw, max(indices.size - 1, 0))
        nbr = np.where(ok, indices[at].reshape(t, lanes) if indices.size
                       else 0, -1)
        levels.append(nbr)
        valid.append(ok)
        frontier = np.where(ok, nbr, 0)
        live = ok
    return levels, valid
