"""Device-side forest sampling — port of ``repro.serve.device_sampler``.

The counter-hash sampler is pure arithmetic in ``(key, tree_key, hop,
lane)`` and the bucket layout is a static reshape of the per-tree tables,
so the whole chain runs on the device inside the dispatched step: seeds +
per-tree counter terms go in (one host-to-device copy of a (3, T) int64
array), the sampled ``(node_ids, hop_valid)`` bucket arrays come out on
the device in the layout ``buckets.stack_trees`` would have produced.  On
the card that is one launch of the fused ``forest_sample`` kernel
(``kernels/forest_sampler``): every hop of every tree, the draws fused
into their CSR gathers.

Draw-for-draw equality with the host sampler is a hard invariant: the
serving parity check replays requests through the HOST sampler and
compares at ≤1e-5, and the tests assert exact node-table equality.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, host_to_device, resolve_device
from repro_torch.kernels.forest_sampler import forest_sample
from repro_torch.sparse import sampler as host_sampler
from repro_torch.sparse.sampler import _K_TREE, _mix64, SampledSubgraph


def tree_key_mix(tree_keys: np.ndarray) -> np.ndarray:
    """Host-side per-tree counter term ``tree_key · C₁`` as int64 holding
    the uint64 bits — the only per-request arithmetic the host does."""
    with np.errstate(over="ignore"):
        tkm = np.asarray(tree_keys, np.uint64) * _K_TREE
    return tkm.view(np.int64)


def pack_trees(seeds, tkm, live) -> np.ndarray:
    """A bucket's trees as ``forest_sample`` takes them: one (3, T) int64
    host array of seeds, ``tree_key_mix`` bits and live (0/1), so the step
    makes one host-to-device copy."""
    return np.stack([np.asarray(seeds, np.int64), np.asarray(tkm, np.int64),
                     np.asarray(live, bool).astype(np.int64)])


class DeviceSamplerPlane:
    """Per-graph device state: the CSR arrays and the key's counter term
    ``mix64(key)``; the per-hop and per-lane terms are computed where the
    draws are."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 fanouts: Sequence[int], key: int = 0,
                 device: DeviceLike = None):
        dev = resolve_device(device)
        self.device = dev
        self.fanouts = tuple(int(f) for f in fanouts)
        self.indptr = torch.from_numpy(
            np.asarray(indptr, np.int64).copy()).to(dev)
        self.indices = torch.from_numpy(
            np.asarray(indices, np.int64).copy()).to(dev)
        self.key_c = int(_mix64(np.uint64(int(key) % (1 << 64))))

    def sample_trees(self, trees):
        """``forest_sample`` on a (3, T) ``pack_trees`` array (host or
        device): ``(node_ids (n_nodes,), hop_valid (Σbudgets,))`` in the
        bucket's breadth-major layout, on the device."""
        trees = host_to_device(trees, self.device, torch.int64)
        return forest_sample(self.indptr, self.indices, trees, self.fanouts,
                             self.key_c)

    def sample_bucket(self, seeds, tkm, live):
        """Sampled batch in the bucket's breadth-major layout, on device.

        seeds (T,) int, tkm (T,) int64 (``tree_key_mix``), live (T,) bool
        (False ⇒ padding lane: all nodes -1, all edges invalid), as host
        arrays.  A bucket level block viewed as (n_seeds, size) rows is
        tree-major, so the (T, size) level tables ARE the bucket blocks.
        Returns ``(node_ids (n_nodes,), hop_valid (Σbudgets,))``.
        """
        return self.sample_trees(pack_trees(seeds, tkm, live))

    def sample_levels(self, seeds, tkm, live):
        """``sample_bucket`` cut into per-level tables: levels[ℓ] is
        (T, size_ℓ) int64, valid_hops[h] is (T, budget_h) bool — the
        mirror of the host ``sample_forest`` loop."""
        node_ids, hop_valid = self.sample_bucket(seeds, tkm, live)
        t = len(seeds)
        levels, valid_hops = [node_ids[:t].reshape(t, 1)], []
        size, off = 1, 0
        for f in self.fanouts:
            size *= f
            n = t * size
            levels.append(node_ids[t + off:t + off + n].reshape(t, size))
            valid_hops.append(hop_valid[off:off + n].reshape(t, size))
            off += n
        return levels, valid_hops


def sample_forest_device(indptr: np.ndarray, indices: np.ndarray,
                         seeds: np.ndarray, fanouts: Sequence[int],
                         key: int = 0, tree_keys: np.ndarray = None,
                         device: DeviceLike = None) -> List[SampledSubgraph]:
    """Device twin of ``sparse.sampler.sample_forest``: runs the device pass
    and re-assembles per-tree host ``SampledSubgraph`` views.  Output is
    exactly ``sample_forest(indptr, indices, seeds, fanouts, key,
    tree_keys)``."""
    seeds = np.atleast_1d(np.asarray(seeds, np.int64))
    n_trees = seeds.shape[0]
    fanouts = tuple(int(f) for f in fanouts)
    if tree_keys is None:
        tree_keys = np.arange(n_trees, dtype=np.uint64)
    plane = DeviceSamplerPlane(indptr, indices, fanouts, key=key,
                               device=device)
    levels, valid_hops = plane.sample_levels(
        seeds, tree_key_mix(tree_keys), np.ones(n_trees, bool))
    nodes_all = torch.cat(levels, dim=1).cpu().numpy()
    valids = [v.cpu().numpy() for v in valid_hops]
    tmpl = host_sampler.hop_slots(1, fanouts)
    tmpl_s = [s for s, _ in tmpl]
    tmpl_r = [r for _, r in tmpl]
    return [SampledSubgraph(
        node_ids=nodes_all[t], hop_senders=tmpl_s, hop_receivers=tmpl_r,
        hop_valid=[valids[h][t] for h in range(len(fanouts))], n_seeds=1)
        for t in range(n_trees)]
