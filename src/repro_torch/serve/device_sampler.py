"""Device-side forest sampling — port of ``repro.serve.device_sampler``.

The counter-hash sampler is pure arithmetic in ``(key, tree_key, hop,
lane)`` and the bucket layout is a static reshape of the per-tree tables,
so the whole chain runs on the device inside the dispatched step: seeds +
per-tree counter terms go in, the sampled ``(node_ids, hop_valid)`` bucket
arrays come out on the device in the layout ``buckets.stack_trees`` would
have produced.  The draws are the ``hash_draws`` kernel
(``kernels/forest_sampler``).

Draw-for-draw equality with the host sampler is a hard invariant: the
serving parity check replays requests through the HOST sampler and
compares at ≤1e-5, and the tests assert exact node-table equality.  JAX
gathers clip out-of-range indices where torch faults, so every gather index
here is clamped explicitly.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.forest_sampler import hash_draws
from repro_torch.sparse import sampler as host_sampler
from repro_torch.sparse.sampler import (_K_HOP, _K_LANE, _K_TREE, _mix64,
                                        SampledSubgraph)


def tree_key_mix(tree_keys: np.ndarray) -> np.ndarray:
    """Host-side per-tree counter term ``tree_key · C₁`` as int64 holding
    the uint64 bits — the only per-request arithmetic the host does."""
    with np.errstate(over="ignore"):
        tkm = np.asarray(tree_keys, np.uint64) * _K_TREE
    return tkm.view(np.int64)


class DeviceSamplerPlane:
    """Per-graph device state: the CSR arrays and the per-hop constant
    counter terms ``mix64(key) ⊕ hop·C₂ ⊕ lane·C₃`` (precomputed once on
    the host; they depend only on ``(key, fanouts)``)."""

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
        self.n_edges = int(np.asarray(indices).size)
        key_c = _mix64(np.uint64(int(key) % (1 << 64)))
        self._hop_consts = []
        lanes = 1
        for h, f in enumerate(self.fanouts):
            lane_idx = np.arange(lanes * f, dtype=np.uint64)
            with np.errstate(over="ignore"):
                zc = (key_c ^ (np.uint64(h + 1) * _K_HOP)
                      ^ (lane_idx * _K_LANE))
            self._hop_consts.append(torch.from_numpy(zc.view(np.int64)
                                                     ).to(dev))
            lanes *= f

    def sample_levels(self, seeds, tkm, live):
        """One vectorized pass over T trees → per-level tables.

        seeds (T,) int, tkm (T,) int64 (``tree_key_mix``), live (T,) bool
        (False ⇒ padding lane: all nodes -1, all edges invalid).  Returns
        ``(levels, valid_hops)``: levels[ℓ] is (T, size_ℓ) int64,
        valid_hops[h] is (T, budget_h) bool — the mirror of the host
        ``sample_forest`` loop.
        """
        dev = self.device
        seeds = torch.as_tensor(seeds, device=dev).to(torch.int64)
        tkm = torch.as_tensor(tkm, device=dev)
        live = torch.as_tensor(live, device=dev)
        t = seeds.shape[0]
        last = self.indptr.shape[0] - 1
        frontier = torch.where(live, seeds, 0).reshape(t, 1)
        live_l = live.reshape(t, 1)
        levels = [torch.where(live, seeds, -1).reshape(t, 1)]
        valid_hops = []
        lanes = 1
        for h, f in enumerate(self.fanouts):
            start = self.indptr[frontier.clamp(0, last)]
            deg = self.indptr[(frontier + 1).clamp(0, last)] - start
            has_nbr = deg > 0
            z = tkm[:, None] ^ self._hop_consts[h][None, :]
            dmax = deg.clamp_min(1).to(torch.int32).repeat_interleave(f, 1)
            r = hash_draws(z.contiguous(), dmax.contiguous())
            r = r.reshape(t, lanes, f).to(torch.int64)
            if self.n_edges:
                gather = (start[:, :, None] + r).clamp(0, self.n_edges - 1)
                nbr = self.indices[gather]
            else:
                nbr = torch.zeros((t, lanes, f), dtype=torch.int64,
                                  device=dev)
            valid = (has_nbr & live_l)[:, :, None].expand(t, lanes, f)
            nbr = torch.where(valid, nbr, -1)
            levels.append(nbr.reshape(t, lanes * f))
            valid_hops.append(valid.reshape(t, lanes * f))
            frontier = torch.where(valid, nbr, 0).reshape(t, lanes * f)
            live_l = valid.reshape(t, lanes * f)
            lanes *= f
        return levels, valid_hops

    def sample_bucket(self, seeds, tkm, live):
        """Sampled batch in the bucket's breadth-major layout, on device.

        A bucket level block viewed as (n_seeds, size) rows is tree-major,
        so the (T, size) level tables ARE the bucket blocks: flatten and
        concatenate.  Returns ``(node_ids (n_nodes,), hop_valid
        (Σbudgets,))``.
        """
        levels, valid_hops = self.sample_levels(seeds, tkm, live)
        node_ids = torch.cat([lv.reshape(-1) for lv in levels])
        hop_valid = torch.cat([v.reshape(-1) for v in valid_hops])
        return node_ids, hop_valid


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
