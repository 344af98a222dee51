#!/usr/bin/env python3
"""B4 (``spmm_dedup_chunks_q8``) at one lane from several checkouts, in
turns, on one GPU.

    python3 tools/b4_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of this repo (for example the parent commit
unpacked with ``git archive`` into an ignored directory, and ``.``).  The
roots run one after another, each in its own process that imports that
root's ``repro_torch`` and builds its kernels from that root's sources, so
give them in turns (``parent . . parent``; ``tools/in_turns.py`` runs
them).  Every process times, by the same code, B4 with one row of feature
scales (the single-lane serving and training path) and f32 B1 beside it,
at phase 2's bucket-16 plan with D = 16 and the Cora-scale plan with
D = 1433, on the same seeded inputs, and hashes B4's output: one lane's
bits must not depend on the checkout.
Prints the card's name and power limit first, one JSON line a process,
then a JSON summary; exits non-zero without a GPU, when a process fails
or when the outputs' bits differ between roots.
"""
from __future__ import annotations

import hashlib
import pathlib
import sys

import in_turns

SHAPES = (("bucket16", 16), ("cora_full", 1433))


def measure(root: pathlib.Path) -> dict:
    sys.path[:0] = [str(root / "src"), str(root)]
    import numpy as np
    import torch
    import chip_smoke as c
    from repro_torch.data.synthetic import cora_like
    from repro_torch.kernels.gustavson_spmm import (auto_d_tile,
                                                    spmm_dedup_chunks,
                                                    spmm_dedup_chunks_q8)
    from repro_torch.serve.buckets import build_bucket_structure
    from repro_torch.sparse.graph import sym_norm_weights
    from repro_torch.sparse.plan import make_plan
    from repro_torch.sparse.quantize import quantize_feature_tiles
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    st = build_bucket_structure(16, (5, 3), with_loops=True)
    w = rng.uniform(0.1, 1.0, st.n_edges).astype(np.float32)
    backends = ("cuda", "cuda_q8")
    plans = {"bucket16": make_plan(st.senders, st.receivers, st.n_nodes,
                                   edge_weight=w, backends=backends,
                                   device=dev)}
    s, r, _, _, _ = cora_like(seed=0)
    s2, r2, wn = sym_norm_weights(s, r, 2708)
    plans["cora_full"] = make_plan(s2, r2, 2709, edge_weight=wn,
                                   backends=backends, device=dev)
    out = {"root": str(root)}
    for name, d in SHAPES:
        p = plans[name]
        x = torch.from_numpy(rng.normal(size=(p.n_rows, d)).astype(
            np.float32)).to(dev)
        qt = auto_d_tile(d)
        x_q8, x_scale = quantize_feature_tiles(x, qt)

        def b4():
            return spmm_dedup_chunks_q8(p.ell_u_cols, p.ell_remaining,
                                        p.ell_block_ptr, p.ell_a_q8,
                                        p.ell_a_scale, x_q8, x_scale,
                                        block_rows=8, q_tile=qt)

        def b1():
            return spmm_dedup_chunks(p.ell_u_cols, p.ell_remaining,
                                     p.ell_block_ptr, p.ell_a, x,
                                     block_rows=8)
        y = b4().cpu().numpy()
        out[f"{name} D={d}"] = dict(
            b4_ms=c.graph_ms(b4), b1_ms=c.graph_ms(b1),
            sha256=hashlib.sha256(y.tobytes()).hexdigest())
    return out


if __name__ == "__main__":
    sys.exit(in_turns.main(__file__, measure, sys.argv[1:],
                           same_bits=True))
