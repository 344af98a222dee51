"""End-to-end training driver (port of ``repro.launch.train``).

Trains with allocated parameters, a data stream, checkpoints and the
fault-tolerant loop, on the card unless ``--device cpu`` is given:

  # ~100M-parameter LM (the lm100m preset), blocked attention:
  PYTHONPATH=src python -m repro_torch.launch.train --preset lm100m \
      --steps 300

  # any LM arch at its reduced config:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      --steps 50

  # paper workload — GCN at full width on a Cora-scale synthetic graph:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gcn-cora \
      --full-gnn --backend cuda --steps 50

  # GAT (8 heads, each head's aggregation on B1) and DLRM (B6 forward):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gat-cora \
      --full-gnn --backend cuda --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-rm2 \
      --batch 8 --steps 50

  # the same on the CPU (the kernels' plain versions):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gcn-cora \
      --full-gnn --backend cuda --steps 5 --device cpu

The LM family (``--preset lm100m``, ``--arch <lm>`` at its reduced
config) trains on ``TokenStream(--batch, --seq)`` batches, AdamW at lr
3e-4, through ``launch/steps.build_lm_step`` (blocked attention: B8 has no
backward).  ``--backend`` picks the aggregation executor (``dense``,
``chunked``, ``cuda``, ``cuda_q8``); ``--two-hop`` aggregates over the
SpGEMM-built Â² (gcn).  dlrm-rm2 trains its *reduced* config, as the
reference does, on ``--batch``-sample ``dlrm_batch(seed=i)`` batches.
schnet and dimenet raise ``NotImplementedError``, as the reference's
launcher does not train them either: its setup builds Cora's graph and its
node features (``dataclasses.replace(cfg, d_in=...)``), which the
geometric configs do not have.  Train those through
``launch/steps.build_gnn_step`` and ``train.loop.run`` on a molecule
batch.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.shapes import LMShape
from repro_torch.data import synthetic as syn
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.models.lm.transformer import LMConfig
from repro_torch.optim import adamw
from repro_torch.sparse.plan import ALL_BACKENDS
from repro_torch.train import loop as train_loop

N_NODES = 2708
N_LABELLED = 140

LM100M = LMConfig(
    name="lm100m", n_layers=10, d_model=640, n_heads=10, n_kv_heads=5,
    head_dim=64, d_ff=2560, vocab=32768, act="silu", qk_norm=True,
    q_chunk=256, kv_chunk=256,
)  # ≈ 103M params (61M layers + 2×21M embeddings)


def _lm_setup(cfg, batch: int, seq: int, seed: int,
              device: DeviceLike = None):
    """(params, step, batches) for an LM config: parameters drawn on the
    device from ``seed``, ``TokenStream(batch, seq, seed=seed)`` batches,
    AdamW at lr 3e-4, as the reference sets it up."""
    from repro_torch.models.lm import transformer as T
    dev = resolve_device(device)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    stream = syn.TokenStream(batch, seq, cfg.vocab, seed=seed)
    step = steps_mod.build_lm_step(cfg, LMShape("train", "train", seq, batch),
                                   adamw.AdamWConfig(lr=3e-4))
    batches = ({"tokens": torch.from_numpy(t).to(dev)} for t in stream)
    return params, step, batches


def _gnn_setup(arch_id, cfg, seed, backend: str = "dense",
               two_hop: bool = False, device: DeviceLike = None):
    """(params, step, batches) for ``arch_id`` on the Cora-scale graph: for
    gcn sym-normed edges with self loops, for gat the edges as they are
    (no weights); a zero ghost row, the first 140 nodes labelled, AdamW at
    lr 1e-2."""
    from repro_torch.sparse.graph import make_graph, sym_norm_weights
    dev = resolve_device(device)
    s, r, x, y, c = syn.cora_like(seed)
    n = N_NODES
    gcn_like = arch_id.startswith("gcn")
    if gcn_like:
        s2, r2, w = sym_norm_weights(s, r, n)
        g = make_graph(s2, r2, n, w, device=dev)
        from repro_torch.models.gnn import gcn as m
    else:
        g = make_graph(s, r, n, device=dev)
        from repro_torch.models.gnn import gat as m
    cfg = dataclasses.replace(cfg, d_in=x.shape[1], n_classes=c)
    params = m.init_params(cfg, torch.Generator().manual_seed(seed),
                           device=dev)
    xp = np.vstack([x, np.zeros((1, x.shape[1]), np.float32)])
    labels = np.concatenate([y, [0]]).astype(np.int32)
    mask = np.zeros(n + 1, bool)
    mask[:N_LABELLED] = True

    def t(a):
        return torch.from_numpy(a).to(dev)
    batch = {"x": t(xp), "senders": g.senders, "receivers": g.receivers,
             "edge_valid": g.edge_valid, "labels": t(labels),
             "label_mask": t(mask)}
    if gcn_like:
        batch["edge_weight"] = g.edge_weight
    # the graph goes through the plan cache: re-building the step re-packs
    # nothing, and the plan keeps its sums' orders from step to step
    step = steps_mod.build_gnn_step(arch_id, cfg, adamw.AdamWConfig(lr=1e-2),
                                    backend=backend, graph=g,
                                    two_hop=two_hop or None)

    def batches():
        while True:
            yield batch

    return params, step, batches()


def _recsys_setup(arch_id, seed, batch: int, device: DeviceLike = None):
    """(params, step, batches) for the RecSys arch at its *reduced*
    config, as the reference trains it: AdamW at lr 1e-3 on
    ``dlrm_batch(batch, seed=i)`` for i = 0, 1, …"""
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.models.recsys import dlrm
    dev = resolve_device(device)
    cfg = registry.get_config(arch_id, reduced=True)
    params = dlrm.init_params(cfg, torch.Generator().manual_seed(seed),
                              device=dev)
    step = steps_mod.build_recsys_step(cfg, RECSYS_SHAPES["train_batch"],
                                       adamw.AdamWConfig(lr=1e-3))

    def batches():
        i = 0
        while True:
            d, ids, y = syn.dlrm_batch(batch, cfg.n_dense, cfg.vocab_sizes,
                                       seed=i)
            yield {"dense": torch.from_numpy(d).to(dev),
                   "sparse_ids": torch.from_numpy(ids).to(dev),
                   "labels": torch.from_numpy(y).to(dev)}
            i += 1

    return params, step, batches()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="assigned arch id (reduced)")
    ap.add_argument("--preset", default=None, choices=[None, "lm100m"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8,
                    help="samples a step (LM, recsys)")
    ap.add_argument("--seq", type=int, default=512,
                    help="tokens a sample (LM)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory; a committed step there is "
                         "resumed (default: a new temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--full-gnn", action="store_true",
                    help="full (non-reduced) GNN config on Cora-scale data")
    ap.add_argument("--backend", default="dense",
                    choices=[b for b in ALL_BACKENDS if b != "distributed"],
                    help="sparse aggregation executor (GNN archs; the "
                         "SPMD `distributed` one trains through "
                         "launch.variants on a process group)")
    ap.add_argument("--two-hop", action="store_true",
                    help="aggregate over the SpGEMM-precomputed Â² two-hop "
                         "graph (gcn; gat raises)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    arch_id = args.arch or "gcn-cora"
    if args.preset == "lm100m":
        from repro_torch.models.common import count_params
        params, step, batches = _lm_setup(LM100M, args.batch, args.seq,
                                          args.seed, args.device)
        print(f"[train] lm100m: {count_params(params) / 1e6:.1f}M params")
    elif registry.entry(arch_id).gnn_kind == "geom":
        raise NotImplementedError(
            f"{arch_id!r} is not trained by this launcher, as the "
            "reference's is not: its setup builds the Cora-scale graph and "
            "its node features (d_in), which the geometric configs do not "
            "have; train it on a molecule batch through "
            "launch/steps.build_gnn_step and train.loop.run")
    elif registry.entry(arch_id).family == "lm":
        cfg = registry.get_config(arch_id, reduced=True)
        params, step, batches = _lm_setup(cfg, args.batch, args.seq,
                                          args.seed, args.device)
    elif registry.entry(arch_id).family == "recsys":
        params, step, batches = _recsys_setup(arch_id, args.seed,
                                              args.batch, args.device)
    else:
        cfg = registry.get_config(arch_id, reduced=not args.full_gnn)
        params, step, batches = _gnn_setup(arch_id, cfg, args.seed,
                                           backend=args.backend,
                                           two_hop=args.two_hop,
                                           device=args.device)
    state = train_loop.TrainState(params=params,
                                  opt_state=adamw.init_state(params))
    cfg_loop = train_loop.TrainLoopConfig(
        n_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir)
    t0 = time.time()
    state, hist = train_loop.run(state, step, batches, cfg_loop)
    dt = time.time() - t0
    print(f"[train] {state.step} steps in {dt:.1f}s; "
          f"loss {hist['loss'][0]:.4f} → {hist['loss'][-1]:.4f}; "
          f"stragglers={hist['stragglers']} retries={hist['retries']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
