#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU and check it.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on any failure:

1. device — print the card's name and power limit (``nvidia-smi``), build
   the eight CUDA kernels from the six sources of
   ``src/repro_torch/kernels/*/csrc`` (B1 and B4 share one, B2 and B5
   another) with ``nvcc`` (started together) and print the build seconds;
2. kernels — ``spmm_dedup_chunks`` against its plain PyTorch version on the
   card (≤1e-5) and against itself run to run (bitwise) at the bucket-16
   serving plan (D = 16 and 7), the Cora-scale full graph (D = 16 and
   1433), the n=4096/e=16384 graph (D = 64) and the sampled block of the
   ``minibatch_lg`` shape (``build_bucket_structure(1024, (15, 10))``,
   169,984 nodes, seeded weights, D = 602: x is 409 MB, eight times the
   L2), timed beside ``torch.sparse.mm`` on the same CSR matrix, with
   ``bound_share`` (bound ÷ kernel), ``vs_library`` (kernel ÷ library) and,
   as a reading, ``gather_ms`` (``index_select`` of the live lanes' x rows:
   what gathering them alone costs a library call);
   ``hash_draws`` against its plain version and numpy's ``_mix64 % deg``,
   exactly equal;
3. full-graph forward — gcn-cora at full width on the Cora-scale graph,
   ``backend="cuda"`` against ``backend="dense"`` (≤1e-4), and the dense GPU
   run against the CPU (≤1e-4);
4. serving, host sampler — ``GNNServer`` with the ``cuda`` backend: warm up,
   serve 256 single-seed requests, drain; every request settles once, no
   step is rebuilt after warm-up, the SpMM kernel ran, and results equal
   offline one-at-a-time replay (≤1e-5); then one warm bucket-16 step is
   timed and traced with ``torch.profiler`` (device time per step);
5. serving, device sampler — the same with ``sampler="device"``; the draw
   kernel ran too, and parity holds against the host-sampled replay;
6. SpGEMM kernel — ``spgemm_hashpad`` on B's compact cells against its
   compact plain version and the dense-slab oracle gathered through
   ``out_row``/``out_bucket`` (≤1e-5), and against itself run to run
   (bitwise), at three A·A plans: gcn-cora's Â² (Cora-scale, sym-normed
   with self loops), the n=4096/e=16384 power-law graph and a Pubmed-scale
   stand-in (n=19717, e=88648); each timed graph-replayed and eager beside
   eager ``torch.sparse.mm(A, A)`` (cuSPARSE SpGEMM, structure included),
   the whole ``cuda`` executor, and the port's whole A·A from the host's
   arrays (symbolic, pack and numeric: what cuSPARSE's one call does),
   with its bound (the function's own bytes and operations; the count of
   the earlier dense-slab kernels as ``slab_bound_bytes``) and the plan's
   device bytes beside those of the dense-slab layout;
7. SpGEMM executor and the two-hop path — the ``cuda`` executor against
   ``reference`` at the three plans and against ``dense`` at the first two
   (≤1e-4); then, counted, ``two_hop_graph`` and ``coarsen_graph`` with
   ``backend="cuda"`` and gcn-cora at full width over the Â² plan, each held
   against ``reference`` / ``dense`` / the CPU, with the Â² build's wall
   time by phase;
8. int8 aggregation and serving — ``spmm_dedup_chunks_q8`` against its
   plain version (exactly equal) at phase 2's six shapes (D = 1433 in
   three scale tiles), each timed beside ``spmm_dedup_chunks`` at the same
   shape and ``torch.sparse.mm`` on the dequantized matrix (the nearest
   library call: there is no int8 one), with ``bound_share``,
   ``vs_library`` and ``gather_ms`` of the int8 rows; the ``cuda_q8``
   executor
   against ``dense`` under ``q8_gate`` of its scale-derived bound;
   gcn-cora at full width with ``cuda_q8`` against ``dense`` (within
   ``Q8_E2E_TOL``) and its int8 aggregations replayed on the CPU from the
   same inputs (≤1e-5); then, counted, ``GNNServer(backend="cuda_q8",
   sampler="device")`` serving 256 requests as in phase 5, held to offline
   replay within ``Q8_E2E_TOL``, with one warm bucket-16 step traced and
   held against the same step on the CPU;
9. int8 SpGEMM and the two-hop path — ``spgemm_hashpad_q8`` on the baked
   int8 cells against its compact plain version and the dense int8 oracle
   (≤1e-5) and run to run (bitwise) at phase 6's three plans, timed as in
   phase 6 beside phase 6's ``spgemm_hashpad`` and cuSPARSE; the baked
   ``cuda_q8`` executor against ``reference`` under ``q8_gate``, timed
   beside the ``cuda`` executor;
   then, counted, ``two_hop_graph``, ``coarsen_graph`` and gcn-cora over
   the Â² plan, all with ``cuda_q8``, held against ``reference`` / ``dense``
   and against the same int8 calls on the CPU;
10. embedding_bag and dlrm-rm2 serving — dlrm-rm2 at full width with its
    whole fused table (49,127,424 × 64 f32, 12.6 GB) drawn on the card;
    ``embedding_bag`` against its plain version (exactly equal at M = 1,
    ≤1e-5) at the serve_p99 (B = 512) and serve_bulk (B = 262,144) batches
    and a multi-hot batch (M = 4), with row·D past 2³¹, timed beside
    ``F.embedding_bag``; then, counted (one launch per forward),
    ``build_recsys_step`` for serve_p99, serve_bulk and retrieval_cand
    (1 query, 1,000,000 candidates), each held against the same step
    through the plain lookup (≤1e-5) and traced with ``torch.profiler``;
11. sddmm — ``edge_scores`` at the Cora-scale graph (d = 64), the
    ogb_products shape (2,449,029 nodes, 61,859,140 edges, d = 100) and
    that shape with skewed sources drawn on the card (``src = floor(N·u²)``,
    ~40K edges on row 0), counted, against the plain version (≤1e-5
    relative and absolute) and against itself run to run (bitwise), timed
    with ``grouped_floor_ms`` (each distinct x row once, one y row per
    edge, indices and scores) beside the bound and, at ogb_products scale,
    each kernel of one call traced (``kernels_ms``); the first two also on
    src-sorted edges (``src_sorted_ms``) and beside
    ``torch.sparse.sampled_addmm`` on a CSR pattern built beforehand and,
    as ``library_with_pattern_ms``, with the argsort, bincount, cumsum and
    ``sparse_csr_tensor`` that build that pattern from the unsorted
    (src, dst) and the scatter of the scores back to the caller's edge
    order inside the timed call; then the scores of a permuted
    ogb_products edge list, permuted back, must equal the unpermuted ones;
12. flash attention — ``mha_causal`` at qwen3-0.6b's attention width (16
    heads, 8 kv heads, head_dim 128), S = 4096, batch 1, in f32 and bf16,
    counted, against the f32 plain version (≤2e-5 f32, ≤2e-2 bf16), timed
    beside ``scaled_dot_product_attention(is_causal=True)``, with B8's
    achieved TFLOP/s and share of its bound per dtype; then, as readings
    and not gates, each B8 instantiation's ``HGMMA`` / ``HMMA`` count in
    its SASS (``cuobjdump -sass``) and its registers, stack, local (spill)
    and static shared memory (``cuobjdump --dump-resource-usage``), and
    where each dtype's error comes from (``flash_numerics``: bf16 against
    the rounded f32 plain version and P's rounding alone, f32 against an
    f64 plain version beside emulations of its 3xTF32 sums).

Launch counters are set to 0 just before each main-path run (the three
serving runs, phases 7 and 9's paths, each DLRM step and phases 11 and
12's wrapper calls) and read just after it; launches made to compare or
time a kernel are not counted.  The
line before last is a JSON object with each kernel's launches, error and
times; the last line is ``{"ok": true, "device": {...}}``.  Times come from
CUDA events: the kernels, ``torch.sparse.mm`` SpMM, ``F.embedding_bag``
and ``scaled_dot_product_attention`` replayed from a captured CUDA graph
(device time per call); the plain versions, the SpGEMM executor, cuSPARSE
SpGEMM (which syncs on the host to size its output, so it cannot be
captured) and ``sampled_addmm`` run eagerly.
"""
from __future__ import annotations

import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12        # H100 SXM tf32 tensor cores, dense
# an f32-accurate product on the tensor cores as 3xTF32: three TF32 products
# for each f32 one
F32_3XTF32_FLOPS_PER_S = TF32_FLOPS_PER_S / 3
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
INT8_OPS_PER_S = 1979e12         # H100 SXM int8 tensor cores, dense
KERNEL_TOL = 1e-5
EXECUTOR_TOL = 1e-4
SERVE_TOL = 1e-5
N_REQUESTS = 256
# phases 10-12 sizes: B6 batches (name, B, M); ogb_products (nodes, edges,
# d), repro configs/shapes.py:70; qwen3-0.6b attention (B, S, H, KV, hd),
# repro configs/qwen3_0_6b.py at the train_4k length, batch cut to 1
B6_CASES = (("serve_p99", 512, 1), ("serve_bulk", 262144, 1),
            ("multi_hot", 4096, 4))
OGB_PRODUCTS = (2_449_029, 61_859_140, 100)
QWEN3_ATTENTION = (1, 4096, 16, 8, 128)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    print(f"[chip-smoke] {msg}", flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def _median_event_ms(run, per_run: int, reps: int = 5) -> float:
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / per_run)
    return statistics.median(samples)


def graph_ms(fn, calls: int = 50, replays: int = 10) -> float:
    """Device time per call: ``calls`` calls captured in one CUDA graph,
    replayed ``replays`` times between two events (no host overhead)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()

    def run():
        for _ in range(replays):
            graph.replay()
    return _median_event_ms(run, calls * replays)


def eager_ms(fn, iters: int = 50) -> float:
    """Time per call issued eagerly from Python (host overhead included)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    return _median_event_ms(run, iters)


# ---------------------------------------------------------------------------
# phase 2 — kernels
# ---------------------------------------------------------------------------

def spmm_case(name, plan, d, rng):
    from repro_torch.kernels.gustavson_spmm import (spmm_dedup_chunks,
                                                    spmm_dedup_chunks_plain)
    dev = plan.device
    x = torch.from_numpy(rng.normal(size=(plan.n_rows, d)).astype(
        np.float32)).to(dev)
    args = (plan.ell_u_cols, plan.ell_remaining, plan.ell_block_ptr,
            plan.ell_a, x)
    br = plan.block_rows
    y = spmm_dedup_chunks(*args, block_rows=br)
    y_plain = spmm_dedup_chunks_plain(*args, block_rows=br)
    torch.cuda.synchronize()
    err = float((y - y_plain).abs().max())
    del y_plain
    check(bool(torch.isfinite(y).all()), f"B1 {name}: non-finite output")
    check(err <= KERNEL_TOL, f"B1 {name} d={d}: max|kernel-plain| {err:.3e}"
                             f" > {KERNEL_TOL}")
    check(torch.equal(spmm_dedup_chunks(*args, block_rows=br), y),
          f"B1 {name} d={d}: not bitwise equal run to run")
    a_csr = torch.sparse_coo_tensor(
        torch.stack([plan.rows, plan.cols]), plan.base_vals,
        (plan.n_rows, plan.n_rows),
        check_invariants=True).coalesce().to_sparse_csr()
    lib_err = float((torch.sparse.mm(a_csr, x)
                     - y[: plan.n_rows]).abs().max())
    check(lib_err <= EXECUTOR_TOL,
          f"B1 {name}: kernel vs torch.sparse.mm {lib_err:.3e}")
    calls = 50 if y.numel() < 2 ** 26 else 5       # 50 × 409 MB is too much
    ms = graph_ms(lambda: spmm_dedup_chunks(*args, block_rows=br), calls)
    rec = dict(
        shape=f"{name} D={d}", max_abs_err=err, run_to_run="bitwise",
        ms=ms,
        eager_ms=eager_ms(lambda: spmm_dedup_chunks(*args, block_rows=br)),
        plain_ms=eager_ms(lambda: spmm_dedup_chunks_plain(*args,
                                                          block_rows=br),
                          iters=50 if calls == 50 else 5),
        library_ms=graph_ms(lambda: torch.sparse.mm(a_csr, x), calls))
    # least bytes: what the function must read once and write once.  Only
    # the live lanes u < remaining[k] of a chunk carry data, so count those
    # u_cols and those (BR,) tile columns, not the padded (BR, W) tiles;
    # each x row that a live lane names, once; remaining, block_ptr and y
    # whole.  Least operations: 2 flops per nonzero coefficient per column.
    rem = plan.ell_remaining.cpu().numpy().astype(np.int64)
    u_cols = plan.ell_u_cols.cpu().numpy()
    live = np.arange(u_cols.shape[1]) < rem[:, None]
    live_lanes = int(rem.sum())
    x_rows = np.unique(u_cols[live]).size
    n_bytes = 4 * (live_lanes * (1 + br) + rem.size
                   + plan.ell_block_ptr.numel() + x_rows * d + y.numel())
    padded_bytes = 4 * (sum(t.numel() for t in args) + y.numel())
    n_flops = 2 * int((plan.ell_a != 0).sum()) * d
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / F32_FLOPS_PER_S
    rec.update(bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bound_bytes=n_bytes, padded_bytes=padded_bytes,
               gathered_mb=4 * d * live_lanes / 1e6)
    # a reading, not a gate: one library gather of the same live x rows
    # (read and written once each), the floor of a gather-then-fold design
    live_cols = plan.ell_u_cols[torch.from_numpy(live).to(dev)].long()
    rec.update(bound_share=rec["bound_ms"] / ms,
               vs_library=ms / rec["library_ms"],
               gather_ms=graph_ms(lambda: x.index_select(0, live_cols),
                                  calls))
    say(f"B1 {json.dumps(rec)}")
    return rec


def minibatch_lg_plan(dev, rng):
    """The sampled block of the repo's ``minibatch_lg`` shape (batch 1024,
    fanouts (15, 10), ``repro`` configs/shapes.py:65) as the serving path
    builds a bucket, with seeded weights: 169,984 nodes, 21,248 blocks.
    At D = 602 its x (409 MB) is eight times the L2."""
    from repro_torch.serve.buckets import build_bucket_structure
    from repro_torch.sparse.plan import make_plan
    st = build_bucket_structure(1024, (15, 10), with_loops=True)
    w = rng.uniform(0.1, 1.0, st.n_edges).astype(np.float32)
    return make_plan(st.senders, st.receivers, st.n_nodes, edge_weight=w,
                     backends=("dense", "cuda", "cuda_q8"), device=dev)


def phase_kernels(dev):
    from repro_torch.data.synthetic import cora_like, powerlaw_graph
    from repro_torch.kernels.forest_sampler import (hash_draws,
                                                    hash_draws_plain)
    from repro_torch.serve.buckets import build_bucket_structure
    from repro_torch.sparse.graph import sym_norm_weights
    from repro_torch.sparse.plan import make_plan
    from repro_torch.sparse.sampler import _mix64
    rng = np.random.default_rng(0)
    backends = ("dense", "chunked", "cuda", "cuda_q8")

    st = build_bucket_structure(16, (5, 3), with_loops=True)
    w = rng.uniform(0.1, 1.0, st.n_edges).astype(np.float32)
    bucket = make_plan(st.senders, st.receivers, st.n_nodes, edge_weight=w,
                       backends=backends, device=dev)
    s, r, _, _, _ = cora_like(seed=0)
    s2, r2, wn = sym_norm_weights(s, r, 2708)
    cora = make_plan(s2, r2, 2709, edge_weight=wn, backends=backends,
                     device=dev)
    s, r = powerlaw_graph(4096, 16384 + 256, seed=4096)
    flag = make_plan(s[:16384], r[:16384], 4097,
                     edge_weight=rng.normal(size=16384).astype(np.float32),
                     backends=backends, device=dev)
    minibatch = minibatch_lg_plan(dev, rng)
    b1 = [spmm_case("bucket16", bucket, 16, rng),
          spmm_case("bucket16", bucket, 7, rng),
          spmm_case("cora_full", cora, 16, rng),
          spmm_case("n4096_e16384", flag, 64, rng),
          spmm_case("cora_full", cora, 1433, rng),
          spmm_case("minibatch_lg", minibatch, 602, rng)]

    # B3: the serving shape (16 trees × 15 second-hop lanes) plus edge values
    z = rng.integers(0, 2 ** 63, (16, 15), dtype=np.int64).view(np.uint64)
    z[0, :5] = [0, 2 ** 64 - 1, 2 ** 63, 2 ** 63 - 1, 0x9E3779B97F4A7C15]
    z[1:4] |= np.uint64(1 << 63)                 # top bit set
    deg = rng.integers(1, 2 ** 31 - 1, (16, 15)).astype(np.int32)
    deg[0, :3] = 1
    deg[0, 3:6] = 2 ** 31 - 1
    deg[4] = 2
    want = (_mix64(z) % deg.astype(np.uint64)).astype(np.int32)
    zt = torch.from_numpy(z.view(np.int64).copy()).to(dev)
    dt = torch.from_numpy(deg).to(dev)
    got = hash_draws(zt, dt).cpu().numpy()
    plain = hash_draws_plain(zt, dt).cpu().numpy()
    check(np.array_equal(got, want), "B3 kernel != numpy _mix64 % deg")
    check(np.array_equal(plain, want), "B3 plain != numpy _mix64 % deg")
    n = z.size
    b3 = dict(shape="16x15", max_abs_err=0.0,
              ms=graph_ms(lambda: hash_draws(zt, dt)),
              eager_ms=eager_ms(lambda: hash_draws(zt, dt)),
              plain_ms=eager_ms(lambda: hash_draws_plain(zt, dt)),
              library_ms=None,
              # integer hashing has no peak in the card's table; 8 B of z
              # and 4 B of deg in, 4 B out per draw
              bound_ms=(8 + 4 + 4) * n / HBM_BYTES_PER_S * 1e3,
              bound_by="bytes")
    say(f"B3 {json.dumps(b3)}")
    return b1, b3, {"bucket16": bucket, "cora_full": cora,
                    "n4096_e16384": flag, "minibatch_lg": minibatch}


# ---------------------------------------------------------------------------
# phases 3-5 — model and serving
# ---------------------------------------------------------------------------

def phase_forward(dev, cora_plan, params, x_table):
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.models.gnn import gcn
    from repro_torch.sparse.plan import make_plan
    x = torch.from_numpy(x_table).to(dev)
    y_cuda = gcn.forward(params, FULL, x, backend="cuda", plan=cora_plan)
    y_dense = gcn.forward(params, FULL, x, backend="dense", plan=cora_plan)
    check(tuple(y_cuda.shape) == (2709, FULL.n_classes),
          f"forward shape {tuple(y_cuda.shape)}")
    check(bool(torch.isfinite(y_cuda).all()), "forward: non-finite logits")
    err = float((y_cuda - y_dense).abs().max())
    check(err <= EXECUTOR_TOL, f"forward cuda vs dense {err:.3e}")
    # the dense executor on the GPU against the same forward on the CPU
    cpu_params = {k: {n: t.cpu() for n, t in p.items()}
                  for k, p in params.items()}
    cpu_plan = make_plan(cora_plan.cols.cpu().numpy(),
                         cora_plan.rows.cpu().numpy(), cora_plan.n_rows,
                         edge_weight=cora_plan.base_vals.cpu().numpy(),
                         device="cpu")
    y_cpu = gcn.forward(cpu_params, FULL, torch.from_numpy(x_table),
                        backend="dense", plan=cpu_plan)
    err_cpu = float((y_dense.cpu() - y_cpu).abs().max())
    check(err_cpu <= EXECUTOR_TOL, f"forward GPU vs CPU {err_cpu:.3e}")
    say(f"forward gcn-cora on the Cora-scale graph: cuda vs dense "
        f"{err:.3e}, GPU dense vs CPU dense {err_cpu:.3e}")


def host_input_step(server, seeds):
    """The server's bucket-16 step body on host-sampled node tables (the
    step a host-sampler server runs; a device-sampler server fuses sampling
    in front of the same body), with its inputs."""
    from repro_torch.serve.buckets import stack_trees
    from repro_torch.serve.compute import build_infer_step
    trees = server.sample_for(seeds[:16], rid=0)
    node_ids, hop_valid = stack_trees(trees, 16, server.fanouts)
    step = build_infer_step(server.arch_id, server.cfg, server.store,
                            server._struct(16), backend=server.backend)
    return step, node_ids, hop_valid


def trace_steps(step, n_steps: int, kernel: str, top: int = 0) -> dict:
    """Wall time per call of ``step`` (host clock around ``n_steps`` calls
    and a sync), and from a ``torch.profiler`` trace of another
    ``n_steps`` the device time of all its kernels, of ``kernel`` alone
    and, with ``top``, of the ``top`` costliest device operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    kernel_us = sum(e.self_device_time_total for e in kernels
                    if kernel in e.key)
    rec = dict(step_wall_ms=wall_ms,
               device_ms_per_step=dev_us / 1e3 / n_steps,
               kernel_ms_per_step=kernel_us / 1e3 / n_steps,
               device_ops_per_step=sum(e.count for e in kernels) / n_steps,
               device_busy_share=dev_us / 1e3 / n_steps / wall_ms)
    if top:
        costliest = sorted(kernels, key=lambda e: -e.self_device_time_total)
        rec["top_ms_per_step"] = {
            e.key[:60]: e.self_device_time_total / 1e3 / n_steps
            for e in costliest[:top]}
    return rec


def step_breakdown(server, seeds, n_steps: int = 20) -> dict:
    """Where one warm bucket-16 host-input step spends its time: wall per
    step, and from a ``torch.profiler`` trace the device time of all its
    kernels and of the SpMM kernel (f32 or int8) alone."""
    step, node_ids, hop_valid = host_input_step(server, seeds)
    rec = trace_steps(lambda: step(server.params, node_ids, hop_valid),
                      n_steps, "spmm_dedup_chunks")
    rec["spmm_ms_per_step"] = rec.pop("kernel_ms_per_step")
    return rec


def phase_serve(dev, mode, params, indptr, indices, store, seeds,
                backend="cuda"):
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.kernels.forest_sampler import hash_draws
    from repro_torch.kernels.gustavson_spmm import (spmm_dedup_chunks,
                                                    spmm_dedup_chunks_q8)
    from repro_torch.serve import GNNServer, offline_replay
    from repro_torch.sparse.quantize import Q8_E2E_TOL
    spmm = {"cuda": spmm_dedup_chunks,
            "cuda_q8": spmm_dedup_chunks_q8}[backend]
    tol = Q8_E2E_TOL if backend == "cuda_q8" else SERVE_TOL
    kernels = (spmm_dedup_chunks, spmm_dedup_chunks_q8, hash_draws)
    with GNNServer("gcn", FULL, params, indptr, indices, store,
                   fanouts=(5, 3), backend=backend, sampler=mode,
                   max_batch_seeds=16, device=dev) as server:
        server.warmup()
        builds = server.steps.builds
        server.reset_stats()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        reqs = [server.submit([int(s)]) for s in seeds]
        server.drain()
        dt = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels}
        st = server.stats()
        check(all(r.n_settles == 1 and r.error is None for r in reqs),
              f"{backend}/{mode}: a request did not settle exactly once "
              "with a result")
        check(server.steps.builds == builds,
              f"{backend}/{mode}: {server.steps.builds - builds} step "
              "rebuild(s) after warm-up")
        check(launches[spmm.__name__] > 0,
              f"{backend}/{mode}: {spmm.__name__} never launched")
        if mode == "device":
            check(launches["hash_draws"] > 0,
                  f"{backend}/device: hash_draws never launched")
        ref = np.concatenate([offline_replay(server, r) for r in reqs])
        breakdown = {}
        if mode == "host" or backend == "cuda_q8":
            breakdown = step_breakdown(server, seeds)
        if backend == "cuda_q8":
            breakdown.update(q8_step_vs_cpu(server, seeds))
    got = np.concatenate([r.result for r in reqs])
    check(got.shape == (len(seeds), FULL.n_classes) and np.isfinite(
        got).all(), f"{backend}/{mode}: served results malformed")
    err = float(np.abs(got - ref).max())
    check(err <= tol, f"{backend}/{mode}: served vs offline replay "
                      f"{err:.3e} > {tol}")
    rec = dict(backend=backend, sampler=mode, requests=len(seeds),
               req_per_s=len(seeds) / dt, p50_ms=st["p50_ms"],
               p99_ms=st["p99_ms"], batches=st["n_batches"],
               buckets=st["bucket_counts"], launches=launches,
               parity_max_abs=err, **breakdown)
    say(f"serve {json.dumps(rec)}")
    return rec


# ---------------------------------------------------------------------------
# phases 6-7 — SpGEMM kernel, executors and the two-hop path
# ---------------------------------------------------------------------------

def spgemm_plans(dev):
    """The three A·A plans: (name, plan, dense oracle allowed)."""
    from repro_torch.data.synthetic import cora_like, powerlaw_graph
    from repro_torch.sparse.graph import sym_norm_weights
    from repro_torch.sparse.spgemm import make_spgemm_plan
    s, r, _, _, _ = cora_like(seed=0)
    s2, r2, w = sym_norm_weights(s, r, 2708)
    cases = [("cora_a2", r2, s2, 2708, w, True)]
    s, r = powerlaw_graph(4096, 16384 + 256, seed=4096)   # spgemm_sweep
    cases.append(("n4096_e16384", r[:16384], s[:16384], 4096,
                  np.random.default_rng(1).normal(size=16384).astype(
                      np.float32), True))
    s, r = powerlaw_graph(19717, 88648 + 2000, alpha=1.6, seed=0)
    cases.append(("pubmed_scale", r[:88648], s[:88648], 19717,
                  np.random.default_rng(2).normal(size=88648).astype(
                      np.float32), False))
    plans = []
    for name, r, s, n, w, dense_ok in cases:
        t0 = time.perf_counter()
        plan = make_spgemm_plan(r, s, n, r, s, n, a_vals=w, b_vals=w,
                                executors=("dense", "reference", "cuda",
                                           "cuda_q8"),
                                device=dev)
        torch.cuda.synchronize()
        say(f"spgemm plan {name}: nnz(A) {plan.nnz_a}, pp {plan.pp_interim},"
            f" nnz(C) {plan.nnz_out}, pad_width {plan.pad_width}, "
            f"{plan.n_chunks} chunks x {plan.width}, host plan "
            f"{time.perf_counter() - t0:.3f}s")
        plans.append((name, plan, dense_ok))
    return plans


CELL_FIELDS = ("cell_ptr", "cell_lane", "cell_bucket", "cell_val", "cell_src",
               "cell_src_ptr", "cell_q8")


def plan_bytes(plan) -> dict:
    """Device bytes of an ``SpgemmPlan``: its tensors now, and the same
    plan in the layout before B's compact cells (no ``cell_*`` fields, and
    with ``cuda_q8`` a dense ``(n_chunks·width, pad_width)`` int8 slab)."""
    import dataclasses

    def nbytes(names):
        return sum(t.numel() * t.element_size() for t in
                   (getattr(plan, n) for n in names)
                   if isinstance(t, torch.Tensor))
    now = nbytes([f.name for f in dataclasses.fields(plan)])
    before = now - nbytes(CELL_FIELDS)
    if plan.cell_q8 is not None:
        before += plan.n_chunks * plan.width * plan.pad_width
    return dict(plan_bytes=now, plan_bytes_dense_slab_layout=before)


def spgemm_bound(plan, tiles, value_bytes: int,
                 peak_ops_per_s: float) -> dict:
    """The least time for the hash-pad function on this plan's data.
    Bytes: A's live coefficient columns, each compact cell once (lane,
    bucket, value), the cell pointers, C's buckets read and values written,
    remaining, block_ptr, c_indptr (and the two per-chunk scales of the
    int8 kernel).  Operations: 2 per product of a nonzero coefficient with
    a cell of its lane.  ``slab_bound_bytes`` is the count of the earlier
    dense-slab kernels (each live slab row once, the pad written once),
    kept so their readings stay comparable."""
    k, w, h, br = plan.n_chunks, plan.width, plan.pad_width, plan.block_rows
    live = int(plan.ell_remaining.sum())
    scale_bytes = 8 * k if value_bytes == 1 else 0
    n_bytes = (live * br * value_bytes + plan.n_cells * (8 + value_bytes)
               + 4 * ((k + 1) + 2 * plan.nnz_out + k
                      + plan.ell_block_ptr.numel() + plan.c_indptr.numel())
               + scale_bytes)
    a_nz = (tiles.reshape(k, br, w) != 0).sum(1)                # (k, w)
    chunk = torch.repeat_interleave(
        torch.arange(k, device=plan.device),
        (plan.cell_ptr[1:] - plan.cell_ptr[:-1]).long())
    n_ops = 2 * int(a_nz[chunk, plan.cell_lane.long()].sum())
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak_ops_per_s
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=n_bytes, bound_ops=n_ops, live_lanes=live,
                n_cells=plan.n_cells,
                slab_bound_bytes=value_bytes * live * (h + br) + scale_bytes
                + 4 * (k + plan.ell_block_ptr.numel() + plan.n_blocks * br * h))


def whole_build_ms(plan, backend: str) -> float:
    """Wall ms of the port's whole A·B from the host's COO arrays, best of
    two: the host symbolic phase and pack (``make_spgemm_plan`` with
    ``backend``'s layout only) and the numeric phase, synchronized.  That
    is the work ``torch.sparse.mm`` does in one call (C's structure and
    values); the kernel's ms is the numeric phase alone."""
    from repro_torch.sparse import backend as sb
    from repro_torch.sparse.spgemm import make_spgemm_plan
    a_rows, a_cols, b_rows, b_cols, a_vals, b_vals = (
        t.cpu().numpy() for t in (plan.a_rows, plan.a_cols, plan.b_rows,
                                  plan.b_cols, plan.a_base, plan.b_base))
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = make_spgemm_plan(a_rows, a_cols, plan.n_rows, b_rows, b_cols,
                             plan.n_inner, plan.n_cols, a_vals=a_vals,
                             b_vals=b_vals, executors=(backend,),
                             device=plan.device)
        sb.spgemm(p, backend=backend)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def spgemm_case(name, plan):
    from repro_torch.kernels.spgemm_pad import (spgemm_hashpad,
                                                spgemm_hashpad_compact_plain,
                                                spgemm_hashpad_plain)
    from repro_torch.sparse import backend as sb
    from repro_torch.sparse.spgemm.numeric import hashed_slab
    args = (plan.ell_remaining, plan.ell_block_ptr, plan.ell_a, plan.cell_ptr,
            plan.cell_lane, plan.cell_bucket, plan.cell_val, plan.c_indptr,
            plan.out_bucket)
    kw = dict(block_rows=plan.block_rows, pad_width=plan.pad_width)
    c_vals = spgemm_hashpad(*args, **kw)
    again = spgemm_hashpad(*args, **kw)
    plain = spgemm_hashpad_compact_plain(*args, **kw)
    oracle = spgemm_hashpad_plain(
        plan.ell_remaining, plan.ell_block_ptr, plan.ell_a,
        hashed_slab(plan), **kw)[plan.out_row.long(), plan.out_bucket.long()]
    torch.cuda.synchronize()
    check(c_vals.shape == (plan.nnz_out,) and bool(
        torch.isfinite(c_vals).all()), f"B2 {name}: malformed C values")
    err = float((c_vals - plain).abs().max())
    check(err <= KERNEL_TOL, f"B2 {name}: max|kernel-plain| {err:.3e} > "
                             f"{KERNEL_TOL}")
    err_oracle = float((c_vals - oracle).abs().max())
    check(err_oracle <= KERNEL_TOL, f"B2 {name}: max|kernel-dense oracle| "
                                    f"{err_oracle:.3e} > {KERNEL_TOL}")
    check(torch.equal(again, c_vals), f"B2 {name}: two calls differ")
    del plain, oracle, again
    big = plan.nnz_out > 200_000
    a_csr = torch.sparse_coo_tensor(
        torch.stack([plan.a_rows.long(), plan.a_cols.long()]), plan.a_base,
        (plan.n_rows, plan.n_inner),
        check_invariants=True).coalesce().to_sparse_csr()
    rec = dict(
        shape=f"{name} H={plan.pad_width}", max_abs_err=err,
        dense_oracle_err=err_oracle, run_to_run_equal=True,
        ms=graph_ms(lambda: spgemm_hashpad(*args, **kw)),
        eager_ms=eager_ms(lambda: spgemm_hashpad(*args, **kw)),
        plain_ms=eager_ms(lambda: spgemm_hashpad_compact_plain(*args, **kw),
                          iters=3 if big else 10),
        library_ms=eager_ms(lambda: torch.sparse.mm(a_csr, a_csr),
                            iters=10),
        executor_ms=eager_ms(lambda: sb.spgemm(plan, backend="cuda")),
        whole_build_ms=whole_build_ms(plan, "cuda"),
        library_note="torch.sparse.mm(A_csr, A_csr): cuSPARSE SpGEMM, "
                     "structure included, eager; set it beside "
                     "whole_build_ms (symbolic + pack + numeric), not "
                     "beside the kernel's numeric phase alone",
        **spgemm_bound(plan, plan.ell_a, 4, F32_FLOPS_PER_S),
        **plan_bytes(plan))
    say(f"B2 {json.dumps(rec)}")
    return rec


def phase_spgemm_executors(plans):
    from repro_torch.sparse import backend as sb
    for name, plan, dense_ok in plans:
        got = sb.spgemm(plan, backend="cuda")
        check(got.shape == (plan.nnz_out,) and bool(torch.isfinite(
            got).all()), f"spgemm cuda {name}: malformed result")
        err_ref = float((got - sb.spgemm(plan, backend="reference")
                         ).abs().max())
        check(err_ref <= EXECUTOR_TOL,
              f"spgemm {name}: cuda vs reference {err_ref:.3e}")
        msg = f"spgemm executor {name}: cuda vs reference {err_ref:.3e}"
        if dense_ok:
            err_dense = float((got - sb.spgemm(plan, backend="dense")
                               ).abs().max())
            check(err_dense <= EXECUTOR_TOL,
                  f"spgemm {name}: cuda vs dense {err_dense:.3e}")
            msg += f", vs dense {err_dense:.3e}"
        say(msg)


def phase_two_hop(dev, params, x_table):
    """The counted path: Â² and a coarsened graph through the ``cuda``
    SpGEMM executor, then gcn-cora at full width over the Â² plan."""
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.data.synthetic import cora_like
    from repro_torch.kernels.gustavson_spmm import spmm_dedup_chunks
    from repro_torch.kernels.spgemm_pad import spgemm_hashpad
    from repro_torch.models.gnn import gcn
    from repro_torch.sparse.graph import (coarsen_graph, graph_coo,
                                          make_graph, sym_norm_weights)
    from repro_torch.sparse.plan import plan_from_graph
    from repro_torch.sparse.spgemm import two_hop_graph
    from repro_torch.sparse.stats import kernel_stats
    s, r, _, _, _ = cora_like(seed=0)
    s2, r2, w = sym_norm_weights(s, r, 2708)
    g = make_graph(s2, r2, 2708, edge_weight=w, device=dev)
    clusters = np.random.default_rng(3).integers(0, 128, 2708)
    x = torch.from_numpy(x_table).to(dev)
    kernel_stats().reset()

    spgemm_hashpad.launches = 0
    spmm_dedup_chunks.launches = 0
    t0 = time.perf_counter()
    g2 = two_hop_graph(g, backend="cuda")
    t1 = time.perf_counter()
    plan2 = plan_from_graph(g2, backends=("cuda",))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    gc = coarsen_graph(g, clusters, 128, backend="cuda")
    y = gcn.forward(params, FULL, x, backend="cuda", plan=plan2)
    torch.cuda.synchronize()
    launches = {"spgemm_hashpad": spgemm_hashpad.launches,
                "spmm_dedup_chunks": spmm_dedup_chunks.launches}
    check(launches == {"spgemm_hashpad": 3, "spmm_dedup_chunks": 2},
          f"two-hop path launches {launches}, expected 3 spgemm_hashpad "
          "(two_hop_graph 1 + coarsen_graph 2) and 2 spmm_dedup_chunks")
    series = kernel_stats().snapshot()["series"]
    build = {k: series[f"two_hop.{k}_s"]["sum"]
             for k in ("symbolic", "numeric", "repack")}
    build.update(b1_plan_pack=t2 - t1, two_hop_graph_total=t1 - t0)

    # Â² through cuda has the reference's edges and weights
    g2_ref = two_hop_graph(g, backend="reference")
    s_c, r_c, w_c = graph_coo(g2)
    s_r, r_r, w_r = graph_coo(g2_ref)
    check(np.array_equal(s_c, s_r) and np.array_equal(r_c, r_r),
          "two-hop: cuda and reference Â² have different edges")
    err_w = float(np.abs(w_c - w_r).max())
    check(err_w <= KERNEL_TOL, f"two-hop weights cuda vs reference "
                               f"{err_w:.3e}")
    gc_ref = coarsen_graph(g, clusters, 128, backend="reference")
    s_c, r_c, w_c = graph_coo(gc)
    s_r, r_r, w_r = graph_coo(gc_ref)
    check(np.array_equal(s_c, s_r) and np.array_equal(r_c, r_r),
          "coarsen: cuda and reference graphs have different edges")
    err_c = float(np.abs(w_c - w_r).max())
    check(err_c <= EXECUTOR_TOL, f"coarsen cuda vs reference {err_c:.3e}")

    # gcn-cora at full width over Â²: cuda vs dense, GPU vs CPU
    check(tuple(y.shape) == (2709, FULL.n_classes) and bool(
        torch.isfinite(y).all()), "two-hop forward malformed")
    y_dense = gcn.forward(params, FULL, x, backend="dense", plan=plan2)
    err_y = float((y - y_dense).abs().max())
    check(err_y <= EXECUTOR_TOL, f"two-hop forward cuda vs dense "
                                 f"{err_y:.3e}")
    cpu_params = {k: {n: t.cpu() for n, t in p.items()}
                  for k, p in params.items()}
    s2_c, r2_c, w2_c = graph_coo(g2)
    g2_cpu = make_graph(s2_c, r2_c, 2708, edge_weight=w2_c, device="cpu")
    y_cpu = gcn.forward(cpu_params, FULL, torch.from_numpy(x_table),
                        backend="dense",
                        plan=plan_from_graph(g2_cpu, backends=("dense",)))
    err_cpu = float((y.cpu() - y_cpu).abs().max())
    check(err_cpu <= EXECUTOR_TOL, f"two-hop forward GPU vs CPU "
                                   f"{err_cpu:.3e}")
    rec = dict(a2_edges=int(g2.edge_valid.sum()),
               coarse_edges=int(gc.edge_valid.sum()), launches=launches,
               a2_weight_err=err_w, coarsen_err=err_c,
               forward_cuda_vs_dense=err_y, forward_gpu_vs_cpu=err_cpu,
               build_s=build)
    say(f"two-hop {json.dumps(rec)}")
    return rec


# ---------------------------------------------------------------------------
# phases 8-9 — the int8 path
# ---------------------------------------------------------------------------

def on_cpu(plan):
    """The same plan with every tensor copied to the CPU."""
    import dataclasses
    return dataclasses.replace(plan, **{
        f.name: getattr(plan, f.name).cpu()
        for f in dataclasses.fields(plan)
        if isinstance(getattr(plan, f.name), torch.Tensor)})


def replay_aggregates_on_cpu(run):
    """Run ``run()`` with every ``sparse.backend.aggregate`` call recorded,
    then replay each call on the CPU (plain kernel versions) from the very
    inputs the card saw.  Returns (run's result, calls, max |card − CPU|).

    A whole int8 forward on the CPU can round differently from the card's:
    the f32 combination ``h @ W`` sums in another order, and a value that
    moves by one ulp across a rounding boundary changes an int8 by one.
    Replaying each aggregation from the same ``h`` holds the kernels and the
    quantization to the plain path without that."""
    from repro_torch.sparse import backend as sb
    calls = []
    aggregate = sb.aggregate

    def recorded(plan, vals, x, backend="dense"):
        y = aggregate(plan, vals, x, backend=backend)
        calls.append((plan, vals, x, backend, y))
        return y
    sb.aggregate = recorded
    try:
        out = run()
    finally:
        sb.aggregate = aggregate
    err = 0.0
    for plan, vals, x, backend, y in calls:
        y_cpu = aggregate(on_cpu(plan), None if vals is None else vals.cpu(),
                          x.cpu(), backend=backend)
        err = max(err, float((y.cpu() - y_cpu).abs().max()))
    return out, len(calls), err


def dequantized_csr(plan, a_q8, a_scale):
    """The f32 matrix the int8 tiles stand for, as CSR: the operand of the
    nearest library call (``torch.sparse.mm`` has no int8 SpMM)."""
    k, w = plan.ell_u_cols.shape
    br = plan.block_rows
    ptr = plan.ell_block_ptr.long()
    n_blocks = ptr.numel() - 1
    block = torch.repeat_interleave(torch.arange(n_blocks, device=ptr.device),
                                    ptr[1:] - ptr[:-1])
    tiles = a_q8.reshape(k, br, w).float() * a_scale[:, None, None]
    live = torch.arange(w, device=ptr.device)[None, :] < \
        plan.ell_remaining[:, None]
    kk, rr, uu = torch.nonzero(live[:, None, :] & (tiles != 0),
                               as_tuple=True)
    idx = torch.stack([block[kk] * br + rr, plan.ell_u_cols[kk, uu].long()])
    return torch.sparse_coo_tensor(
        idx, tiles[kk, rr, uu], (n_blocks * br, plan.n_rows),
        check_invariants=True).coalesce().to_sparse_csr()


def spmm_q8_case(name, plan, d, rng):
    from repro_torch.kernels.gustavson_spmm import (auto_d_tile,
                                                    spmm_dedup_chunks,
                                                    spmm_dedup_chunks_q8,
                                                    spmm_dedup_chunks_q8_plain)
    from repro_torch.sparse import backend as sb
    from repro_torch.sparse import quantize as qz
    dev = plan.device
    x = torch.from_numpy(rng.normal(size=(plan.n_rows, d)).astype(
        np.float32)).to(dev)
    qt = auto_d_tile(d)
    x_q8, x_scale = qz.quantize_feature_tiles(x, qt)
    args = (plan.ell_u_cols, plan.ell_remaining, plan.ell_block_ptr,
            plan.ell_a_q8, plan.ell_a_scale, x_q8, x_scale)
    br = plan.block_rows
    y = spmm_dedup_chunks_q8(*args, block_rows=br, q_tile=qt)
    y_plain = spmm_dedup_chunks_q8_plain(*args, block_rows=br, q_tile=qt)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(y).all()), f"B4 {name}: non-finite output")
    err = float((y - y_plain).abs().max())
    del y_plain
    check(err == 0, f"B4 {name} d={d}: max|kernel-plain| {err:.3e} != 0")
    # the executor against dense, under the scale-derived bound
    y_exec = sb.aggregate(plan, None, x, backend="cuda_q8")
    dev_dense = float((y_exec - sb.aggregate(plan, None, x, backend="dense")
                       ).abs().max())
    bound = qz.aggregate_q8_bound(plan.ell_remaining, plan.ell_out_block,
                                  plan.n_blocks, plan.ell_a_scale, x_scale)
    check(qz.q8_gate(dev_dense, bound),
          f"B4 {name} d={d}: cuda_q8 vs dense {dev_dense:.3e} over the "
          f"bound {bound:.3e}")
    a_csr = dequantized_csr(plan, plan.ell_a_q8, plan.ell_a_scale)
    x_deq = x_q8.float() * torch.repeat_interleave(x_scale, qt)[:d]
    lib_err = float((torch.sparse.mm(a_csr, x_deq) - y).abs().max())
    check(lib_err <= EXECUTOR_TOL,
          f"B4 {name}: kernel vs torch.sparse.mm(dequantized) {lib_err:.3e}")
    f32_args = (plan.ell_u_cols, plan.ell_remaining, plan.ell_block_ptr,
                plan.ell_a, x)
    calls = 50 if y.numel() < 2 ** 26 else 5
    rec = dict(
        shape=f"{name} D={d}", max_abs_err=err,
        ms=graph_ms(lambda: spmm_dedup_chunks_q8(*args, block_rows=br,
                                                 q_tile=qt), calls),
        f32_kernel_ms=graph_ms(lambda: spmm_dedup_chunks(*f32_args,
                                                         block_rows=br),
                               calls),
        plain_ms=eager_ms(lambda: spmm_dedup_chunks_q8_plain(
            *args, block_rows=br, q_tile=qt), iters=10 if calls == 50 else 3),
        library_ms=graph_ms(lambda: torch.sparse.mm(a_csr, x_deq), calls),
        library_note="torch.sparse.mm on the dequantized f32 matrix and "
                     "features (nearest library call: no int8 SpMM)",
        q8_executor_vs_dense=dev_dense, q8_bound=bound,
        library_err=lib_err)
    # least bytes: each live lane's u_cols entry (4 B) and int8 tile column
    # (block_rows B) once, each x row a live lane names once (D int8), the
    # scales, remaining, block_ptr, and y (f32) written once.  Least
    # operations: 2 int8 operations per nonzero coefficient per column.
    rem = plan.ell_remaining.cpu().numpy().astype(np.int64)
    u_cols = plan.ell_u_cols.cpu().numpy()
    live = np.arange(u_cols.shape[1]) < rem[:, None]
    live_lanes = int(rem.sum())
    x_rows = np.unique(u_cols[live]).size
    n_bytes = (live_lanes * (4 + br) + x_rows * d
               + 4 * (2 * rem.size + x_scale.numel()
                      + plan.ell_block_ptr.numel() + y.numel()))
    padded_bytes = (sum(t.numel() * t.element_size() for t in args)
                    + 4 * y.numel())
    a_live = plan.ell_a_q8.reshape(rem.size, br, -1) != 0
    n_ops = 2 * int(a_live.sum()) * d
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / INT8_OPS_PER_S
    rec.update(bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bound_bytes=n_bytes, padded_bytes=padded_bytes)
    live_cols = plan.ell_u_cols[torch.from_numpy(live).to(dev)].long()
    rec.update(bound_share=rec["bound_ms"] / rec["ms"],
               vs_library=rec["ms"] / rec["library_ms"],
               gather_ms=graph_ms(lambda: x_q8.index_select(0, live_cols),
                                  calls))
    say(f"B4 {json.dumps(rec)}")
    return rec


def phase_q8_kernels(agg_plans):
    rng = np.random.default_rng(8)
    return [spmm_q8_case("bucket16", agg_plans["bucket16"], 16, rng),
            spmm_q8_case("bucket16", agg_plans["bucket16"], 7, rng),
            spmm_q8_case("cora_full", agg_plans["cora_full"], 16, rng),
            spmm_q8_case("n4096_e16384", agg_plans["n4096_e16384"], 64, rng),
            spmm_q8_case("cora_full", agg_plans["cora_full"], 1433, rng),
            spmm_q8_case("minibatch_lg", agg_plans["minibatch_lg"], 602,
                         rng)]


def phase_q8_forward(dev, cora_plan, params, x_table):
    """gcn-cora at full width through ``cuda_q8`` on the Cora-scale graph."""
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.models.gnn import gcn
    from repro_torch.sparse.quantize import Q8_E2E_TOL
    x = torch.from_numpy(x_table).to(dev)
    y_q8, n_calls, replay_err = replay_aggregates_on_cpu(
        lambda: gcn.forward(params, FULL, x, backend="cuda_q8",
                            plan=cora_plan))
    check(tuple(y_q8.shape) == (2709, FULL.n_classes) and bool(
        torch.isfinite(y_q8).all()), "q8 forward malformed")
    check(n_calls == FULL.n_layers and replay_err <= KERNEL_TOL,
          f"q8 forward: {n_calls} aggregations, card vs CPU replay "
          f"{replay_err:.3e}")
    y_dense = gcn.forward(params, FULL, x, backend="dense", plan=cora_plan)
    err = float((y_q8 - y_dense).abs().max())
    check(err <= Q8_E2E_TOL, f"q8 forward vs dense {err:.3e}")
    cpu_params = {k: {n: t.cpu() for n, t in p.items()}
                  for k, p in params.items()}
    y_cpu = gcn.forward(cpu_params, FULL, torch.from_numpy(x_table),
                        backend="cuda_q8", plan=on_cpu(cora_plan))
    err_cpu = float((y_q8.cpu() - y_cpu).abs().max())
    check(err_cpu <= Q8_E2E_TOL, f"q8 forward GPU vs CPU {err_cpu:.3e}")
    rec = dict(q8_vs_dense=err, aggregations_vs_cpu_replay=replay_err,
               forward_gpu_vs_cpu=err_cpu)
    say(f"q8 forward gcn-cora {json.dumps(rec)}")
    return rec


def q8_step_vs_cpu(server, seeds) -> dict:
    """One warm bucket-16 ``cuda_q8`` step on the card against the same
    step on the CPU: each int8 aggregation replayed on the CPU from the
    card's inputs (≤1e-5), and the whole step's output (within
    ``Q8_E2E_TOL``: the CPU's own ``h @ W`` may round an int8 the other
    way)."""
    from repro_torch.serve.compute import FeatureStore, build_infer_step
    from repro_torch.sparse.quantize import Q8_E2E_TOL
    step, node_ids, hop_valid = host_input_step(server, seeds)
    y, n_calls, replay_err = replay_aggregates_on_cpu(
        lambda: step(server.params, node_ids, hop_valid))
    check(n_calls == server.cfg.n_layers and replay_err <= KERNEL_TOL,
          f"q8 step: {n_calls} aggregations, card vs CPU replay "
          f"{replay_err:.3e}")
    store = FeatureStore(n_nodes=server.store.n_nodes,
                         x=server.store.x.cpu())
    cpu_step = build_infer_step(server.arch_id, server.cfg, store,
                                server._struct(16), backend="cuda_q8")
    cpu_params = {k: {n: t.cpu() for n, t in p.items()}
                  for k, p in server.params.items()}
    y_cpu = cpu_step(cpu_params, node_ids, hop_valid)
    err = float((y.cpu() - y_cpu).abs().max())
    check(err <= Q8_E2E_TOL, f"q8 step GPU vs CPU {err:.3e}")
    return dict(step_aggregations_vs_cpu_replay=replay_err,
                step_gpu_vs_cpu=err)


def spgemm_q8_case(name, plan, b2):
    from repro_torch.kernels.spgemm_pad import (spgemm_hashpad_q8,
                                                spgemm_hashpad_q8_compact_plain,
                                                spgemm_hashpad_q8_plain)
    from repro_torch.sparse import backend as sb
    from repro_torch.sparse import quantize as qz
    from repro_torch.sparse.spgemm.numeric import hashed_slab_q8
    args = (plan.ell_remaining, plan.ell_block_ptr, plan.ell_a_q8,
            plan.ell_a_scale, plan.cell_ptr, plan.cell_lane, plan.cell_bucket,
            plan.cell_q8, plan.slab_scale, plan.c_indptr, plan.out_bucket)
    kw = dict(block_rows=plan.block_rows, pad_width=plan.pad_width)
    c_vals = spgemm_hashpad_q8(*args, **kw)
    again = spgemm_hashpad_q8(*args, **kw)
    plain = spgemm_hashpad_q8_compact_plain(*args, **kw)
    oracle = spgemm_hashpad_q8_plain(
        plan.ell_remaining, plan.ell_block_ptr, plan.ell_a_q8,
        plan.ell_a_scale, hashed_slab_q8(plan), plan.slab_scale,
        **kw)[plan.out_row.long(), plan.out_bucket.long()]
    torch.cuda.synchronize()
    check(c_vals.shape == (plan.nnz_out,) and bool(
        torch.isfinite(c_vals).all()), f"B5 {name}: malformed C values")
    err = float((c_vals - plain).abs().max())
    check(err <= KERNEL_TOL, f"B5 {name}: max|kernel-plain| {err:.3e} > "
                             f"{KERNEL_TOL}")
    err_oracle = float((c_vals - oracle).abs().max())
    check(err_oracle <= KERNEL_TOL, f"B5 {name}: max|kernel-dense oracle| "
                                    f"{err_oracle:.3e} > {KERNEL_TOL}")
    check(torch.equal(again, c_vals), f"B5 {name}: two calls differ")
    del plain, oracle, again
    got = sb.spgemm(plan, backend="cuda_q8")
    check(got.shape == (plan.nnz_out,) and bool(torch.isfinite(got).all()),
          f"spgemm cuda_q8 {name}: malformed result")
    dev_ref = float((got - sb.spgemm(plan, backend="reference")).abs().max())
    bound = qz.spgemm_q8_bound(plan.width, plan.ell_out_block, plan.n_blocks,
                               plan.ell_a_scale, plan.slab_scale)
    check(qz.q8_gate(dev_ref, bound),
          f"spgemm {name}: cuda_q8 vs reference {dev_ref:.3e} over the "
          f"bound {bound:.3e}")
    big = plan.nnz_out > 200_000
    rec = dict(
        shape=f"{name} H={plan.pad_width}", max_abs_err=err,
        dense_oracle_err=err_oracle, run_to_run_equal=True,
        ms=graph_ms(lambda: spgemm_hashpad_q8(*args, **kw)),
        eager_ms=eager_ms(lambda: spgemm_hashpad_q8(*args, **kw)),
        f32_kernel_ms=b2["ms"],
        plain_ms=eager_ms(lambda: spgemm_hashpad_q8_compact_plain(*args,
                                                                  **kw),
                          iters=3 if big else 10),
        library_ms=b2["library_ms"],
        library_note="torch.sparse.mm(A_csr, A_csr) on the f32 operands, "
                     "timed in phase 6 of this run: cuSPARSE SpGEMM, the "
                     "nearest library call (no int8 SpGEMM), eager",
        q8_executor_ms=eager_ms(lambda: sb.spgemm(plan, backend="cuda_q8")),
        f32_executor_ms=eager_ms(lambda: sb.spgemm(plan, backend="cuda")),
        whole_build_ms=whole_build_ms(plan, "cuda_q8"),
        q8_executor_vs_reference=dev_ref, q8_bound=bound,
        **spgemm_bound(plan, plan.ell_a_q8, 1, INT8_OPS_PER_S))
    say(f"B5 {json.dumps(rec)}")
    return rec


def phase_q8_two_hop(dev, params, x_table):
    """The counted int8 path: Â² and a coarsened graph through the
    ``cuda_q8`` SpGEMM executor, then gcn-cora at full width over the Â²
    plan through ``cuda_q8`` aggregation."""
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.data.synthetic import cora_like
    from repro_torch.kernels.gustavson_spmm import spmm_dedup_chunks_q8
    from repro_torch.kernels.spgemm_pad import spgemm_hashpad_q8
    from repro_torch.models.gnn import gcn
    from repro_torch.sparse import quantize as qz
    from repro_torch.sparse.graph import (coarsen_graph, graph_coo,
                                          make_graph, sym_norm_weights)
    from repro_torch.sparse.plan import plan_from_graph
    from repro_torch.sparse.spgemm import make_spgemm_plan, two_hop_graph
    s, r, _, _, _ = cora_like(seed=0)
    s2, r2, w = sym_norm_weights(s, r, 2708)
    g = make_graph(s2, r2, 2708, edge_weight=w, device=dev)
    clusters = np.random.default_rng(3).integers(0, 128, 2708)
    x = torch.from_numpy(x_table).to(dev)

    spgemm_hashpad_q8.launches = 0
    spmm_dedup_chunks_q8.launches = 0
    t0 = time.perf_counter()
    g2 = two_hop_graph(g, backend="cuda_q8")
    plan2 = plan_from_graph(g2, backends=("cuda_q8",))
    gc = coarsen_graph(g, clusters, 128, backend="cuda_q8")
    y, n_calls, replay_err = replay_aggregates_on_cpu(
        lambda: gcn.forward(params, FULL, x, backend="cuda_q8", plan=plan2))
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = {"spgemm_hashpad_q8": spgemm_hashpad_q8.launches,
                "spmm_dedup_chunks_q8": spmm_dedup_chunks_q8.launches}
    check(launches == {"spgemm_hashpad_q8": 3, "spmm_dedup_chunks_q8": 2},
          f"q8 two-hop path launches {launches}, expected 3 "
          "spgemm_hashpad_q8 (two_hop_graph 1 + coarsen_graph 2) and 2 "
          "spmm_dedup_chunks_q8")

    # Â² through cuda_q8: the reference's edges, weights within the bound
    g2_ref = two_hop_graph(g, backend="reference")
    s_q, r_q, w_q = graph_coo(g2)
    s_r, r_r, w_r = graph_coo(g2_ref)
    check(np.array_equal(s_q, s_r) and np.array_equal(r_q, r_r),
          "q8 two-hop: cuda_q8 and reference Â² have different edges")
    err_w = float(np.abs(w_q - w_r).max())
    sp = make_spgemm_plan(r2, s2, 2708, r2, s2, 2708, a_vals=w, b_vals=w,
                          executors=("cuda_q8",), device=dev)
    bound_w = qz.spgemm_q8_bound(sp.width, sp.ell_out_block, sp.n_blocks,
                                 sp.ell_a_scale, sp.slab_scale)
    check(qz.q8_gate(err_w, bound_w), f"q8 two-hop weights vs reference "
                                      f"{err_w:.3e} over {bound_w:.3e}")
    gc_ref = coarsen_graph(g, clusters, 128, backend="reference")
    s_q, r_q, w_c = graph_coo(gc)
    s_r, r_r, w_cr = graph_coo(gc_ref)
    check(np.array_equal(s_q, s_r) and np.array_equal(r_q, r_r),
          "q8 coarsen: cuda_q8 and reference graphs have different edges")
    err_c_ref = float(np.abs(w_c - w_cr).max())

    # the same int8 calls on the CPU (plain versions)
    g_cpu = make_graph(s2, r2, 2708, edge_weight=w, device="cpu")
    g2_cpu = two_hop_graph(g_cpu, backend="cuda_q8")
    _, _, w2_cpu = graph_coo(g2_cpu)
    err_w_cpu = float(np.abs(w_q - w2_cpu).max())
    check(err_w_cpu <= KERNEL_TOL, f"q8 two-hop GPU vs CPU {err_w_cpu:.3e}")
    _, _, wc_cpu = graph_coo(coarsen_graph(g_cpu, clusters, 128,
                                           backend="cuda_q8"))
    err_c_cpu = float(np.abs(w_c - wc_cpu).max())
    check(err_c_cpu <= KERNEL_TOL, f"q8 coarsen GPU vs CPU {err_c_cpu:.3e}")

    # gcn-cora over Â²: aggregations replayed on the CPU, then end to end
    check(tuple(y.shape) == (2709, FULL.n_classes) and bool(
        torch.isfinite(y).all()), "q8 two-hop forward malformed")
    check(n_calls == FULL.n_layers and replay_err <= KERNEL_TOL,
          f"q8 two-hop forward: card vs CPU replay {replay_err:.3e}")
    err_y = float((y - gcn.forward(params, FULL, x, backend="dense",
                                   plan=plan2)).abs().max())
    check(err_y <= qz.Q8_E2E_TOL, f"q8 two-hop forward vs dense {err_y:.3e}")
    cpu_params = {k: {n: t.cpu() for n, t in p.items()}
                  for k, p in params.items()}
    y_cpu = gcn.forward(cpu_params, FULL, torch.from_numpy(x_table),
                        backend="cuda_q8",
                        plan=plan_from_graph(g2_cpu, backends=("cuda_q8",)))
    err_cpu = float((y.cpu() - y_cpu).abs().max())
    check(err_cpu <= qz.Q8_E2E_TOL, f"q8 two-hop forward GPU vs CPU "
                                    f"{err_cpu:.3e}")
    rec = dict(a2_edges=int(g2.edge_valid.sum()),
               coarse_edges=int(gc.edge_valid.sum()), launches=launches,
               a2_weight_err_vs_reference=err_w, a2_q8_bound=bound_w,
               coarsen_err_vs_reference=err_c_ref,
               a2_gpu_vs_cpu=err_w_cpu, coarsen_gpu_vs_cpu=err_c_cpu,
               forward_aggregations_vs_cpu_replay=replay_err,
               forward_q8_vs_dense=err_y, forward_gpu_vs_cpu=err_cpu,
               path_wall_s=path_s)
    say(f"q8 two-hop {json.dumps(rec)}")
    return rec


# ---------------------------------------------------------------------------
# phases 10-12 — embedding_bag and DLRM-RM2 serving, sddmm, flash_attention
# ---------------------------------------------------------------------------

def embedding_bag_case(name, ids, table):
    """B6 against its plain version over ``table`` at global ids ``ids``
    (B, F, M), timed beside ``F.embedding_bag(mode="sum")``."""
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_plain)
    b, f, m = ids.shape
    d = table.shape[1]
    out = embedding_bag(ids, table)
    plain = embedding_bag_plain(ids, table)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"B6 {name}: non-finite output")
    err = float((out - plain).abs().max())
    del plain
    check(err <= KERNEL_TOL, f"B6 {name}: max|kernel-plain| {err:.3e} > "
                             f"{KERNEL_TOL}")
    check(m > 1 or err == 0, f"B6 {name}: a one-row bag differs from its "
                             f"row by {err:.3e}")
    bags = ids.reshape(b * f, m)
    library = lambda: F.embedding_bag(bags, table, mode="sum")  # noqa: E731
    lib_err = float((library() - out.reshape(b * f, d)).abs().max())
    check(lib_err <= KERNEL_TOL, f"B6 {name}: kernel vs F.embedding_bag "
                                 f"{lib_err:.3e}")
    big = out.numel() > 1 << 26
    graph_kw = dict(calls=5, replays=4) if big else {}
    rec = dict(
        shape=f"{name} B={b} F={f} M={m} D={d}", max_abs_err=err,
        max_row_offset=int(ids.max()) * d,
        ms=graph_ms(lambda: embedding_bag(ids, table), **graph_kw),
        plain_ms=eager_ms(lambda: embedding_bag_plain(ids, table),
                          iters=3 if big else 20),
        library_ms=graph_ms(library, **graph_kw), library_err=lib_err,
        library_note="F.embedding_bag(mode='sum') on the (B*F, M) bags")
    # least bytes: the ids once, each distinct table row they name once,
    # the bags written once.  Least operations: M - 1 adds per element.
    n_rows = torch.unique(ids).numel()
    n_bytes = 4 * (ids.numel() + n_rows * d + out.numel())
    n_flops = b * f * max(m - 1, 0) * d
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / F32_FLOPS_PER_S
    rec.update(bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bound_bytes=n_bytes, distinct_rows=n_rows)
    say(f"B6 {json.dumps(rec)}")
    return rec


def phase_dlrm(dev):
    """dlrm-rm2 at full width with its whole 12.6 GB table on the card: B6
    at the two serving batches and a multi-hot case, then the counted
    serving and retrieval steps against the plain lookup."""
    from repro_torch.configs.dlrm_rm2 import FULL
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.data.synthetic import dlrm_batch
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.launch.steps import build_recsys_step
    from repro_torch.models.recsys import dlrm
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = dlrm.init_params(FULL, gen, device=dev)
    torch.cuda.synchronize()
    table = params["table"]
    check(tuple(table.shape) == (FULL.padded_vocab, FULL.embed_dim)
          and table.numel() > 2 ** 31, f"dlrm table {tuple(table.shape)}")
    say(f"dlrm-rm2 table {tuple(table.shape)}, "
        f"{table.numel() * 4 / 1e9:.2f} GB, drawn on the card in "
        f"{time.perf_counter() - t0:.2f}s")
    offs = torch.from_numpy(FULL.field_offsets).to(dev)

    b6 = []
    for name, batch, multi_hot in B6_CASES:
        _, ids, _ = dlrm_batch(batch, FULL.n_dense, FULL.vocab_sizes,
                               multi_hot=multi_hot, seed=10)
        gids = torch.from_numpy(ids).to(dev) + offs[None, :, None]
        b6.append(embedding_bag_case(name, gids, table))
    top = max(c["max_row_offset"] for c in b6)
    check(top >= 2 ** 31, f"B6: largest row*D {top} < 2**31")
    say(f"B6: largest row*D reached {top} (2**31 = {2 ** 31})")

    steps, launches = [], 0
    for shape_name, n_steps in (("serve_p99", 20), ("serve_bulk", 5),
                                ("retrieval_cand", 20)):
        shape = RECSYS_SHAPES[shape_name]
        dense, ids, _ = dlrm_batch(shape.batch, FULL.n_dense,
                                   FULL.vocab_sizes, seed=20)
        batch = {"dense": torch.from_numpy(dense).to(dev),
                 "sparse_ids": torch.from_numpy(ids).to(dev)}
        if shape.kind == "retrieval":
            batch["candidates"] = torch.randn(
                (shape.n_candidates, FULL.embed_dim), generator=gen,
                device=dev)
        step = build_recsys_step(FULL, shape)
        embedding_bag.launches = 0
        got = step(params, batch)
        torch.cuda.synchronize()
        n = embedding_bag.launches
        check(n == 1, f"dlrm {shape_name}: {n} embedding_bag launches, "
                      "expected 1 per forward")
        launches += n
        if shape.kind == "retrieval":
            want_shape = (shape.batch, shape.n_candidates)
            want = dlrm.retrieval_step(params, FULL, batch["dense"],
                                       batch["sparse_ids"],
                                       batch["candidates"], use_kernel=False)
        else:
            want_shape = (shape.batch,)
            want = dlrm.forward(params, FULL, batch["dense"],
                                batch["sparse_ids"], use_kernel=False)
        check(tuple(got.shape) == want_shape and bool(
            torch.isfinite(got).all()), f"dlrm {shape_name}: output "
                                        f"{tuple(got.shape)} malformed")
        err = float((got - want).abs().max())
        check(err <= SERVE_TOL, f"dlrm {shape_name}: kernel path vs plain "
                                f"lookup {err:.3e}")
        rec = dict(shape=shape_name, batch=shape.batch, launches=n,
                   vs_plain_lookup=err,
                   **trace_steps(lambda: step(params, batch), n_steps,
                                 "embedding_bag", top=5))
        say(f"dlrm step {json.dumps(rec)}")
        steps.append(rec)
    return b6, steps, launches


B7_GROUPED, B7_DIRECT = 0, 2 ** 63 - 1   # thresholds that force a path


def on_b7_path(threshold, fn):
    """``fn()`` with B7's grouping threshold set to ``threshold`` bytes."""
    import importlib
    mod = importlib.import_module("repro_torch.kernels.sddmm.sddmm")
    old, mod.GROUP_ABOVE_X_BYTES = mod.GROUP_ABOVE_X_BYTES, threshold
    try:
        return fn()
    finally:
        mod.GROUP_ABOVE_X_BYTES = old


def sddmm_case(name, src, dst, x, y, library=True):
    """B7 through ``edge_scores`` against its plain version (≤1e-5
    relative and absolute) and against itself run to run (bitwise), timed
    on the path the wrapper takes (``ms``) and on each path forced
    (``grouped_ms``, ``direct_ms``), beside ``torch.sparse.sampled_addmm``
    unless ``library`` is False."""
    import torch.nn.functional as F
    from repro_torch.kernels.sddmm import edge_scores, sddmm, sddmm_plain
    e, d = src.shape[0], x.shape[1]
    got = edge_scores(src, dst, x, y)
    want = sddmm_plain(src, dst, x, y)
    torch.cuda.synchronize()
    check(tuple(got.shape) == (e,) and bool(torch.isfinite(got).all()),
          f"B7 {name}: malformed scores")
    err = float((got - want).abs().max())
    excess = float(((got - want).abs() - KERNEL_TOL * want.abs()).max())
    check(excess <= KERNEL_TOL, f"B7 {name}: kernel vs plain {err:.3e} "
                                "beyond 1e-5 + 1e-5*|plain|")
    del want
    check(torch.equal(edge_scores(src, dst, x, y), got),
          f"B7 {name}: scores differ from run to run")
    pad = (-e) % 256
    src_p, dst_p = F.pad(src, (0, pad)), F.pad(dst, (0, pad))
    big = e > 1 << 24
    graph_kw = dict(calls=5, replays=4) if big else {}
    rec = dict(shape=f"{name} E={e} D={d}", max_abs_err=err,
               run_to_run_equal=True,
               ms=graph_ms(lambda: sddmm(src_p, dst_p, x, y), **graph_kw))
    for path, threshold in (("grouped", B7_GROUPED), ("direct", B7_DIRECT)):
        rec[f"{path}_ms"] = on_b7_path(threshold, lambda: graph_ms(
            lambda: sddmm(src_p, dst_p, x, y), **graph_kw))
    if big:        # device ms of each kernel of one call, from a trace
        rec["kernels_ms"] = trace_steps(lambda: sddmm(src_p, dst_p, x, y),
                                        3, "sddmm", top=8)["top_ms_per_step"]
    del src_p, dst_p
    # least bytes: the indices once, each distinct x and y row they name
    # once, the scores once.  Least operations: 2 per element of each pair.
    # The grouped design's floor: each distinct x row once, one y row per
    # edge (no reuse of y in L2), the indices and the scores.
    rows = [int(torch.zeros(t.shape[0], dtype=torch.bool, device=t.device)
                .index_fill_(0, i.long(), True).sum())
            for t, i in ((x, src), (y, dst))]
    n_bytes = 4 * (3 * e + d * sum(rows))
    n_flops = 2 * e * d
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / F32_FLOPS_PER_S
    floor_bytes = 4 * (3 * e + d * (rows[0] + e))
    rec.update(bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bound_bytes=n_bytes, bound_flops=n_flops,
               grouped_floor_ms=floor_bytes / HBM_BYTES_PER_S * 1e3,
               grouped_floor_bytes=floor_bytes)
    if not library:
        rec.update(plain_ms=None, library_ms=None)
        say(f"B7 {json.dumps(rec)}")
        return rec
    rec["plain_ms"] = eager_ms(lambda: sddmm_plain(src, dst, x, y),
                               iters=3 if big else 20)
    # torch.sparse.sampled_addmm on the CSR pattern of (src, dst), edges in
    # (src, dst) order; the pattern repeats edges, which CSR may refuse

    def csr_pattern():
        order = torch.argsort(src.long() * y.shape[0] + dst.long())
        crow = torch.zeros(x.shape[0] + 1, dtype=torch.int64,
                           device=x.device)
        crow[1:] = torch.cumsum(
            torch.bincount(src.long(), minlength=x.shape[0]), 0)
        return order, torch.sparse_csr_tensor(
            crow, dst.long()[order], torch.zeros(e, device=x.device),
            (x.shape[0], y.shape[0]))
    order, pattern = csr_pattern()
    # the kernel on the same edges in that (src, dst) order: the caller has
    # grouped them already
    src_s = F.pad(src[order], (0, pad))
    dst_s = F.pad(dst[order], (0, pad))
    rec["src_sorted_ms"] = graph_ms(lambda: sddmm(src_s, dst_s, x, y),
                                    **graph_kw)
    for path, threshold in (("grouped", B7_GROUPED), ("direct", B7_DIRECT)):
        rec[f"src_sorted_{path}_ms"] = on_b7_path(threshold, lambda: graph_ms(
            lambda: sddmm(src_s, dst_s, x, y), **graph_kw))
    del src_s, dst_s
    y_t = y.T
    try:
        lib = torch.sparse.sampled_addmm(pattern, x, y_t, beta=0.0)
    except RuntimeError as exc:          # the library refuses the pattern
        rec.update(library_ms=None, library_note=f"— sampled_addmm: "
                                                 f"{str(exc)[:160]}")
    else:
        lib_err = float((lib.values() - got[order]).abs().max())
        check(lib_err <= EXECUTOR_TOL, f"B7 {name}: kernel vs sampled_addmm "
                                       f"{lib_err:.3e}")
        del lib
        rec.update(library_ms=eager_ms(
            lambda: torch.sparse.sampled_addmm(pattern, x, y_t, beta=0.0),
            iters=3 if big else 20), library_err=lib_err,
            library_note="torch.sparse.sampled_addmm on the CSR pattern of "
                         "(src, dst), eager")
        # the like-for-like yardstick: the kernel takes (src, dst) as they
        # come and returns scores in that order, so the library call pays
        # for its pattern and for the scatter back to the caller's order

        def library_with_pattern():
            order, pattern = csr_pattern()
            vals = torch.sparse.sampled_addmm(pattern, x, y_t,
                                              beta=0.0).values()
            return torch.empty_like(vals).index_copy_(0, order, vals)
        order_err = float((library_with_pattern() - got).abs().max())
        check(order_err <= EXECUTOR_TOL, f"B7 {name}: kernel vs "
                                         f"sampled_addmm in edge order "
                                         f"{order_err:.3e}")
        rec["library_with_pattern_ms"] = eager_ms(library_with_pattern,
                                                  iters=3 if big else 20)
    del pattern, order
    say(f"B7 {json.dumps(rec)}")
    return rec


def phase_sddmm(dev):
    """B7 through ``edge_scores`` at the Cora-scale graph (d = 64), at the
    ogb_products shape (2,449,029 nodes, 61,859,140 edges, d = 100, indices
    and features drawn on the card) and at that shape with skewed sources
    (``src = floor(N·u²)``, ~40K edges on row 0); then the permutation
    check at ogb_products."""
    from repro_torch.data.synthetic import cora_like
    from repro_torch.kernels.sddmm import edge_scores, sddmm
    rng = np.random.default_rng(11)
    s, r, _, _, _ = cora_like(seed=0)
    cora = [torch.from_numpy(a).to(dev) for a in (
        s.astype(np.int32), r.astype(np.int32),
        rng.normal(size=(2708, 64)).astype(np.float32),
        rng.normal(size=(2708, 64)).astype(np.float32))]
    gen = torch.Generator(device=dev).manual_seed(11)
    n, e, d = OGB_PRODUCTS
    products = [torch.randint(0, n, (e,), generator=gen, device=dev,
                              dtype=torch.int32) for _ in range(2)]
    products += [torch.randn((n, d), generator=gen, device=dev)
                 for _ in range(2)]
    u = torch.rand(e, generator=gen, device=dev, dtype=torch.float64)
    skewed = [(n * u * u).floor().clamp_max(n - 1).to(torch.int32),
              products[1], products[2], products[3]]
    del u
    hub = int((skewed[0] == 0).sum())
    sddmm.launches = 0
    edge_scores(*cora)
    edge_scores(*products)
    edge_scores(*skewed)
    torch.cuda.synchronize()
    launches = sddmm.launches
    check(launches == 3, f"B7: {launches} launches on the edge_scores path, "
                         "expected 3")
    recs = [sddmm_case("cora_like", *cora),
            sddmm_case("ogb_products", *products),
            sddmm_case("ogb_products_skewed", *skewed, library=False)]
    recs[2]["hub_edges"] = hub
    del skewed
    # scores of a permuted edge list, permuted back, equal the unpermuted
    perm = torch.randperm(e, generator=gen, device=dev)
    want = edge_scores(*products)
    permuted = edge_scores(products[0][perm], products[1][perm],
                           *products[2:])
    back = torch.empty_like(permuted)
    back[perm] = permuted
    torch.cuda.synchronize()
    check(torch.equal(back, want), "B7 ogb_products: permuted edges give "
                                   "other scores")
    recs[1]["permutation_equal"] = True
    say(f"B7 permutation check at ogb_products: equal; hub row 0 of the "
        f"skewed case holds {hub} edges")
    del perm, want, permuted, back
    recs[1]["path_sweep"] = b7_path_sweep(dev, products[2], products[3], gen)
    return recs, launches


def b7_path_sweep(dev, x_full, y_full, gen):
    """Both B7 paths on uniform random edges at ogb_products' width and
    mean degree (E / N = 25.26), x (and y) from ¼ to 8× the card's L2:
    where grouping by source starts to pay.  The two paths must give the
    same bits."""
    from repro_torch.kernels.sddmm import sddmm
    n_all, e_all, d = OGB_PRODUCTS
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    sweep = []
    for share in (0.25, 0.5, 1, 2, 4, 8):
        n = int(share * l2) // (4 * d)
        e = round(n * e_all / n_all) // 256 * 256
        src, dst = (torch.randint(0, n, (e,), generator=gen, device=dev,
                                  dtype=torch.int32) for _ in range(2))
        x, y = x_full[:n], y_full[:n]
        rec = dict(x_over_l2=share, nx=n, e=e)
        got = {}
        for path, threshold in (("grouped", B7_GROUPED),
                                ("direct", B7_DIRECT)):
            got[path] = on_b7_path(threshold,
                                   lambda: sddmm(src, dst, x, y))
            rec[f"{path}_ms"] = on_b7_path(threshold, lambda: graph_ms(
                lambda: sddmm(src, dst, x, y), calls=10, replays=5))
        check(torch.equal(got["grouped"], got["direct"]),
              f"B7 path sweep at {share}x L2: the paths' scores differ")
        sweep.append(rec)
    say(f"B7 path sweep (L2 {l2} B) {json.dumps(sweep)}")
    return sweep


def flash_case(dtype, flat):
    """B8 at one dtype on the (BH, S, d) layout ``flat`` = (qf, kf, vf):
    timed beside its plain version and ``scaled_dot_product_attention``."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (causal_attention_plain,
                                                     flash_attention)
    qf, kf, vf = flat
    bh, s, d = qf.shape
    out = flash_attention(qf, kf, vf)
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qf[None], kf[None], vf[None], is_causal=True)[0]
    lib_err = float((library().float() - out.float()).abs().max())
    check(lib_err <= (2e-2 if dtype == torch.bfloat16 else 1e-4),
          f"B8 {dtype}: kernel vs scaled_dot_product_attention {lib_err:.3e}")
    rec = dict(shape=f"qwen3-0.6b attention BH={bh} S={s} d={d} "
                     f"{str(dtype).split('.')[-1]}",
               ms=graph_ms(lambda: flash_attention(qf, kf, vf), calls=5,
                           replays=4),
               plain_ms=eager_ms(lambda: causal_attention_plain(qf, kf, vf),
                                 iters=3),
               library_ms=graph_ms(library, calls=5, replays=4),
               library_err=lib_err,
               library_note="F.scaled_dot_product_attention(is_causal=True)"
                            " on the repeated (1, BH, S, d) heads")
    # least bytes: q, k, v read once and o written once (the repeated
    # heads, as the kernel takes them).  Least operations: q.k and p.v over
    # the S(S+1)/2 causal pairs, 2 flops a multiply-add, at the tensor
    # cores' peak for the input type: bf16, or for f32 the 3xTF32 rate
    # (the TF32 peak over the three products each f32 one takes)
    n_bytes = 4 * bh * s * d * qf.element_size()
    n_flops = 2 * bh * d * s * (s + 1)
    peak = (BF16_FLOPS_PER_S if dtype == torch.bfloat16
            else F32_3XTF32_FLOPS_PER_S)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / peak
    rec.update(bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bound_bytes=n_bytes, bound_flops=n_flops)
    rec.update(tflop_s=n_flops / rec["ms"] / 1e9,
               bound_share=rec["bound_ms"] / rec["ms"])
    return rec


def sass_readings(library: pathlib.Path) -> dict:
    """Per kernel instantiation in ``library``: its ``HGMMA`` and ``HMMA``
    instructions (``cuobjdump -sass``) and its resource usage
    (``cuobjdump --dump-resource-usage``: registers, stack, local memory,
    which holds spills, and static shared memory; the dynamic shared memory
    is set by the launch function)."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")

    def dump(flag):
        return subprocess.run([tool, flag, str(library)], capture_output=True,
                              text=True, check=True, timeout=300).stdout

    def readable(mangled):       # _Z17flash_bf16_kernelILi128E... → <128>
        m = re.search(r"_Z\d+(\w+?_kernel)ILi(\d+)E", mangled)
        return f"{m.group(1)}<{m.group(2)}>" if m else mangled

    out, name = {}, None
    for line in dump("-sass").splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = readable(head.group(1))
            out[name] = {"HGMMA": 0, "HMMA": 0}
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                out[name][op] += bool(re.search(rf"\b{op}\.", line))
    for line in dump("--dump-resource-usage").splitlines():
        head = re.search(r"Function (\S+):", line)
        if head:
            name = readable(head.group(1))
        elif name in out:
            out[name].update({k.lower(): int(v) for k, v in re.findall(
                r"(REG|STACK|SHARED|LOCAL):(\d+)", line)})
    return out


def _tf32(x):
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` (to nearest, ties away
    from zero): half of the 13 dropped bits added, then masked off."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(
        torch.float32)


def _mm_3xtf32(a, b):
    """``a @ b`` from the f32 kernel's 3xTF32 terms (hi = tf32(x), lo =
    tf32(x - hi); the cross terms first).  Every operand is exact in TF32,
    so torch's TF32 flag changes only where the sums are taken: on the
    CUDA cores (off) or in the tensor cores (on)."""
    ah, bh = _tf32(a), _tf32(b)
    return (_tf32(a - ah) @ bh + ah @ _tf32(b - bh)) + ah @ bh


def _causal(q, k, v, mm=torch.matmul, exp2=torch.exp2,
            round_p=lambda p: p):
    """Causal attention on (BH, S, d) in q's dtype with the kernels'
    arithmetic route (scores scaled after the product, exponentials in base
    2), the max over the whole row, and P passed through ``round_p`` for
    P·v only (the row sums add P as it was)."""
    s, d = q.shape[1:]
    x = mm(q, k.transpose(1, 2)) * (math.log2(math.e) / math.sqrt(d))
    x.masked_fill_(torch.ones((s, s), dtype=torch.bool, device=q.device)
                   .triu_(1), -1e30)
    p = exp2(x - x.amax(-1, keepdim=True))
    del x
    return mm(round_p(p), v) / p.sum(-1, keepdim=True)


def _bf16_steps(a, ref):
    """|a - ref| in bf16 steps at ref's magnitude (8 significant bits: a
    step is 2^(e - 8) for |ref| in [2^(e-1), 2^e))."""
    _, e = torch.frexp(ref.float())
    return (a.float() - ref.float()).abs() / torch.ldexp(
        torch.ones_like(ref, dtype=torch.float32), e - 8)


def flash_numerics(dtype, flat) -> dict:
    """Where B8's error comes from, on the (BH, S, d) inputs ``flat``.

    bf16: the share of the kernel's outputs within 0, 1 and 2 bf16 steps
    of the f32 plain version rounded once to bf16, and max and mean |error|
    of the kernel against the f32 plain version, of the output's rounding
    alone, and of P's rounding to bf16 before P·v alone (the plain route
    with it against the same route without; also the share of outputs
    whose bf16 value it changes).  f32: the kernel, the plain version and
    emulations of the kernel's 3xTF32 products (sums on the CUDA cores,
    sums in the tensor cores, and with a random relative error of up to
    2^-22 on each exponential, about 2 ulp, as a stand-in for
    ``ex2.approx``) against an f64 plain version: max and mean |error|, the
    max per eighth of the rows (row i sums over i + 1 keys), and
    ``toward_zero``, the mean of (x - f64)·sign(f64) over the mean
    |x - f64| (-1 when every error shrinks the value's magnitude)."""
    from repro_torch.kernels.flash_attention import (causal_attention_plain,
                                                     flash_attention)
    got = flash_attention(*flat)
    q, k, v = (t.float() for t in flat)
    if dtype == torch.bfloat16:
        want = causal_attention_plain(q, k, v)
        steps = _bf16_steps(got, want.bfloat16())
        route = _causal(q, k, v)
        p16 = _causal(q, k, v, round_p=lambda p: p.bfloat16().float())
        readings = dict(
            kernel_within_steps_of_rounded_plain={
                n: float((steps <= n).float().mean()) for n in (0, 1, 2)},
            p_rounding_changes_rounded_output=float(
                (p16.bfloat16() != route.bfloat16()).float().mean()))
        for name, x, ref in (("kernel", got.float(), want),
                             ("output_rounding", want.bfloat16().float(),
                              want),
                             ("p_rounding", p16, route)):
            readings.update({f"{name}_max_abs": float((x - ref).abs().max()),
                             f"{name}_mean_abs": float(
                                 (x - ref).abs().mean())})
        return readings
    ref = _causal(q.double(), k.double(), v.double())
    gen = torch.Generator(device=q.device).manual_seed(15)

    def noisy_exp2(x):
        return torch.exp2(x) * (1 + (2 * torch.rand(
            x.shape, generator=gen, device=x.device) - 1) * 2.0 ** -22)

    def tensor_core_sums():
        allow = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return _causal(q, k, v, mm=_mm_3xtf32)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow
    out = {}
    for name, fn in (
            ("kernel", lambda: got),
            ("plain", lambda: causal_attention_plain(q, k, v)),
            ("emulated_3xtf32", lambda: _causal(q, k, v, mm=_mm_3xtf32)),
            ("emulated_3xtf32_tensor_core_sums", tensor_core_sums),
            ("emulated_3xtf32_ex2_error",
             lambda: _causal(q, k, v, mm=_mm_3xtf32, exp2=noisy_exp2))):
        diff = fn().double() - ref
        mag = diff.abs()
        out[name] = dict(
            max_abs=float(mag.max()), mean_abs=float(mag.mean()),
            toward_zero=float((diff * ref.sign()).mean() / mag.mean()),
            max_abs_by_eighth=[float(e) for e in mag.amax(dim=(0, 2))
                               .view(8, -1).amax(1)])
        del diff, mag
    return out


def phase_flash(dev):
    """B8 through ``mha_causal`` at qwen3-0.6b's attention width (16 heads,
    8 kv heads, head_dim 128: repro configs/qwen3_0_6b.py) and the
    train_4k length (S = 4096), batch cut to 1, in f32 and bf16."""
    from repro_torch.kernels.flash_attention import (LIBRARY,
                                                     flash_attention,
                                                     mha_causal)
    b, s, h, kv, hd = QWEN3_ATTENTION
    gen = torch.Generator(device=dev).manual_seed(12)
    q, k, v = (torch.randn((b, s, n, hd), generator=gen, device=dev)
               for n in (h, kv, kv))
    q16, k16, v16 = (t.bfloat16() for t in (q, k, v))
    flash_attention.launches = 0
    out32 = mha_causal(q, k, v)
    out16 = mha_causal(q16, k16, v16)
    torch.cuda.synchronize()
    launches = flash_attention.launches
    check(launches == 2, f"B8: {launches} launches on the mha_causal path, "
                         "expected 2")
    want32 = mha_causal(q, k, v, use_kernel=False)
    want16 = mha_causal(q16.float(), k16.float(), v16.float(),
                        use_kernel=False)
    torch.cuda.synchronize()
    recs = []
    for dtype, out, want, tol, args in (
            (torch.float32, out32, want32, 2e-5, (q, k, v)),
            (torch.bfloat16, out16, want16, 2e-2, (q16, k16, v16))):
        check(out.dtype == dtype and tuple(out.shape) == (b, s, h, hd)
              and bool(torch.isfinite(out).all()), f"B8 {dtype}: malformed")
        err = float((out.float() - want).abs().max())
        check(err <= tol, f"B8 {dtype}: kernel vs f32 plain {err:.3e} > "
                          f"{tol}")
        qt, kt, vt = args
        flat = tuple(t.repeat_interleave(h // t.shape[2], dim=2)
                     .transpose(1, 2).reshape(b * h, s, hd).contiguous()
                     for t in (qt, kt, vt))
        rec = dict(max_abs_err=err, tolerance=tol,
                   **flash_case(dtype, flat))
        say(f"B8 {json.dumps(rec)}")
        sdpa_tflop_s = rec["bound_flops"] / rec["library_ms"] / 1e9
        say(f"B8 {dtype}: {rec['tflop_s']} TFLOP/s, "
            f"{100 * rec['bound_share']}% of its {rec['bound_by']} bound; "
            f"SDPA {sdpa_tflop_s} TFLOP/s")
        say(f"B8 {dtype} numerics "
            f"{json.dumps(flash_numerics(dtype, flat))}")
        recs.append(rec)
    say(f"B8 SASS and resources {json.dumps(sass_readings(LIBRARY.path))}")
    return recs, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("[chip-smoke] torch.cuda.is_available() is false: this script "
              "needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    warnings.filterwarnings("ignore", message="Sparse")   # beta CSR notes
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.data.synthetic import cora_like
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.kernels import (embedding_bag, flash_attention,
                                     forest_sampler, gustavson_spmm, sddmm,
                                     spgemm_pad)
    from repro_torch.models.gnn import gcn
    from repro_torch.serve import FeatureStore
    from repro_torch.sparse.graph import coo_to_csr

    # phase 1 — device and build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = resolve_device("cuda")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    libraries = [gustavson_spmm.LIBRARY, forest_sampler.LIBRARY,
                 spgemm_pad.LIBRARY, embedding_bag.LIBRARY, sddmm.LIBRARY,
                 flash_attention.LIBRARY]
    secs = build.build(libraries)
    say(f"built {' + '.join(lib.name for lib in libraries)} with nvcc in "
        f"{secs:.2f}s")

    # phase 2 — kernels against their plain versions
    b1, b3, agg_plans = phase_kernels(dev)
    cora_plan = agg_plans["cora_full"]

    # phase 3 — gcn-cora at full width on the Cora-scale graph
    s, r, x, _, _ = cora_like(seed=0)
    params = gcn.init_params(FULL, torch.Generator().manual_seed(0),
                             device=dev)
    x_table = np.concatenate([x, np.zeros((1, x.shape[1]), np.float32)])
    phase_forward(dev, cora_plan, params, x_table)

    # phases 4-5 — serving from the resident Cora-scale graph
    indptr, indices, _ = coo_to_csr(s, r, 2708)
    store = FeatureStore.build(2708, x, device=dev)
    seeds = np.random.default_rng(2).integers(0, 2708, N_REQUESTS)
    serves = [phase_serve(dev, mode, params, indptr, indices, store, seeds)
              for mode in ("host", "device")]

    # phase 6 — the SpGEMM kernel against its plain version
    plans = spgemm_plans(dev)
    b2 = [spgemm_case(name, plan) for name, plan, _ in plans]

    # phase 7 — SpGEMM executors, then the counted two-hop path
    phase_spgemm_executors(plans)
    two_hop = phase_two_hop(dev, params, x_table)

    # phase 8 — int8 aggregation, the int8 forward, then int8 serving
    b4 = phase_q8_kernels(agg_plans)
    phase_q8_forward(dev, cora_plan, params, x_table)
    serves.append(phase_serve(dev, "device", params, indptr, indices, store,
                              seeds, backend="cuda_q8"))

    # phase 9 — int8 SpGEMM at phase 6's plans, then the counted path
    b5 = [spgemm_q8_case(name, plan, rec)
          for (name, plan, _), rec in zip(plans, b2)]
    del plans
    two_hop_q8 = phase_q8_two_hop(dev, params, x_table)
    del agg_plans, cora_plan
    torch.cuda.empty_cache()

    # phase 10 — B6 and dlrm-rm2 serving at full width (12.6 GB table)
    b6, dlrm_steps, b6_launches = phase_dlrm(dev)
    torch.cuda.empty_cache()

    # phase 11 — B7 through edge_scores, Cora-scale and ogb_products
    b7, b7_launches = phase_sddmm(dev)
    torch.cuda.empty_cache()

    # phase 12 — B8 through mha_causal at qwen3-0.6b width, S = 4096
    b8, b8_launches = phase_flash(dev)

    launches = {k: sum(sv["launches"][k] for sv in serves)
                for k in ("spmm_dedup_chunks", "spmm_dedup_chunks_q8",
                          "hash_draws")}
    launches["spmm_dedup_chunks"] += two_hop["launches"]["spmm_dedup_chunks"]
    launches["spmm_dedup_chunks_q8"] += \
        two_hop_q8["launches"]["spmm_dedup_chunks_q8"]
    main_b1 = b1[0]                      # bucket 16, D = 16: the main shape
    main_b2 = b2[0]                      # gcn-cora Â²: the two-hop path's
    main_b4 = b4[0]                      # bucket 16, D = 16: q8 serving
    main_b5 = b5[0]                      # gcn-cora Â²: the q8 two-hop path
    # B6 at serve_bulk, B7 at ogb_products, B8 in bf16 (b*[1] below)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        dict(name="spmm_dedup_chunks", route="cuda",
             source="src/repro_torch/kernels/gustavson_spmm/csrc/"
                    "spmm_dedup_chunks.cu",
             replaces="src/repro/kernels/gustavson_spmm/gustavson_spmm.py"
                      ":139",
             launches=launches["spmm_dedup_chunks"],
             max_abs_err=max(c["max_abs_err"] for c in b1),
             shape=main_b1["shape"], **{k: main_b1[k] for k in keys}),
        dict(name="hash_draws", route="cuda",
             source="src/repro_torch/kernels/forest_sampler/csrc/"
                    "hash_draws.cu",
             replaces="src/repro/kernels/forest_sampler/forest_sampler.py"
                      ":127",
             launches=launches["hash_draws"], max_abs_err=b3["max_abs_err"],
             shape=b3["shape"], **{k: b3[k] for k in keys}),
        dict(name="spgemm_hashpad", route="cuda",
             source="src/repro_torch/kernels/spgemm_pad/csrc/"
                    "spgemm_hashpad.cu",
             replaces="src/repro/kernels/spgemm_pad/spgemm_pad.py:83",
             launches=two_hop["launches"]["spgemm_hashpad"],
             max_abs_err=max(c["max_abs_err"] for c in b2),
             shape=main_b2["shape"], **{k: main_b2[k] for k in keys}),
        dict(name="spmm_dedup_chunks_q8", route="cuda",
             source="src/repro_torch/kernels/gustavson_spmm/csrc/"
                    "spmm_dedup_chunks.cu",
             replaces="src/repro/kernels/gustavson_spmm/gustavson_spmm.py"
                      ":299",
             launches=launches["spmm_dedup_chunks_q8"],
             max_abs_err=max(c["max_abs_err"] for c in b4),
             shape=main_b4["shape"], **{k: main_b4[k] for k in keys}),
        dict(name="spgemm_hashpad_q8", route="cuda",
             source="src/repro_torch/kernels/spgemm_pad/csrc/"
                    "spgemm_hashpad.cu",
             replaces="src/repro/kernels/spgemm_pad/spgemm_pad.py:168",
             launches=two_hop_q8["launches"]["spgemm_hashpad_q8"],
             max_abs_err=max(c["max_abs_err"] for c in b5),
             shape=main_b5["shape"], **{k: main_b5[k] for k in keys}),
        dict(name="embedding_bag", route="cuda",
             source="src/repro_torch/kernels/embedding_bag/csrc/"
                    "embedding_bag.cu",
             replaces="src/repro/kernels/embedding_bag/embedding_bag.py:76",
             launches=b6_launches,
             max_abs_err=max(c["max_abs_err"] for c in b6),
             shape=b6[1]["shape"], **{k: b6[1][k] for k in keys}),
        dict(name="sddmm", route="cuda",
             source="src/repro_torch/kernels/sddmm/csrc/sddmm.cu",
             replaces="src/repro/kernels/sddmm/sddmm.py:54",
             launches=b7_launches,
             launches_note="edge_scores calls: one kernel each on the "
                           "direct path, 8 kernels and 2 memsets on the "
                           "grouped path (ogb_products)",
             max_abs_err=max(c["max_abs_err"] for c in b7),
             shape=b7[1]["shape"], **{k: b7[1][k] for k in keys}),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/flash_attention.py"
                      ":68",
             launches=b8_launches,
             max_abs_err=max(c["max_abs_err"] for c in b8),
             shape=b8[1]["shape"], **{k: b8[1][k] for k in keys}),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
