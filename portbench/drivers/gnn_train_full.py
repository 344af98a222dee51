"""Driver of full-graph GNN training (traffic ``train_full``).

Set-up makes the configuration's fixed graph and, from ``--seed``, the
features, labels, training mask and weights on the device; it hands the
edge list to the program, which normalises it and packs its aggregation
plan (``launch/steps.build_gnn_step`` over ``sparse/plan``), and drives
the program's step through its first ``check_steps`` steps, as
``train/loop.run`` drives it: each step's loss read back to the host.
The same step, parameters and optimizer state then run the window.

After the window the reference (``pbref.gcn_train``) repeats the first
steps from the same inputs and weights, and three numbers are compared:
each step's loss, each leaf's first gradient as the optimizer took it
(the program's from its first moment after one step, ``m / (1 - b1)``),
and each leaf's change over the steps.  A leaf's gap is the gap of the two
norms over the larger of the reference's norm of that leaf and of the
median leaf; leaves whose reference gradient is under a thousandth of the
median leaf's are left out.

The window's own last step is compared too, since a program may change
its path after the first steps (a captured graph, a swapped plan): the
reference takes one step from the program's parameters and optimizer
state just before it, and that step's loss and each leaf's change are
compared by the same measure.  Only this stage starts from the program's
state; the first steps above check the start from the benchmark's own.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from pbcore import env, graphs, work
from pbcore.gnn import dims, flat, sync
from pbcore.record import Run, check
from pbcore.trace import maybe_profiled
from pbref import gcn_train as ref



def graph(cfg: dict, dev: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """The configuration's fixed graph, drawn and symmetrised on ``dev``:
    (senders, receivers) on the host, where the program takes them."""
    g = cfg["graph"]
    s, r = graphs.symmetrize(*graphs.powerlaw_exact(
        g["nodes"], g["edges"], g["alpha"], g["seed"], dev), g["nodes"])
    return s.cpu().numpy(), r.cpu().numpy()


def inputs(cfg: dict, seed: int, dev: torch.device):
    """(features with a zero ghost row, labels, training mask, weights)
    drawn from ``seed`` on ``dev``."""
    n = cfg["graph"]["nodes"]
    gen = torch.Generator(device=dev).manual_seed(seed % (1 << 63))
    x = torch.randn((n + 1, cfg["in_channels"]), generator=gen, device=dev)
    x[n] = 0.0
    labels = torch.randint(0, cfg["out_channels"], (n + 1,), generator=gen,
                           device=dev)
    train = torch.randperm(n, generator=gen, device=dev)[:cfg["train_nodes"]]
    mask = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    mask[train] = True
    d = dims(cfg)
    params = {}
    for i, (din, dout) in enumerate(zip(d[:-1], d[1:])):
        params[f"layer{i}"] = {
            "w": torch.randn((din, dout), generator=gen, device=dev)
            / din ** 0.5,
            "b": torch.zeros((dout,), device=dev)}
    return x, labels, mask, params


def program(cfg: dict, s: np.ndarray, r: np.ndarray, dev: torch.device):
    """The program's step over the graph, and its graph: the port's
    normalisation, padded graph and plan (packed here, once)."""
    from repro_torch.launch import steps
    from repro_torch.models.gnn.gcn import GCNConfig
    from repro_torch.optim import adamw
    from repro_torch.sparse.graph import make_graph, sym_norm_weights
    n = cfg["graph"]["nodes"]
    s2, r2, w = sym_norm_weights(s, r, n)
    g = make_graph(s2, r2, n, w, device=dev)
    model = GCNConfig(name=cfg["name"], n_layers=cfg["num_layers"],
                      d_in=cfg["in_channels"], d_hidden=cfg["hidden_channels"],
                      n_classes=cfg["out_channels"],
                      param_dtype=cfg["dtype"])
    o = cfg["optimizer"]
    opt = adamw.AdamWConfig(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                            weight_decay=o["weight_decay"],
                            grad_clip=o["grad_clip"])
    step = steps.build_gnn_step(cfg["arch"], model, opt,
                                backend=cfg["backend"], graph=g)
    return g, step, adamw.init_state


def leaf_gap(prog: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             keep: List[str]) -> float:
    """The widest gap of a leaf's norm, program against reference, over
    the larger of the reference's norm of that leaf and of the median
    leaf."""
    norms = {k: float(torch.linalg.vector_norm(want[k].double()))
             for k in keep}
    median = float(np.median(list(norms.values())))
    return max(abs(float(torch.linalg.vector_norm(prog[k].double()))
                   - norms[k]) / max(norms[k], median, 1e-30)
               for k in keep)


def moved(grads: dict) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move by round-off alone."""
    gnorm = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in grads.items()}
    floor = 1e-3 * float(np.median(list(gnorm.values())))
    return [k for k in grads if gnorm[k] >= floor]


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def compare(cfg: dict, first: Tuple[List[float], dict, dict],
            want: Tuple[List[float], dict, dict],
            params0: dict) -> Dict[str, float]:
    """The first steps' three numbers: (losses, first gradients,
    parameters after the steps) of the program against the reference's."""
    losses, grads, last = first
    r_losses, r_grads, r_last = want
    keep = moved(r_grads)
    return {
        "loss_gap": max(rel_gap(a, b) for a, b in zip(losses, r_losses)),
        "grad_gap": leaf_gap(grads, r_grads, keep),
        "step_gap": leaf_gap({k: last[k] - params0[k] for k in keep},
                             {k: r_last[k] - params0[k] for k in keep},
                             keep),
    }


def compare_last(loss: float, before: dict, after: dict,
                 want: Tuple[List[float], dict, dict]) -> Dict[str, float]:
    """The window's last step: its loss, and each leaf's change from
    ``before`` to ``after``, against the reference's one step from
    ``before``."""
    r_losses, r_grads, r_after = want
    keep = moved(r_grads)
    return {
        "window_loss_gap": rel_gap(loss, r_losses[0]),
        "window_step_gap": leaf_gap(
            {k: after[k] - before[k] for k in keep},
            {k: r_after[k] - before[k] for k in keep}, keep),
    }


def reference(cfg: dict, s, r, x, labels, mask, params0: dict,
              precision: str = "float32", state=None):
    """The reference's first ``check_steps`` steps from ``params0``, or,
    given the program's optimizer ``state``, its one step from there."""
    n = cfg["graph"]["nodes"]
    state0 = None if state is None else {
        "t": int(state.step), "m": flat(state.m), "v": flat(state.v)}
    return ref.train(params0, cfg["num_layers"], x[:n], s, r, n, labels[:n],
                     mask[:n], cfg["optimizer"],
                     cfg["check_steps"] if state is None else 1, precision,
                     state0)


def first_steps(step, params, opt_state, batch, n_steps: int, b1: float):
    """The program's first steps through the window's own call: (params,
    state, losses, the first gradients from the first moment)."""
    losses, grads = [], None
    for _ in range(n_steps):
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
        if grads is None:
            grads = {k: v / (1.0 - b1) for k, v in flat(opt_state.m).items()}
    return params, opt_state, losses, grads


def window(step, p, o, batch, seconds: float):
    """The timed steps, back to back, each loss read back to the host, for
    at least ``seconds``: (steps, non-finite losses, the state before the
    last step, the state after it, the last step's loss).  The step is
    pure, so keeping the state before a step costs nothing."""
    failed = steps_done = 0
    t0 = time.perf_counter()
    while True:
        before = (p, o)
        p, o, m = step(p, o, batch)
        loss = float(m["loss"])
        failed += not math.isfinite(loss)
        steps_done += 1
        if time.perf_counter() - t0 >= seconds:
            return steps_done, failed, before, (p, o), loss


def run(cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda") -> Run:
    cfg, dev = cell.config, torch.device(device)
    notes, t = {}, time.perf_counter()
    s, r = graph(cfg, dev)
    sync(dev)
    n = cfg["graph"]["nodes"]
    notes["graph"] = {"nodes": n, "edges_directed": cfg["graph"]["edges"],
                      "edges_symmetric": int(s.size),
                      "in_degree": graphs.degree_percentiles(
                          np.bincount(r, minlength=n))}
    notes["setup_graph_s"] = time.perf_counter() - t
    t = time.perf_counter()
    x, labels, mask, params = inputs(cfg, seed, dev)
    params0 = {k: v.clone() for k, v in flat(params).items()}
    sync(dev)
    notes["setup_inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    g, step, init_state = program(cfg, s, r, dev)
    batch = {"x": x, "senders": g.senders, "receivers": g.receivers,
             "edge_weight": g.edge_weight, "edge_valid": g.edge_valid,
             "labels": labels, "label_mask": mask}
    notes["setup_program_s"] = time.perf_counter() - t
    t = time.perf_counter()
    p, o, losses, grads = first_steps(step, params, init_state(params), batch,
                                      cfg["check_steps"],
                                      cfg["optimizer"]["b1"])
    last = flat(p)
    sync(dev)
    notes["setup_first_steps_s"] = time.perf_counter() - t

    from repro_torch.kernels.gustavson_spmm import spmm_dedup_chunks
    launches0 = spmm_dedup_chunks.launches
    env.freeze_setup()
    setup_s = env.setup_seconds()
    with maybe_profiled(trace, dev) as prof, env.GcPauses() as pauses:
        t0 = time.perf_counter()
        steps_done, failed, before, (p, o), last_loss = window(
            step, p, o, batch, seconds)
        sync(dev)
        window_s = time.perf_counter() - t0
    notes["gc_pauses"] = pauses.summary()
    notes["b1_launches_per_step"] = ((spmm_dedup_chunks.launches - launches0)
                                     / steps_done)
    from repro_torch.sparse import stats
    notes["program_counters"] = stats.kernel_stats().counters()

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    before_p, before_o, after_p = flat(before[0]), before[1], flat(p)
    del p, o, before, step, batch, g
    from repro_torch.sparse.plan import plan_cache_clear
    plan_cache_clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    want = reference(cfg, s, r, x, labels, mask, params0)
    gaps = compare(cfg, (losses, grads, last), want, params0)
    want_last = reference(cfg, s, r, x, labels, mask, before_p,
                          state=before_o)
    gaps.update(compare_last(last_loss, before_p, after_p, want_last))
    notes["reference_s"] = time.perf_counter() - t
    notes["losses"] = {"program": losses + [last_loss],
                       "reference": want[0] + want_last[0]}
    lim = cell.limits["limits"]

    nnz = int(s.size) + n
    flops, calls = work.gcn_train_step(n, nnz, dims(cfg))
    return Run(
        attempted=steps_done, failed=failed,
        checks={k: check(v, lim[k]) for k, v in gaps.items()},
        host={"setup_s": setup_s, "window_s": window_s,
              "steps": steps_done},
        work={"steps": steps_done, "model_flops": flops * steps_done,
              "precision": cfg["precision"],
              "b1_calls": [(c, steps_done) for c in calls]},
        trace=None if prof is None else prof.result,
        memory_peak_bytes=int(peak), notes=notes)
