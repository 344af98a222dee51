"""Driver of open-loop serving of sampled GNNs (traffic ``serve_*`` with
``arrivals: poisson``).

Set-up draws the configuration's fixed graph on the device, hands its CSR
to the program's server on the host (``serve/engine.GNNServer``, device
sampler, the server's other defaults), and makes the features and weights
from ``--seed`` on the device; the server then builds and warms the
buckets this traffic can fill, and no other.

The window is an open loop.  The traffic file fixes the rate and the law
of the request sizes and arrivals; the schedule (each request's size and
due time, the gaps scaled to fill the window exactly) is drawn from the
file's ``shape_seed``, the same for every seed, as a recorded trace is
replayed, and ``--seed`` draws the seed nodes.  Each request is timed
from when it was due, so a generator that runs late charges its lateness
to the requests.  After the window closes
the run waits up to ``settle_wait_s`` for every request due in it; one
that never settles counts as failed and as infinitely late.

Then a sample of the served requests, drawn from ``--seed`` and holding
the largest, is answered again by the reference (``pbref.sage_serve``: the
frozen sampler, the plain forward, f32 with TF32 off) and the widest gap
over all their rows, relative to the largest reference logit, is compared.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import math
import sys
import time
from typing import List, Tuple

import numpy as np
import torch

from pbcore import env, graphs, work
from pbcore.gnn import dims, flat, sync
from pbcore.record import Run, check
from pbcore.trace import maybe_profiled
from pbref import sage_serve as ref



def graph(cfg: dict, dev: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """The configuration's fixed graph as a host CSR (rows are
    receivers)."""
    g = cfg["graph"]
    indptr, indices = graphs.powerlaw_csr_device(
        g["nodes"], g["edges"], g["alpha"], g["seed"], dev)
    return indptr.cpu().numpy(), indices.cpu().numpy()


def inputs(cfg: dict, seed: int, dev: torch.device):
    """(features with a zero ghost row, weights) drawn from ``seed`` on
    ``dev``."""
    n = cfg["graph"]["nodes"]
    gen = torch.Generator(device=dev).manual_seed(seed % (1 << 63))
    x = torch.randn((n + 1, cfg["in_channels"]), generator=gen, device=dev)
    x[n] = 0.0
    d = dims(cfg)
    params = {}
    for i, (din, dout) in enumerate(zip(d[:-1], d[1:])):
        w = torch.randn((2, din, dout), generator=gen, device=dev) / din ** 0.5
        params[f"layer{i}"] = {"w_self": w[0], "w_nbr": w[1],
                               "b": torch.zeros((dout,), device=dev)}
    return x, params


def sizes(traffic: dict, m: int, shape: np.random.Generator) -> np.ndarray:
    """Each of ``m`` requests' seed count by the traffic's law: ``fixed``
    (every request ``seeds_max`` seeds; ``seeds_min`` must equal it) or
    ``log_uniform`` over ``seeds_min … seeds_max``."""
    lo, hi, law = traffic["seeds_min"], traffic["seeds_max"], \
        traffic["seeds_law"]
    if law == "fixed" and lo == hi:
        return np.full(m, hi, np.int64)
    if law == "log_uniform":
        return np.floor(np.exp(shape.uniform(np.log(lo), np.log(hi + 1), m))
                        ).astype(np.int64).clip(lo, hi)
    raise ValueError(f"seeds_law {law!r} over {lo}..{hi}")


def schedule(traffic: dict, seconds: float, seed: int, n_nodes: int):
    """(due times from the window's start, each request's seed nodes)."""
    m = max(int(round(traffic["rate_per_s"] * seconds)), 1)
    shape = np.random.default_rng(traffic["shape_seed"])
    counts = sizes(traffic, m, shape)
    gaps = shape.exponential(1.0, m)
    gaps *= seconds / gaps.sum()
    rng = np.random.default_rng(seed % (1 << 63))
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    nodes = rng.integers(0, n_nodes, int(counts.sum()))
    return due, np.split(nodes, np.cumsum(counts)[:-1])


def program(cfg: dict, indptr, indices, x, params, tracing: bool,
            capacity: int, dev: torch.device):
    from repro_torch.models.gnn.sage import SAGEConfig
    from repro_torch.serve.compute import FeatureStore
    from repro_torch.serve.engine import GNNServer
    model = SAGEConfig(name=cfg["name"], n_layers=cfg["num_layers"],
                       d_in=cfg["in_channels"],
                       d_hidden=cfg["hidden_channels"],
                       n_classes=cfg["out_channels"],
                       param_dtype=cfg["dtype"])
    store = FeatureStore(n_nodes=cfg["graph"]["nodes"], x=x)
    return GNNServer(cfg["arch"], model, params, indptr, indices, store,
                     fanouts=tuple(cfg["fanouts"]), backend=cfg["backend"],
                     sampler=cfg["sampler"],
                     max_batch_seeds=cfg["batch_size"], tracing=tracing,
                     trace_capacity=capacity, device=dev)


def ladder(cfg: dict, traffic: dict) -> List[int]:
    """The buckets this traffic can fill: from the smallest request's
    bucket up to the cap."""
    from repro_torch.serve.buckets import all_buckets, bucket_for
    cap = cfg["batch_size"]
    low = bucket_for(traffic["seeds_min"], cap)
    return [b for b in all_buckets(cap) if b >= low]


class Offered:
    """The window's requests as the harness books them: each request's due
    time, submit time, settle time (infinite until it settles with an
    answer) and whether it failed.  A settled request is dropped at once
    unless it is to be checked, so the collector's walks in the window do
    not grow with the requests served."""

    def __init__(self, t0: float, due: np.ndarray, check: set):
        m = due.shape[0]
        self.t0 = t0
        self.due_at = t0 + due
        self.t_submit = np.full(m, np.nan)
        self.t_done = np.full(m, math.inf)
        self.failed = np.zeros(m, bool)
        self.settled = np.zeros(m, bool)
        self.check = check
        self.kept = {}
        self.pending = collections.deque()

    def _book(self, i: int, r) -> None:
        self.settled[i] = r.done
        self.failed[i] = r.error is not None
        if r.result is not None:
            self.t_done[i] = r.t_done
            if i in self.check:
                self.kept[i] = r

    def reap(self) -> None:
        """Book the settled requests at the head of the queue."""
        while self.pending and self.pending[0][1].done:
            self._book(*self.pending.popleft())

    def settle(self, deadline: float, clock) -> None:
        """Wait for every request still out, up to ``deadline``."""
        while self.pending:
            i, r = self.pending.popleft()
            left = deadline - clock()
            if left > 0:
                r.wait_done(left)
            self._book(i, r)

    @property
    def latencies(self) -> np.ndarray:
        return self.t_done - self.due_at


# The generator stands for clients in other processes, but shares the
# server's interpreter lock: at Python's default 5 ms switch interval a due
# request can wait that long for the engine thread to let go.  A short
# interval keeps that wait, an artifact of the harness, out of the tail.
SWITCH_INTERVAL_S = 2e-4


@contextlib.contextmanager
def prompt_generator():
    """The short switch interval for the block, the old one after it."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(SWITCH_INTERVAL_S)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def offer(server, due: np.ndarray, seeds: list, seconds: float,
          check: set) -> Offered:
    """Submit each request at its due time; the window closes ``seconds``
    after its start."""
    clock = server.clock
    t0 = clock()
    off = Offered(t0, due, check)
    for i, (when, s) in enumerate(zip(due, seeds)):
        off.reap()
        wait = t0 + when - clock()
        if wait > 0:
            time.sleep(wait)
        r = server.submit(s)
        off.t_submit[i] = r.t_submit
        off.pending.append((i, r))
    while clock() < t0 + seconds:
        off.reap()
        time.sleep(min(1e-3, max(t0 + seconds - clock(), 0.0)))
    return off


def p95(lat: np.ndarray) -> float:
    """Nearest-rank 95th percentile: a missing request counts as
    infinitely late."""
    s = np.sort(lat)
    return float(s[max(int(math.ceil(0.95 * s.size)) - 1, 0)])


def pick_checked(seeds: list, n: int, seed: int) -> set:
    """Up to ``n`` request indices drawn from ``seed``, the largest request
    among them."""
    rng = np.random.default_rng((seed % (1 << 63)) ^ 0x5EED)
    big = max(range(len(seeds)), key=lambda i: len(seeds[i]))
    return {big} | set(rng.permutation(len(seeds))[:max(n - 1, 0)].tolist())


def serve_gap(got: List[np.ndarray], want: List[torch.Tensor]) -> float:
    """The widest gap of an answer over the largest reference logit."""
    scale = max(float(w.abs().max()) for w in want)
    gap = max(float((torch.from_numpy(g).to(w.device) - w).abs().max())
              for g, w in zip(got, want))
    return gap / max(scale, 1e-30)


def allocator(dev: torch.device) -> dict:
    """The caching allocator's counts of device allocations, frees and
    retries (each retry frees cached blocks and synchronizes)."""
    if dev.type != "cuda":
        return {}
    st = torch.cuda.memory_stats(dev)
    return {k: st.get(k, 0) for k in ("num_device_alloc", "num_device_free",
                                       "num_alloc_retries")}


def run(cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda") -> Run:
    cfg, traffic, dev = cell.config, cell.traffic, torch.device(device)
    n = cfg["graph"]["nodes"]
    notes, t = {}, time.perf_counter()
    indptr, indices = graph(cfg, dev)
    notes["graph"] = {"nodes": n, "edges": int(indices.size),
                      "in_degree": graphs.degree_percentiles(
                          np.diff(indptr))}
    notes["setup_graph_s"] = time.perf_counter() - t
    t = time.perf_counter()
    x, params = inputs(cfg, seed, dev)
    due, seeds = schedule(traffic, seconds, seed, n)
    sync(dev)
    notes["setup_inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    server = program(cfg, indptr, indices, x, params, trace,
                     len(due) + 1024, dev)
    notes["setup_server_s"] = time.perf_counter() - t
    t = time.perf_counter()
    buckets = ladder(cfg, traffic)
    server.warmup(buckets=buckets)
    sync(dev)
    notes["setup_warmup_s"] = time.perf_counter() - t
    notes["buckets"] = buckets

    from repro_torch.kernels.forest_sampler import forest_sample
    from repro_torch.kernels.gustavson_spmm import spmm_dedup_chunks
    launches0 = (spmm_dedup_chunks.launches, forest_sample.launches)
    server.reset_stats()
    env.freeze_setup()
    alloc0 = allocator(dev)
    setup_s = env.setup_seconds()
    to_check = pick_checked(seeds, traffic["check_requests"], seed)
    with maybe_profiled(trace, dev) as prof, env.GcPauses() as pauses, \
            prompt_generator():
        off = offer(server, due, seeds, seconds, to_check)
        off.settle(off.t0 + seconds + traffic["settle_wait_s"], server.clock)
        sync(dev)
        window_s = server.clock() - off.t0
    notes["gc_pauses"] = pauses.summary()
    notes["allocator"] = {k: v - alloc0.get(k, 0)
                          for k, v in allocator(dev).items()}
    stats = server.stats()
    late = off.t_submit - off.due_at
    lat = off.latencies
    n_steps = stats["n_batches"]
    notes["generator_late_ms"] = {"p50": float(np.median(late) * 1e3),
                                  "p99": float(np.percentile(late, 99) * 1e3),
                                  "max": float(late.max() * 1e3)}
    notes["latency_ms"] = {"p50": float(np.median(lat) * 1e3),
                           "p99": float(np.percentile(lat, 99) * 1e3)}
    notes["buckets_dispatched"] = stats["bucket_counts"]
    notes["step_builds_after_warmup"] = stats["recompiles"] - len(buckets)
    notes["launches_per_step"] = {
        "b1": (spmm_dedup_chunks.launches - launches0[0]) / max(n_steps, 1),
        "forest_sample": ((forest_sample.launches - launches0[1])
                          / max(n_steps, 1))}
    spans = {}
    if server.tracer is not None:
        spans["queue_wait_s"] = [
            s["t1"] - s["t0"] for tr in server.tracer.traces()
            for s in tr["spans"] if s["name"] == "queue_wait"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    checked = [off.kept[i] for i in sorted(off.kept)]
    got = [r.result for r in checked]
    asked = [(r.rid, r.seeds) for r in checked]
    unsettled = int((~off.settled).sum())
    errors = int(off.failed.sum())
    server.close()
    del server, off, checked
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    want = ref.answers(indptr, indices, x, flat(params),
                       tuple(cfg["fanouts"]), cfg["sampler_key"], asked)
    notes["reference_s"] = time.perf_counter() - t
    notes["checked_requests"] = len(asked)
    notes["checked_seeds"] = int(sum(len(s) for _, s in asked))
    lim = cell.limits["limits"]
    gap = serve_gap(got, want) if got else math.inf

    served_seeds = int(sum(len(s) for s in seeds))
    flops, calls = work.sampled_tree_work(cfg["fanouts"], dims(cfg))
    return Run(
        attempted=len(due), failed=unsettled + errors,
        checks={"serve_gap": check(gap, lim["serve_gap"]),
                "unsettled": check(unsettled, lim["unsettled"]),
                "errors": check(errors, lim["errors"])},
        host={"setup_s": setup_s, "window_s": window_s,
              "latencies_s": lat, "p95_s": p95(lat)},
        work={"steps": n_steps, "seeds_served": served_seeds,
              "bucket_seeds": int(sum(b * c for b, c in
                                      stats["bucket_counts"].items())),
              "model_flops": flops * served_seeds,
              "precision": cfg["precision"],
              "b1_calls": [(c, served_seeds) for c in calls]},
        spans=spans, trace=None if prof is None else prof.result,
        memory_peak_bytes=int(peak), notes=notes)
