"""The GNN inference server: request + data + compute planes wired up.

Port of the single-lane part of ``repro.serve.engine``.  ``GNNServer`` owns
a resident graph (host CSR for the sampler, device ``FeatureStore`` for the
model) and serves seed-node requests:

1. ``submit(seeds)`` hands the request to sampler **worker threads** (numpy)
   — one fanout tree per seed, counter-based draws keyed on the request id
   so offline replay sees identical subgraphs.  Under ``sampler="device"``
   there are no workers: the request carries its seeds and one int64
   counter term per tree, joins the batcher at once, and the sampling runs
   inside the dispatched bucket step on the device (one ``forest_sample``
   launch);
2. sampled requests join the ``DynamicBatcher`` (deadline/size triggers);
3. the engine thread — the only thread that touches CUDA tensors, on the
   current stream — stacks a batch's trees into its power-of-two bucket,
   fetches the bucket's step from the ``StepCache`` and dispatches it.
   CUDA's asynchronous launches plus an in-flight queue of depth 2
   double-buffer host sampling and batch assembly against device compute;
4. results come back per request (``.cpu()`` is the device sync) and the
   request's latency clock stops.

The operations plane is opt-in, each part ``None`` when off so the hot
loops pay one ``is None`` test per stage: ``tracing=`` records a span tree
per request (``serve.tracing``: ``sample``, ``queue_wait``,
``bucket_pack``, ``dispatch``, then ``settle`` or ``error``; ``dispatch``
covers the asynchronous launches alone, and the device window is the gap
from its end to ``settle``, taken after the ``.cpu()`` sync);
``metrics=``/``metrics_port=`` keep a ``MetricsRegistry`` and serve it over
HTTP (``launch.metrics_server``); ``chaos=`` injects sampler faults and
transient step faults, which the retry path re-queues up to
``max_retries`` times before failing the request with
``RetriesExhausted``.

``offline_inference`` is the correctness anchor: the same trees, one
request at a time through the bucket-1 step — serving output must match it
to ≤1e-5.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serve.batcher import DynamicBatcher, ServeRequest
from repro_torch.serve.buckets import (all_buckets, bucket_for,
                                       build_bucket_structure, stack_trees)
from repro_torch.serve.compute import (FeatureStore, StepCache, _arch_key,
                                       build_infer_step)
from repro_torch.serve.errors import (DeadlineExceeded, DrainTimeout,
                                      RetriesExhausted, SamplerError,
                                      ServeError, ServerClosed,
                                      TransientStepError)
from repro_torch.serve.telemetry import percentiles_ms
from repro_torch.serve.tracing import Tracer
from repro_torch.sparse import sampler
from repro_torch.sparse.plan import plan_cache_info

# span attrs are read-only once emitted: hot-path spans share one dict
_DEVICE_SAMPLE_ATTRS = {"mode": "device"}


def _needs_loops(arch_id: str) -> bool:
    """gcn's A + I normalization needs self loops; sage, gin, gat and the
    geometric family aggregate over the sampled edges alone."""
    return _arch_key(arch_id) == "gcn"


def default_tree_keys(rid: int, n: int) -> np.ndarray:
    """One counter-hash stream per (request, seed index): deterministic and
    independent of how requests group into sampling calls, so offline
    replay re-derives the served trees from ``rid`` alone."""
    return (np.uint64(rid) << np.uint64(16)) + np.arange(n, dtype=np.uint64)


class SamplerPool:
    """Data-plane worker pool shared by the single-lane server and the
    cluster tier: samples each submitted request's fanout trees on daemon
    threads, draining whatever else is queued into one vectorized forest
    pass (counter-based draws make grouped sampling identical to
    per-request sampling), then hands the request to ``on_ready``.  A
    failing request is isolated and reported through ``on_error``.
    ``fault_hook`` (chaos) is called with each request before sampling; a
    raise is handled like a real sampling failure."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 fanouts: Sequence[int], key: int, *,
                 on_ready, on_error, n_workers: int = 2,
                 group_cap: int = 64, fault_hook=None):
        # the resident CSR lives in ONE tuple so a graph swap is a single
        # reference flip: a worker snapshots it once per group and never
        # sees a torn (new indptr, old indices) pair
        self._graph = (np.asarray(indptr), np.asarray(indices), 0)
        self.fanouts = tuple(int(f) for f in fanouts)
        self.key = key
        self.on_ready = on_ready
        self.on_error = on_error
        self.fault_hook = fault_hook
        self.group_cap = int(group_cap)
        self._q: "queue.Queue" = queue.Queue()
        self._workers = [threading.Thread(target=self._worker, daemon=True,
                                          name=f"gnn-serve-sampler-{i}")
                         for i in range(max(int(n_workers), 1))]
        for w in self._workers:
            w.start()

    @property
    def indptr(self) -> np.ndarray:
        return self._graph[0]

    @indptr.setter
    def indptr(self, value):
        self._graph = (value,) + self._graph[1:]

    @property
    def indices(self) -> np.ndarray:
        return self._graph[1]

    @indices.setter
    def indices(self, value):
        self._graph = (self._graph[0], value, self._graph[2])

    @property
    def graph_epoch(self) -> int:
        return self._graph[2]

    def set_graph(self, indptr: np.ndarray, indices: np.ndarray,
                  epoch: Optional[int] = None) -> int:
        """Swap the resident CSR in one reference flip.  Groups already
        snapshotted keep sampling the old arrays; every later group sees
        the new graph whole.  Returns the new graph epoch."""
        epoch = self._graph[2] + 1 if epoch is None else int(epoch)
        self._graph = (np.asarray(indptr), np.asarray(indices), epoch)
        return epoch

    def submit(self, req: ServeRequest):
        self._q.put(req)

    def submit_block(self, reqs: Sequence[ServeRequest]):
        """Enqueue a pre-formed block as ONE queue item: a worker folds the
        whole block into one vectorized forest pass (the bulk-ingest path,
        where per-item queue overhead would dominate a burst)."""
        if reqs:
            self._q.put(list(reqs))

    def sample_for(self, seeds, rid: int) -> list:
        """The pool's sampling, re-runnable offline (parity anchor)."""
        seeds = np.atleast_1d(np.asarray(seeds, np.int64))
        indptr, indices, _ = self._graph
        return sampler.sample_forest(indptr, indices, seeds, self.fanouts,
                                     key=self.key,
                                     tree_keys=default_tree_keys(
                                         rid, seeds.shape[0]))

    def _sample_group(self, group):
        if self.fault_hook is not None:
            for r in group:
                self.fault_hook(r)
        # one snapshot per group: every request in it samples one epoch
        indptr, indices, epoch = self._graph
        seeds_all = np.concatenate([r.seeds for r in group])
        keys = np.concatenate([default_tree_keys(r.rid, r.n_seeds)
                               for r in group])
        trees = sampler.sample_forest(indptr, indices, seeds_all,
                                      self.fanouts, key=self.key,
                                      tree_keys=keys)
        i = 0
        for req in group:                     # assign everything first so a
            req.trees = trees[i:i + req.n_seeds]  # failure submits nothing
            req.graph_epoch = epoch
            i += req.n_seeds
        for req in group:
            self.on_ready(req)

    def _sample_isolated(self, group):
        """Per-request fallback: innocent groupmates still serve."""
        for r in group:
            try:
                self._sample_group([r])
            except Exception as exc:  # noqa: BLE001 — reported per request
                self.on_error([r], exc)

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            group = list(item) if isinstance(item, list) else [item]
            while len(group) < self.group_cap:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:           # shutdown sentinel: hand it back
                    self._q.put(None)
                    break
                if isinstance(nxt, list):
                    group.extend(nxt)
                else:
                    group.append(nxt)
            try:
                self._sample_group(group)
            except Exception:  # noqa: BLE001 — isolate the bad request(s);
                # the worker (and every later request routed to it) survives
                self._sample_isolated(group)

    def close(self, timeout: Optional[float] = None):
        """Join the workers, then sample anything still queued inline on
        the calling thread — everything submitted before ``close`` still
        reaches ``on_ready``."""
        for _ in self._workers:
            self._q.put(None)
        for w in self._workers:
            w.join(timeout)
        leftovers = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if isinstance(item, list):
                leftovers.extend(item)
            elif item is not None:
                leftovers.append(item)
        if leftovers:
            self._sample_isolated(leftovers)


class GNNServer:
    """Dynamic-batching inference server over a resident graph.

    ``device=None`` serves on ``cuda`` (and raises without a GPU); the
    feature store must live on the same device and hold what the arch
    reads: ``x`` for the conv family, ``species`` and ``pos`` for schnet
    and dimenet.  ``chaos``, ``tracing`` and ``metrics``/``metrics_port``
    are off by default (the module docstring says what each adds).
    """

    def __init__(self, arch_id: str, cfg, params, indptr: np.ndarray,
                 indices: np.ndarray, store: FeatureStore, *,
                 fanouts: Sequence[int] = (5, 3), backend: str = "dense",
                 sampler: str = "host",
                 max_batch_seeds: int = 16, max_wait_ms: float = 5.0,
                 n_workers: int = 2, seed: int = 0,
                 step_cache_size: int = 16, inflight: int = 2,
                 chaos=None, max_retries: int = 1,
                 tracing: bool = False, trace_capacity: int = 4096,
                 metrics: bool = False, metrics_port: Optional[int] = None,
                 clock=time.monotonic, device: DeviceLike = None):
        self.device = resolve_device(device)
        if store.device != self.device:
            raise ValueError(f"feature store is on {store.device}, server "
                             f"on {self.device}")
        _arch_key(arch_id)
        self.arch_id = arch_id
        self.cfg = cfg
        self.params = params
        self.indptr = np.asarray(indptr)
        self.indices = np.asarray(indices)
        self.store = store
        self.fanouts = tuple(int(f) for f in fanouts)
        self.backend = backend
        self.max_batch_seeds = int(max_batch_seeds)
        self.seed = seed
        self.clock = clock
        self.inflight_depth = max(int(inflight), 1)
        self.chaos = chaos                # fault injector; None = no chaos
        self.max_retries = max(int(max_retries), 0)
        self._round_no = 0                # dispatch counter (chaos trigger)
        self.tracer = (Tracer(capacity=trace_capacity, clock=clock)
                       if tracing else None)

        self.batcher = DynamicBatcher(self.max_batch_seeds,
                                      max_wait_ms / 1e3, clock=clock)
        self.steps = StepCache(self._build_step, maxsize=step_cache_size)
        self._structs: Dict[int, object] = {}
        self._host_step1 = None

        self._rid_lock = threading.Lock()
        self._next_rid = 0
        self.requests: Dict[int, ServeRequest] = {}

        # latencies keep a sliding window so a long-lived server does not
        # grow without bound; percentiles are over recent traffic
        self._stats_lock = threading.Lock()
        self.bucket_counts: Dict[int, int] = collections.Counter()
        self.bucket_hits = 0            # batches landing in a warm bucket
        self.n_served = 0
        self.n_deadline_failed = 0
        self.latencies: "collections.deque[float]" = collections.deque(
            maxlen=4096)

        # metrics plane: a registry read by scrapes (host state only)
        self.metrics = None
        self._metrics_server = None
        self._m_latency = self._m_requests = None
        if metrics or metrics_port is not None:
            from repro_torch.serve.metrics import MetricsRegistry
            self.metrics = MetricsRegistry()
            self._m_latency = self.metrics.histogram(
                "request_latency_seconds", "end-to-end request latency")
            self._m_requests = self.metrics.counter(
                "requests_total", "settled requests by outcome")
            self._m_queue = self.metrics.gauge(
                "queue", "dynamic-batcher queue state")
            self._m_cache = self.metrics.gauge(
                "cache_hit_rate", "host plan/step cache hit rates")
            self.metrics.connect_kernel_stats()
            self.metrics.register_pull(self._pull_metrics)
            if metrics_port is not None:
                from repro_torch.launch.metrics_server import MetricsServer
                self._metrics_server = MetricsServer(self.metrics.render,
                                                     port=metrics_port)

        # data plane: host sampler worker pool, or the device plane — where
        # sampling runs INSIDE the per-bucket step
        if sampler not in ("host", "device"):
            raise ValueError(f"sampler must be 'host' or 'device', "
                             f"got {sampler!r}")
        self.sampler_mode = sampler
        if sampler == "device":
            from repro_torch.serve.device_sampler import DeviceSamplerPlane
            self._sampler = None
            self._plane = DeviceSamplerPlane(self.indptr, self.indices,
                                             self.fanouts, key=seed,
                                             device=self.device)
        else:
            self._plane = None
            self._sampler = SamplerPool(
                self.indptr, self.indices, self.fanouts, seed,
                # tracing picks the hand-off at construction: the untraced
                # one carries no branch
                on_ready=(self.batcher.submit if self.tracer is None
                          else self._on_sampled_traced),
                on_error=self._fail_requests, n_workers=n_workers,
                fault_hook=(chaos.sampler_hook if chaos is not None
                            else None))
        # compute plane: engine loop + in-flight double buffer
        self._closing = False
        self._close_lock = threading.Lock()
        self._stop = threading.Event()
        self._inflight: "collections.deque" = collections.deque()
        self._engine = threading.Thread(target=self._engine_loop, daemon=True,
                                        name="gnn-serve-engine")
        self._engine.start()

    # -- request plane ------------------------------------------------------
    def submit(self, seeds, *,
               deadline_ms: Optional[float] = None) -> ServeRequest:
        if self._closing:
            raise RuntimeError("server is closed; no worker will serve this")
        seeds = np.atleast_1d(np.asarray(seeds, np.int64))
        # reject malformed requests synchronously — an exception past this
        # point would land in a worker thread instead of the caller
        n_graph = self.indptr.shape[0] - 1
        if seeds.size == 0 or seeds.size > self.max_batch_seeds:
            raise ValueError(
                f"request carries {seeds.size} seeds; must be in "
                f"[1, {self.max_batch_seeds}] (the bucket cap)")
        if (seeds < 0).any() or (seeds >= n_graph).any():
            raise ValueError(
                f"seed ids {seeds[(seeds < 0) | (seeds >= n_graph)]} out of "
                f"range for the resident graph ({n_graph} nodes)")
        with self._rid_lock:
            rid = self._next_rid
            self._next_rid += 1
            now = self.clock()
            req = ServeRequest(
                rid=rid, seeds=seeds, t_submit=now,
                deadline=(now + deadline_ms / 1e3
                          if deadline_ms is not None else None))
            self.requests[rid] = req
        if self._plane is not None:
            from repro_torch.serve.device_sampler import tree_key_mix
            req.tkm = tree_key_mix(default_tree_keys(rid, seeds.shape[0]))
            if self.tracer is not None:
                # the host's whole data-plane stage is the key mix above;
                # the span keeps the tree's shape the same in both modes
                self.tracer.span(rid, "sample", now, self.clock(),
                                 _DEVICE_SAMPLE_ATTRS)
            self.batcher.submit(req)
        else:
            self._sampler.submit(req)
        return req

    def _on_sampled_traced(self, req: ServeRequest):
        """The traced sampler hand-off: the ``sample`` span covers the whole
        data-plane stage (the pool's queue and the forest pass)."""
        self.tracer.span(req.rid, "sample", req.t_submit, self.clock())
        self.batcher.submit(req)

    # -- data plane ---------------------------------------------------------
    def _fail_requests(self, reqs, exc: BaseException):
        """Fail exactly ``reqs`` with a typed error carrying each request
        id; the sampler worker and the engine loop survive."""
        now = self.clock()
        with self._rid_lock:
            for req in reqs:
                self.requests.pop(req.rid, None)
        for req in reqs:
            err = exc if isinstance(exc, ServeError) \
                else SamplerError(req.rid, exc)
            if req.fail(err, now):
                self._trace_error(req, err, now)

    def _trace_error(self, req: ServeRequest, err: BaseException,
                     now: float) -> None:
        """The terminal ``error`` span of a request that just failed."""
        if self.tracer is not None:
            self.tracer.settle(req.rid, "error", now, now,
                               {"error": type(err).__name__})

    def sample_for(self, seeds, rid: int) -> list:
        """The data plane's sampling, re-runnable offline (parity anchor).
        Always the HOST sampler, even in device mode: the device draws are
        bit-exact, so host replay is the independent oracle."""
        seeds = np.atleast_1d(np.asarray(seeds, np.int64))
        return sampler.sample_forest(self.indptr, self.indices, seeds,
                                     self.fanouts, key=self.seed,
                                     tree_keys=default_tree_keys(
                                         rid, seeds.shape[0]))

    # -- compute plane ------------------------------------------------------
    def _build_step(self, key: tuple):
        (bucket,) = key
        body = build_infer_step(self.arch_id, self.cfg, self.store,
                                self._struct(bucket), backend=self.backend)
        if self._plane is None:
            return body
        # fused dispatch: sampling + feature gather + GNN forward in one
        # device step per bucket; the step's input shrinks from the stacked
        # node tables to the packed (3, bucket) seeds, counter terms, live
        plane = self._plane

        def fused(params, trees):
            node_ids, hop_valid = plane.sample_trees(trees)
            return body(params, node_ids, hop_valid)

        return fused

    def _struct(self, bucket: int):
        if bucket not in self._structs:
            self._structs[bucket] = build_bucket_structure(
                bucket, self.fanouts, with_loops=_needs_loops(self.arch_id))
        return self._structs[bucket]

    def _device_batch(self, batch: List[ServeRequest],
                      bucket: int) -> np.ndarray:
        """Pack a batch's seeds + counter terms into the bucket's lanes as
        one (3, bucket) ``pack_trees`` array, written in place: one
        asynchronous host-to-device copy a step (padding lanes: live=0 ⇒
        the device sampler blanks them)."""
        trees = np.zeros((3, bucket), np.int64)
        i = 0
        for r in batch:
            k = r.n_seeds
            trees[0, i:i + k] = r.seeds
            trees[1, i:i + k] = r.tkm
            trees[2, i:i + k] = 1
            i += k
        return trees

    def _dispatch(self, batch: List[ServeRequest]):
        self._round_no += 1
        if self.chaos is not None and self.chaos.step_fault(self._round_no):
            # a faulted round launches nothing
            self._retry_batch(batch, TransientStepError(self._round_no))
            return
        tr = self.tracer
        t_pack0 = self.clock() if tr is not None else 0.0
        n_trees = sum(r.n_seeds for r in batch)
        bucket = bucket_for(n_trees, self.max_batch_seeds)
        warm = self.steps.builds
        step = self.steps.get((bucket,))
        if self._plane is None:
            trees = [t for r in batch for t in r.trees]
            node_ids, hop_valid = stack_trees(trees, bucket, self.fanouts)
            t_pack1 = self.clock() if tr is not None else 0.0
            out = step(self.params, node_ids, hop_valid)   # async launch
        else:
            packed = self._device_batch(batch, bucket)
            t_pack1 = self.clock() if tr is not None else 0.0
            out = step(self.params, packed)
        if tr is not None:
            # queue_wait ends where packing starts; dispatch is the
            # asynchronous step call alone — the device window shows as
            # the gap from its end to the settle span
            t_disp = self.clock()
            attrs = {"bucket": bucket, "round": self._round_no}
            for r in batch:
                tr.extend(r.rid, (("queue_wait", r.t_ready, t_pack0, None),
                                  ("bucket_pack", t_pack0, t_pack1, attrs),
                                  ("dispatch", t_pack1, t_disp, attrs)))
        with self._stats_lock:
            self.bucket_counts[bucket] += 1
            self.bucket_hits += int(self.steps.builds == warm)
        self._inflight.append((batch, out))
        while len(self._inflight) > self.inflight_depth:
            self._finalize_one()

    def _finalize_one(self):
        batch, out = self._inflight.popleft()
        out = out.cpu().numpy()                        # device sync
        now = self.clock()
        tr = self.tracer
        settles = [] if tr is not None else None
        row = 0
        for req in batch:
            k = req.n_seeds
            if req.finish(out[row:row + k].copy(), now) and tr is not None:
                settles.append((req.rid, "settle", now, now, None))
            row += k
        if settles:
            tr.settle_many(settles)
        with self._rid_lock:
            # results live on the request objects; the server-side index
            # must not grow without bound under sustained traffic
            for req in batch:
                self.requests.pop(req.rid, None)
        with self._stats_lock:
            self.n_served += len(batch)
            self.latencies.extend(r.latency for r in batch)
        if self._m_latency is not None:
            for r in batch:      # exemplar = the request's trace id
                self._m_latency.observe(r.latency, exemplar=str(r.rid))
            self._m_requests.inc(len(batch), outcome="served")

    def _pull_metrics(self):
        """Render-time gauge refresh from host bookkeeping (queue and
        cache state); a scrape reads no device tensor."""
        info = self.batcher.info()
        self._m_queue.set(float(info["depth"]), field="depth")
        self._m_queue.set(float(info["depth_seeds"]), field="depth_seeds")
        sc = self.steps.info()
        tries = sc["hits"] + sc["builds"]
        self._m_cache.set(sc["hits"] / tries if tries else 0.0, cache="step")
        with self._stats_lock:
            n_batches = int(sum(self.bucket_counts.values()))
            hits = self.bucket_hits
        self._m_cache.set(hits / n_batches if n_batches else 0.0,
                          cache="bucket")

    def _retry_batch(self, batch: List[ServeRequest], exc: ServeError):
        """Transient step failure: re-queue each request, or fail it with
        ``RetriesExhausted`` once its retry budget is spent.  A retried
        request keeps its rid, so it samples the same trees."""
        now = self.clock()
        tr = self.tracer
        for req in batch:
            req.attempts += 1
            if req.attempts > self.max_retries:
                with self._rid_lock:
                    self.requests.pop(req.rid, None)
                err = RetriesExhausted(req.rid, req.attempts, exc)
                if req.fail(err, now):
                    self._trace_error(req, err, now)
            else:
                if tr is not None:
                    tr.span(req.rid, "retry", now, now,
                            {"attempt": req.attempts})
                self.batcher.submit(req)

    def _reap_expired(self):
        expired = self.batcher.reap_expired(self.clock())
        if expired:
            now = self.clock()
            with self._rid_lock:
                for req in expired:
                    self.requests.pop(req.rid, None)
            for req in expired:
                err = DeadlineExceeded(req.rid, req.deadline, now)
                if req.fail(err, now):
                    self._trace_error(req, err, now)
            with self._stats_lock:
                self.n_deadline_failed += len(expired)

    def _engine_loop(self):
        while not self._stop.is_set():
            self._reap_expired()
            if self._inflight:
                # work is on the device: only grab a ripe batch, otherwise
                # retire the oldest in-flight batch (its sync overlaps the
                # sampler workers filling the queue)
                batch = self.batcher.poll()
                if batch is None:
                    self._finalize_one()
                    continue
            else:
                batch = self.batcher.take(timeout=0.02)
            if batch:
                self._dispatch(batch)
        for batch in self.batcher.flush():
            self._dispatch(batch)
        while self._inflight:
            self._finalize_one()

    # -- lifecycle / utilities ---------------------------------------------
    def warmup(self, buckets: Optional[Sequence[int]] = None):
        """Build the bucket ladder ahead of traffic and run one dummy batch
        through each step (plans pack and kernels build on first call)."""
        buckets = (all_buckets(self.max_batch_seeds) if buckets is None
                   else buckets)
        for b in buckets:
            step = self.steps.get((b,))
            if self._plane is not None:
                step(self.params, np.zeros((3, b), np.int64)).cpu()
                continue
            struct = self._struct(b)
            step(self.params, np.full(struct.n_nodes, -1, np.int64),
                 np.zeros(struct.n_hop_edges, bool)).cpu()

    def drain(self, timeout: float = 60.0):
        """Block until every submitted request has settled (result or typed
        error).  On timeout the stragglers are failed with ``DrainTimeout``
        and the same error is raised."""
        deadline = time.monotonic() + timeout
        with self._rid_lock:
            pending = list(self.requests.values())
        for req in pending:
            left = deadline - time.monotonic()
            if left <= 0 or not req.wait_done(left):
                break
        stragglers = [r for r in pending if not r.done]
        if stragglers:
            err = DrainTimeout(len(stragglers), timeout,
                               [r.rid for r in stragglers])
            now = self.clock()
            with self._rid_lock:
                for r in stragglers:
                    self.requests.pop(r.rid, None)
            for r in stragglers:
                if r.fail(err, now):
                    self._trace_error(r, err, now)
            raise err

    def reset_stats(self):
        with self._stats_lock:
            self.bucket_counts.clear()
            self.bucket_hits = 0
            self.n_served = 0
            self.n_deadline_failed = 0
            self.latencies.clear()

    def stats(self) -> dict:
        with self._stats_lock:
            out = {
                "n_served": self.n_served,
                "deadline_failed": self.n_deadline_failed,
                "n_batches": int(sum(self.bucket_counts.values())),
                "bucket_counts": dict(self.bucket_counts),
                "bucket_hits": self.bucket_hits,
                "recompiles": self.steps.builds,
                "step_cache": self.steps.info(),
                "plan_cache": plan_cache_info(),
                "batcher": self.batcher.info(),
                **percentiles_ms(self.latencies),
            }
        if self.tracer is not None:
            out["tracing"] = self.tracer.stats()
        if self._metrics_server is not None:
            out["metrics_url"] = self._metrics_server.url
        return out

    def close(self, timeout: float = 30.0):
        """Graceful shutdown: everything submitted before ``close`` is still
        served.  Samplers stop FIRST, so no request can reach the batcher
        after the engine thread's final flush.  Idempotent; if the engine
        thread does not exit within ``timeout``, every still-pending
        request is failed with ``ServerClosed``."""
        with self._close_lock:
            if self._closing:
                return
            self._closing = True
        if self._sampler is not None:
            self._sampler.close(timeout)
        self._stop.set()
        self._engine.join(timeout)
        if self._engine.is_alive():
            now = self.clock()
            with self._rid_lock:
                pending = list(self.requests.values())
                self.requests.clear()
            for req in pending:
                err = ServerClosed(req.rid)
                if req.fail(err, now):
                    self._trace_error(req, err, now)
        if self._metrics_server is not None:
            self._metrics_server.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def offline_inference(server: GNNServer, trees: list) -> np.ndarray:
    """One-request-at-a-time reference: each tree through a bucket-1
    host-input step; returns the stacked (n_trees, d_out) outputs.  Under
    device sampling the cached steps take (seeds, keys) instead of node
    tables, so the reference builds its own host-input bucket-1 step — an
    independent program from the fused one it anchors."""
    if server._plane is None:
        step = server.steps.get((1,))
    else:
        if server._host_step1 is None:
            server._host_step1 = build_infer_step(
                server.arch_id, server.cfg, server.store, server._struct(1),
                backend=server.backend)
        step = server._host_step1
    out = []
    for tree in trees:
        node_ids, hop_valid = stack_trees([tree], 1, server.fanouts)
        out.append(step(server.params, node_ids, hop_valid).cpu().numpy())
    return np.concatenate(out, axis=0)


def offline_replay(server: GNNServer, req: ServeRequest) -> np.ndarray:
    """The full unbatched pipeline for one request: re-sample its trees
    through the host sampler's deterministic streams, then infer one tree
    at a time.  Must equal ``req.result`` to ≤1e-5."""
    return offline_inference(server, server.sample_for(req.seeds, req.rid))
