"""Scale-out GNN serving: DRHM-routed replica lanes under a supervised
control plane (port of ``repro.serve.cluster``).

The paper's third mechanism — load balancing via **dynamic reseeding
hash-based mapping** — applied one level up: the *requests* are the TAGs,
the *serving lanes* are the bins.

``ClusterServer`` runs ``n_lanes`` replica lanes over one resident graph,
in one process:

* **routing** — a ``DRHMRouter`` maps each request's seed TAG through a
  splitmix-conditioned bin, then through the γ-seeded DRHM bijective
  bin→lane permutation (``core.drhm.plan_request_routing``).  Every
  *active* lane owns exactly ``n_bins/n_active`` bins.  When per-lane
  queue-depth skew exceeds a threshold the router **reseeds γ** and
  re-permutes the bins.  In-flight requests drain on the old map (the lane
  is pinned at submit) unless their lane *dies*, in which case the
  supervisor re-routes them exactly once onto the surviving set.
* **replicated mode, stacked placement** — every lane reads the full
  resident graph; per-lane dynamic batchers feed **rounds**: one batch per
  lane, stacked into ONE dispatch of the lane step
  (``compute.build_lane_infer_step``: one forward over the block-diagonal
  stack of the lanes' bucket plans, so each aggregation kernel launches
  once a layer for all lanes).
* **sharded mode** — feature *residency* is DRHM-row-sharded
  (``sparse.plan.plan_feature_sharding``): lane i's shard of the permuted
  table lives on its device, and a round's halo exchange
  (``core.distributed.LaneHalo``) copies the shards' rows onto each
  lane's device and gathers its subgraph there; bitwise identical to
  replicated residency.
* **mesh placement** — lane i's step runs on its own device
  (``compute.build_lane_infer_step(placement="mesh")``), at its place in
  the round's stacked shapes, so its rows are bitwise the stacked
  round's.

Sharded mode and mesh placement take the lanes' ``devices``: by default
one lane a visible card of the server's device type (fewer cards than
lanes raises ``ValueError``, as the reference does with fewer devices
than lanes).  A caller may pass ``devices`` that repeat a device — the
counterpart of the reference tests' emulated XLA devices: the CPU tests
run ``devices=["cpu"] * n_lanes``, and one card can hold every lane.

The control plane on top:

* **telemetry** (``serve.telemetry``) — per-lane counters and latency
  windows are the source of truth ``stats()``/``lane_stats()`` derive
  from; a monitor thread samples queue depth, in-flight rounds and batcher
  lengths and drives every control arm below from those samples.
* **supervision** — each lane has a heartbeat the engine refreshes when the
  lane dispatches (or is idle); a lane with queued work and a stale
  heartbeat is declared dead.  Death ⇒ the router **rebalances** onto the
  surviving lane set, the dead lane's queued requests re-route exactly
  once, and — after ``restart_after`` — the lane restarts through a
  **shadow warm-up** (a dummy round through the shared step) before
  rejoining the active set.
* **request robustness** — per-request deadlines (typed
  ``DeadlineExceeded``); transient step faults retry ``max_retries`` times
  (``RetriesExhausted`` after); sustained queue growth sheds new
  submissions at the door (typed ``Overloaded``); per-class SLO burn rates
  (``serve.slo``) shed ``best_effort`` before ``batch`` and never
  ``interactive``; sustained idle/overload trends **park/unpark lanes**.
* **chaos** (``serve.chaos``) — lane kills and stalls, step and sampler
  faults; with ``chaos=None`` the hot path carries only ``is None`` guards.
* **tracing** — one span tree per accepted request (``route``, ``sample``,
  ``queue_wait``, ``bucket_pack``, ``dispatch``, ``settle`` or ``error``;
  ``reroute`` and ``retry`` hops), and a one-span ``shed`` trace per
  rejected submission.

Delivery contract: every accepted request settles exactly once — a result
XOR a typed ``serve.errors`` error.  Correctness anchor: every result
equals the single-lane offline replay (same trees, bucket-1 step) to
≤1e-5.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

import torch

from repro_torch.core import drhm
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serve.batcher import DynamicBatcher, ServeRequest
from repro_torch.serve.buckets import (all_buckets, bucket_for,
                                       build_bucket_structure, stack_trees)
from repro_torch.serve.compute import (CONV_ARCHS, FeatureStore, StepCache,
                                       _arch_key, build_fetch_step,
                                       build_infer_step,
                                       build_lane_infer_step,
                                       bucket_plan, dispatch_annotation)
from repro_torch.serve.engine import SamplerPool, _needs_loops
from repro_torch.serve.errors import (DeadlineExceeded, DrainTimeout,
                                      LaneFailure, Overloaded,
                                      RetriesExhausted, SamplerError,
                                      ServeError, ServerClosed,
                                      TransientStepError)
from repro_torch.serve.scheduler import LaneSlotPools
from repro_torch.serve.slo import CLASSES, DEFAULT_SLOS, SLOEngine
from repro_torch.serve.telemetry import TelemetryHub
from repro_torch.serve.tracing import Tracer
from repro_torch.sparse.plan import plan_cache_info

MODES = ("replicated", "sharded")
PLACEMENTS = ("stacked", "mesh")
LANE_STATES = ("active", "dead", "warming", "parked")


# ---------------------------------------------------------------------------
# Router — DRHM with dynamic reseeding, one level up
# ---------------------------------------------------------------------------

class DRHMRouter:
    """Seed-TAG → lane mapping with dynamic γ reseeding and an elastic
    active-lane set.

    ``lane_of(seeds) = active[perm_γ[mix64(seed₀) mod n_bins] // span]``
    where ``perm_γ`` is the DRHM bijective permutation of the bin space —
    so for every epoch the bin→lane map is an exact-balance bijection over
    the **active** lanes (each owns exactly ``n_bins/n_active`` bins; the
    property tests pin this for every subset size).

    ``maybe_reseed(depths)`` implements the paper's trigger at traffic
    level: when the max active-lane queue depth exceeds ``skew_threshold``
    × the mean (and there is enough traffic for the signal to be
    meaningful), draw a new γ and re-permute.  ``rebalance(active)`` is the
    failover/elasticity arm: the same re-permutation onto a different lane
    count — shrink on a lane death or park, grow on restart — without
    moving any resident state.

    Not thread-safe by itself; the cluster serializes access.
    """

    def __init__(self, n_lanes: int, n_bins: int = 1024, seed: int = 0,
                 skew_threshold: float = 1.5, min_mean_depth: float = 1.0,
                 noise_slack: float = 4.0):
        if n_lanes <= 0:
            raise ValueError(f"n_lanes must be positive, got {n_lanes}")
        self.n_lanes = int(n_lanes)
        self.seed = int(seed)
        self.skew_threshold = float(skew_threshold)
        self.min_mean_depth = float(min_mean_depth)
        self.noise_slack = float(noise_slack)
        self.epoch = 0
        self.reseeds = 0
        self.rebalances = 0
        self._active = np.arange(self.n_lanes, dtype=np.int64)
        self._base_bins = max(int(n_bins), self.n_lanes)
        self._plan = drhm.plan_request_routing(self._base_bins, self.n_lanes,
                                               self.seed, 0)
        self.n_bins = self._plan.n_pad        # padded to a lane multiple
        # per-epoch routed counts — the utilization-spread record the bench
        # reports before/after a reseed
        self.epoch_counts: List[np.ndarray] = [np.zeros(n_lanes, np.int64)]
        # queue depths at the last reseed: old-map backlog that a new γ
        # cannot fix (those requests drain on the old map) — subtracted
        # from the skew signal so one hot burst triggers ONE reseed, not
        # one per check interval while the hot lane drains
        self._depths_at_reseed = np.zeros(n_lanes, np.float64)

    @property
    def gamma(self) -> int:
        return self._plan.gamma

    @property
    def active_lanes(self) -> np.ndarray:
        return self._active.copy()

    @property
    def n_active(self) -> int:
        return int(self._active.size)

    def _lanes_for(self, tags: np.ndarray) -> np.ndarray:
        """THE bin→lane math (one home, scalar and bulk paths share it):
        splitmix-conditioned TAG → bin → γ-permuted owner among the
        active lanes."""
        bins = (drhm.mix64(np.asarray(tags, np.uint64))
                % np.uint64(self.n_bins)).astype(np.int64)
        return self._active[self._plan.perm[bins]
                            // self._plan.rows_per_shard]

    def bin_of(self, seeds) -> int:
        tag = np.uint64(int(np.atleast_1d(seeds)[0]))
        return int(drhm.mix64(tag) % np.uint64(self.n_bins))

    def lane_of(self, seeds) -> int:
        return int(self._lanes_for([np.atleast_1d(seeds)[0]])[0])

    def route(self, seeds) -> int:
        """``lane_of`` + utilization accounting (the serving entry point)."""
        lane = self.lane_of(seeds)
        self.epoch_counts[-1][lane] += 1
        return lane

    def route_many(self, first_seeds: np.ndarray) -> np.ndarray:
        """Vectorized ``route`` over one TAG per request (bulk ingest)."""
        lanes = self._lanes_for(first_seeds)
        np.add.at(self.epoch_counts[-1], lanes, 1)
        return lanes

    def lane_map(self) -> np.ndarray:
        """(n_bins,) bin → lane under the current γ and active set (for the
        bijectivity property: every active lane appears exactly
        ``n_bins/n_active`` times)."""
        return self._active[self._plan.perm
                            // self._plan.rows_per_shard].astype(np.int64)

    def _replan(self):
        self._plan = drhm.plan_request_routing(self._base_bins,
                                               self.n_active, self.seed,
                                               self.epoch)
        self.n_bins = self._plan.n_pad
        self.epoch_counts.append(np.zeros(self.n_lanes, np.int64))

    def reseed(self):
        self.epoch += 1
        self.reseeds += 1
        self._replan()

    def bump_epoch(self):
        """Epoch flip without touching the active set or the skew counters
        (the live weight-swap boundary): requests routed
        before the flip drain on the old map/weights; the new epoch gets a
        fresh γ permutation and a fresh utilization ledger."""
        self.epoch += 1
        self._replan()

    def rebalance(self, active_lanes: Sequence[int]):
        """Re-permute the bin space onto a new active-lane set (lane death,
        restart, or elastic park/unpark).  The map stays an exact-balance
        bijection over the new set; only future routing changes — requests
        already pinned keep their lane (the supervisor re-routes the ones
        whose lane is gone)."""
        active = sorted(set(int(x) for x in active_lanes))
        if not active:
            raise ValueError("rebalance needs at least one active lane")
        if active[0] < 0 or active[-1] >= self.n_lanes:
            raise ValueError(f"active lanes {active} out of range for "
                             f"{self.n_lanes} lanes")
        if np.array_equal(active, self._active):
            return
        self.epoch += 1
        self.rebalances += 1
        self._active = np.asarray(active, np.int64)
        self._replan()

    def maybe_reseed(self, queue_depths: Sequence[float]) -> bool:
        # judge only depth accrued SINCE the last reseed on ACTIVE lanes:
        # the old map's backlog is pinned to its lanes and no new γ can
        # rebalance it (the subtraction over-counts as old requests finish
        # — that only makes the trigger more conservative, never spurious)
        d_full = np.maximum(np.asarray(queue_depths, np.float64)
                            - self._depths_at_reseed, 0.0)
        d = d_full[self._active]
        mean = float(d.mean())
        if mean < self.min_mean_depth:
            return False                  # too little traffic to judge skew
        # skew must clear BOTH the ratio threshold and a Poisson-noise slack
        # (~√mean): uniform traffic at low depth routinely shows max/mean
        # near 2 by pure counting noise — reseeding on that would churn the
        # map without improving balance
        skewed = (float(d.max()) > self.skew_threshold * mean
                  and float(d.max()) - mean > self.noise_slack * mean ** 0.5)
        if skewed:
            self._depths_at_reseed = np.asarray(queue_depths, np.float64)
            self.reseed()
            return True
        return False

    def info(self) -> dict:
        return {"epoch": self.epoch, "reseeds": self.reseeds,
                "rebalances": self.rebalances,
                "active_lanes": self._active.tolist(),
                "gamma": self.gamma, "n_bins": self.n_bins,
                "routed_per_epoch": [c.tolist() for c in self.epoch_counts]}


def _lane_devices(device: torch.device, n_lanes: int, devices, mode: str,
                  placement: str) -> list:
    """The lanes' devices: ``devices`` as given (one a lane; a device may
    repeat), or one lane a visible card of ``device``'s type — fewer
    cards than lanes raises."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if len(devices) != n_lanes:
            raise ValueError(f"{len(devices)} devices for {n_lanes} lanes: "
                             "pass one device a lane (a device may repeat)")
        return devices
    have = (torch.cuda.device_count() if device.type == "cuda" else 1)
    if have < n_lanes:
        raise ValueError(
            f"mode={mode!r}/placement={placement!r} needs {n_lanes} "
            f"devices, have {have} {device.type} device(s) — pass devices="
            "[...] with one device a lane (a device may repeat), or use "
            "placement='stacked' replicated, which is device-count-agnostic")
    return [torch.device(device.type, i) if device.type == "cuda"
            else device for i in range(n_lanes)]


def utilization_spread(counts: Sequence[float]) -> float:
    """max/mean per-lane load — 1.0 is perfect balance (the paper's hot-spot
    metric, ``drhm.imbalance``, on host counters)."""
    c = np.asarray(counts, np.float64)
    return float(c.max() / max(c.mean(), 1e-9))


# ---------------------------------------------------------------------------
# The cluster server
# ---------------------------------------------------------------------------

class ClusterServer:
    """N-lane scale-out serving tier over one resident graph, supervised.

    ``device=None`` serves on ``cuda`` (and raises without a GPU); the
    feature store must live on the same device and hold ``x``."""

    def __init__(self, arch_id: str, cfg, params, indptr: np.ndarray,
                 indices: np.ndarray, store: FeatureStore, *,
                 n_lanes: int = 4, mode: str = "replicated",
                 placement: str = "stacked",
                 fanouts: Sequence[int] = (5, 3), backend: str = "dense",
                 max_batch_seeds: int = 16, max_wait_ms: float = 5.0,
                 n_workers: int = 2, seed: int = 0, inflight: int = 2,
                 step_cache_size: int = 16, router_bins: int = 1024,
                 skew_threshold: float = 1.5, reseed_check_every: int = 32,
                 sampler_group: int = 256,
                 chaos=None, max_retries: int = 1,
                 telemetry_jsonl: Optional[str] = None,
                 telemetry_interval: float = 0.05,
                 stall_timeout: float = 1.0, restart_after: float = 2.0,
                 auto_restart: bool = True,
                 shed_queue_hwm: Optional[float] = None,
                 shed_sustain_ticks: int = 2,
                 slo=None, slo_fast_window: float = 1.0,
                 slo_slow_window: float = 5.0,
                 slo_burn_threshold: float = 2.0,
                 slo_sustain_ticks: int = 2, slo_recover_ticks: int = 4,
                 metrics: bool = False, metrics_port: Optional[int] = None,
                 scale_min_lanes: Optional[int] = None,
                 scale_up_depth: float = 8.0, scale_down_depth: float = 0.25,
                 scale_sustain_ticks: int = 4,
                 tracing: bool = False, trace_capacity: int = 4096,
                 profile_annotations: bool = False,
                 devices=None, clock=time.monotonic,
                 device: DeviceLike = None):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; have {MODES}")
        if placement not in PLACEMENTS:
            raise ValueError(f"unknown placement {placement!r}; "
                             f"have {PLACEMENTS}")
        if _arch_key(arch_id) not in CONV_ARCHS:
            raise ValueError(f"cluster serving covers {CONV_ARCHS}; "
                             f"{arch_id!r} is single-device only")
        if store.x is None:
            raise ValueError("cluster serving needs FeatureStore.x")
        self.device = resolve_device(device)
        if store.device != self.device:
            raise ValueError(f"feature store is on {store.device}, server "
                             f"on {self.device}")
        self.arch_id = arch_id
        self.cfg = cfg
        # live weight plane: dispatch snapshots ONE tuple so
        # a hot-swap is a single atomic reference flip between rounds —
        # every request settles on exactly one (params, version) pair
        self._live_params = (params, 0)
        self._retired_params: Dict[int, object] = {}
        self._version_inflight: Dict[int, int] = collections.Counter()
        self._version_first_dispatch: Dict[int, float] = {}
        self._last_dispatch_t: Optional[float] = None
        self.indptr = np.asarray(indptr)
        self.indices = np.asarray(indices)
        self.store = store
        self.n_lanes = int(n_lanes)
        self.lane_devices = None
        if mode == "sharded" or placement == "mesh":
            self.lane_devices = _lane_devices(self.device, self.n_lanes,
                                              devices, mode, placement)
        self.mode = mode
        self.placement = placement
        self.fanouts = tuple(int(f) for f in fanouts)
        self.backend = backend
        self.max_batch_seeds = int(max_batch_seeds)
        self.seed = seed
        self.clock = clock
        self.inflight_depth = max(int(inflight), 1)
        self.reseed_check_every = max(int(reseed_check_every), 1)
        self.chaos = chaos
        self.max_retries = max(int(max_retries), 0)

        # telemetry plane — the source of truth stats() derives from, and
        # the signal every control arm (supervision, shedding, scaling)
        # acts on.  The monitor thread starts with the server.
        self.telemetry = TelemetryHub(self.n_lanes,
                                      interval=telemetry_interval,
                                      jsonl_path=telemetry_jsonl,
                                      clock=clock)
        # NeuraScope tracing — chaos convention: None when off, one
        # ``is None`` test per stage when on.  Completed span trees share
        # the hub's time axis and flush through its JSONL writer; with no
        # flight recorder configured the sink stays None so settlement
        # never materializes record dicts just to drop them.
        self.tracer = (Tracer(capacity=trace_capacity, clock=clock,
                              t0=self.telemetry.t0,
                              sink=(self.telemetry.emit
                                    if telemetry_jsonl else None))
                       if tracing else None)
        # attrs dicts are read-only once emitted (record() copies them into
        # the flushed span), so the per-lane hot-path spans share one cached
        # dict per lane instead of allocating per request
        self._lane_attrs = [{"lane": ln} for ln in range(self.n_lanes)]
        self.profile_annotations = bool(profile_annotations)

        # routing plane
        self.router = DRHMRouter(self.n_lanes, n_bins=router_bins, seed=seed,
                                 skew_threshold=skew_threshold)
        self._router_lock = threading.Lock()
        self._since_check = 0
        self._lane_submitted = np.zeros(self.n_lanes, np.int64)
        self._lane_finished = np.zeros(self.n_lanes, np.int64)

        # supervision plane (dead / warming / parked / active)
        self.stall_timeout = float(stall_timeout)
        self.restart_after = float(restart_after)
        self.auto_restart = bool(auto_restart)
        self._sup_lock = threading.Lock()
        self._lane_state: List[str] = ["active"] * self.n_lanes
        self._heartbeat = np.full(self.n_lanes, clock(), np.float64)
        # the engine thread's own beat, taken once a loop: lanes are judged
        # against it, so an engine busy for a while (a first step build, a
        # long sync) does not make every lane with queued work look dead
        self._engine_beat = clock()
        self._dead_since = np.zeros(self.n_lanes, np.float64)

        # load shedding + elastic scaling knobs (None disables each arm)
        self.shed_queue_hwm = shed_queue_hwm
        self.shed_sustain_ticks = max(int(shed_sustain_ticks), 1)
        self._shedding = False
        self._shed_hi_ticks = 0
        self.scale_min_lanes = scale_min_lanes
        self.scale_up_depth = float(scale_up_depth)
        self.scale_down_depth = float(scale_down_depth)
        self.scale_sustain_ticks = max(int(scale_sustain_ticks), 1)
        self._scale_hi = 0
        self._scale_lo = 0

        # online metrics plane + per-class SLO burn-rate shedding (both
        # opt-in — chaos convention: None when off, one ``is None`` test
        # per call site when the arm is dark)
        self.metrics = None
        self._metrics_server = None
        self._m_requests = self._m_latency = None
        self._m_cache = self._m_router = None
        if metrics or metrics_port is not None or slo is not None:
            from repro_torch.serve.metrics import MetricsRegistry
            self.metrics = MetricsRegistry()
            self._m_requests = self.metrics.counter(
                "requests_total", "settled cluster requests by class/outcome")
            self._m_latency = self.metrics.histogram(
                "request_latency_seconds",
                "end-to-end request latency by class")
            self._m_cache = self.metrics.gauge(
                "cache_hit_rate", "host plan/step cache hit rates")
            self._m_router = self.metrics.gauge(
                "drhm_router", "DRHM routing-plane state")
            self.metrics.connect_hub(self.telemetry)
            self.metrics.connect_kernel_stats()
            self.metrics.register_pull(self._pull_metrics)
        self.slo: Optional[SLOEngine] = None
        if slo is not None:
            if isinstance(slo, SLOEngine):
                self.slo = slo
            else:
                self.slo = SLOEngine(
                    DEFAULT_SLOS if slo is True else slo,
                    fast_window=slo_fast_window,
                    slow_window=slo_slow_window,
                    burn_threshold=slo_burn_threshold,
                    sustain_ticks=slo_sustain_ticks,
                    recover_ticks=slo_recover_ticks,
                    registry=self.metrics, clock=clock)
            self.telemetry.add_tick(self._slo_tick)
        if metrics_port is not None:
            # launch-layer import stays lazy: serve never pays for the
            # HTTP stack unless the endpoint is actually requested
            from repro_torch.launch.metrics_server import MetricsServer
            self._metrics_server = MetricsServer(self.metrics.render,
                                                 port=metrics_port)

        # request plane: one dynamic batcher per lane + in-flight slot pools
        self.batchers = [DynamicBatcher(self.max_batch_seeds,
                                        max_wait_ms / 1e3, clock=clock)
                         for _ in range(self.n_lanes)]
        self.pools = LaneSlotPools(self.n_lanes, self.inflight_depth)

        # compute plane
        self.steps = StepCache(self._build_step, maxsize=step_cache_size)
        self._offline_steps = StepCache(self._build_offline_step, maxsize=4)
        self._structs: Dict[int, object] = {}
        self.shard_plan = None
        if mode == "sharded":
            from repro_torch.core.distributed import LaneHalo
            from repro_torch.sparse.plan import plan_feature_sharding
            n_rows = self.store.n_nodes + 1           # ghost row included
            self.shard_plan = plan_feature_sharding(n_rows, self.n_lanes)
            self._halo = LaneHalo(self.store.x, self.shard_plan,
                                  self.lane_devices,
                                  n_ghost_slot=self.store.n_nodes)
        else:
            self._fetch_step = build_fetch_step(self.store)

        self._rid_lock = threading.Lock()
        self._next_rid = 0
        self.requests: Dict[int, ServeRequest] = {}

        self._stats_lock = threading.Lock()
        self.bucket_counts: Dict[int, int] = collections.Counter()
        self.bucket_hits = 0
        self.n_rounds = 0
        self._round_no = 0                 # engine-owned dispatch counter

        # data plane: the shared sampler pool; compute plane: engine thread
        # larger drain groups than the single-lane default: a cluster burst
        # queues hundreds of requests, and the vectorized forest pass's
        # fixed cost amortizes across everything a worker can grab
        self._sampler = SamplerPool(
            self.indptr, self.indices, self.fanouts, seed,
            on_ready=(self._on_sampled if self.tracer is None
                      else self._on_sampled_traced),
            on_error=self._fail_requests,
            n_workers=n_workers, group_cap=sampler_group,
            fault_hook=(chaos.sampler_hook if chaos is not None else None))
        self._closing = False
        self._close_lock = threading.Lock()
        self._stop = threading.Event()
        self._work = threading.Event()
        self._inflight: "collections.deque" = collections.deque()
        self._engine = threading.Thread(target=self._engine_loop, daemon=True,
                                        name="gnn-cluster-engine")
        self._engine.start()

        # monitor: probes feed the time-series; the tick drives supervision
        self.telemetry.register_probe("queue_depth",
                                      lambda: self.queue_depths())
        self.telemetry.register_probe("inflight",
                                      lambda: self.pools.depths())
        self.telemetry.register_probe(
            "batcher_len", lambda: [len(b) for b in self.batchers])
        self.telemetry.add_tick(self._supervise)
        self.telemetry.start()

    # -- request plane ------------------------------------------------------
    def _check_admission(self, n: int = 1, cls: str = "interactive"):
        if self._closing:
            raise RuntimeError("cluster is closed; no lane will serve this")
        # two shedders, one door: the class-blind queue-HWM backstop sheds
        # everything; the SLO burn-rate engine sheds only the classes it
        # has dropped (best_effort before batch, never interactive)
        slo_shed = self.slo is not None and self.slo.should_shed(cls)
        if self._shedding or slo_shed:
            with self._rid_lock:
                self.telemetry.count("shed", 0, n)
            if self._m_requests is not None:
                self._m_requests.inc(n, outcome="shed", **{"class": cls})
            depth = float(np.sum(self.queue_depths()))
            if self.tracer is not None:
                # rejected before a rid exists — a single-span terminal
                # trace is the whole story of a shed submission
                self.tracer.point("shed", {"n": int(n), "depth": depth,
                                           "cls": cls})
            raise Overloaded(
                depth, retry_after_s=self.telemetry.interval
                * self.shed_sustain_ticks,
                cls=cls if slo_shed else None)

    def submit(self, seeds, *, deadline_ms: Optional[float] = None,
               cls: str = "interactive") -> ServeRequest:
        if cls not in CLASSES:
            raise ValueError(f"unknown request class {cls!r}; "
                             f"expected one of {CLASSES}")
        self._check_admission(cls=cls)
        seeds = np.atleast_1d(np.asarray(seeds, np.int64))
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
                rid=rid, seeds=seeds, t_submit=now, cls=cls,
                deadline=(now + deadline_ms / 1e3
                          if deadline_ms is not None else None))
            self.requests[rid] = req
        with self._router_lock:
            # lane pinned at submit — a later reseed never remaps a request
            # already in flight (it drains on the old map)
            req.lane = self.router.route(seeds)
            self._lane_submitted[req.lane] += 1
            self.telemetry.count("submitted", req.lane)
            self._since_check += 1
            if self._since_check >= self.reseed_check_every:
                self._since_check = 0
                if self.router.maybe_reseed(self.queue_depths()):
                    self.telemetry.event("reseed", epoch=self.router.epoch)
        if self.tracer is not None:
            self.tracer.span(rid, "route", now, self.clock(),
                             self._lane_attrs[req.lane])
        self._sampler.submit(req)
        return req

    def submit_many(self, seed_lists: Sequence, *,
                    deadline_ms: Optional[float] = None,
                    cls: str = "interactive") -> List[ServeRequest]:
        """Bulk ingest: validate, rid-assign, and DRHM-route a whole burst
        in vectorized passes, then hand the block to the sampler pool as one
        group.  Per-request ``submit()`` costs ~80µs under load (locks,
        scalar hashing, queue round-trips) — an open-loop load generator
        firing thousands of requests would be *arrival-bound* on that path
        and measure the generator, not the lanes.  Routing semantics are
        identical: the reseed check still runs every ``reseed_check_every``
        requests (the burst is routed in chunks), and each request's lane is
        pinned when its chunk is routed.  Under load shedding the whole
        call is rejected (``Overloaded``) — callers submit in chunks."""
        if cls not in CLASSES:
            raise ValueError(f"unknown request class {cls!r}; "
                             f"expected one of {CLASSES}")
        self._check_admission(len(seed_lists), cls=cls)
        seed_arrs = [np.atleast_1d(np.asarray(s, np.int64))
                     for s in seed_lists]
        if not seed_arrs:
            return []
        n_graph = self.indptr.shape[0] - 1
        sizes = np.array([a.size for a in seed_arrs])
        if (sizes == 0).any() or (sizes > self.max_batch_seeds).any():
            raise ValueError(f"every request must carry 1..."
                             f"{self.max_batch_seeds} seeds; "
                             f"got sizes {sizes[(sizes == 0) | (sizes > self.max_batch_seeds)]}")
        flat = np.concatenate(seed_arrs)
        if (flat < 0).any() or (flat >= n_graph).any():
            raise ValueError(f"seed ids out of range for the resident graph "
                             f"({n_graph} nodes)")
        now = self.clock()
        deadline = now + deadline_ms / 1e3 if deadline_ms is not None \
            else None
        with self._rid_lock:
            rid0 = self._next_rid
            self._next_rid += len(seed_arrs)
            reqs = [ServeRequest(rid=rid0 + i, seeds=a, t_submit=now,
                                 deadline=deadline, cls=cls)
                    for i, a in enumerate(seed_arrs)]
            for req in reqs:
                self.requests[req.rid] = req
        first = np.array([a[0] for a in seed_arrs], np.uint64)
        with self._router_lock:
            i = 0
            while i < len(reqs):
                # chunked so reseed checks fire at the same cadence as the
                # scalar path (lane pinned per chunk, on the current map)
                take = min(self.reseed_check_every - self._since_check,
                           len(reqs) - i)
                lanes = self.router.route_many(first[i:i + take])
                for j, lane in enumerate(lanes):
                    reqs[i + j].lane = int(lane)
                np.add.at(self._lane_submitted, lanes, 1)
                np.add.at(self.telemetry.counters["submitted"], lanes, 1)
                self._since_check += take
                i += take
                if self._since_check >= self.reseed_check_every:
                    self._since_check = 0
                    if self.router.maybe_reseed(self.queue_depths()):
                        self.telemetry.event("reseed",
                                             epoch=self.router.epoch)
        if self.tracer is not None:
            t_routed = self.clock()
            attrs = self._lane_attrs
            for req in reqs:
                self.tracer.span(req.rid, "route", now, t_routed,
                                 attrs[req.lane])
        self._sampler.submit_block(reqs)
        return reqs

    def queue_depths(self) -> np.ndarray:
        """Per-lane submitted-but-unfinished request counts — the router's
        skew signal and the monitor's shedding/scaling signal."""
        return self._lane_submitted - self._lane_finished

    def _enqueue(self, req: ServeRequest) -> bool:
        """Hand a sampled request to its lane's batcher iff the lane is
        active.  Holding the supervision lock closes the race against a
        concurrent kill/park flushing that batcher — a request can never
        slip into a queue nobody will ever drain."""
        with self._sup_lock:
            if self._lane_state[req.lane] != "active":
                return False
            self.batchers[req.lane].submit(req)
        self._work.set()
        return True

    def _reroute_assign(self, req: ServeRequest):
        """Pick a fresh lane for a request whose pinned lane is gone (route
        on the *current* map — post-rebalance, so only surviving lanes)."""
        req.reroutes += 1
        with self._router_lock:
            old = req.lane
            req.lane = self.router.route(req.seeds)
            self._lane_submitted[old] -= 1
            self._lane_submitted[req.lane] += 1
        self.telemetry.count("reroutes", req.lane)
        if self.tracer is not None:
            now = self.clock()
            self.tracer.span(req.rid, "reroute", now, now,
                             {"from": old, "to": req.lane})

    def _on_sampled_traced(self, req: ServeRequest):
        """Tracing-on sampler hand-off (pool ``on_ready`` only — re-routed
        and retried requests re-enter via ``_on_sampled`` directly, so the
        sample span is emitted exactly once per request)."""
        self.tracer.span(req.rid, "sample", req.t_submit, self.clock(),
                         self._lane_attrs[req.lane])
        self._on_sampled(req)

    def _on_sampled(self, req: ServeRequest):
        attempts = 0
        while not self._enqueue(req):
            if attempts >= self.n_lanes:
                self._settle_fail(req, LaneFailure(
                    req.rid, req.lane, "no active lane to re-route onto"))
                return
            self._reroute_assign(req)
            attempts += 1

    def _settle_fail(self, req: ServeRequest, err: ServeError):
        now = self.clock()
        with self._rid_lock:
            self.requests.pop(req.rid, None)
        if req.lane is not None:
            with self._router_lock:
                self._lane_finished[req.lane] += 1
            if req.fail(err, now):
                self.telemetry.count("failed", req.lane)
                if self._m_requests is not None:
                    self._m_requests.inc(1, outcome="failed",
                                         **{"class": req.cls})
                if self.tracer is not None:
                    self.tracer.settle(req.rid, "error", now, now,
                                       {"error": type(err).__name__,
                                        "lane": req.lane})
        else:
            if req.fail(err, now) and self.tracer is not None:
                self.tracer.settle(req.rid, "error", now, now,
                                   {"error": type(err).__name__})

    def _fail_requests(self, reqs, exc: BaseException):
        """Sampler-stage failure path: fail exactly the affected requests
        with a typed error carrying each request id — the worker, its
        groupmates, and the engine loop all survive."""
        for req in reqs:
            err = exc if isinstance(exc, ServeError) \
                else SamplerError(req.rid, exc)
            self.telemetry.count("sampler_faults",
                                 req.lane if req.lane is not None else 0)
            self._settle_fail(req, err)

    # -- SLO / metrics plane ------------------------------------------------
    def _slo_tick(self, sample: dict):
        """Monitor-tick hook: advance the burn-rate engine; every shed-set
        transition becomes a ``shed_class`` telemetry event (so the flight
        recorder and the chaos bench see the precedence order)."""
        for ev in self.slo.tick():
            self.telemetry.event("shed_class", cls=ev["cls"], on=ev["on"],
                                 burn_fast=round(ev["burn_fast"], 4),
                                 burn_slow=round(ev["burn_slow"], 4))

    def _pull_metrics(self):
        """Render-time gauge refresh: cache hit rates and routing-plane
        state that already live in host bookkeeping — no feeder thread."""
        info = self.steps.info()
        tries = info["hits"] + info["builds"]
        self._m_cache.set(info["hits"] / tries if tries else 0.0,
                          cache="step")
        with self._stats_lock:
            rounds, hits = self.n_rounds, self.bucket_hits
        self._m_cache.set(hits / rounds if rounds else 0.0, cache="bucket")
        self._m_router.set(float(self.router.reseeds), field="reseeds")
        self._m_router.set(float(self.router.epoch), field="epoch")
        depths = np.maximum(self.queue_depths(), 0)
        self._m_router.set(utilization_spread(depths)
                           if depths.sum() else 1.0, field="queue_spread")

    def _observe_settled(self, req: ServeRequest):
        """Per-request metrics/SLO observation at the settle site.  The rid
        doubles as the exemplar trace id — the histogram bucket a latency
        lands in links straight to its NeuraScope span tree."""
        if self.slo is not None:
            # the engine writes the shared latency histogram itself
            self.slo.observe(req.cls, req.latency, exemplar=str(req.rid))
        elif self._m_latency is not None:
            self._m_latency.observe(req.latency, exemplar=str(req.rid),
                                    **{"class": req.cls})
        if self._m_requests is not None:
            self._m_requests.inc(1, outcome="served", **{"class": req.cls})

    # -- supervision plane (monitor tick) -----------------------------------
    def _supervise(self, sample: dict):
        """One control-plane tick: stall detection, restarts, shedding
        hysteresis, elastic scaling.  Runs on the telemetry monitor thread;
        every action it takes is also a telemetry event."""
        now = self.clock()
        depths = self.queue_depths()
        # 1) heartbeat-based dead/stalled-lane detection
        for lane in range(self.n_lanes):
            if (self._lane_state[lane] == "active" and depths[lane] > 0
                    and self._engine_beat - self._heartbeat[lane]
                    > self.stall_timeout):
                self._kill_lane(lane, "stalled-heartbeat")
        # 2) lane restart after the cool-down, via shadow warm-up
        if self.auto_restart:
            for lane in range(self.n_lanes):
                if (self._lane_state[lane] == "dead"
                        and now - self._dead_since[lane]
                        >= self.restart_after):
                    self._restore_lane(lane)
        # 3) load-shedding hysteresis on total queued work
        if self.shed_queue_hwm is not None:
            total = float(depths.sum())
            if total > self.shed_queue_hwm:
                self._shed_hi_ticks += 1
            else:
                self._shed_hi_ticks = 0
                if self._shedding and total < 0.5 * self.shed_queue_hwm:
                    self._shedding = False
                    self.telemetry.event("shed_off", depth=total)
            if (not self._shedding
                    and self._shed_hi_ticks >= self.shed_sustain_ticks):
                self._shedding = True
                self.telemetry.event("shed_on", depth=total)
        # 4) telemetry-driven elastic lane scaling
        if self.scale_min_lanes is not None:
            self._elastic_tick(depths)

    def _elastic_tick(self, depths: np.ndarray):
        active = [i for i in range(self.n_lanes)
                  if self._lane_state[i] == "active"]
        parked = [i for i in range(self.n_lanes)
                  if self._lane_state[i] == "parked"]
        if not active:
            return
        mean_depth = float(depths.sum()) / len(active)
        if mean_depth > self.scale_up_depth:
            self._scale_hi += 1
            self._scale_lo = 0
        elif mean_depth < self.scale_down_depth:
            self._scale_lo += 1
            self._scale_hi = 0
        else:
            self._scale_hi = self._scale_lo = 0
        if self._scale_hi >= self.scale_sustain_ticks and parked:
            self._scale_hi = 0
            self.telemetry.event("scale_up", lane=parked[0],
                                 mean_depth=mean_depth)
            self._restore_lane(parked[0])
        elif (self._scale_lo >= self.scale_sustain_ticks
              and len(active) > max(int(self.scale_min_lanes), 1)):
            self._scale_lo = 0
            self.telemetry.event("scale_down", lane=active[-1],
                                 mean_depth=mean_depth)
            self._park_lane(active[-1])

    def _deactivate(self, lane: int,
                    new_state: str) -> Optional[List[ServeRequest]]:
        """Common kill/park step: flip the state and flush the lane's
        batcher under the supervision lock (no request can slip in after
        the flush — see ``_enqueue``).  ``None`` means the lane was not
        active (a concurrent transition won) — the caller must not
        double-process."""
        with self._sup_lock:
            if self._lane_state[lane] != "active":
                return None
            self._lane_state[lane] = new_state
            batches = self.batchers[lane].flush()
        return [r for b in batches for r in b]

    def _kill_lane(self, lane: int, reason: str):
        stranded = self._deactivate(lane, "dead")
        if stranded is None:
            return
        self._dead_since[lane] = self.clock()
        self.telemetry.event("lane_dead", lane=lane, reason=reason,
                             stranded=len(stranded))
        if self.chaos is not None:
            self.chaos.on_lane_dead(lane)    # the crashed process is gone
        self._rebalance_router()
        # exactly-once re-route of the queued backlog; requests still in
        # the sampler stage re-route through _on_sampled's state check
        for req in stranded:
            self._reroute_assign(req)
            self._on_sampled(req)

    def _park_lane(self, lane: int):
        stranded = self._deactivate(lane, "parked")
        if stranded is None:
            return
        self._rebalance_router()
        for req in stranded:
            self._reroute_assign(req)
            self._on_sampled(req)

    def _restore_lane(self, lane: int):
        """Dead/parked → warming (shadow warm-up off the serving path) →
        active + router rebalance.  The warm-up runs a full dummy round
        through the shared lane step so the restarted lane's first real
        batch hits warm caches, not a compile."""
        with self._sup_lock:
            if self._lane_state[lane] not in ("dead", "parked"):
                return
            self._lane_state[lane] = "warming"
        self.telemetry.event("lane_warming", lane=lane)
        try:
            self._shadow_warmup()
        except Exception as exc:  # noqa: BLE001 — restart failed: back off
            with self._sup_lock:
                self._lane_state[lane] = "dead"
            self._dead_since[lane] = self.clock()
            self.telemetry.event("lane_restart_failed", lane=lane,
                                 error=repr(exc))
            return
        with self._sup_lock:
            self._lane_state[lane] = "active"
            self._heartbeat[lane] = self.clock()
        self.telemetry.event("lane_restored", lane=lane)
        self._rebalance_router()

    def _shadow_warmup(self, bucket: int = 1, params=None):
        # with ``params`` this doubles as the hot-swap shadow leg: the
        # candidate weights run a full dummy round off the serving path
        # (shape/dtype validation + device paging) before the flip
        params = self._live_params[0] if params is None else params
        step = self.steps.get((bucket,))
        struct = self._struct(bucket)
        node_ids = np.full((self.n_lanes, struct.n_nodes), -1, np.int64)
        hop_valid = np.zeros((self.n_lanes, struct.n_hop_edges), bool)
        x = self._gather(node_ids)
        step(params, x, node_ids, hop_valid).cpu()

    def _rebalance_router(self):
        active = [i for i in range(self.n_lanes)
                  if self._lane_state[i] == "active"]
        if not active:
            # total outage: keep the last map; submissions queue (or shed)
            # until a restart brings a lane back
            self.telemetry.event("no_active_lanes")
            return
        with self._router_lock:
            self.router.rebalance(active)
        self.telemetry.event("rebalance", active=active,
                             epoch=self.router.epoch)

    def lane_states(self) -> List[str]:
        return list(self._lane_state)

    # -- weight and graph plane -------------------------------------------
    @property
    def params(self):
        return self._live_params[0]

    @params.setter
    def params(self, value):
        # direct assignment is a new weight version too (test/offline use);
        # the serving path goes through install_params for the full swap
        cur = getattr(self, "_live_params", (None, -1))
        self._live_params = (value, cur[1] + 1)

    @property
    def params_version(self) -> int:
        return self._live_params[1]

    def install_params(self, params, version: Optional[int] = None,
                       *, bump_router: bool = True) -> int:
        """Atomically flip the serving weights to ``params``.

        The old version's reference is retained until its last in-flight
        round finalizes (``_finalize_one`` GCs it), so a round dispatched a
        microsecond before the flip still settles on the weights it ran on.
        ``bump_router`` flips the DRHM router epoch with the weights — the
        observable epoch boundary the swap drill asserts on."""
        old_params, old_ver = self._live_params
        new_ver = old_ver + 1 if version is None else int(version)
        if new_ver <= old_ver:
            raise ValueError(f"new params version {new_ver} must exceed "
                             f"current {old_ver} (versions are monotone)")
        with self._stats_lock:
            self._live_params = (params, new_ver)
            if self._version_inflight.get(old_ver, 0) > 0:
                # rounds still computing on the old weights: retain the ref
                # until the last one finalizes (_finalize_one GCs it)
                self._retired_params[old_ver] = old_params
        if bump_router:
            with self._router_lock:
                self.router.bump_epoch()
        self.telemetry.event("params_swap", version=new_ver,
                             old_version=old_ver,
                             router_epoch=self.router.epoch)
        return new_ver

    def version_inflight(self) -> Dict[int, int]:
        """Weight versions with rounds still in flight → round count."""
        with self._stats_lock:
            return {v: c for v, c in self._version_inflight.items() if c > 0}

    def retired_versions(self) -> List[int]:
        """Old weight versions not yet drained+GCed (empty = swap settled)."""
        with self._stats_lock:
            return sorted(self._retired_params)

    def first_dispatch_at(self, version: int) -> Optional[float]:
        """Clock time of the first dispatch on ``version`` (blackout
        measurement: subtract the flip time), or None if none yet."""
        with self._stats_lock:
            return self._version_first_dispatch.get(int(version))

    def last_dispatch_at(self) -> Optional[float]:
        with self._stats_lock:
            return self._last_dispatch_t

    def apply_graph_update(self, indptr: np.ndarray, indices: np.ndarray,
                           *, epoch: Optional[int] = None) -> int:
        """Install a new resident CSR (streaming edge mutations).

        Node count is immutable — live mutation re-shapes edges, never the
        id space (seed validation and the feature store depend on it).  The
        sampler swap is one atomic tuple flip; requests sampled before the
        flip drain on the old adjacency (bounded staleness, stamped per
        request via ``graph_epoch``)."""
        indptr = np.asarray(indptr)
        indices = np.asarray(indices)
        if indptr.shape[0] != self.indptr.shape[0]:
            raise ValueError(
                f"graph update changes node count ({indptr.shape[0] - 1} vs "
                f"{self.indptr.shape[0] - 1}); live mutation is edges-only")
        ep = self._sampler.set_graph(indptr, indices, epoch)
        self.indptr, self.indices = indptr, indices
        self.telemetry.event("graph_update", epoch=ep,
                             n_edges=int(indices.shape[0]))
        return ep

    def update_feature_rows(self, row_ids, rows):
        """Re-home updated feature rows into the resident store.

        Sharded residency writes them in place into the permuted lane
        shards at the slots the existing DRHM shard plan gives them
        (``perm[row_ids]``: no re-shard, no round trip of the table);
        replicated residency patches the table on its device and rebuilds
        the fetch step over it."""
        import dataclasses as _dc
        row_ids = np.asarray(row_ids, np.int64).ravel()
        rows = np.asarray(rows, np.float32)
        if row_ids.size == 0:
            return
        rows = rows.reshape(row_ids.size, -1)
        n, d = self.store.n_nodes, int(self.store.x.shape[1])
        if rows.shape[1] != d:
            raise ValueError(f"feature rows have d={rows.shape[1]}, "
                             f"store has d={d}")
        if row_ids.min() < 0 or row_ids.max() >= n:
            raise ValueError(f"feature row ids out of range [0, {n})")
        x = self.store.x.clone()
        x[torch.from_numpy(row_ids).to(x.device)] = torch.from_numpy(
            rows).to(x.device)
        self.store = _dc.replace(self.store, x=x)
        if self.mode == "sharded":
            self._halo.update(row_ids, rows)
        else:
            self._fetch_step = build_fetch_step(self.store)
        # the offline-replay anchor closes over the store at build time;
        # drop the cached steps so replay sees the patched features too
        self._offline_steps = StepCache(self._build_offline_step, maxsize=4)
        self.telemetry.event("feature_rehome", n_rows=int(row_ids.size))

    # -- compute plane ------------------------------------------------------
    def _struct(self, bucket: int):
        if bucket not in self._structs:
            self._structs[bucket] = build_bucket_structure(
                bucket, self.fanouts, with_loops=_needs_loops(self.arch_id))
        return self._structs[bucket]

    def _build_step(self, key: tuple):
        (bucket,) = key
        struct = self._struct(bucket)
        # the lane-stacked plan (on every lane's device under mesh
        # placement) packs here, with the step: a build is one cache miss,
        # and the round that pays it is the one that counts it
        if self.placement == "mesh":
            for dev in dict.fromkeys(self.lane_devices):
                bucket_plan(struct, self.backend, True, dev, self.n_lanes)
        else:
            bucket_plan(struct, self.backend, True, self.device,
                        self.n_lanes)
        return build_lane_infer_step(self.arch_id, self.cfg, struct,
                                     backend=self.backend,
                                     placement=self.placement,
                                     devices=self.lane_devices,
                                     out_device=self.device)

    def _build_offline_step(self, key: tuple):
        # the single-lane serving step — the parity anchor
        (bucket,) = key
        return build_infer_step(self.arch_id, self.cfg, self.store,
                                self._struct(bucket), backend=self.backend)

    def _gather(self, node_ids: np.ndarray):
        if self.mode == "sharded":
            lanes = self._halo.gather(node_ids)
            if self.placement == "mesh":
                return lanes            # each lane's batch on its device
            return torch.stack([x.to(self.device) for x in lanes])
        return self._fetch_step(node_ids)

    def _reap_expired(self):
        now = self.clock()
        for lane in range(self.n_lanes):
            for req in self.batchers[lane].reap_expired(now):
                self.telemetry.count("timeouts", lane)
                self._settle_fail(
                    req, DeadlineExceeded(req.rid, req.deadline, now))

    def _collect_ready(self, shutdown: bool = False
                       ) -> Dict[int, List[ServeRequest]]:
        ready = {}
        now = self.clock()
        for lane in range(self.n_lanes):
            if not shutdown:
                if self._lane_state[lane] != "active":
                    continue
                if (self.chaos is not None
                        and self.chaos.blocked(lane, self._round_no)):
                    continue            # wedged: no dispatch, no heartbeat
            if len(self.batchers[lane]) == 0 and self.pools.idle(lane):
                self._heartbeat[lane] = now   # fully idle is healthy
            if self.pools.can_dispatch(lane):
                batch = self.batchers[lane].poll()
                if batch:
                    ready[lane] = batch
        return ready

    def _dispatch_round(self, ready: Dict[int, List[ServeRequest]]):
        self._round_no += 1
        if self.chaos is not None and self.chaos.step_fault(self._round_no):
            raise TransientStepError(self._round_no)
        tr = self.tracer
        t_pack0 = self.clock() if tr is not None else 0.0
        trees = {lane: [t for r in batch for t in r.trees]
                 for lane, batch in ready.items()}
        bucket = bucket_for(max(len(ts) for ts in trees.values()),
                            self.max_batch_seeds)
        warm = self.steps.builds
        step = self.steps.get((bucket,))
        struct = self._struct(bucket)
        node_ids = np.full((self.n_lanes, struct.n_nodes), -1, np.int64)
        hop_valid = np.zeros((self.n_lanes, struct.n_hop_edges), bool)
        for lane, ts in trees.items():
            node_ids[lane], hop_valid[lane] = stack_trees(ts, bucket,
                                                          self.fanouts)
        t_pack1 = self.clock() if tr is not None else 0.0
        params, pver = self._live_params    # ONE atomic read per round
        if self.profile_annotations:
            with dispatch_annotation(
                    f"neurachip:dispatch_round:b{bucket}"):
                x = self._gather(node_ids)
                out = step(params, x, node_ids, hop_valid)
        else:
            x = self._gather(node_ids)
            out = step(params, x, node_ids, hop_valid)  # async dispatch
        slots = {lane: self.pools.acquire(lane, ready[lane][0].rid)
                 for lane in ready}
        now = self.clock()
        if tr is not None:
            attrs = {"bucket": bucket, "round": self._round_no}
            for lane, batch in ready.items():
                for r in batch:
                    tr.extend(r.rid, (("queue_wait", r.t_ready, t_pack0,
                                       None),
                                      ("bucket_pack", t_pack0, t_pack1,
                                       attrs),
                                      ("dispatch", t_pack1, now, attrs)))
        with self._stats_lock:
            self.bucket_counts[bucket] += 1
            self.n_rounds += 1
            self._version_inflight[pver] += 1
            if pver not in self._version_first_dispatch:
                self._version_first_dispatch[pver] = now
            self._last_dispatch_t = now
            if self.steps.builds == warm:
                self.bucket_hits += 1
            else:
                self.telemetry.event("recompile", bucket=bucket)
                # a build stalls every lane alike: none of them is dead
                self._heartbeat[:] = now
            for lane, batch in ready.items():
                self.telemetry.count("batches", lane)
                self.telemetry.count("seeds_dispatched", lane,
                                     sum(r.n_seeds for r in batch))
                self._heartbeat[lane] = now
        self._inflight.append((ready, out, slots, pver))

    def _retry_round(self, ready: Dict[int, List[ServeRequest]],
                     exc: TransientStepError):
        """Transient device-step failure: every affected request retries
        once (idempotent delivery makes a raced duplicate harmless), then
        fails typed."""
        for lane, batch in ready.items():
            for req in batch:
                req.attempts += 1
                if req.attempts > self.max_retries:
                    self._settle_fail(
                        req, RetriesExhausted(req.rid, req.attempts, exc))
                else:
                    self.telemetry.count("retries", req.lane)
                    if self.tracer is not None:
                        t = self.clock()
                        self.tracer.span(req.rid, "retry", t, t,
                                         {"attempt": req.attempts})
                    self._on_sampled(req)   # re-enqueue (re-routes if dead)

    def _finalize_one(self):
        ready, out, slots, pver = self._inflight.popleft()
        out = out.cpu().numpy()                        # device sync
        now = self.clock()
        tr = self.tracer
        settles = [] if tr is not None else None
        for lane, batch in ready.items():
            row = 0
            for req in batch:
                k = req.n_seeds
                req.params_version = pver   # the version this result ran on
                if req.finish(out[lane, row:row + k].copy(), now):
                    self.telemetry.count("served", req.lane)
                    self.telemetry.observe_latency(req.lane, req.latency)
                    if self.metrics is not None:
                        self._observe_settled(req)
                    if tr is not None:
                        settles.append((req.rid, "settle", now, now,
                                        self._lane_attrs[lane]))
                row += k
            self.pools.release(lane, slots[lane])
        if settles:
            tr.settle_many(settles)
        with self._rid_lock:
            for batch in ready.values():
                for req in batch:
                    self.requests.pop(req.rid, None)
        with self._router_lock:
            for lane, batch in ready.items():
                self._lane_finished[lane] += len(batch)
        retired = None
        with self._stats_lock:
            self._version_inflight[pver] -= 1
            if (self._version_inflight[pver] <= 0
                    and pver != self._live_params[1]):
                # last round on an old weight version settled: drop our
                # reference — the drain+GC leg of the swap state machine
                self._version_inflight.pop(pver, None)
                if self._retired_params.pop(pver, None) is not None:
                    retired = pver
        if retired is not None:
            self.telemetry.event("params_retired", version=retired)

    def _engine_loop(self):
        while not self._stop.is_set():
            self._engine_beat = self.clock()
            self._reap_expired()
            ready = self._collect_ready()
            if ready:
                try:
                    self._dispatch_round(ready)
                except TransientStepError as exc:
                    self._retry_round(ready, exc)
                while len(self._inflight) > self.inflight_depth:
                    self._finalize_one()
            elif self._inflight:
                # nothing ripe: retire the oldest round (its sync overlaps
                # the sampler workers refilling the lane batchers)
                self._finalize_one()
            else:
                self._work.wait(timeout=0.002)
                self._work.clear()
        # shutdown flush: everything still pending forms final rounds
        # (retire in-flight rounds before each dispatch so lane slot pools
        # can never over-subscribe; throughput is moot at shutdown).
        # Dead/blocked lanes flush too — close()'s contract is that every
        # accepted request settles, and idempotent delivery makes serving
        # an already-failed straggler a no-op.
        leftovers = [collections.deque(b.flush()) for b in self.batchers]
        while any(leftovers):
            while self._inflight:
                self._finalize_one()
            round_ready = {lane: dq.popleft()
                           for lane, dq in enumerate(leftovers) if dq}
            try:
                self._dispatch_round(round_ready)
            except TransientStepError as exc:
                self._retry_round(round_ready, exc)
                for lane, dq in enumerate(leftovers):
                    dq.extend(self.batchers[lane].flush())
        while self._inflight:
            self._finalize_one()

    # -- lifecycle / utilities ---------------------------------------------
    def warmup(self, buckets: Optional[Sequence[int]] = None):
        """Build the bucket ladder (lane-stacked plans, and the kernels on
        first launch) ahead of traffic: one dummy round a bucket."""
        buckets = (all_buckets(self.max_batch_seeds) if buckets is None
                   else buckets)
        for b in buckets:
            step = self.steps.get((b,))
            struct = self._struct(b)
            node_ids = np.full((self.n_lanes, struct.n_nodes), -1, np.int64)
            hop_valid = np.zeros((self.n_lanes, struct.n_hop_edges), bool)
            x = self._gather(node_ids)
            step(self.params, x, node_ids, hop_valid).cpu()

    def offline_replay(self, req: ServeRequest) -> np.ndarray:
        """Single-lane offline replay of one request: re-sample its trees
        through the deterministic data plane, then the bucket-1 single-lane
        step one tree at a time — must equal ``req.result`` to ≤1e-5, the
        cluster parity contract."""
        trees = self._sampler.sample_for(req.seeds, req.rid)
        step = self._offline_steps.get((1,))
        out = []
        for tree in trees:
            node_ids, hop_valid = stack_trees([tree], 1, self.fanouts)
            out.append(step(self.params, node_ids, hop_valid).cpu().numpy())
        return np.concatenate(out, axis=0)

    def drain(self, timeout: float = 120.0):
        """Block until every submitted request has *settled* (result or
        typed error).  On timeout the stragglers are failed with
        ``DrainTimeout`` (count surfaced on the raised error) — a request
        is never left silently pending."""
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
            for r in stragglers:
                self._settle_fail(r, err)
            raise err

    def reset_stats(self):
        with self._stats_lock:
            self.bucket_counts.clear()
            self.bucket_hits = 0
            self.n_rounds = 0
        self.telemetry.reset()

    def lane_stats(self) -> dict:
        c = self.telemetry.counters
        with self._stats_lock, self._router_lock:
            served = c["served"].copy()
            return {
                "submitted": self._lane_submitted.tolist(),
                "served": served.tolist(),
                "failed": c["failed"].tolist(),
                "reroutes": c["reroutes"].tolist(),
                "batches": c["batches"].tolist(),
                "queue_depths": self.queue_depths().tolist(),
                "states": self.lane_states(),
                "served_spread": (utilization_spread(served)
                                  if served.sum() else 1.0),
            }

    def stats(self) -> dict:
        t = self.telemetry.totals()
        ev = self.telemetry.event_counts()
        with self._stats_lock:
            return {
                "mode": self.mode, "placement": self.placement,
                "n_lanes": self.n_lanes,
                "n_served": t["served"], "n_rounds": self.n_rounds,
                "failed": t["failed"], "shed": t["shed"],
                "timeouts": t["timeouts"], "retries": t["retries"],
                "reroutes": t["reroutes"],
                "lane_deaths": ev.get("lane_dead", 0),
                "lane_restores": ev.get("lane_restored", 0),
                "bucket_counts": dict(self.bucket_counts),
                "bucket_hits": self.bucket_hits,
                "recompiles": self.steps.builds,
                "step_cache": self.steps.info(),
                "plan_cache": plan_cache_info(),
                "reseeds": self.router.reseeds,
                **self.telemetry.merged_percentiles(),
                **({"tracing": self.tracer.stats()}
                   if self.tracer is not None else {}),
                **({"classes": self.slo.summary()}
                   if self.slo is not None else {}),
                **({"metrics_url": self._metrics_server.url}
                   if self._metrics_server is not None else {}),
            }

    def close(self, timeout: float = 60.0):
        """Graceful shutdown: samplers stop FIRST so no request can reach a
        batcher after the engine thread's final flush.  Idempotent, and
        safe over a **wedged** engine loop: if the engine does not exit
        within ``timeout`` every still-pending request is failed with
        ``ServerClosed`` so no caller blocks forever."""
        with self._close_lock:
            if self._closing:
                return
            self._closing = True
        self._sampler.close(timeout)
        self._stop.set()
        self._work.set()
        self._engine.join(timeout)
        if self._engine.is_alive():
            now = self.clock()
            with self._rid_lock:
                pending = list(self.requests.values())
                self.requests.clear()
            for req in pending:
                if req.fail(ServerClosed(req.rid), now) \
                        and self.tracer is not None:
                    self.tracer.settle(req.rid, "error", now, now,
                                       {"error": "ServerClosed"})
            self.telemetry.event("close_forced", pending=len(pending))
        self.telemetry.stop()
        if self._metrics_server is not None:
            self._metrics_server.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
