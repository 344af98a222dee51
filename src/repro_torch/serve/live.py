"""Zero-downtime live mutation plane (port of ``repro.serve.live``).

Two arms over a *running* ``serve.cluster.ClusterServer``:

* ``hot_swap`` — versioned weight hot-swap from the checkpoint store.
  State machine: **validate** (commit marker and manifest against the live
  tree, ``checkpoint.store.restore``) → **warm** (the candidate weights
  run a full dummy round off the serving path) → **flip** (one atomic
  reference swap and a DRHM router epoch bump between dispatch rounds) →
  **drain** (rounds dispatched on the old version settle on the weights
  they ran on; the last one drops the old reference).  Any failure before
  the flip raises a typed ``HotSwapError`` and traffic never sees the
  candidate.  ``blackout_ms`` — first post-flip dispatch minus the flip,
  both on the server's clock — is the record that the router never
  stalls.

  On the card every round's kernels are queued on the one stream all
  threads share, so a round dispatched on the old weights may still be
  reading them when the flip lands.  Neither the flip nor the drain
  writes into a weight tensor: the candidate is a new tree, and dropping
  the old reference hands its blocks back to the caching allocator, which
  reuses them only for work queued on that stream after the launches that
  read them.

* ``GraphStream`` — streaming edge inserts and deletes over a
  ``sparse.delta.DeltaGraphState``, flushed when ``max_pending`` mutations
  are buffered or on an explicit ``flush()``.  Each flush re-packs the CSR
  and dedup-chunk layouts incrementally (clean blocks untouched), proves
  them bitwise against a cold re-pack before installing (every
  ``parity_every``-th epoch), then swaps the serving CSR atomically
  through ``SamplerPool.set_graph``.  Requests
  sampled before the flip drain on the old adjacency and carry its
  ``graph_epoch``.  Feature-row updates re-home through the server's
  resident store: on sharded residency in place at each row's DRHM slot
  of its owner lane's shard, with no re-shard.

Both arms act on any residency and placement: a swap's shadow warm-up
and every round after the flip run on the lanes' own devices, and a
flush swaps the CSR the shared sampler reads, never the resident table.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.checkpoint import store as ckpt_store
from repro_torch.serve.errors import GraphMutationError, HotSwapError
from repro_torch.sparse.delta import (DeltaGraphError, DeltaGraphState,
                                      chunks_match)

_POLL_S = 0.0005               # hot_swap's poll of the dispatch and drain


# ---------------------------------------------------------------------------
# Weight hot-swap
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SwapReport:
    """One hot-swap, end to end."""

    step: int                  # checkpoint step that was installed
    old_version: int
    version: int               # new serving params_version
    router_epoch: int          # DRHM epoch after the flip
    validate_s: float
    warm_s: float
    t_flip: float              # server clock at the atomic flip
    blackout_ms: float         # first post-flip dispatch − flip (NaN if the
    #                            server saw no traffic inside the wait)
    drained_old: bool          # old version fully settled and dropped
    metadata: dict             # checkpoint manifest metadata


def hot_swap(server, ckpt_dir, step: Optional[int] = None, *,
             wait_for_dispatch: float = 5.0,
             drain_timeout: float = 30.0) -> SwapReport:
    """Swap a running server onto checkpoint ``step`` with zero downtime.

    ``step=None`` takes the newest committed step.  Raises
    ``HotSwapError`` if resolving, validating and restoring, or the shadow
    warm-up fails: the serving version is unchanged in every abort path.
    Times in the report are on ``server.clock``; the waits for the first
    post-flip dispatch and for the drain run on the wall clock, since the
    server's clock may be virtual.
    """
    clock = server.clock
    if step is None:
        step = ckpt_store.latest_step(ckpt_dir)
        if step is None:
            raise HotSwapError("resolve", ckpt_store.CheckpointError(
                f"no committed checkpoint step under {ckpt_dir}"))
    t0 = clock()
    try:
        new_params, metadata = ckpt_store.restore(ckpt_dir, step,
                                                  like_tree=server.params)
    except ckpt_store.CheckpointError as exc:
        raise HotSwapError("validate", exc) from exc
    t1 = clock()
    try:
        server._shadow_warmup(params=new_params)
    except Exception as exc:  # noqa: BLE001 — typed abort, server untouched
        raise HotSwapError("warmup", exc) from exc
    t2 = clock()
    old_ver = server.params_version
    t_flip = clock()
    new_ver = server.install_params(new_params)
    # blackout: how long until the engine dispatches on the new version —
    # under load the flip lands between rounds; with no traffic there is
    # nothing to measure and it reports NaN
    blackout_ms = float("nan")
    deadline = time.monotonic() + float(wait_for_dispatch)
    while time.monotonic() < deadline:
        t_first = server.first_dispatch_at(new_ver)
        if t_first is not None:
            blackout_ms = (t_first - t_flip) * 1e3
            break
        time.sleep(_POLL_S)
    # drain: the old version leaves the retired set once its last in-flight
    # round settles (at once, if none was in flight)
    drained = False
    deadline = time.monotonic() + float(drain_timeout)
    while time.monotonic() < deadline:
        if old_ver not in server.retired_versions():
            drained = True
            break
        time.sleep(_POLL_S)
    report = SwapReport(step=int(step), old_version=old_ver, version=new_ver,
                        router_epoch=server.router.epoch,
                        validate_s=t1 - t0, warm_s=t2 - t1, t_flip=t_flip,
                        blackout_ms=blackout_ms, drained_old=drained,
                        metadata=dict(metadata or {}))
    server.telemetry.event("hot_swap", step=int(step), version=new_ver,
                           old_version=old_ver,
                           blackout_ms=blackout_ms, drained=drained)
    return report


# ---------------------------------------------------------------------------
# Streaming graph mutation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FlushReport:
    """One epoch boundary of the mutation stream."""

    epoch: int
    inserted: int
    deleted: int
    dirty_blocks: int
    clean_blocks: int
    n_edges: int
    staleness_s: float         # age of the oldest buffered mutation
    repack_s: float            # incremental re-pack (+ parity, if checked)
    parity_ok: Optional[bool]  # None when the parity check was skipped


class GraphStream:
    """Bounded-staleness edge stream feeding a running cluster server.

    Mutations buffer on a ``DeltaGraphState``; a flush (explicit, or
    automatic when the buffer reaches ``max_pending`` mutations) applies
    them as one epoch: the incremental CSR and chunk re-pack, a bitwise
    parity proof of the CSR and both chunk layouts against the cold pack
    (every ``parity_every``-th epoch; 0 disables it), then one atomic
    sampler swap.  A failed proof raises ``GraphMutationError`` *before*
    the swap: the serving graph never installs an unproven CSR.  A
    mutation the delta state refuses (an out-of-range node, an absent
    edge) raises ``GraphMutationError`` and buffers nothing.
    """

    def __init__(self, server, delta: Optional[DeltaGraphState] = None, *,
                 max_pending: int = 256, parity_every: int = 0):
        if delta is None:
            delta = DeltaGraphState(
                *_csr_to_coo(server.indptr, server.indices),
                server.indptr.shape[0] - 1)
        if delta.n_nodes != server.indptr.shape[0] - 1:
            raise GraphMutationError(
                f"delta graph has {delta.n_nodes} nodes, server "
                f"{server.indptr.shape[0] - 1} — node count is immutable")
        self.server = server
        self.delta = delta
        self.max_pending = int(max_pending)
        self.parity_every = int(parity_every)
        self._t_oldest: Optional[float] = None
        self.flushes: List[FlushReport] = []

    # -- mutation ingress ---------------------------------------------------
    @property
    def pending(self) -> int:
        return self.delta.pending

    def staleness(self) -> float:
        """Seconds the oldest buffered mutation has waited (0 if none) —
        the bounded-staleness observable."""
        if self._t_oldest is None:
            return 0.0
        return max(self.server.clock() - self._t_oldest, 0.0)

    def insert(self, sender: int, receiver: int, weight: float = 1.0):
        try:
            self.delta.insert_edge(sender, receiver, weight)
        except DeltaGraphError as exc:
            raise GraphMutationError(str(exc)) from exc
        self._stamp()
        self._maybe_flush()

    def delete(self, sender: int, receiver: int):
        try:
            self.delta.delete_edge(sender, receiver)
        except DeltaGraphError as exc:
            raise GraphMutationError(str(exc)) from exc
        self._stamp()
        self._maybe_flush()

    def update_features(self, row_ids, rows):
        """Feature-row refresh rides the same plane: rows re-home into the
        server's resident store at once (no epoch buffering: features
        carry no layout to re-pack)."""
        self.server.update_feature_rows(row_ids, rows)

    def _stamp(self):
        if self._t_oldest is None and self.delta.pending > 0:
            self._t_oldest = self.server.clock()

    def _maybe_flush(self):
        if self.delta.pending >= self.max_pending:
            self.flush()

    # -- epoch boundary -----------------------------------------------------
    def flush(self) -> Optional[FlushReport]:
        """Apply the buffered batch as one epoch; no-op on an empty buffer."""
        if self.delta.pending == 0:
            return None
        clock = self.server.clock
        staleness = self.staleness()
        self._t_oldest = None
        t0 = clock()
        res = self.delta.flush()
        indptr, indices = self.delta.csr()
        parity_ok: Optional[bool] = None
        if self.parity_every > 0 and res.epoch % self.parity_every == 0:
            parity_ok = True
            cold_fwd, cold_tr, cold_csr = self.delta.cold_repack()
            # the CSR is what the cluster serves from: each row's order
            # decides the sampler's draws, and the chunk proof is blind to it
            for name, inc, cold in zip(("indptr", "indices"),
                                       (indptr, indices), cold_csr):
                if inc.dtype != cold.dtype or not np.array_equal(inc, cold):
                    raise GraphMutationError(
                        f"epoch {res.epoch}: incremental CSR {name} differs "
                        f"from the cold sort — not installing")
            for inc, cold in zip(self.delta.repack(), (cold_fwd, cold_tr)):
                ok, detail = chunks_match(inc, cold, tol=0.0)
                if not ok:
                    raise GraphMutationError(
                        f"epoch {res.epoch}: incremental re-pack failed "
                        f"parity vs cold pack ({detail}) — not installing")
        t1 = clock()
        self.server.apply_graph_update(indptr, indices, epoch=res.epoch)
        report = FlushReport(epoch=res.epoch, inserted=res.inserted,
                             deleted=res.deleted,
                             dirty_blocks=res.dirty_blocks,
                             clean_blocks=res.clean_blocks,
                             n_edges=res.n_edges, staleness_s=staleness,
                             repack_s=t1 - t0, parity_ok=parity_ok)
        self.flushes.append(report)
        self.server.telemetry.event(
            "graph_flush", epoch=res.epoch, inserted=res.inserted,
            deleted=res.deleted, dirty_blocks=res.dirty_blocks,
            n_edges=res.n_edges, staleness_s=staleness,
            parity_ok=parity_ok)
        return report

    def info(self) -> dict:
        return {"epoch": self.delta.epoch, "pending": self.delta.pending,
                "n_edges": self.delta.n_edges,
                "flushes": len(self.flushes),
                "staleness_s": self.staleness(),
                "chunk_stats": self.delta.chunk_stats()}


def _csr_to_coo(indptr: np.ndarray, indices: np.ndarray):
    """Server CSR (receiver-major) back to (senders, receivers) COO."""
    indptr = np.asarray(indptr)
    receivers = np.repeat(np.arange(indptr.shape[0] - 1, dtype=np.int64),
                          np.diff(indptr))
    return np.asarray(indices, np.int64), receivers
