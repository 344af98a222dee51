"""The port's live mutation plane (``repro_torch.serve.live``) on a
running ``ClusterServer(device="cpu")``, and against the reference's:

* the counterparts of the ten replicated tests of
  ``tests/test_live_mutation.py``: three hot-swaps under load with every
  request settled once on one version and the old versions drained; the
  router epoch flip; torn, shape-mismatched and missing checkpoints as
  typed aborts with the server untouched; streaming edge mutations
  installed only after their parity proof (a CSR row planted out of
  order is refused, though the chunk layouts match), stamped per request and
  replayed on the mutated graph; the bounded-staleness window; rejected
  mutations; the immutable node count; feature rows re-homed;
* across packages: the same world, the same perturbed checkpoints
  (carried over by ``convert.gcn_params_from_jax``), request stream and
  mutation script give equal flush counts and, for the requests settled
  on the final version and epoch in both, results within 1e-5;
* ``gnn_serve --replicas 2 --swap-versions 3 --mutate-edges 64`` exits 0;
* the replay filter: a request sampled before a flush is not replayed
  (its replay on the mutated graph would not reproduce it).
"""
import contextlib
import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.launch import gnn_serve as jlaunch
from repro.serve import ClusterServer as JClusterServer
from repro.serve import GraphStream as JGraphStream
from repro.serve import hot_swap as jhot_swap
from repro_torch import convert
from repro_torch.checkpoint import store as ckpt_store
from repro_torch.launch import gnn_serve as tlaunch
from repro_torch.launch.gnn_serve import (build_world, live_replayable,
                                          perturbed)
from repro_torch.models.gnn import gcn as tgcn
from repro_torch.serve import (ClusterServer, GraphMutationError,
                               GraphStream, HotSwapError, hot_swap)
from repro_torch.serve import compute as tcompute
from repro_torch.serve.live import _csr_to_coo
from repro_torch.sparse.delta import chunks_match

CPU = "cpu"
N_NODES, N_EDGES, D_IN = 256, 2048, 16
TOL = 1e-5
WAIT = 1.0          # seconds a swap waits for a post-flip dispatch
STALL = 60.0        # seconds before a lane with queued work counts as dead


def _server(**kw):
    cfg, params, indptr, indices, store = build_world(N_NODES, N_EDGES, D_IN,
                                                      0, CPU)
    kw.setdefault("n_lanes", 2)
    srv = ClusterServer("gcn", cfg, params, indptr, indices, store, seed=0,
                        device=CPU, **kw)
    srv.warmup([1, 2])
    return srv, params, indptr, indices


def _submit_load(srv, rng, n=24):
    return srv.submit_many(
        [rng.integers(0, N_NODES, size=2) for _ in range(n)])


# ---------------------------------------------------------------------------
# Hot swap
# ---------------------------------------------------------------------------

def test_three_swaps_under_load_exactly_once(tmp_path):
    """Three consecutive swaps with traffic in flight: every request
    settles exactly once on exactly one version, nothing lost."""
    srv, params, _, _ = _server(backend="cuda")
    rng = np.random.default_rng(0)
    all_reqs = []
    try:
        for k in (1, 2, 3):
            ckpt_store.save(tmp_path, k, perturbed(params, k), {"cycle": k})
        for k in (1, 2, 3):
            all_reqs += _submit_load(srv, rng)
            rep = hot_swap(srv, tmp_path, step=k, drain_timeout=60.0,
                           wait_for_dispatch=WAIT)
            assert rep.version == k and rep.old_version == k - 1
            assert rep.drained_old, "old version never drained"
            assert rep.metadata == {"cycle": k}
            all_reqs += _submit_load(srv, rng)
        srv.drain()
    finally:
        srv.close()
    assert len(all_reqs) == 6 * 24
    for r in all_reqs:
        assert r.n_settles == 1, f"rid {r.rid} settled {r.n_settles}×"
        assert r.error is None and r.result is not None
        assert r.params_version is not None
        assert 0 <= r.params_version <= 3
    assert srv.retired_versions() == []
    assert srv.params_version == 3


def test_swap_flips_router_epoch_and_results_change(tmp_path):
    srv, params, _, _ = _server()
    rng = np.random.default_rng(1)
    try:
        seeds = rng.integers(0, N_NODES, size=2)
        before = srv.submit(seeds).wait(30)
        epoch0 = srv.router.epoch
        ckpt_store.save(tmp_path, 5, perturbed(params, 9))
        rep = hot_swap(srv, tmp_path, wait_for_dispatch=WAIT)
        assert rep.step == 5
        assert srv.router.epoch == epoch0 + 1      # the epoch boundary
        after = srv.submit(seeds).wait(30)
        assert np.max(np.abs(after - before)) > 0  # new weights serve
        req = srv.submit(seeds)
        req.wait(30)
        np.testing.assert_allclose(srv.offline_replay(req), req.result,
                                   atol=TOL)
    finally:
        srv.close()


def test_torn_checkpoint_aborts_swap_with_server_untouched(tmp_path):
    srv, params, _, _ = _server(n_lanes=1)
    try:
        step_dir = tmp_path / "step_000002"
        step_dir.mkdir(parents=True)
        (step_dir / "manifest.json").write_text("{}")   # no COMMIT
        with pytest.raises(HotSwapError) as ei:
            hot_swap(srv, tmp_path, step=2)
        assert ei.value.stage == "validate"
        assert srv.params_version == 0
        assert srv.retired_versions() == []
        # a shape-mismatched tree also aborts before the flip
        bad = {k: {n: torch.zeros(3, 3) for n in v}
               for k, v in params.items()}
        ckpt_store.save(tmp_path, 3, bad)
        with pytest.raises(HotSwapError):
            hot_swap(srv, tmp_path, step=3)
        assert srv.params_version == 0
        srv.submit(np.array([1, 2])).wait(30)       # still serves
    finally:
        srv.close()


def test_no_checkpoint_is_a_typed_abort(tmp_path):
    srv, _, _, _ = _server(n_lanes=1)
    try:
        with pytest.raises(HotSwapError) as ei:
            hot_swap(srv, tmp_path / "empty")
        assert ei.value.stage == "resolve"
    finally:
        srv.close()


def test_install_params_rejects_stale_version():
    srv, params, _, _ = _server(n_lanes=1)
    try:
        srv.install_params(perturbed(params, 1), version=4)
        with pytest.raises(ValueError):
            srv.install_params(params, version=4)
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# Streaming graph mutation
# ---------------------------------------------------------------------------

def test_graph_stream_parity_and_epoch_stamping():
    srv, _, indptr, indices = _server(backend="cuda")
    rng = np.random.default_rng(2)
    try:
        gs = GraphStream(srv, max_pending=64, parity_every=1)
        # the reconstructed delta state starts bitwise at the serving CSR
        np.testing.assert_array_equal(gs.delta.csr()[0], indptr)
        np.testing.assert_array_equal(gs.delta.csr()[1], indices)
        s0, r0 = _csr_to_coo(indptr, indices)
        for i in range(40):
            gs.insert(int(rng.integers(0, N_NODES)),
                      int(rng.integers(0, N_NODES)))
            if i % 4 == 0:
                gs.delete(int(s0[i]), int(r0[i]))
        rep = gs.flush()
        assert rep is not None and rep.parity_ok is True
        assert rep.inserted == 40 and rep.deleted == 10
        # requests sampled after the flush carry the new epoch and replay
        # offline (the sampler and the offline path share the swapped CSR)
        reqs = _submit_load(srv, rng, n=8)
        srv.drain()
        for r in reqs:
            assert r.error is None and r.graph_epoch == rep.epoch
        np.testing.assert_allclose(srv.offline_replay(reqs[0]),
                                   reqs[0].result, atol=TOL)
    finally:
        srv.close()


def test_graph_stream_refuses_a_reordered_csr_row(monkeypatch):
    # a planted fault the chunk proof is blind to: two senders of one row
    # swapped in the incremental CSR after the flush's re-pack
    srv, _, _, _ = _server(n_lanes=1)
    try:
        gs = GraphStream(srv, parity_every=1)
        delta, real_flush = gs.delta, gs.delta.flush
        served = (srv.indptr, srv.indices)

        def flush_then_reorder():
            res = real_flush()
            fwd = delta._fwd
            for row in range(delta.n_nodes):
                seg = fwd.sorted_cols[fwd.indptr[row]:fwd.indptr[row + 1]]
                other = np.nonzero(seg != seg[0])[0] if seg.size else []
                if len(other):
                    seg[[0, other[0]]] = seg[[other[0], 0]]
                    return res
            raise AssertionError("no row with two distinct senders")

        monkeypatch.setattr(delta, "flush", flush_then_reorder)
        gs.insert(3, 7)
        with pytest.raises(GraphMutationError, match="CSR indices"):
            gs.flush()
        # both layouts still match the cold pack: only the CSR proof saw it
        for inc, cold in zip(delta.repack(), delta.cold_repack()[:2]):
            assert chunks_match(inc, cold, tol=0.0)[0]
        assert srv.indptr is served[0] and srv.indices is served[1]
        assert not gs.flushes
    finally:
        srv.close()


def test_graph_stream_bounded_staleness_autoflush():
    srv, _, _, _ = _server(n_lanes=1)
    try:
        gs = GraphStream(srv, max_pending=4)
        for i in range(3):
            gs.insert(i, i + 1)
        assert gs.pending == 3 and not gs.flushes     # window open
        gs.insert(3, 4)                               # trips max_pending
        assert gs.pending == 0 and len(gs.flushes) == 1
        assert gs.staleness() == 0.0
    finally:
        srv.close()


def _has_edge(srv, s, r):
    lo, hi = srv.indptr[r], srv.indptr[r + 1]
    return bool(np.any(np.asarray(srv.indices[lo:hi]) == s))


def test_graph_stream_rejects_bad_mutations():
    srv, _, _, _ = _server(n_lanes=1)
    try:
        gs = GraphStream(srv)
        with pytest.raises(ValueError):               # GraphMutationError
            gs.insert(N_NODES + 7, 0)
        absent = next((s, r) for r in range(N_NODES) for s in range(N_NODES)
                      if not _has_edge(srv, s, r))
        with pytest.raises(GraphMutationError):
            gs.delete(*absent)
        assert gs.pending == 0
    finally:
        srv.close()


def test_node_count_is_immutable():
    srv, _, indptr, indices = _server(n_lanes=1)
    try:
        with pytest.raises(ValueError):
            srv.apply_graph_update(np.asarray(indptr)[:-1],
                                   np.asarray(indices))
    finally:
        srv.close()


def test_feature_rehome_replicated():
    srv, _, _, _ = _server(n_lanes=1)
    rng = np.random.default_rng(3)
    try:
        seeds = np.array([7, 7])
        before = srv.submit(seeds).wait(30)
        rows = np.unique(rng.integers(0, N_NODES, 32).astype(np.int64))
        new = rng.normal(size=(rows.size, D_IN)).astype(np.float32)
        GraphStream(srv).update_features(rows, new)
        assert torch.equal(srv.store.x[torch.from_numpy(rows)],
                           torch.from_numpy(new))
        req = srv.submit(seeds)
        req.wait(30)
        # offline replay (rebuilt over the patched store) still matches
        np.testing.assert_allclose(srv.offline_replay(req), req.result,
                                   atol=TOL)
        assert np.max(np.abs(req.result - before)) >= 0.0
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# Against the reference's plane
# ---------------------------------------------------------------------------

def _mutation_script(indptr, indices, seed=4):
    """Three epochs of (inserts, deletes of original edges)."""
    rng = np.random.default_rng(seed)
    s0, r0 = _csr_to_coo(indptr, indices)
    pick = rng.choice(s0.size, 3 * 6, replace=False)
    return [([(int(rng.integers(0, N_NODES)), int(rng.integers(0, N_NODES)))
              for _ in range(20)],
             [(int(s0[k]), int(r0[k])) for k in pick[6 * e:6 * (e + 1)]])
            for e in range(3)]


def _drive(srv, swap, stream, ckpt_dir, script, streams):
    """Per epoch: a burst, a swap under it, the epoch's mutations and a
    flush; then a last burst on the final version and epoch."""
    reqs, flushes = [], []
    for k, (ins, dels) in enumerate(script, start=1):
        reqs += srv.submit_many(streams[k - 1])
        swap(srv, ckpt_dir, step=k, wait_for_dispatch=WAIT,
             drain_timeout=60.0)
        for s, r in ins:
            stream.insert(s, r)
        for s, r in dels:
            stream.delete(s, r)
        flushes.append(stream.flush())
    reqs += srv.submit_many(streams[-1])
    srv.drain(timeout=120)
    return reqs, flushes


def test_live_mutation_matches_reference(tmp_path):
    jcfg, jparams, indptr, indices, jst = jlaunch.build_world(
        "gcn", N_NODES, N_EDGES, D_IN, 0)
    tcfg = tgcn.GCNConfig(**{f: getattr(jcfg, f)
                             for f in tgcn.GCNConfig.__dataclass_fields__})
    host = jax.tree.map(np.asarray, jparams)
    tparams = convert.gcn_params_from_jax(host, device=CPU)
    tst = tcompute.FeatureStore.build(N_NODES, np.asarray(jst.x)[:-1],
                                      device=CPU)
    for k in (1, 2, 3):
        jk = jax.tree.map(lambda a, _k=k: a * (1.0 + 0.01 * _k), host)
        jstore.save(tmp_path / "jax", k, jk, {"cycle": k})
        ckpt_store.save(tmp_path / "torch", k,
                        convert.gcn_params_from_jax(jk, device=CPU),
                        {"cycle": k})
    script = _mutation_script(indptr, indices)
    rng = np.random.default_rng(5)
    streams = [[rng.integers(0, N_NODES, size=2) for _ in range(12)]
               for _ in range(4)]
    # both clusters take the same stall timeout, past any dispatch here:
    # under a loaded suite, a lane's first round on a new version or epoch
    # (the reference recompiles its step) ran past the default 1 s, and the
    # reference's supervisor declared both its lanes dead
    # ("stalled-heartbeat"), failing every queued request with LaneFailure
    kw = dict(n_lanes=2, seed=0, backend="dense", stall_timeout=STALL)
    out = {}
    for name, srv, swap, stream_cls in (
            ("jax", JClusterServer("gcn", jcfg, jparams, indptr, indices,
                                   jst, **kw), jhot_swap, JGraphStream),
            ("torch", ClusterServer("gcn", tcfg, tparams, indptr, indices,
                                    tst, device=CPU, **kw), hot_swap,
             GraphStream)):
        with srv:
            srv.warmup([1, 2])
            stream = stream_cls(srv, max_pending=1024, parity_every=1)
            reqs, flushes = _drive(srv, swap, stream, tmp_path / name,
                                   script, streams)
            assert all(r.n_settles == 1 and r.error is None for r in reqs)
            assert srv.params_version == 3 and srv.retired_versions() == []
            out[name] = (reqs, flushes, srv.indptr.copy(),
                         srv.indices.copy())
    (jreqs, jfl, jip, jix), (treqs, tfl, tip, tix) = out["jax"], out["torch"]
    counts = ("epoch", "inserted", "deleted", "dirty_blocks", "clean_blocks",
              "n_edges", "parity_ok")
    assert ([{f: getattr(f_, f) for f in counts} for f_ in tfl]
            == [{f: getattr(f_, f) for f in counts} for f_ in jfl])
    assert np.array_equal(tip, jip) and np.array_equal(tix, jix)
    final = {r.rid: r for r in jreqs
             if r.params_version == 3 and r.graph_epoch == 3}
    both = [r for r in treqs if r.rid in final
            and r.params_version == 3 and r.graph_epoch == 3]
    assert len(both) >= 12                     # the last burst at least
    for r in both:
        np.testing.assert_allclose(r.result, final[r.rid].result, rtol=0,
                                   atol=TOL)


def test_launcher_live_mutation_exits_zero():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tlaunch.main(["--device", "cpu", "--replicas", "2",
                           "--swap-versions", "3", "--mutate-edges", "64",
                           "--requests", "96", "--nodes", str(N_NODES),
                           "--edges", str(N_EDGES), "--d-in", "8"])
    text = buf.getvalue()
    assert rc == 0, text
    assert "live mutation: 3 swap(s) -> v3" in text and "parity=OK" in text
    assert "offline replay parity" in text


def test_replay_filter_drops_requests_sampled_before_a_flush():
    """``offline_replay`` re-samples on the current graph: a request
    sampled before a flush that rewired its seed replays to another
    result, so the launcher's filter keeps only the last epoch's."""
    srv, _, indptr, indices = _server(n_lanes=1)
    seed = int(np.argmax(np.diff(indptr)))          # the busiest row
    try:
        before = srv.submit([seed])
        srv.drain()
        gs = GraphStream(srv, parity_every=1)
        lo, hi = indptr[seed], indptr[seed + 1]
        for s in np.unique(indices[lo:hi]):         # rewire every in-edge
            for _ in range(int(np.sum(indices[lo:hi] == s))):
                gs.delete(int(s), seed)
        for s in range(8):
            gs.insert((seed + 1 + s) % N_NODES, seed)
        flushes = [gs.flush()]
        after = srv.submit([seed])
        srv.drain()
        assert (before.graph_epoch, after.graph_epoch) == (0, 1)
        assert live_replayable([before, after], srv, flushes) == [after]
        assert live_replayable([before, after], srv, []) == [before, after]
        np.testing.assert_allclose(srv.offline_replay(after), after.result,
                                   atol=TOL)
        assert np.abs(srv.offline_replay(before) - before.result).max() > TOL
    finally:
        srv.close()


def test_flush_report_fields_equal_reference_dataclass():
    from repro.serve import live as jlive
    from repro_torch.serve import live as tlive
    for name in ("FlushReport", "SwapReport"):
        assert ([f.name for f in dataclasses.fields(getattr(tlive, name))]
                == [f.name for f in dataclasses.fields(getattr(jlive,
                                                               name))])
