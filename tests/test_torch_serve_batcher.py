"""The port's request and data planes: ``pack_fifo`` equal to the
reference's in both modes (skip-ahead and strict FIFO), the dynamic
batcher on a virtual clock, exactly-once settlement, sampler-failure
isolation and deadline/drain failures."""
import threading

import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # deterministic fallback; requirements-dev.txt has the real one
    from _hypothesis_shim import given, settings, st

from repro.serve.scheduler import pack_fifo as jpack
from repro_torch.configs.gcn_cora import reduced
from repro_torch.data.synthetic import powerlaw_graph
from repro_torch.models.gnn import gcn
from repro_torch.serve import (DeadlineExceeded, DynamicBatcher, FeatureStore,
                               GNNServer, SamplerError, SamplerPool,
                               ServeRequest, offline_replay)
from repro_torch.serve.scheduler import pack_fifo
from repro_torch.sparse.graph import coo_to_csr


class Clock:
    """Virtual clock for the batcher alone (the engine needs real time)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _req(rid, k=1, deadline=None):
    return ServeRequest(rid=rid, seeds=np.arange(k), deadline=deadline)


@given(st.lists(st.integers(1, 6), min_size=0, max_size=20),
       st.integers(1, 16))
@settings(max_examples=40, deadline=None)
def test_pack_fifo_equals_reference(sizes, capacity):
    items = list(range(len(sizes)))
    got = pack_fifo(items, capacity, size_of=lambda i: sizes[i])
    want = jpack(items, capacity, size_of=lambda i: sizes[i])
    assert got == want


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("skip_ahead", [True, False])
def test_pack_fifo_modes_equal_reference_on_traces(skip_ahead, seed):
    """Seeded traces of request sizes (1-12, a few oversized against the
    capacity) packed by the port and by the reference, in skip-ahead and
    strict FIFO mode: equal ``taken``, ``remaining`` and ``used``; strict
    FIFO takes a prefix of the trace."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 13, int(rng.integers(0, 40))).tolist()
    items = list(range(len(sizes)))
    for capacity in (1, 7, 16, 64):
        got = pack_fifo(items, capacity, size_of=lambda i: sizes[i],
                        skip_ahead=skip_ahead)
        want = jpack(items, capacity, size_of=lambda i: sizes[i],
                     skip_ahead=skip_ahead)
        assert got == want
        if not skip_ahead:
            assert got[0] == items[:len(got[0])]


def test_pack_fifo_strict_stops_at_the_first_misfit():
    """``test_serve_batcher.py::test_pack_fifo_skip_ahead`` on the port."""
    sizes = {"a": 10, "b": 9, "c": 3, "d": 2}
    taken, rest, used = pack_fifo(list("abcd"), 16, size_of=sizes.get)
    assert taken == ["a", "c", "d"] and rest == ["b"] and used == 15
    taken, rest, used = pack_fifo(list("abcd"), 16, size_of=sizes.get,
                                  skip_ahead=False)
    assert taken == ["a"] and rest == ["b", "c", "d"] and used == 10


def test_batcher_size_and_deadline_triggers():
    clock = Clock()
    b = DynamicBatcher(4, max_wait=0.010, clock=clock)
    b.submit(_req(0, 3))
    assert b.poll() is None                      # 3 < 4 seeds, not old
    b.submit(_req(1, 2))                         # 5 ≥ 4: size trigger
    batch = b.poll()
    assert [r.rid for r in batch] == [0]         # 3 + 2 > 4: rid 1 waits
    assert b.poll() is None
    clock.t = 0.011                              # oldest waited 11 ms
    assert [r.rid for r in b.poll()] == [1]
    with pytest.raises(ValueError):
        b.submit(_req(2, 5))
    assert b.info()["batches"] == 2 and b.info()["depth"] == 0


def test_batcher_reaps_expired_and_flushes():
    clock = Clock()
    b = DynamicBatcher(8, max_wait=1.0, clock=clock)
    b.submit(_req(0, deadline=0.5))
    b.submit(_req(1))
    assert b.reap_expired(0.4) == []
    assert [r.rid for r in b.reap_expired(0.5)] == [0]
    assert [[r.rid for r in batch] for batch in b.flush()] == [[1]]
    assert b.info()["expired"] == 1


def test_request_settles_exactly_once():
    r = _req(0)
    assert r.finish(np.ones(2), 1.0)
    assert not r.fail(RuntimeError("late"), 2.0)
    assert r.n_settles == 1 and r.error is None and r.wait(0) is r.result
    e = _req(1)
    assert e.fail(DeadlineExceeded(1, 0.0, 1.0), 1.0)
    with pytest.raises(DeadlineExceeded):
        e.wait(0)


def test_sampler_pool_isolates_a_failing_request():
    s, r = powerlaw_graph(50, 200, seed=0)
    indptr, indices, _ = coo_to_csr(s, r, 50)
    ready, failed, done = [], [], threading.Event()

    def on_ready(req):
        ready.append(req.rid)
        if len(ready) + len(failed) == 3:
            done.set()

    def on_error(reqs, exc):
        failed.extend(r.rid for r in reqs)
        if len(ready) + len(failed) == 3:
            done.set()

    pool = SamplerPool(indptr, indices, (2, 2), 0, on_ready=on_ready,
                       on_error=on_error, n_workers=1)
    pool.submit(ServeRequest(rid=0, seeds=np.array([1])))
    pool.submit(ServeRequest(rid=1, seeds=np.array([10 ** 6])))  # bad
    pool.submit(ServeRequest(rid=2, seeds=np.array([3, 4])))
    pool.close(timeout=30)
    assert done.wait(30)
    assert sorted(ready) == [0, 2] and failed == [1]


def _server(**kw):
    s, r = powerlaw_graph(200, 900, seed=1)
    indptr, indices, _ = coo_to_csr(s, r, 200)
    cfg = reduced()
    x = np.random.default_rng(0).normal(size=(200, cfg.d_in)).astype(
        np.float32)
    params = gcn.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    return GNNServer("gcn", cfg, params, indptr, indices,
                     FeatureStore.build(200, x, device="cpu"),
                     fanouts=(3, 2), backend="cuda", max_batch_seeds=8,
                     device="cpu", **kw)


@pytest.fixture
def server():
    srv = _server()
    yield srv
    srv.close()


def test_multi_seed_requests_match_offline_replay(server):
    server.warmup()
    rng = np.random.default_rng(4)
    reqs = [server.submit(rng.integers(0, 200, k)) for k in (1, 3, 8, 2, 5)]
    server.drain()
    for r in reqs:
        assert r.result.shape == (r.n_seeds, 4)
        np.testing.assert_allclose(r.result, offline_replay(server, r),
                                   rtol=0, atol=1e-5)


def test_expired_requests_fail_typed():
    # a batch only ripens after 10 s, so the engine reaps the request,
    # whose deadline passed at submit, instead of serving it
    with _server(max_wait_ms=10_000.0) as srv:
        req = srv.submit([1], deadline_ms=-1.0)
        srv.drain(timeout=30)
        with pytest.raises(DeadlineExceeded):
            req.wait(0)
        assert srv.stats()["deadline_failed"] == 1


def test_sampler_errors_are_typed_and_submit_after_close_raises(server):
    server._sampler.indptr = None                  # every sample now fails
    req = server.submit([1])
    server.drain(timeout=30)
    with pytest.raises(SamplerError):
        req.wait(0)
    server.close()
    with pytest.raises(RuntimeError, match="closed"):
        server.submit([1])
