"""The port's fault injection (``repro_torch.serve.chaos``), slot pools and
retry path against the reference's: the same ``ChaosInjector`` decisions,
bitwise, for the same seed over a grid of sites and counters (its hash is
``sparse.sampler._mix64``, bitwise the reference's ``mix64``), the same
lane-fault schedule and slot bookkeeping; then a port ``GNNServer`` under
chaos — every accepted request settles exactly once, a sampler fault fails
only its request, a transient step fault is retried with the same trees
(equal to replay within 1e-5), and a step that always faults exhausts every
request's retries without a step running."""
import numpy as np
import pytest

from repro.core.drhm import mix64 as jmix64
from repro.serve import chaos as jchaos
from repro.serve import scheduler as jsched
from repro_torch.launch.gnn_serve import build_world
from repro_torch.serve import chaos as tchaos
from repro_torch.serve import scheduler as tsched
from repro_torch.serve import (ChaosInjector, GNNServer,
                               InjectedSamplerFault, LaneFault,
                               offline_replay)
from repro_torch.serve.errors import (DeadlineExceeded, DrainTimeout,
                                      RetriesExhausted, SamplerError)
from repro_torch.sparse.sampler import _mix64


def _assert_exactly_once(reqs, expect_error=None):
    for r in reqs:
        assert r.done and r.n_settles == 1, r.rid
        if expect_error is None:
            assert r.error is None and r.result is not None, r.error
        else:
            assert isinstance(r.error, expect_error), r.error
            assert r.result is None


# ---------------------------------------------------------------------------
# The injector against the reference's
# ---------------------------------------------------------------------------

def test_mix64_is_bitwise_the_reference():
    rng = np.random.default_rng(0)
    z = rng.integers(0, 2 ** 63, 10_000, dtype=np.int64).view(np.uint64)
    z[::2] |= np.uint64(1 << 63)
    z[:4] = [0, 2 ** 64 - 1, 2 ** 63, 0x9E3779B97F4A7C15]
    assert np.array_equal(_mix64(z), jmix64(z))
    for v in z[:64]:
        assert _mix64(np.uint64(v)) == jmix64(np.uint64(v))


@pytest.mark.parametrize("p", [0.0, 0.05, 0.2, 0.5, 1.0])
def test_hash_decisions_equal_the_reference(p):
    for seed in (0, 1, 7, 2 ** 32 + 5, 2 ** 40 - 1):
        for site in (1, 2, 3):
            got = [tchaos._hash_p(seed, site, c, p) for c in range(0, 3000,
                                                                   7)]
            assert got == [jchaos._hash_p(seed, site, c, p)
                           for c in range(0, 3000, 7)]
            if 0.0 < p < 1.0:
                assert 0 < sum(got) < len(got)


class _Req:
    def __init__(self, rid):
        self.rid = rid


def _decisions(mod, seed):
    ch = mod.ChaosInjector(seed, p_step_fault=0.2, p_sampler_fault=0.1,
                           step_fault_rounds=(3, 40),
                           sampler_fault_rids=(5, 6))
    steps = [ch.step_fault(r) for r in range(1, 400)]
    sampled = []
    for rid in range(400):
        try:
            ch.sampler_hook(_Req(rid))
            sampled.append(False)
        except RuntimeError as exc:
            assert type(exc).__name__ == "InjectedSamplerFault"
            assert exc.rid == rid
            sampled.append(True)
    return steps, sampled, ch.info()


@pytest.mark.parametrize("seed", [0, 3, 123456789])
def test_injector_decisions_equal_the_reference(seed):
    got = _decisions(tchaos, seed)
    assert got == _decisions(jchaos, seed)
    steps, sampled, info = got
    assert steps[2] and steps[39] and sampled[5] and sampled[6]
    assert info["injected"]["step"] == sum(steps)


def test_lane_faults_follow_the_reference():
    """Kill (blocked until acknowledged) and stall (self-recovers after its
    duration), round by round on a virtual clock."""
    def run(mod):
        t = {"now": 0.0}
        ch = mod.ChaosInjector(
            lane_faults=[mod.LaneFault(lane=1, at_round=2),
                         mod.LaneFault(lane=0, kind="stall", duration=1.0,
                                       at_round=1)],
            clock=lambda: t["now"])
        out = []
        for rnd in range(8):
            t["now"] = 0.4 * rnd
            out.append((ch.blocked(0, rnd), ch.blocked(1, rnd),
                        ch.blocked(2, rnd)))
            if rnd == 5:
                ch.on_lane_dead(1)
        return out, ch.info(), ch.triggered_wall_times()
    got = run(tchaos)
    assert got == run(jchaos)
    assert got[0][2][1] and not got[0][6][1]       # killed, then restarted
    with pytest.raises(ValueError, match="lane-fault kind"):
        LaneFault(lane=0, kind="meteor")


def test_scripted_faults_fire_exactly_where_scheduled():
    ch = ChaosInjector(step_fault_rounds=(3, 5))
    assert [ch.step_fault(r) for r in range(1, 7)] == \
        [False, False, True, False, True, False]
    with pytest.raises(InjectedSamplerFault):
        ChaosInjector(sampler_fault_rids=(9,)).sampler_hook(_Req(9))


def _pool_script(mod):
    """A seeded run of acquire/release on a SlotPool and LaneSlotPools."""
    rng = np.random.default_rng(4)
    pool = mod.SlotPool(4)
    lanes = mod.LaneSlotPools(3, 2)
    out = []
    held = []
    for k in range(200):
        if rng.random() < 0.55:
            slot = pool.acquire(f"r{k}")
            out.append(("acq", slot))
            if slot is not None:
                held.append(slot)
        elif held:
            slot = held.pop(int(rng.integers(len(held))))
            out.append(("rel", pool.release(slot)))
        lane = int(rng.integers(3))
        if lanes.can_dispatch(lane):
            out.append(("lane", lane, lanes.acquire(lane, k)))
        else:
            occupied = lanes.pools[lane].live()
            out.append(("lane_rel", lanes.release(lane, occupied[0][0])))
        out.append((pool.free_count, pool.live(), lanes.depths(),
                    [lanes.idle(i) for i in range(3)]))
    return out


def test_slot_pools_follow_the_reference():
    assert _pool_script(tsched) == _pool_script(jsched)
    pool = tsched.SlotPool(1)
    pool.acquire("a")
    assert pool.release(0) == "a"
    with pytest.raises(ValueError):
        pool.release(0)
    with pytest.raises(ValueError):
        tsched.SlotPool(0)
    lanes = tsched.LaneSlotPools(1, 1)
    lanes.acquire(0, "x")
    with pytest.raises(RuntimeError):
        lanes.acquire(0, "y")


# ---------------------------------------------------------------------------
# The engine under chaos
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    return build_world(256, 1024, 8, seed=0, device="cpu", arch="sage")


def _server(world, **kw):
    cfg, params, indptr, indices, store = world
    kw.setdefault("fanouts", (2, 2))
    kw.setdefault("backend", "cuda")
    kw.setdefault("max_batch_seeds", 4)
    return GNNServer("sage", cfg, params, indptr, indices, store,
                     device="cpu", **kw)


def test_sampler_fault_isolated_and_typed(world):
    chaos = ChaosInjector(sampler_fault_rids=(2,))
    with _server(world, chaos=chaos) as srv:
        reqs = [srv.submit([i % 256]) for i in range(8)]
        srv.drain(timeout=120)
        bad = [r for r in reqs if r.rid == 2]
        _assert_exactly_once(bad, expect_error=SamplerError)
        _assert_exactly_once([r for r in reqs if r.rid != 2])
        assert bad[0].error.rid == 2
        assert isinstance(bad[0].error.__cause__, InjectedSamplerFault)
        more = [srv.submit([i % 256]) for i in range(8)]
        srv.drain(timeout=120)
        _assert_exactly_once(more)


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_transient_step_faults_retried_with_the_same_trees(world, sampler):
    chaos = ChaosInjector(5, p_step_fault=0.3)
    with _server(world, chaos=chaos, max_retries=1, sampler=sampler,
                 tracing=True) as srv:
        srv.warmup()
        reqs = [srv.submit([(5 * i) % 256]) for i in range(48)]
        srv.drain(timeout=120)
        assert chaos.injected["step"] >= 1
        for r in reqs:
            assert r.done and r.n_settles == 1
            if r.error is None:
                np.testing.assert_allclose(offline_replay(srv, r), r.result,
                                           rtol=0, atol=1e-5)
            else:
                assert isinstance(r.error, RetriesExhausted)
                assert r.attempts == 2
        assert any(r.attempts and r.error is None for r in reqs)
        assert srv.stats()["n_served"] == sum(r.error is None for r in reqs)


def test_every_step_faulting_exhausts_retries_typed(world):
    chaos = ChaosInjector(p_step_fault=1.0)
    with _server(world, chaos=chaos, max_retries=1) as srv:
        reqs = [srv.submit([i % 256]) for i in range(16)]
        srv.drain(timeout=120)
        _assert_exactly_once(reqs, expect_error=RetriesExhausted)
        assert all(r.attempts == 2 for r in reqs)
        stats = srv.stats()
        # a faulted round launches nothing: no step was built or run
        assert stats["n_batches"] == 0 and stats["recompiles"] == 0


def test_deadline_exceeded_is_typed_and_reaped(world):
    # four one-seed requests do not fill a bucket of 16: the reaper runs
    # before the batcher's 40 ms deadline trigger
    with _server(world, max_wait_ms=40.0, max_batch_seeds=16) as srv:
        reqs = [srv.submit([i], deadline_ms=0.01) for i in range(4)]
        srv.drain(timeout=120)
        _assert_exactly_once(reqs, expect_error=DeadlineExceeded)
        assert all(isinstance(r.error, TimeoutError) for r in reqs)


def test_drain_timeout_fails_stragglers_typed_then_close_is_safe(world):
    """Requests retried for ever never settle on their own: the drain
    deadline fails them with ``DrainTimeout``, and the close that follows
    settles nothing twice."""
    chaos = ChaosInjector(p_step_fault=1.0)
    srv = _server(world, chaos=chaos, max_retries=10 ** 9)
    reqs = [srv.submit([i % 256]) for i in range(8)]
    with pytest.raises(DrainTimeout) as ei:
        srv.drain(timeout=0.3)
    assert ei.value.n_pending == len(reqs)
    assert sorted(ei.value.rids) == [r.rid for r in reqs]
    srv.close()
    srv.close()                                    # idempotent
    _assert_exactly_once(reqs, expect_error=DrainTimeout)
