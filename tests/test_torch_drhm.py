"""The port's DRHM (``repro_torch.core.drhm``) against the reference's
``repro.core.drhm``: the host functions bit for bit, the torch hashes
(int64 with the low 32 bits kept) equal to the reference's uint32
wraparound, the maps and balance statistics equal on seeded tags, and the
counterparts of ``tests/test_drhm.py``'s properties."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # deterministic fallback; requirements-dev.txt has the real one
    from _hypothesis_shim import given, settings, st

from repro.core import drhm as jd
from repro_torch.core import drhm as td


def _tags(seed, n=4096, low=-2 ** 31, high=2 ** 31):
    rng = np.random.default_rng(seed)
    t = rng.integers(low, high, n, dtype=np.int64).astype(np.int32)
    t[:6] = [0, 1, -1, 2 ** 31 - 1, -2 ** 31, 65535]
    return t


GAMMAS = (1, 3, 0x9E3779B1, 2 ** 32 - 1, 2654435761, 77, 2 ** 31 + 5)


# ---------------------------------------------------------------------------
# host functions, bit for bit
# ---------------------------------------------------------------------------

def test_mix64_and_route_gamma_equal_reference():
    rng = np.random.default_rng(0)
    z = rng.integers(0, 2 ** 63, 5000, dtype=np.int64).view(np.uint64)
    z[::3] |= np.uint64(1 << 63)
    z[:3] = [0, 2 ** 64 - 1, 0x9E3779B97F4A7C15]
    assert np.array_equal(td.mix64(z), jd.mix64(z))
    assert td.mix64(z).dtype == jd.mix64(z).dtype
    for seed in (0, 1, 7, 2 ** 32 + 3, 12345):
        for epoch in range(40):
            assert td.route_gamma(seed, epoch) == jd.route_gamma(seed, epoch)


@pytest.mark.parametrize("n_bins,n_lanes,seed,epoch",
                         [(1024, 4, 0, 0), (1024, 8, 3, 5), (1000, 3, 1, 2),
                          (7, 8, 2, 1), (256, 1, 9, 0)])
def test_plan_request_routing_equals_reference(n_bins, n_lanes, seed, epoch):
    a = td.plan_request_routing(n_bins, n_lanes, seed, epoch)
    b = jd.plan_request_routing(n_bins, n_lanes, seed, epoch)
    assert (a.gamma, a.n_ids, a.n_pad, a.n_shards) == \
        (b.gamma, b.n_ids, b.n_pad, b.n_shards)
    assert np.array_equal(a.perm, b.perm) and a.perm.dtype == b.perm.dtype
    assert np.array_equal(a.inv_perm, b.inv_perm)
    ids = np.arange(a.n_pad)
    assert np.array_equal(a.owner_of(ids), b.owner_of(ids))
    assert np.array_equal(a.slot_of(ids), b.slot_of(ids))


@pytest.mark.parametrize("n_ids,n_shards,gamma",
                         [(10_000, 16, 0x9E3779B1), (999, 7, 6), (12, 16, 4),
                          (4096, 8, 2 ** 32 - 2)])
def test_plan_row_sharding_equals_reference(n_ids, n_shards, gamma):
    a = td.plan_row_sharding(n_ids, n_shards, gamma)
    b = jd.plan_row_sharding(n_ids, n_shards, gamma)
    assert (a.gamma, a.n_pad, a.rows_per_shard) == \
        (b.gamma, b.n_pad, b.rows_per_shard)
    assert np.array_equal(a.perm, b.perm)
    assert np.array_equal(a.inv_perm, b.inv_perm)


def test_permutation_coprime_gamma_and_inverse_equal_reference():
    for n in (1, 2, 5, 64, 255, 256, 1000, 4096, 3 * 5 * 7 * 11 * 13):
        for seed in range(7):
            assert td.coprime_gamma(n, seed) == jd.coprime_gamma(n, seed)
        g = td.coprime_gamma(n, 1)
        p = td.drhm_permutation(n, g)
        assert np.array_equal(p, jd.drhm_permutation(n, g))
        assert np.array_equal(td.invert_permutation(p),
                              jd.invert_permutation(p))


def test_bin_balance_snapshot_equals_reference_and_records_when_loaded():
    a = np.random.default_rng(1).integers(0, 32, 5000)
    assert td.bin_balance_snapshot(a, 32) == jd.bin_balance_snapshot(a, 32)
    assert td.bin_balance_snapshot([], 4)["max"] == 0
    from repro_torch.sparse import stats
    assert sys.modules.get("repro_torch.sparse.stats") is stats
    stats.reset()
    td.bin_balance_snapshot(a, 32)
    td.plan_request_routing(64, 4, 0, 2)
    snap = stats.stats()
    assert "drhm.imbalance" in snap["series"]
    assert snap["counters"]["drhm.route_plans"] == 1
    assert snap["counters"]["drhm.route_reseeds"] == 1
    assert snap["counters"]["drhm.shard_plans"] == 1


# ---------------------------------------------------------------------------
# tensor hashes and maps: int64 with the low 32 bits equal uint32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gamma", GAMMAS)
@pytest.mark.parametrize("n_bins", [2, 7, 32, 64, 1000, 4096])
@pytest.mark.parametrize("k", [16, 8, 31])
def test_drhm_hashes_equal_reference(gamma, n_bins, k):
    tags = _tags(gamma % 1000 + n_bins)
    got = td.drhm_hash(torch.from_numpy(tags), gamma, n_bins, k=k)
    want = jd.drhm_hash(jnp.asarray(tags), jnp.uint32(gamma), n_bins, k=k)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    got = td.drhm_hash_upper(torch.from_numpy(tags), torch.tensor(gamma),
                             n_bins, k=k)
    want = jd.drhm_hash_upper(jnp.asarray(tags), jnp.uint32(gamma), n_bins,
                              k=k)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_bins", [3, 32, 64, 1024])
def test_maps_bin_counts_and_imbalance_equal_reference(n_bins):
    tags = (_tags(n_bins, low=0) % 65536).astype(np.int32)
    tt, jt = torch.from_numpy(tags), jnp.asarray(tags)
    lookup = np.random.default_rng(n_bins).integers(
        0, n_bins, 65536).astype(np.int32)
    kw_t = dict(gamma=0x9E3779B1, lookup=torch.from_numpy(lookup))
    kw_j = dict(gamma=jnp.uint32(0x9E3779B1), lookup=jnp.asarray(lookup))
    assert set(td.MAPPINGS) == set(jd.MAPPINGS)
    for name in td.MAPPINGS:
        got = td.MAPPINGS[name](tt, n_bins, **kw_t)
        want = jd.MAPPINGS[name](jt, n_bins, **kw_j)
        assert np.array_equal(got.numpy(), np.asarray(want)), name
        assert np.array_equal(td.bin_counts(got, n_bins).numpy(),
                              np.asarray(jd.bin_counts(want, n_bins))), name
        assert float(td.imbalance(got, n_bins)) == \
            float(jd.imbalance(want, n_bins)), name


def test_modular_map_wraps_like_uint32():
    tags = np.array([0, 1, 2, 65536, 2 ** 31 - 1, -1, -2 ** 31], np.int32)
    for prime in (2654435761, 2 ** 32 + 7, 40503):
        got = td.modular_map(torch.from_numpy(tags), 1000, prime=prime)
        want = jd.modular_map(jnp.asarray(tags), 1000, prime=prime)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_reseed_draws_an_odd_gamma_in_range():
    gens = [torch.Generator().manual_seed(s) for s in range(64)]
    gs = [int(td.reseed(g)) for g in gens]
    assert all(g % 2 == 1 and 3 <= g < 2 ** 31 for g in gs)
    assert len(set(gs)) > 60
    g = torch.Generator().manual_seed(5)
    h = torch.Generator().manual_seed(5)
    assert int(td.reseed(g)) == int(td.reseed(h))


# ---------------------------------------------------------------------------
# the counterparts of tests/test_drhm.py
# ---------------------------------------------------------------------------

@given(st.integers(2, 12), st.integers(0, 2**30))
@settings(max_examples=50, deadline=None)
def test_permutation_bijective(log_n, gamma):
    n = 1 << log_n
    perm = td.drhm_permutation(n, gamma | 1)
    assert np.array_equal(np.sort(perm), np.arange(n))


@given(st.integers(0, 2**30), st.integers(2, 512))
@settings(max_examples=30, deadline=None)
def test_hash_consistency_and_range(gamma, n_bins):
    tags = torch.arange(1000, dtype=torch.int32)
    g = gamma * 2 + 1
    h1 = td.drhm_hash(tags, g, n_bins)
    h2 = td.drhm_hash(tags, g, n_bins)
    assert torch.equal(h1, h2)                # consistency (paper §2.4)
    assert bool(((h1 >= 0) & (h1 < n_bins)).all())


def test_shard_plan_exact_balance():
    """Bijective permutation ⇒ every shard owns exactly n_pad/n_shards
    slots."""
    plan = td.plan_row_sharding(10_000, 16, gamma=0x9E3779B1)
    owners = plan.owner_of(np.arange(10_000))
    counts = np.bincount(owners, minlength=16)
    assert counts.max() - counts.min() <= np.ceil(10_000 / plan.n_pad * 16) + 1
    all_owners = plan.perm // plan.rows_per_shard
    assert np.bincount(all_owners).std() == 0


def test_drhm_beats_ring_on_strided_pattern():
    """The paper's hot-spot scenario: strided tags pile onto one ring
    bin."""
    n_bins = 32
    tags = torch.from_numpy((np.arange(20_000) * n_bins) % (1 << 16))
    ring_imb = float(td.imbalance(td.ring_map(tags, n_bins), n_bins))
    g = td.reseed(torch.Generator().manual_seed(0))
    drhm_imb = float(td.imbalance(td.drhm_map(tags, n_bins, gamma=g),
                                  n_bins))
    assert ring_imb > 5.0 * drhm_imb        # ring collapses, DRHM stays flat


def test_reseed_changes_mapping():
    tags = torch.arange(4096)
    h1 = td.drhm_hash(tags, td.reseed(torch.Generator().manual_seed(1)), 64)
    h2 = td.drhm_hash(tags, td.reseed(torch.Generator().manual_seed(2)), 64)
    assert not torch.equal(h1, h2)


def test_inverse_permutation():
    perm = td.drhm_permutation(256, 77)
    inv = td.invert_permutation(perm)
    assert np.array_equal(perm[inv], np.arange(256))


def test_reference_reseed_gammas_hash_alike():
    """γ drawn by the reference's ``reseed`` hashes alike in both."""
    tags = _tags(3)
    for s in range(8):
        g = jd.reseed(jax.random.key(s))
        got = td.drhm_hash(torch.from_numpy(tags), int(g), 64)
        assert np.array_equal(got.numpy(),
                              np.asarray(jd.drhm_hash(jnp.asarray(tags), g,
                                                      64)))
