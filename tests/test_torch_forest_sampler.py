"""The port's ``hash_draws`` (plain version on CPU tensors) against the JAX
reference's ``hash_draws_ref`` and numpy's ``_mix64 % deg``: exactly
equal, edge values included.  The port's device sampler (``forest_sample``
through ``DeviceSamplerPlane``, its plain version on the CPU) against the
reference's ``DeviceSamplerPlane.sample_bucket`` (with and without the
Pallas ``hash_draws`` in interpret mode) and the host ``sample_forest``:
exactly equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # deterministic fallback; requirements-dev.txt has the real one
    from _hypothesis_shim import given, settings, st

from repro.kernels.forest_sampler.forest_sampler import hash_draws_ref
from repro.serve import device_sampler as jds
from repro.sparse import sampler as jsampler
from repro.sparse.sampler import _mix64
from repro_torch.data.synthetic import powerlaw_graph
from repro_torch.kernels.forest_sampler import (MAX_HOPS, forest_sample,
                                                forest_sample_plain,
                                                hash_draws, hash_draws_plain,
                                                split64)
from repro_torch.serve.buckets import stack_trees
from repro_torch.serve.device_sampler import (DeviceSamplerPlane,
                                              pack_trees, tree_key_mix)
from repro_torch.sparse.graph import coo_to_csr

EDGE_Z = [0, 1, 2 ** 32 - 1, 2 ** 32, 2 ** 63 - 1, 2 ** 63, 2 ** 63 + 1,
          2 ** 64 - 1, 0x9E3779B97F4A7C15, 0x61C8864680B583EB]
EDGE_DEG = [1, 2, 3, 7, 2 ** 16 + 1, 2 ** 31 - 1]


def _three_ways(z: np.ndarray, deg: np.ndarray):
    """(port, JAX reference, numpy) draws for uint64 z and int32 deg."""
    port = hash_draws(torch.from_numpy(z.view(np.int64).copy()),
                      torch.from_numpy(deg)).numpy()
    hi, lo = split64(z.view(np.int64))
    ref = np.asarray(hash_draws_ref(jnp.asarray(hi), jnp.asarray(lo),
                                    jnp.asarray(deg.astype(np.uint32))))
    host = (_mix64(z) % deg.astype(np.uint64)).astype(np.int32)
    return port, ref, host


def test_edge_values_exact():
    z, deg = np.meshgrid(np.array(EDGE_Z, np.uint64),
                         np.array(EDGE_DEG, np.int32), indexing="ij")
    port, ref, host = _three_ways(z.copy(), deg.copy())
    assert port.dtype == np.int32
    assert np.array_equal(port, host)
    assert np.array_equal(ref, host)


@given(st.integers(0, 2 ** 32 - 1), st.integers(0, 2 ** 32 - 1),
       st.integers(1, 2 ** 31 - 1))
@settings(max_examples=60, deadline=None)
def test_random_words_exact(hi, lo, d):
    z = np.array([[(hi << 32) | lo, hi, lo << 32]], np.uint64)
    deg = np.array([[d, 1, 2 ** 31 - 1]], np.int32)
    port, ref, host = _three_ways(z, deg)
    assert np.array_equal(port, host) and np.array_equal(ref, host)


def test_bulk_top_bit_set_exact():
    rng = np.random.default_rng(0)
    z = rng.integers(0, 2 ** 63, (16, 15), dtype=np.int64).view(np.uint64)
    z[::2] |= np.uint64(1 << 63)
    deg = rng.integers(1, 2 ** 31 - 1, (16, 15)).astype(np.int32)
    port, ref, host = _three_ways(z, deg)
    assert np.array_equal(port, host) and np.array_equal(ref, host)


def test_split64_round_trips():
    z = np.array(EDGE_Z, np.uint64)
    hi, lo = split64(torch.from_numpy(z.view(np.int64).copy()))
    back = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    assert hi.dtype == lo.dtype == np.uint32
    assert np.array_equal(back, z)


def test_wrapper_checks_and_cpu_path():
    z = torch.zeros((2, 3), dtype=torch.int64)
    deg = torch.ones((2, 3), dtype=torch.int32)
    assert torch.equal(hash_draws(z, deg), hash_draws_plain(z, deg))
    assert hash_draws.launches == 0
    with pytest.raises(TypeError):
        hash_draws(z.int(), deg)
    with pytest.raises(ValueError, match="shape"):
        hash_draws(z, deg[:, :2].contiguous())


# ---------------------------------------------------------------------------
# forest_sample: the port's device sampler against the reference's
# ---------------------------------------------------------------------------

def _powerlaw_csr(n, e, seed):
    s, r = powerlaw_graph(n, e, seed=seed)
    indptr, indices, _ = coo_to_csr(s, r, n)
    return indptr, indices


def _isolated_csr():
    # node 0 and the last node have no in-edges (the end-of-CSR corner)
    s = np.array([1, 2, 3, 3, 4, 5, 5, 5])
    r = np.array([2, 1, 1, 4, 3, 3, 4, 1])
    indptr, indices, _ = coo_to_csr(s, r, 7)
    return indptr, indices


GRAPHS = {
    "powerlaw": lambda: _powerlaw_csr(150, 900, seed=3),
    "isolated": _isolated_csr,
    "edgeless": lambda: (np.zeros(33, np.int64), np.zeros(0, np.int64)),
}

# (graph, bucket, live trees, fanouts, run the Pallas kernel in interpret
# mode too); the interpret runs are kept to the small draw grids
FOREST_CASES = [
    ("powerlaw", 1, 1, (5, 3), True),
    ("powerlaw", 3, 3, (5, 3), True),
    ("powerlaw", 16, 16, (5, 3), True),
    ("powerlaw", 16, 9, (5, 3), False),
    ("powerlaw", 3, 3, (15, 10), False),
    ("powerlaw", 16, 16, (15, 10), False),
    ("powerlaw", 16, 16, (2, 2, 2), True),
    ("powerlaw", 16, 5, (2, 2, 2), False),
    ("isolated", 16, 16, (5, 3), True),
    ("isolated", 3, 2, (2, 2, 2), False),
    ("edgeless", 3, 3, (5, 3), True),
    ("edgeless", 16, 10, (2, 2, 2), False),
]


@pytest.mark.parametrize("graph,bucket,n_live,fanouts,interpret",
                         FOREST_CASES)
def test_sample_bucket_equals_reference_and_host_sampler(
        graph, bucket, n_live, fanouts, interpret):
    indptr, indices = GRAPHS[graph]()
    n = indptr.shape[0] - 1
    rng = np.random.default_rng(bucket * 100 + n_live + len(fanouts))
    key = int(rng.integers(0, 2 ** 31))
    seeds = rng.integers(0, n, bucket)
    if graph == "isolated":
        seeds[:2] = [0, n - 1]
    tree_keys = rng.integers(0, 2 ** 63, bucket).astype(np.uint64)
    live = np.arange(bucket) < n_live
    seeds = np.where(live, seeds, 0)

    port = DeviceSamplerPlane(indptr, indices, fanouts, key=key,
                              device="cpu")
    node_ids, hop_valid = port.sample_bucket(seeds, tree_key_mix(tree_keys),
                                             live)
    node_ids, hop_valid = node_ids.numpy(), hop_valid.numpy()
    assert node_ids.dtype == np.int64 and hop_valid.dtype == bool

    hi, lo = jds.tree_key_mix(tree_keys)
    for use_kernel in ((False, True) if interpret else (False,)):
        ref = jds.DeviceSamplerPlane(indptr, indices, fanouts, key=key,
                                     use_kernel=use_kernel)
        want_ids, want_valid = ref.sample_bucket(
            jnp.asarray(seeds.astype(np.int32)), jnp.asarray(hi),
            jnp.asarray(lo), jnp.asarray(live))
        assert np.array_equal(node_ids, np.asarray(want_ids, np.int64))
        assert np.array_equal(hop_valid, np.asarray(want_valid))

    forest = jsampler.sample_forest(indptr, indices, seeds[live], fanouts,
                                    key=key, tree_keys=tree_keys[live])
    host_ids, host_valid = stack_trees(forest, bucket, fanouts)
    assert np.array_equal(node_ids, host_ids)
    assert np.array_equal(hop_valid, host_valid)


def test_sample_levels_cut_the_bucket_by_level():
    indptr, indices = _powerlaw_csr(150, 900, seed=4)
    plane = DeviceSamplerPlane(indptr, indices, (3, 2), key=5, device="cpu")
    seeds = np.array([4, 77, 0])
    tkm = tree_key_mix(np.arange(3, dtype=np.uint64))
    live = np.array([True, False, True])
    node_ids, hop_valid = plane.sample_bucket(seeds, tkm, live)
    levels, valid = plane.sample_levels(seeds, tkm, live)
    assert [tuple(lv.shape) for lv in levels] == [(3, 1), (3, 3), (3, 6)]
    assert [tuple(v.shape) for v in valid] == [(3, 3), (3, 6)]
    assert torch.equal(torch.cat([lv.reshape(-1) for lv in levels]),
                       node_ids)
    assert torch.equal(torch.cat([v.reshape(-1) for v in valid]), hop_valid)
    assert all((lv[1] == -1).all() for lv in levels)   # padding tree
    assert not any(v[1].any() for v in valid)


def test_pack_trees_layout():
    trees = pack_trees(np.array([3, 9]), np.array([-5, 7], np.int64),
                       np.array([True, False]))
    assert trees.dtype == np.int64 and trees.shape == (3, 2)
    assert trees.tolist() == [[3, 9], [-5, 7], [1, 0]]


def test_forest_sample_cpu_path_counts_no_launch():
    indptr, indices = _powerlaw_csr(150, 900, seed=5)
    args = (torch.from_numpy(indptr), torch.from_numpy(indices.astype(
        np.int64)), torch.from_numpy(pack_trees([1, 2], [3, 4], [1, 1])))
    key_c = int(_mix64(np.uint64(7)))
    got = forest_sample(*args, (4, 2), key_c)
    want = forest_sample_plain(*args, (4, 2), key_c)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert forest_sample.launches == 0


def test_forest_sample_wrapper_raises():
    indptr = torch.tensor([0, 1, 2], dtype=torch.int64)
    indices = torch.tensor([1, 0], dtype=torch.int64)
    trees = torch.from_numpy(pack_trees([0, 1], [5, 6], [1, 1]))
    with pytest.raises(TypeError, match="indptr"):
        forest_sample(indptr.int(), indices, trees, (2,), 0)
    with pytest.raises(TypeError, match="indices"):
        forest_sample(indptr, indices.int(), trees, (2,), 0)
    with pytest.raises(TypeError, match="trees"):
        forest_sample(indptr, indices, trees.int(), (2,), 0)
    with pytest.raises(ValueError, match="contiguous"):
        forest_sample(indptr, indices, trees.t().contiguous().t(), (2,), 0)
    with pytest.raises(ValueError, match=r"\(3, T\)"):
        forest_sample(indptr, indices, trees[:2].contiguous(), (2,), 0)
    with pytest.raises(ValueError, match="hops"):
        forest_sample(indptr, indices, trees, (2,) * (MAX_HOPS + 1), 0)
    with pytest.raises(ValueError, match="hops"):
        forest_sample(indptr, indices, trees, (), 0)
    with pytest.raises(ValueError, match="hops"):
        forest_sample(indptr, indices, trees, (2, 0), 0)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        forest_sample(indptr, indices, trees, (2 ** 16, 2 ** 16), 0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        forest_sample(indptr.to("meta"), indices.to("meta"),
                      trees.to("meta"), (2,), 0)
