"""The port's ``hash_draws`` (plain version on CPU tensors) against the JAX
reference's ``hash_draws_ref`` and numpy's ``_mix64 % deg``: exactly
equal, edge values included."""
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
from repro.sparse.sampler import _mix64
from repro_torch.kernels.forest_sampler import (hash_draws, hash_draws_plain,
                                                split64)

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
