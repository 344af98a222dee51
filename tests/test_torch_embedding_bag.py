"""The port's EmbeddingBag kernel (plain version on CPU tensors) against the
reference's oracle ``embedding_bag_ref`` and its ``lookup(use_kernel=
False)``, at ``tests/test_kernels.py``'s shapes and bar (1e-5).  The
reference's Pallas body is not the anchor: it does not run in interpret
mode on this jax."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ops import lookup as ref_lookup
from repro.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_plain, lookup)

SHAPES = [(8, 4, 1, 50, 16), (16, 26, 1, 200, 64), (8, 3, 4, 77, 32)]


def _inputs(b, f, m, v, d):
    rng = np.random.default_rng(b + f)
    ids = rng.integers(0, v, (b, f, m)).astype(np.int32)
    table = rng.normal(size=(v, d)).astype(np.float32)
    return ids, table


@pytest.mark.parametrize("b,f,m,v,d", SHAPES)
def test_embedding_bag_matches_reference_oracle(b, f, m, v, d):
    ids, table = _inputs(b, f, m, v, d)
    got = embedding_bag(torch.from_numpy(ids), torch.from_numpy(table),
                        batch_tile=4)
    want = np.asarray(embedding_bag_ref(jnp.asarray(ids),
                                        jnp.asarray(table)))
    assert got.shape == (b, f * d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if m == 1:                       # a bag of one row is that row exactly
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("b,f,m,v,d", SHAPES)
def test_lookup_matches_reference_lookup(b, f, m, v, d):
    ids, table = _inputs(b, f, m, v, d)
    got = lookup(torch.from_numpy(ids), torch.from_numpy(table),
                 batch_tile=4)
    want = np.asarray(ref_lookup(jnp.asarray(ids), jnp.asarray(table),
                                 use_kernel=False))
    assert got.shape == (b, f, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    plain = lookup(torch.from_numpy(ids), torch.from_numpy(table),
                   use_kernel=False)
    assert torch.equal(got, plain)


def test_out_of_range_ids_follow_jnp_take():
    # -1 wraps to the last row; ids past either end give a NaN bag
    table = np.arange(24, dtype=np.float32).reshape(6, 4)
    ids = np.array([[[0, 5]], [[-1, 2]], [[6, 0]], [[-7, 1]]], np.int32)
    ids = np.concatenate([ids, ids], 0)               # B = 8
    got = embedding_bag(torch.from_numpy(ids), torch.from_numpy(table))
    want = np.asarray(embedding_bag_ref(jnp.asarray(ids),
                                        jnp.asarray(table)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(got.numpy()[2:4]).all()


def test_bag_sum_runs_in_m_order():
    # (1e8 + 1) - 1e8 is 0 in f32 when summed left to right, 1 otherwise
    table = np.array([[1e8], [1.0], [-1e8]], np.float32)
    ids = np.tile(np.array([0, 1, 2], np.int32), (8, 1, 1))
    got = embedding_bag_plain(torch.from_numpy(ids), torch.from_numpy(table))
    assert float(got[0, 0]) == np.float32(np.float32(1e8) + 1) - 1e8


@pytest.mark.parametrize("bad", ["batch_tile", "ids_dtype", "table_dtype",
                                 "ids_rank", "contiguous"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    ids, table = _inputs(8, 4, 1, 50, 16)
    ids_t, table_t = torch.from_numpy(ids), torch.from_numpy(table)
    kw = {}
    err = ValueError
    if bad == "batch_tile":
        kw["batch_tile"] = 3
    elif bad == "ids_dtype":
        ids_t, err = ids_t.long(), TypeError
    elif bad == "table_dtype":
        table_t, err = table_t.double(), TypeError
    elif bad == "ids_rank":
        ids_t = ids_t[:, :, 0]
    else:
        table_t = table_t.T.contiguous().T
    with pytest.raises(err):
        embedding_bag(ids_t, table_t, **kw)


@pytest.mark.parametrize("dim,offset,want", [
    (64, 0, (4, 16)),      # dlrm-rm2: two bags a warp, 16-byte loads
    (128, 0, (4, 32)),
    (96, 0, (4, 32)),      # 24 slices round up to 32 lanes
    (200, 0, (4, 32)),     # 50 slices: two passes of 32 lanes
    (16, 0, (4, 4)),
    (4, 0, (4, 1)),
    (6, 0, (2, 4)),        # 6 % 4 != 0: 3 float2 slices
    (7, 0, (1, 8)),
    (64, 1, (1, 32)),      # a table view one float off 16 bytes
    (64, 2, (2, 32)),      # two floats off: 8-byte aligned
])
def test_lane_layout(dim, offset, want):
    from repro_torch.kernels.embedding_bag.embedding_bag import lane_layout
    base = torch.zeros(8 * dim + 8)
    assert base.data_ptr() % 16 == 0
    table = base[offset:offset + 8 * dim].view(8, dim)
    out = torch.zeros(4, dim)
    assert lane_layout(dim, table, out) == want
