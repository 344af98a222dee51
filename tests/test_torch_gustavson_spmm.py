"""The port's ``spmm_dedup_chunks`` (plain version on CPU tensors) against
the JAX reference's Pallas kernel in interpret mode and its jnp oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gustavson_spmm.gustavson_spmm import \
    spmm_dedup_chunks as jax_spmm
from repro.kernels.gustavson_spmm.ref import spmm_dedup_chunks_ref
from repro.sparse.graph import pack_dedup_chunks
from repro_torch.kernels.gustavson_spmm import (spmm_dedup_chunks,
                                                spmm_dedup_chunks_plain)
from repro_torch.kernels.gustavson_spmm.gustavson_spmm import d_tile_for
from repro_torch.sparse.plan import block_ptr_from_first

TOL = 1e-5


def _packed(n, e, seed, width_cap=32, block_rows=8):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, e)
    cols = rng.integers(0, n, e)
    vals = rng.normal(size=e).astype(np.float32)
    ch = pack_dedup_chunks(rows, cols, vals, n, n, block_rows=block_rows,
                           width_cap=width_cap)
    return ch, rng


def _torch_args(ch, x):
    ptr = block_ptr_from_first(ch.first, ch.n_blocks)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in
                 (ch.u_cols, ch.remaining, ptr, ch.a, x))


@pytest.mark.parametrize("d", [7, 16, 600])
def test_plain_matches_reference_kernel_and_oracle(d):
    ch, rng = _packed(40, 300, seed=d)
    x = rng.normal(size=(40, d)).astype(np.float32)
    got = spmm_dedup_chunks(*_torch_args(ch, x), block_rows=ch.block_rows)
    jargs = tuple(jnp.asarray(a) for a in (ch.u_cols, ch.remaining,
                                           ch.out_block, ch.first, ch.a))
    kern = jax_spmm(*jargs, jnp.asarray(x), block_rows=ch.block_rows,
                    n_blocks=ch.n_blocks, interpret=True)
    oracle = spmm_dedup_chunks_ref(jargs[0], jargs[2], jargs[4],
                                   jnp.asarray(x), ch.block_rows,
                                   ch.n_blocks)
    assert got.shape == (ch.n_blocks * ch.block_rows, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=0,
                               atol=TOL)


def test_hub_split_blocks_accumulate_in_order():
    # width_cap=8 splits every busy block into several chunks
    ch, rng = _packed(24, 400, seed=5, width_cap=8)
    assert ch.n_chunks > ch.n_blocks
    x = rng.normal(size=(24, 16)).astype(np.float32)
    got = spmm_dedup_chunks(*_torch_args(ch, x), block_rows=ch.block_rows)
    jargs = tuple(jnp.asarray(a) for a in (ch.u_cols, ch.remaining,
                                           ch.out_block, ch.first, ch.a))
    kern = jax_spmm(*jargs, jnp.asarray(x), block_rows=ch.block_rows,
                    n_blocks=ch.n_blocks, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=0,
                               atol=TOL)


def test_dead_lanes_are_never_read():
    """Lanes behind ``remaining`` point at a NaN row: the result is still
    the sum over the live lanes (a numpy loop), without a NaN anywhere."""
    ch, rng = _packed(32, 150, seed=11)
    x = rng.normal(size=(33, 16)).astype(np.float32)
    x[32] = np.nan                                  # the poisoned row
    u_cols = ch.u_cols.copy()
    lane = np.arange(ch.width)[None, :]
    u_cols[lane >= ch.remaining[:, None]] = 32
    assert (u_cols == 32).any()
    want = np.zeros((ch.n_blocks * ch.block_rows, 16), np.float64)
    a = ch.a.reshape(ch.n_chunks, ch.block_rows, ch.width)
    for k in range(ch.n_chunks):
        b = ch.out_block[k]
        for u in range(ch.remaining[k]):
            want[b * ch.block_rows:(b + 1) * ch.block_rows] += \
                a[k, :, u:u + 1] * x[u_cols[k, u]][None, :]
    args = _torch_args(ch, x)
    got = spmm_dedup_chunks(torch.from_numpy(u_cols), *args[1:],
                            block_rows=ch.block_rows)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_empty_blocks_evict_zero_tiles():
    ch, rng = _packed(64, 6, seed=2)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    got = spmm_dedup_chunks(*_torch_args(ch, x), block_rows=ch.block_rows)
    empty = np.repeat(ch.remaining[ch.first == 1] == 0, ch.block_rows)
    assert empty.any()
    assert (got.numpy()[empty] == 0).all()


def test_wrapper_rejects_bf16_and_bad_shapes():
    ch, rng = _packed(16, 60, seed=3)
    x = rng.normal(size=(16, 8)).astype(np.float32)
    u, rem, ptr, a, xt = _torch_args(ch, x)
    with pytest.raises(TypeError, match="float32"):
        spmm_dedup_chunks(u, rem, ptr, a, xt.to(torch.bfloat16),
                          block_rows=ch.block_rows)
    with pytest.raises(ValueError, match="a has shape"):
        spmm_dedup_chunks(u, rem, ptr, a[:-1], xt, block_rows=ch.block_rows)
    with pytest.raises(ValueError, match="remaining"):
        spmm_dedup_chunks(u, rem[:-1], ptr, a, xt, block_rows=ch.block_rows)
    with pytest.raises(TypeError, match="int32"):
        spmm_dedup_chunks(u.long(), rem, ptr, a, xt,
                          block_rows=ch.block_rows)
    with pytest.raises(ValueError, match="block_ptr"):
        spmm_dedup_chunks(u, rem, torch.zeros(ch.n_chunks + 2,
                                              dtype=torch.int32), a, xt,
                          block_rows=ch.block_rows)
    with pytest.raises(ValueError, match="contiguous"):
        spmm_dedup_chunks(u, rem, ptr, a, torch.from_numpy(
            np.asfortranarray(x)), block_rows=ch.block_rows)


def test_plain_version_is_what_the_wrapper_runs_on_cpu():
    ch, rng = _packed(30, 200, seed=9)
    x = rng.normal(size=(30, 5)).astype(np.float32)
    args = _torch_args(ch, x)
    assert torch.equal(spmm_dedup_chunks(*args, block_rows=8),
                       spmm_dedup_chunks_plain(*args, block_rows=8))
    assert spmm_dedup_chunks.launches == 0      # no kernel on the CPU


@pytest.mark.parametrize("d,tile", [(1, 1), (7, 8), (16, 16), (33, 32),
                                    (600, 32)])
def test_d_tile_is_smallest_power_of_two_capped(d, tile):
    assert d_tile_for(d) == tile


def test_block_ptr_from_first():
    first = np.array([1, 0, 0, 1, 1, 0], np.int32)
    assert block_ptr_from_first(first, 3).tolist() == [0, 3, 4, 6]
    with pytest.raises(ValueError):
        block_ptr_from_first(first, 4)
