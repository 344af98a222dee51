"""``BlockedELL``/``pack_blocked_ell`` (``repro_torch.sparse.graph``) and
``spmm_blocked_ell`` (``repro_torch.kernels.gustavson_spmm``: a host
re-pack into dedup chunks, then B1) against the reference's, on the CPU:
the packed arrays bitwise, and the product against the reference's
``spmm_blocked_ell_ref`` oracle at ``tests/test_kernels.py``'s shapes,
≤1e-5 (B1's plain version here; the kernel in the ``gpu`` tests)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gustavson_spmm.ref import spmm_blocked_ell_ref
from repro.sparse import graph as jgraph
from repro_torch.kernels.gustavson_spmm import spmm_blocked_ell
from repro_torch.sparse import graph as tgraph

SHAPES = [(32, 120, 8), (64, 400, 128), (100, 777, 33), (16, 16, 256)]


@pytest.mark.parametrize("n,e,d", SHAPES)
@pytest.mark.parametrize("block_rows", [8, 16])
def test_pack_blocked_ell_bitwise(n, e, d, block_rows):
    rng = np.random.default_rng(e)
    rows = rng.integers(0, n, e)
    cols = rng.integers(0, n, e)
    vals = rng.normal(size=e).astype(np.float32)
    a = jgraph.pack_blocked_ell(rows, cols, vals, n, n,
                                block_rows=block_rows, nnz_multiple=32)
    b = tgraph.pack_blocked_ell(rows, cols, vals, n, n,
                                block_rows=block_rows, nnz_multiple=32)
    for f in ("cols", "row_local", "vals", "remaining", "slots"):
        assert getattr(b, f).dtype == getattr(a, f).dtype
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    assert (b.n_blocks, b.nnz_pad) == (a.n_blocks, a.nnz_pad)


@pytest.mark.parametrize("n,e,d", SHAPES)
def test_spmm_blocked_ell_matches_reference_oracle(n, e, d):
    rng = np.random.default_rng(e)
    rows = rng.integers(0, n, e)
    cols = rng.integers(0, n, e)
    vals = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    ell = tgraph.pack_blocked_ell(rows, cols, vals, n, n, block_rows=8,
                                  nnz_multiple=32)
    ref = spmm_blocked_ell_ref(jnp.asarray(ell.cols),
                               jnp.asarray(ell.row_local),
                               jnp.asarray(ell.vals),
                               jnp.asarray(ell.remaining), jnp.asarray(x), 8)
    out = spmm_blocked_ell(ell.cols, ell.row_local, ell.vals, ell.remaining,
                           torch.from_numpy(x), block_rows=8)
    assert out.shape == (ell.n_blocks * 8, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_spmm_blocked_ell_empty_rows():
    """Blocks with no nnz evict zeros (``test_gustavson_empty_rows``)."""
    n, d = 32, 16
    x = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    ell = tgraph.pack_blocked_ell(np.array([0, 0, 1]), np.array([3, 4, 5]),
                                  np.ones(3, np.float32), n, n, block_rows=8,
                                  nnz_multiple=32)
    out = spmm_blocked_ell(torch.from_numpy(ell.cols),
                           torch.from_numpy(ell.row_local),
                           torch.from_numpy(ell.vals),
                           torch.from_numpy(ell.remaining),
                           torch.from_numpy(x), block_rows=8)
    assert float(out[8:].abs().max()) == 0.0
    np.testing.assert_allclose(out[0].numpy(), x[3] + x[4], rtol=1e-6)
