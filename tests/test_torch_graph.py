"""Port's host graph layouts against the JAX reference: ``coo_to_csr``,
``sym_norm_weights`` and ``pack_dedup_chunks`` must be bitwise equal."""
import numpy as np
import pytest

from repro.sparse import graph as jgraph
from repro_torch.data import synthetic as tsyn
from repro_torch.sparse import graph as tgraph
from repro.data import synthetic as jsyn

DEDUP_FIELDS = ("u_cols", "a", "remaining", "out_block", "first", "slots")


def _coo(n, e, seed, hub=None):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, e)
    cols = rng.integers(0, n, e)
    if hub is not None:              # one receiver block with many operands
        rows[: e // 2] = hub
    return rows, cols, rng.normal(size=e).astype(np.float32)


def test_synthetic_graphs_equal_reference():
    for a, b in zip(tsyn.powerlaw_graph(300, 1500, seed=4),
                    jsyn.powerlaw_graph(300, 1500, seed=4)):
        assert np.array_equal(a, b)
    for a, b in zip(tsyn.cora_like(seed=1), jsyn.cora_like(seed=1)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("n,e,seed", [(50, 300, 0), (1, 0, 1), (97, 1000, 2)])
def test_coo_to_csr_and_sym_norm_bitwise(n, e, seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    for a, b in zip(tgraph.coo_to_csr(s, r, n), jgraph.coo_to_csr(s, r, n)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(tgraph.sym_norm_weights(s, r, n),
                    jgraph.sym_norm_weights(s, r, n)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n,e,block_rows,width_cap,hub", [
    (64, 400, 8, 128, None),      # plain
    (64, 900, 8, 16, 3),          # hub block overflows width_cap → splits
    (200, 40, 8, 128, None),      # mostly empty blocks
    (37, 250, 16, 32, 36),        # ragged last block, hub in it
])
def test_pack_dedup_chunks_bitwise(n, e, block_rows, width_cap, hub):
    rows, cols, vals = _coo(n, e, seed=e, hub=hub)
    kw = dict(block_rows=block_rows, width_cap=width_cap)
    got = tgraph.pack_dedup_chunks(rows, cols, vals, n, n, **kw)
    want = jgraph.pack_dedup_chunks(rows, cols, vals, n, n, **kw)
    for f in DEDUP_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (got.n_blocks, got.n_chunks, got.width) == \
        (want.n_blocks, want.n_chunks, want.width)
    if hub is not None:
        assert got.n_chunks > got.n_blocks        # the hub really split
    if e < n:
        assert (got.remaining == 0).any()         # empty blocks own a chunk
