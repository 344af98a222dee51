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
from repro_torch.kernels.gustavson_spmm.gustavson_spmm import (
    blocks_per_cta, group_threads, lane_layout, stripes_for)
from repro_torch.sparse.plan import block_ptr_from_first

TOL = 1e-5
# bf16 against the reference: torch's bf16 defaults for assert_close, and
# each element within 2 bf16 ulps of the larger magnitude
BF16_RTOL, BF16_ATOL, BF16_ULPS = 1.6e-2, 1e-5, 2


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
    """bf16 tiles are rejected (they stay f32 and are rounded in the
    kernel) and so are the x dtypes B1 does not take (f16, f64); a bf16 x
    is taken and gives a bf16 y."""
    ch, rng = _packed(16, 60, seed=3)
    x = rng.normal(size=(16, 8)).astype(np.float32)
    u, rem, ptr, a, xt = _torch_args(ch, x)
    assert spmm_dedup_chunks(u, rem, ptr, a, xt.to(torch.bfloat16),
                             block_rows=ch.block_rows).dtype == torch.bfloat16
    for bad in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="bfloat16"):
            spmm_dedup_chunks(u, rem, ptr, a, xt.to(bad),
                              block_rows=ch.block_rows)
    with pytest.raises(TypeError, match="a must be"):
        spmm_dedup_chunks(u, rem, ptr, a.to(torch.bfloat16),
                          xt.to(torch.bfloat16), block_rows=ch.block_rows)
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


@pytest.mark.parametrize("d,dtype,offset,want", [
    (1, torch.float32, 0, (1, 1, 1, 1)),
    (7, torch.float32, 0, (1, 8, 1, 1)),       # D = 7: 4-byte rows
    (16, torch.float32, 0, (4, 4, 1, 1)),      # bucket16: float4
    (16, torch.float32, 2, (2, 8, 1, 1)),      # a view 8 bytes in
    (16, torch.float32, 1, (1, 16, 1, 1)),
    (33, torch.float32, 0, (1, 64, 8, 1)),
    (64, torch.float32, 0, (4, 16, 1, 1)),
    (128, torch.float32, 0, (4, 32, 8, 1)),
    (602, torch.float32, 0, (2, 160, 8, 2)),   # minibatch_lg
    (1433, torch.float32, 0, (1, 256, 8, 6)),  # Cora's features
    (1433, torch.int8, 0, (1, 256, 8, 6)),     # int8: byte-aligned rows
    (602, torch.int8, 0, (2, 160, 8, 2)),
    (16, torch.int8, 0, (4, 4, 1, 1)),         # int8: 4-byte loads
    (16, torch.int8, 3, (1, 16, 1, 1)),
    (4096, torch.float32, 0, (4, 256, 8, 4)),
    (4096, torch.float32, 1, (1, 256, 8, 16)),
])
def test_lane_layout_picks_load_width_rows_and_stripes(d, dtype, offset,
                                                       want):
    """(elements per load, column threads per stripe, rows a thread holds,
    stripes): the widest load that D and the pointer allow, one row and one
    a thread for rows of at most 16 vectors, else 8, one vector a thread,
    stripes of at most 256 column threads and of equal width."""
    base = torch.zeros(64 * d + 8, dtype=dtype)
    x = base[offset:offset + 64 * d].view(64, d)
    vec, lanes, rows = lane_layout(d, x)
    stripes = stripes_for(d, vec, lanes)
    assert (vec, lanes, rows, stripes) == want
    per_stripe = lanes * vec          # columns
    assert per_stripe * stripes >= d > per_stripe * (stripes - 1)


def test_blocks_per_cta_fills_the_card_within_limits(monkeypatch):
    # bucket16 (42 blocks of 4 column × 8 row threads) on 132 SMs: one
    # block a thread block; Cora (339 blocks): three
    assert group_threads(4, 1) == 32 and group_threads(160, 8) == 160
    assert blocks_per_cta(42, 1, 32, 132) == 1
    assert blocks_per_cta(339, 1, 32, 132) == 3
    assert blocks_per_cta(513, 1, 128, 132) == 2       # 256 threads
    assert blocks_per_cta(21248, 2, 160, 132) == 1
    assert blocks_per_cta(10 ** 6, 1, 8, 132) == 8     # MAX_GROUPS
    assert blocks_per_cta(10 ** 6, 1, 32, 132) == 8
    from repro_torch.kernels.gustavson_spmm import gustavson_spmm as gs
    monkeypatch.setattr(gs, "BLOCKS_PER_CTA", 100)
    assert blocks_per_cta(42, 1, 8, 132) == 8


def test_block_ptr_from_first():
    first = np.array([1, 0, 0, 1, 1, 0], np.int32)
    assert block_ptr_from_first(first, 3).tolist() == [0, 3, 4, 6]
    with pytest.raises(ValueError):
        block_ptr_from_first(first, 4)


def bf16_ulps(got, want) -> np.ndarray:
    """|got - want| in bf16 ulps at the larger magnitude of the two."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), 2.0 ** -126)
    return np.abs(g - w) / 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("width_cap", [32, 8])
@pytest.mark.parametrize("d", [7, 16, 600])
def test_bf16_plain_matches_reference_kernel(d, width_cap):
    """bf16 x through the port's plain version against the reference's
    Pallas kernel (interpret mode) on the same bf16 x: bf16 out, within
    torch's bf16 defaults and 2 ulps (width_cap 8 splits blocks into
    several chunks, each rounded)."""
    ch, rng = _packed(40, 300, seed=d + width_cap, width_cap=width_cap)
    x16 = torch.from_numpy(rng.normal(size=(40, d)).astype(
        np.float32)).to(torch.bfloat16)
    args = _torch_args(ch, x16.float().numpy())[:4]
    got = spmm_dedup_chunks(*args, x16, block_rows=ch.block_rows)
    assert got.dtype == torch.bfloat16
    jargs = tuple(jnp.asarray(a) for a in (ch.u_cols, ch.remaining,
                                           ch.out_block, ch.first, ch.a))
    kern = jax_spmm(*jargs, jnp.asarray(x16.float().numpy(), jnp.bfloat16),
                    block_rows=ch.block_rows, n_blocks=ch.n_blocks,
                    interpret=True)
    assert kern.dtype == jnp.bfloat16
    want = np.asarray(kern.astype(jnp.float32))
    torch.testing.assert_close(got.float(), torch.from_numpy(want.copy()),
                               rtol=BF16_RTOL, atol=BF16_ATOL)
    assert bf16_ulps(got.float().numpy(), want).max() <= BF16_ULPS


def test_bf16_plain_rounds_once_per_chunk():
    """A hand-built block of two chunks: the tile is rounded to bf16, each
    chunk's f32 sum is rounded to bf16, and the second chunk is added in f32
    and rounded again — not one f32 sum rounded at the end."""
    one = 1.0 + 2.0 ** -8              # rounds to 1.0 in bf16 (ties to even)
    u_cols = torch.tensor([[0] + [0] * 15, [1] + [0] * 15], dtype=torch.int32)
    remaining = torch.tensor([1, 1], dtype=torch.int32)
    block_ptr = torch.tensor([0, 2], dtype=torch.int32)
    a = torch.zeros(16, 16)
    a[0, 0] = one                      # chunk 0, row 0
    a[8, 0] = 1.0                      # chunk 1, row 0
    x = torch.tensor([[1.0], [2.0 ** -8 * 3]]).to(torch.bfloat16)
    got = spmm_dedup_chunks(u_cols, remaining, block_ptr, a, x,
                            block_rows=8)
    # chunk 0: bf16(one) · 1 = 1; chunk 1: 3·2⁻⁸; 1 + 3·2⁻⁸ in f32 rounds to
    # bf16 1 + 2⁻⁶ (ulp 2⁻⁷ at 1: 1.01171875 → 1.015625, ties to even)
    assert got.dtype == torch.bfloat16 and got.shape == (8, 1)
    assert float(got[0, 0]) == 1.0 + 2.0 ** -6
    # where one rounding at the end would differ: three chunks of 2⁻⁹ on 1
    # each round away (1 + 2⁻⁹ → 1), while their f32 sum does not
    u3 = torch.tensor([[0] + [0] * 15] * 4, dtype=torch.int32)
    rem3 = torch.ones(4, dtype=torch.int32)
    ptr3 = torch.tensor([0, 4], dtype=torch.int32)
    a3 = torch.zeros(32, 16)
    a3[0, 0] = 1.0
    for k in (1, 2, 3):
        a3[8 * k, 0] = 2.0 ** -9
    x3 = torch.ones(1, 1, dtype=torch.bfloat16)
    got3 = spmm_dedup_chunks(u3, rem3, ptr3, a3, x3, block_rows=8)
    assert float(got3[0, 0]) == 1.0              # per-chunk rounding
    assert float(torch.tensor(1 + 3 * 2.0 ** -9).to(torch.bfloat16)) != 1.0
    assert (got3[1:] == 0).all()
