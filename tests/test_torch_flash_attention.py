"""The port's causal flash attention (plain version on CPU tensors) against
the reference's ``mha_causal(use_kernel=False)`` and
``causal_attention_ref``, at ``tests/test_kernels.py``'s shapes and bars
(2e-5 f32; 2e-2 for bf16 against the f32 oracle).  The reference's Pallas
body is not the anchor: it does not run in interpret mode on this jax."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import mha_causal as ref_mha_causal
from repro.kernels.flash_attention.ref import causal_attention_ref
from repro_torch.kernels.flash_attention import (causal_attention_plain,
                                                 flash_attention, mha_causal)
from repro_torch.kernels.flash_attention.flash_attention import (
    KERNEL_HEAD_DIMS, SLICE, WIDE_CHUNK, kernel_dtype, padded_head_dim,
    value_chunks)


@pytest.mark.parametrize("b,s,h,kv,hd,bq,bk", [
    (2, 128, 4, 2, 32, 32, 32), (1, 256, 2, 2, 64, 64, 128),
    (3, 64, 8, 1, 16, 16, 16),
])
def test_mha_causal_matches_reference(b, s, h, kv, hd, bq, bk):
    rng = np.random.default_rng(s)
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    got = mha_causal(*map(torch.from_numpy, (q, k, v)), block_q=bq,
                     block_k=bk)
    want = np.asarray(ref_mha_causal(*map(jnp.asarray, (q, k, v)),
                                     use_kernel=False))
    assert got.shape == (b, s, h, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_mha_causal_bf16_against_f32_oracle():
    rng = np.random.default_rng(0)
    arrs = [jnp.asarray(rng.normal(size=(2, 64, 2, 32)), jnp.bfloat16)
            for _ in range(3)]
    # the same bf16 values on both sides
    q, k, v = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in arrs)
    got = mha_causal(q, k, v, block_q=32, block_k=32)
    want = np.asarray(ref_mha_causal(*(a.astype(jnp.float32) for a in arrs),
                                     use_kernel=False))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_plain_matches_reference_oracle_on_flat_layout():
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(4, 96, 16)).astype(np.float32)
               for _ in range(3))
    got = causal_attention_plain(*map(torch.from_numpy, (q, k, v)))
    want = np.asarray(causal_attention_ref(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # the first query sees only the first key
    np.testing.assert_allclose(got[:, 0].numpy(), v[:, 0], rtol=1e-6)


@pytest.mark.parametrize("bad", ["block", "dtype", "mixed", "shape",
                                 "wide", "complex"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """What the wrapper refuses: blocks that do not divide S, q, k, v of
    other shapes, complex inputs (the reference's f32 upcast would drop
    their imaginary part).  What it computes, as the reference does, where
    it once raised: f16, a mix of dtypes (the output in q's), and a head
    dim past 256, each against the f32 plain version of the same values
    (2e-5; f16 output 5e-3)."""
    q = torch.randn(2, 64, 16)
    k, v = torch.randn_like(q), torch.randn_like(q)
    kw, err = {}, ValueError
    if bad in ("dtype", "mixed", "wide"):
        tol = 2e-5
        if bad == "dtype":
            q, k, v, tol = q.half(), k.half(), v.half(), 5e-3
        elif bad == "mixed":
            k = k.bfloat16()
        else:
            q, k, v = (torch.randn(2, 64, 264) for _ in range(3))
        got = flash_attention(q, k, v)
        want = causal_attention_plain(q.float(), k.float(), v.float())
        assert got.dtype == q.dtype and got.shape == q.shape
        assert float((got.float() - want).abs().max()) <= tol
        return
    if bad == "block":
        kw["block_q"] = 48                    # does not divide S = 64
    elif bad == "complex":
        q, err = q.cfloat(), TypeError
    else:
        v = v[:, :32].contiguous()
    with pytest.raises(err):
        flash_attention(q, k, v, **kw)


# head dims the kernel once refused: gemma's reduced 24 and FULL 256, the
# reduced deepseek's 8, and 80 (a width between instantiations)
@pytest.mark.parametrize("hd", [8, 24, 80, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_mha_causal_head_dims_match_reference(hd, dtype):
    """GQA (4 query heads on 2 kv heads), S = 48 in blocks of 16: the
    port's ``mha_causal`` against the reference's ``mha_causal(use_kernel=
    False)`` and, on the flat (BH, S, d) layout, B8's plain version against
    ``causal_attention_ref``; 2e-5 in f32, 2e-2 in bf16 and 5e-3 in f16
    against the f32 oracle on the same rounded values."""
    b, s, h, kv = 2, 48, 4, 2
    rng = np.random.default_rng(hd)
    arrs = [rng.normal(size=(b, s, n, hd)).astype(np.float32)
            for n in (h, kv, kv)]
    tol = 2e-5
    if dtype != "float32":          # the same rounded values on both sides
        arrs = [np.array(jnp.asarray(a, getattr(jnp, dtype)).astype(
            jnp.float32)) for a in arrs]
        tol = 2e-2 if dtype == "bfloat16" else 5e-3
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs)
    got = mha_causal(q, k, v, block_q=16, block_k=16)
    want = np.asarray(ref_mha_causal(*map(jnp.asarray, arrs),
                                     use_kernel=False))
    assert got.shape == (b, s, h, hd) and got.dtype == q.dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    flat = [np.repeat(a, h // a.shape[2], axis=2).transpose(0, 2, 1, 3)
            .reshape(b * h, s, hd).copy() for a in arrs]
    got = causal_attention_plain(*(torch.from_numpy(a).to(q.dtype)
                                   for a in flat))
    want = np.asarray(causal_attention_ref(*map(jnp.asarray, flat)))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_padded_head_dim_is_the_next_compiled_width(dtype):
    """On the card a d ≤ 256 the kernel is not compiled for runs at the
    narrowest compiled width above it, q, k and v padded with zero
    columns; past 256 at the next multiple of 64, v's columns in
    ``WIDE_CHUNK`` chunks (the last one partial where it does not
    divide)."""
    widths = KERNEL_HEAD_DIMS[dtype]
    assert widths[-1] == 256
    for d in range(1, 257):
        dp = padded_head_dim(d, dtype)
        assert dp in widths and dp >= d and value_chunks(d, dtype) == 1
        assert all(w < d for w in widths if w < dp)
    for d in range(257, 1100):
        dp = padded_head_dim(d, dtype)
        assert dp % SLICE == 0 and d <= dp < d + SLICE
        assert value_chunks(d, dtype) == -(-dp // WIDE_CHUNK[dtype])


# the f32 route: q, k, v not all f32, all bf16 or all f16 (jax, without
# x64, keeps an f64 array in f32, as the port's wrapper casts it)
REF_CASES = {"float16": (np.float16,) * 3,
             "mixed": (np.float32, "bfloat16", np.float16),
             "float64": (np.float64,) * 3,
             "int32": (np.int32,) * 3}


@pytest.mark.parametrize("hd", [264, 320, 512])
@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_mha_causal_dtypes_past_256_match_reference(case, hd):
    """GQA (4 query heads on 2 kv heads), S = 32 in blocks of 16, head dims
    past 256: the port's ``mha_causal`` on f16, mixed (q f32, k bf16, v
    f16), f64 and int32 inputs against the reference's ``mha_causal(
    use_kernel=False)`` on the same values, and B8's plain version against
    ``causal_attention_ref`` on the flat layout.  Both upcast each input to
    f32 and cast the output to q's dtype; the bars: 2e-5 (f32 outputs), one
    f16 step (an f16 output rounds f32 values that agree within 2e-5), 1
    for int32 (both truncate f32 values that agree within 2e-5)."""
    b, s, h, kv = 1, 32, 4, 2
    rng = np.random.default_rng(hd + len(case))
    arrs = []
    for n, kind in zip((h, kv, kv), REF_CASES[case]):
        a = rng.normal(size=(b, s, n, hd)).astype(np.float32)
        if kind == np.int32:
            a = np.round(2 * a)
        arrs.append(a)
    jarrs = [jnp.asarray(a, jnp.bfloat16 if kind == "bfloat16" else kind)
             for a, kind in zip(arrs, REF_CASES[case])]
    # the same values in torch: bf16 through f32, the rest as they are
    tarrs = [torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()
             if kind == "bfloat16" else torch.from_numpy(
                 np.asarray(a).astype(kind))
             for a, j, kind in zip(arrs, jarrs, REF_CASES[case])]
    atol, rtol = {"float16": (2 ** -14, 2 ** -10), "int32": (1, 0)}.get(
        case, (2e-5, 2e-5))
    got = mha_causal(*tarrs, block_q=16, block_k=16)
    want = np.asarray(ref_mha_causal(*jarrs, use_kernel=False))
    assert got.shape == (b, s, h, hd) and got.dtype == tarrs[0].dtype
    assert kernel_dtype(*tarrs) == (torch.float16 if case == "float16"
                                    else torch.float32)
    np.testing.assert_allclose(got.double().numpy(), want.astype(np.float64),
                               rtol=rtol, atol=atol)
    flat = [t.repeat_interleave(h // t.shape[2], dim=2).transpose(1, 2)
            .reshape(b * h, s, hd).contiguous() for t in tarrs]
    got = causal_attention_plain(*flat)
    want = np.asarray(causal_attention_ref(*(jnp.asarray(
        t.float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16
        else t.numpy().dtype) for t in flat)))
    np.testing.assert_allclose(got.double().numpy(), want.astype(np.float64),
                               rtol=rtol, atol=atol)


def test_blocks_are_cut_to_the_sequence():
    q = torch.randn(2, 64, 16)
    out = flash_attention(q, q, q, block_q=256, block_k=256)
    assert out.shape == q.shape


# ---------------------------------------------------------------------------
# The CUDA kernel's rounding points, emulated in plain torch on the CPU
# ---------------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits to
    the magnitude, then mask them off."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tensor_core_mm(a: torch.Tensor, b: torch.Tensor, split: bool):
    """``a @ b`` from TF32 operands and f32 sums: one pass of the rounded
    operands, or 3xTF32 (hi = tf32(x), lo = tf32(x - hi); the cross terms
    first, then hi·hi)."""
    ah, bh = _tf32(a), _tf32(b)
    if not split:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _emulated_kernel(q, k, v, mode: str) -> torch.Tensor:
    """Causal attention on (BH, S, d) f32 tensors with the kernel's rounding:
    ``mode`` "3xtf32" (the f32 kernel), "tf32" (one TF32 pass, what the f32
    kernel does not do) or "bf16" (bf16 q, k, v with exact products and f32
    sums, P rounded to bf16 before P·V, the output to bf16).  Scores are
    scaled after the product, in base 2, as the kernel keeps them."""
    s, d = q.shape[1:]
    if mode == "bf16":
        q, k, v = (t.bfloat16().float() for t in (q, k, v))
        sc = q @ k.transpose(1, 2)
    else:
        sc = _tensor_core_mm(q, k.transpose(1, 2), mode == "3xtf32")
    x = sc * (math.log2(math.e) / math.sqrt(d))
    causal = torch.ones((s, s), dtype=torch.bool).tril_()
    x = x.masked_fill(~causal, -1e30)
    p = torch.exp2(x - x.max(dim=-1, keepdim=True).values)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if mode == "bf16":
        return ((p.bfloat16().float() @ v) / denom).bfloat16().float()
    return _tensor_core_mm(p, v, mode == "3xtf32") / denom


@pytest.mark.parametrize("s", [256, 1024])
def test_kernel_rounding_points_hold_the_bars(s):
    """At d = 128 against ``causal_attention_ref``: 3xTF32 within the f32
    bar (2e-5), bf16 with P rounded to bf16 within its bar (2e-2), and one
    TF32 pass beyond 2e-5: why the f32 kernel splits its operands."""
    rng = np.random.default_rng(15 + s)
    q, k, v = (rng.normal(size=(2, s, 128)).astype(np.float32)
               for _ in range(3))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want = np.asarray(causal_attention_ref(*map(jnp.asarray, (q, k, v))))
    err = {mode: float(np.abs(_emulated_kernel(tq, tk, tv, mode).numpy()
                              - want).max())
           for mode in ("3xtf32", "tf32")}
    assert err["3xtf32"] <= 2e-5
    assert err["tf32"] > 2e-5
    # bf16: the oracle sees the same bf16 values, in f32
    q16, k16, v16 = (np.array(jnp.asarray(a, jnp.bfloat16).astype(
        jnp.float32)) for a in (q, k, v))
    want16 = np.asarray(causal_attention_ref(*map(jnp.asarray,
                                                  (q16, k16, v16))))
    got16 = _emulated_kernel(tq, tk, tv, "bf16").numpy()
    assert float(np.abs(got16 - want16).max()) <= 2e-2


def test_tf32_rounding_is_round_to_nearest_away():
    one = 1.0
    ulp = 2.0 ** -10                       # TF32's spacing just above 1
    x = torch.tensor([one + ulp / 2, one + ulp / 4, -(one + ulp / 2),
                      one + 3 * ulp / 2, 3.0], dtype=torch.float32)
    got = _tf32(x).tolist()
    assert got == [one + ulp, one, -(one + ulp), one + 2 * ulp, 3.0]
