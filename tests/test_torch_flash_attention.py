"""The port's causal flash attention (plain version on CPU tensors) against
the reference's ``mha_causal(use_kernel=False)`` and
``causal_attention_ref``, at ``tests/test_kernels.py``'s shapes and bars
(2e-5 f32; 2e-2 for bf16 against the f32 oracle).  The reference's Pallas
body is not the anchor: it does not run in interpret mode on this jax."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import mha_causal as ref_mha_causal
from repro.kernels.flash_attention.ref import causal_attention_ref
from repro_torch.kernels.flash_attention import (causal_attention_plain,
                                                 flash_attention, mha_causal)


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


@pytest.mark.parametrize("bad", ["block", "dtype", "mixed", "shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.randn(2, 64, 16)
    k, v = torch.randn_like(q), torch.randn_like(q)
    kw, err = {}, ValueError
    if bad == "block":
        kw["block_q"] = 48                    # does not divide S = 64
    elif bad == "dtype":
        q, k, v, err = q.half(), k.half(), v.half(), TypeError
    elif bad == "mixed":
        k, err = k.bfloat16(), TypeError
    else:
        v = v[:, :32].contiguous()
    with pytest.raises(err):
        flash_attention(q, k, v, **kw)


def test_blocks_are_cut_to_the_sequence():
    q = torch.randn(2, 64, 16)
    out = flash_attention(q, q, q, block_q=256, block_k=256)
    assert out.shape == q.shape
