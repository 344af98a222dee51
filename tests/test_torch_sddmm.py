"""The port's SDDMM kernel (plain version on CPU tensors) against the
reference's oracle ``sddmm_ref`` and its ``edge_scores(use_kernel=False)``,
at ``tests/test_kernels.py``'s shapes and bar (1e-5)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sddmm.ops import edge_scores as ref_edge_scores
from repro.kernels.sddmm.ref import sddmm_ref
from repro_torch.kernels.sddmm import edge_scores, sddmm, sddmm_plain


def _inputs(n, e, d, ny=None):
    rng = np.random.default_rng(d)
    ny = n if ny is None else ny
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, ny, e).astype(np.int32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(ny, d)).astype(np.float32)
    return src, dst, x, y


@pytest.mark.parametrize("n,e,d", [(40, 256, 32), (17, 100, 64),
                                   (8, 64, 128)])
def test_edge_scores_match_reference(n, e, d):
    src, dst, x, y = _inputs(n, e, d)
    got = edge_scores(*map(torch.from_numpy, (src, dst, x, y)),
                      edge_block=64)
    want = np.asarray(sddmm_ref(*map(jnp.asarray, (src, dst, x, y))))
    assert got.shape == (e,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    ref_plain = np.asarray(ref_edge_scores(*map(jnp.asarray,
                                                (src, dst, x, y)),
                                           edge_block=64, use_kernel=False))
    np.testing.assert_allclose(got.numpy(), ref_plain, rtol=1e-5, atol=1e-5)


def test_x_and_y_may_have_different_row_counts():
    src, dst, x, y = _inputs(30, 128, 16, ny=7)
    got = sddmm(*map(torch.from_numpy, (src, dst, x, y)), edge_block=64)
    want = np.asarray(sddmm_ref(*map(jnp.asarray, (src, dst, x, y))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_plain_chunks_agree_with_one_pass(monkeypatch):
    sddmm_module = importlib.import_module("repro_torch.kernels.sddmm.sddmm")
    src, dst, x, y = _inputs(50, 1000, 24)
    args = tuple(map(torch.from_numpy, (src, dst, x, y)))
    one_pass = sddmm_plain(*args)
    monkeypatch.setattr(sddmm_module, "PLAIN_EDGE_CHUNK", 77)
    assert torch.equal(sddmm_plain(*args), one_pass)


def test_out_of_range_indices_follow_jnp_take():
    src, dst, x, y = _inputs(10, 64, 8)
    src[:3] = [-1, 10, -11]
    dst[3] = 12
    got = sddmm(*map(torch.from_numpy, (src, dst, x, y)), edge_block=64)
    want = np.asarray(sddmm_ref(*map(jnp.asarray, (src, dst, x, y))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.isnan(got.numpy()[1:4]).all() and np.isfinite(got.numpy()[0])


@pytest.mark.parametrize("bad", ["edge_block", "src_dtype", "x_dtype",
                                 "width", "shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    src, dst, x, y = map(torch.from_numpy, _inputs(10, 128, 8))
    kw, err = {"edge_block": 64}, ValueError
    if bad == "edge_block":
        kw["edge_block"] = 100
    elif bad == "src_dtype":
        src, err = src.long(), TypeError
    elif bad == "x_dtype":
        x, err = x.half(), TypeError
    elif bad == "width":
        y = y[:, :4].contiguous()
    else:
        dst = dst[:64]
    with pytest.raises(err):
        sddmm(src, dst, x, y, **kw)
