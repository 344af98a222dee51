"""The port's gradient compression (``repro_torch.optim.compression``)
against the reference's (``repro.optim.compression``) on the CPU: int8
codes, scales and decoded values bitwise at lengths that are and are not
whole blocks, with all-zero blocks and exact .5 ties, in f32 and bf16; a
50-step error-feedback trajectory compared step by step; and the
reference's own compression tests run against the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as J
from repro_torch.optim import compression as C

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _case(n, seed):
    """Normal values at a random magnitude, a third of them on .5 ties of
    their block's quantum, and (past one block) an all-zero block."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32) * rng.choice([1e-3, 1.0, 50.0])
    x[: n // 3] = np.round(x[: n // 3] * 2) / 2
    if n > 256:
        x[256:512] = 0.0
    return x


def _both(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000, 4099])
@pytest.mark.parametrize("block", [256, 64])
def test_quantize_dequantize_bitwise(n, dtype, block):
    jx, tx = _both(_case(n, n + block), dtype)
    qj, sj = J.quantize_int8(jx, block)
    qt, st = C.quantize_int8(tx, block)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    dj = J.dequantize_int8(qj, sj, jx.shape, jx.dtype)
    dt = C.dequantize_int8(qt, st, tx.shape, tx.dtype)
    assert dt.dtype == tx.dtype and tuple(dt.shape) == tuple(jx.shape)
    np.testing.assert_array_equal(_np(dt), _np(dj))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_exact_ties_round_half_to_even(dtype):
    # the block's max is 127, so its scale is exactly 1 and x / scale = x
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5],
                 np.float32)
    jx, tx = _both(x, dtype)
    qt, st = C.quantize_int8(tx, block=8)
    qj, _ = J.quantize_int8(jx, block=8)
    assert float(st[0, 0]) == 1.0
    np.testing.assert_array_equal(qt.numpy()[0],
                                  [127, 0, 2, 2, 0, -2, 4, -126])
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))


def test_error_feedback_trajectory_50_steps_bitwise():
    rng = np.random.default_rng(3)
    g = {"w": rng.normal(size=(64, 64)).astype(np.float32),
         "b": rng.normal(size=(300,)).astype(np.float32) * 1e-3,
         "z": np.zeros((17,), np.float32)}
    rj = J.init_residual({k: jnp.asarray(v) for k, v in g.items()})
    rt = C.init_residual({k: torch.from_numpy(v) for k, v in g.items()})
    for step in range(50):
        scale = 1.0 + 0.01 * step
        dj, rj = J.error_feedback_compress(
            {k: jnp.asarray(v * scale) for k, v in g.items()}, rj)
        dt, rt = C.error_feedback_compress(
            {k: torch.from_numpy(v * scale) for k, v in g.items()}, rt)
        for k in g:
            np.testing.assert_array_equal(dt[k].numpy(), np.asarray(dj[k]),
                                          err_msg=f"step {step} {k}")
            np.testing.assert_array_equal(rt[k].numpy(), np.asarray(rj[k]),
                                          err_msg=f"step {step} {k}")


def test_error_feedback_bf16_gradients_bitwise():
    rng = np.random.default_rng(4)
    g = rng.normal(size=(3, 1000)).astype(np.float32)
    jg = {"a": jnp.asarray(g).astype(jnp.bfloat16)}
    tg = {"a": torch.from_numpy(g).to(torch.bfloat16)}
    rj, rt = J.init_residual(jg), C.init_residual(tg)
    assert rt["a"].dtype == torch.float32
    for step in range(5):
        dj, rj = J.error_feedback_compress(jg, rj)
        dt, rt = C.error_feedback_compress(tg, rt)
        assert dt["a"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(dt["a"]), _np(dj["a"]))
        np.testing.assert_array_equal(rt["a"].numpy(), np.asarray(rj["a"]))


def test_compressed_grads_error_feedback():
    """Counterpart of ``test_system.py``'s: int8 + error feedback, the
    long-run average ≈ the true gradient."""
    rng = np.random.default_rng(0)
    g_true = {"w": torch.from_numpy(rng.normal(size=(64, 64)).astype(
        np.float32))}
    residual = C.init_residual(g_true)
    acc = torch.zeros_like(g_true["w"])
    for _ in range(50):
        dec, residual = C.error_feedback_compress(g_true, residual)
        acc = acc + dec["w"]
    np.testing.assert_allclose((acc / 50).numpy(), g_true["w"].numpy(),
                               atol=2e-2)


def test_compression_zero_block_scale_guard():
    """Counterpart of ``test_quantized.py``'s."""
    x = torch.zeros((512,), dtype=torch.float32)
    x[300] = 5.0
    q, scale = C.quantize_int8(x, block=256)
    s = scale.reshape(-1).numpy()
    assert s[0] == 1.0                      # all-zero block: guard scale
    assert np.isfinite(1.0 / s).all()       # no inf/NaN in scale arithmetic
    back = C.dequantize_int8(q, scale, x.shape, x.dtype)
    assert np.all(back[:256].numpy() == 0.0)
    assert abs(float(back[300]) - 5.0) <= float(s[1]) * 0.5 + 1e-6


def test_residual_structure_and_wire_bytes():
    params = {"a": torch.zeros((3, 5), dtype=torch.bfloat16),
              "b": {"c": torch.zeros((600,))}}
    r = C.init_residual(params)
    assert r["a"].dtype == torch.float32 and r["a"].shape == (3, 5)
    assert r["b"]["c"].shape == (600,)
    # 15 elements: one block of 256; 600: three blocks
    assert C.wire_bytes(params) == 4 * (256 + 4)
    with pytest.raises(ValueError):
        C.error_feedback_compress(params, {"a": r["a"]})
