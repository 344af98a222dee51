"""The precision a reference's matrix products run in.

``float32`` is the stated precision: full f32 products, TF32 off.
``tf32`` is the control, the nearest precision below it: on the card the
products run on the tensor cores in TF32; on the CPU, which has no TF32,
each operand is rounded to TF32's 10-bit mantissa (round to nearest even)
and the product is taken in f32, as the tensor cores do.
"""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float32", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32: 13 low mantissa bits cleared, to
    nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def matmul_precision(precision: str):
    """Products inside the block run in ``precision`` on the card; the
    flags are restored after it."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}; have {PRECISIONS}")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class _Tf32MatMul(torch.autograd.Function):
    """``a @ b`` with TF32 operands, and so its two backward products."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in ``precision`` (call inside ``matmul_precision``)."""
    if precision == "tf32" and a.device.type == "cpu":
        return _Tf32MatMul.apply(a, b)
    return a @ b
