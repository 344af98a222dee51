"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates
without sparsity, at the full 700 W power limit).  A roofline share or an
MFU is stated against these, with the card's power limit beside it."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12

# operations a second by the precision an operation runs in
FLOPS_PER_S = {
    "float32": 67e12,        # f32 outside the tensor cores (TF32 off)
    "tf32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
    "fp8": 1979e12,
    "int8": 1979e12,
}


def flops_peak(precision: str) -> float:
    """The peak for ``precision`` (a key of ``FLOPS_PER_S``)."""
    try:
        return FLOPS_PER_S[precision]
    except KeyError:
        raise KeyError(f"no published peak for {precision!r}; have "
                       f"{sorted(FLOPS_PER_S)}") from None
