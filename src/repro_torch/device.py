"""Device selection shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device without a GPU raises: the CPU
    is used only when the caller asks for it.

    Picking a CUDA device also turns TF32 off for matmuls and convolutions,
    because the parity bounds against the JAX reference (≤1e-4 executor vs
    dense, ≤1e-5 served vs offline) assume full f32 products.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU with its plain kernel versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:       # "cuda" and "cuda:0" must compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def host_to_device(a, device: torch.device,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a`` (a host array or a tensor) as a tensor on ``device``, without a
    host sync: a blocking host-to-device copy waits for every launch queued
    on the stream, so a served step's inputs would wait for the step before
    it.  The driver stages pageable host memory before the asynchronous
    copy returns, so ``a`` may be reused at once."""
    t = torch.as_tensor(a, dtype=dtype)
    if t.device == device:
        return t
    return t.to(device, non_blocking=True)
