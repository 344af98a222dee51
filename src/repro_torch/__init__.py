"""PyTorch/CUDA port of the NeuraChip reproduction (``repro``).

The JAX package ``repro`` stays the reference; this package mirrors its
layout module by module (``repro_torch.sparse.plan`` ↔ ``repro.sparse.plan``)
and never imports it, nor JAX.  Each Pallas TPU kernel on a ported path is a
CUDA kernel written by hand for Hopper (``kernels/*/csrc``), built with
``nvcc`` at first use and bound with ``ctypes``.

Entry points take ``device=None`` and then run on ``cuda``; they raise when
no GPU is present unless the caller passes ``device="cpu"``, where every
kernel wrapper runs its plain PyTorch version instead.
"""
