"""SpGEMM hash-pad kernel (port of ``repro.kernels.spgemm_pad``)."""
from repro_torch.kernels.spgemm_pad.spgemm_pad import (
    LIBRARY, spgemm_hashpad, spgemm_hashpad_plain)

__all__ = ["LIBRARY", "spgemm_hashpad", "spgemm_hashpad_plain"]
