"""SpGEMM hash-pad kernels, f32 and int8 (port of
``repro.kernels.spgemm_pad``)."""
from repro_torch.kernels.spgemm_pad.spgemm_pad import (
    LIBRARY, spgemm_hashpad, spgemm_hashpad_compact_plain,
    spgemm_hashpad_plain, spgemm_hashpad_q8, spgemm_hashpad_q8_compact_plain,
    spgemm_hashpad_q8_plain)

__all__ = ["LIBRARY", "spgemm_hashpad",
           "spgemm_hashpad_compact_plain", "spgemm_hashpad_plain",
           "spgemm_hashpad_q8", "spgemm_hashpad_q8_compact_plain",
           "spgemm_hashpad_q8_plain"]
