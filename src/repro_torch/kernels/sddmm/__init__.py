"""SDDMM kernel (port of ``repro.kernels.sddmm``)."""
from repro_torch.kernels.sddmm.ops import edge_scores
from repro_torch.kernels.sddmm.sddmm import LIBRARY, sddmm, sddmm_plain

__all__ = ["LIBRARY", "edge_scores", "sddmm", "sddmm_plain"]
