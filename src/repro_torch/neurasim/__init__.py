"""NeuraSim, the paper's performance model of the NeuraChip machine (port
of ``repro.neurasim``)."""
from repro_torch.neurasim import datasets, machine, model  # noqa: F401
