"""What the GNN drivers share: layer widths from a configuration, the
parameter tree flattened to named leaves, and a device synchronize."""
from __future__ import annotations

from typing import Dict, List

import torch


def dims(cfg: dict) -> List[int]:
    """Each layer's input width, then the last layer's output width."""
    return ([cfg["in_channels"]]
            + [cfg["hidden_channels"]] * (cfg["num_layers"] - 1)
            + [cfg["out_channels"]])


def flat(params: dict) -> Dict[str, torch.Tensor]:
    """``{"layer0": {"w": t}}`` as ``{"layer0.w": t}``."""
    return {f"{k}.{j}": v for k, leaf in params.items()
            for j, v in leaf.items()}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
