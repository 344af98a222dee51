"""Parameter conversion from the JAX reference to the port.

The two packages draw different random numbers from the same seed, so
parity is checked by carrying the reference's parameters across.  The
reference's GCN parameters are ``{"layer{i}": {"w": (d_in, d_out),
"b": (d_out,)}}``; the port keeps that layout, so conversion is a copy of
each array onto the device.  Input arrays are numpy (``np.asarray`` of the
JAX leaves): this module never imports JAX.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.gnn.gcn import Params


def gcn_params_from_jax(tree: Mapping[str, Mapping[str, np.ndarray]],
                        device: DeviceLike = None) -> Params:
    """Reference GCN parameter tree (numpy leaves) → port parameters."""
    dev = resolve_device(device)
    out = {}
    for layer, p in tree.items():
        if set(p) != {"w", "b"}:
            raise ValueError(f"{layer} has keys {sorted(p)}, expected b, w")
        w = np.asarray(p["w"])
        b = np.asarray(p["b"])
        if w.ndim != 2 or b.shape != (w.shape[1],):
            raise ValueError(f"{layer}: w {w.shape} and b {b.shape} do not "
                             "form a (d_in, d_out) layer")
        out[layer] = {"w": torch.from_numpy(w.copy()).to(dev),
                      "b": torch.from_numpy(b.copy()).to(dev)}
    return out
