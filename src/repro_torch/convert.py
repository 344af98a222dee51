"""Parameter conversion from the JAX reference to the port.

The two packages draw different random numbers from the same seed, so
parity is checked by carrying the reference's parameters across.  The
reference's GCN parameters are ``{"layer{i}": {"w": (d_in, d_out),
"b": (d_out,)}}`` and its DLRM parameters ``{"table": (V, D), "bot":
{"w{i}", "b{i}"}, "top": {"w{i}", "b{i}"}}``; the port keeps both
layouts, so conversion is a checked copy of each array onto the device.
Input arrays are numpy (``np.asarray`` of the JAX leaves): this module
never imports JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping

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


def _mlp_from_jax(name: str, tree: Mapping[str, np.ndarray],
                  dev: torch.device) -> Dict[str, torch.Tensor]:
    """One MLP ``{"w{i}", "b{i}"}``: each layer (d_in, d_out) with a
    (d_out,) bias, and each layer's d_in the previous layer's d_out."""
    n = len(tree) // 2
    want = {f"{p}{i}" for p in "wb" for i in range(n)}
    if set(tree) != want or n == 0:
        raise ValueError(f"{name} has keys {sorted(tree)}, expected "
                         f"{sorted(want)}")
    out = {}
    for i in range(n):
        w = np.asarray(tree[f"w{i}"])
        b = np.asarray(tree[f"b{i}"])
        if w.ndim != 2 or b.shape != (w.shape[1],):
            raise ValueError(f"{name}.w{i} {w.shape} and b{i} {b.shape} do "
                             "not form a (d_in, d_out) layer")
        if i and w.shape[0] != out[f"w{i - 1}"].shape[1]:
            raise ValueError(f"{name}.w{i} takes {w.shape[0]} inputs, the "
                             f"layer before gives {out[f'w{i - 1}'].shape[1]}")
        out[f"w{i}"] = torch.from_numpy(w.copy()).to(dev)
        out[f"b{i}"] = torch.from_numpy(b.copy()).to(dev)
    return out


def dlrm_params_from_jax(tree: Mapping[str, object],
                         device: DeviceLike = None) -> Dict[str, object]:
    """Reference DLRM parameter tree (numpy leaves) → port parameters."""
    dev = resolve_device(device)
    if set(tree) != {"table", "bot", "top"}:
        raise ValueError(f"DLRM tree has keys {sorted(tree)}, expected "
                         "bot, table, top")
    table = np.asarray(tree["table"])
    if table.ndim != 2:
        raise ValueError(f"table has shape {table.shape}, expected (V, D)")
    bot = _mlp_from_jax("bot", tree["bot"], dev)
    top = _mlp_from_jax("top", tree["top"], dev)
    n_bot = len(bot) // 2
    if bot[f"w{n_bot - 1}"].shape[1] != table.shape[1]:
        raise ValueError(f"bottom MLP gives {bot[f'w{n_bot - 1}'].shape[1]}"
                         f" features, the table has D = {table.shape[1]}")
    return {"table": torch.from_numpy(table.copy()).to(dev), "bot": bot,
            "top": top}
