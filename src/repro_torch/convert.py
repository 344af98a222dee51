"""Parameter conversion from the JAX reference to the port.

The two packages draw different random numbers from the same seed, so
parity is checked by carrying the reference's parameters across.  The
reference's GCN parameters are ``{"layer{i}": {"w": (d_in, d_out),
"b": (d_out,)}}``, GAT's ``{"layer{i}": {"w": (d_in, heads, d_out),
"a_src", "a_dst": (heads, d_out), "b": (heads·d_out,)}}``, GIN's
``{"layer{i}": {"mlp": {"w{j}", "b{j}"}, "eps": ()}}``, SAGE's
``{"layer{i}": {"w_self", "w_nbr": (d_in, d_out), "b": (d_out,)}}``,
SchNet's ``{"embed": (S, d), "atomwise": mlp, "int{i}": {"w_in",
"filter": mlp, "w_out1", "w_out2"}}``, DimeNet's ``{"embed", "rbf_embed",
"edge_embed": mlp, "output": mlp, "blocks": {...}}`` (per-block weights
stacked on a leading axis), DLRM's ``{"table": (V, D), "bot": {"w{i}",
"b{i}"}, "top": {"w{i}", "b{i}"}}`` and the LM's ``{"embed": (V, D),
"final_norm": (D,)[, "unembed": (D, V)], "sub{i}": {"ln1", "ln2", "attn",
"mlp"}}`` (per-super-layer weights stacked on a leading ``n_super``
axis); the port keeps every layout, so conversion is a checked copy of
each array onto the device.
Input arrays are numpy (``np.asarray`` of the JAX leaves): this module
never imports JAX, nor ``ml_dtypes``, whose bfloat16 arrays it recognises
by their dtype's name and size and carries across bit for bit.
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


def _layers(tree: Mapping[str, Mapping], keys: set):
    """The tree's ``layer{i}`` entries in order, each with exactly
    ``keys``."""
    want = {f"layer{i}" for i in range(len(tree))}
    if set(tree) != want:
        raise ValueError(f"layers {sorted(tree)}, expected {sorted(want)}")
    for i in range(len(tree)):
        p = tree[f"layer{i}"]
        if set(p) != keys:
            raise ValueError(f"layer{i} has keys {sorted(p)}, expected "
                             f"{sorted(keys)}")
        yield i, p


def _bf16_numpy(a: np.ndarray) -> bool:
    """An ``ml_dtypes.bfloat16`` array, known by name and size (the port
    does not import ml_dtypes)."""
    return a.dtype.name == "bfloat16" and a.dtype.itemsize == 2


def _t(a, dev: torch.device) -> torch.Tensor:
    """A copy of ``a`` on ``dev``; a bfloat16 array (which
    ``torch.from_numpy`` refuses) goes across as its 16-bit patterns and
    is viewed as ``torch.bfloat16``, bit for bit."""
    a = np.asarray(a)
    if _bf16_numpy(a):
        bits = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def gat_params_from_jax(tree: Mapping[str, Mapping[str, np.ndarray]],
                        device: DeviceLike = None) -> Dict:
    """Reference GAT parameter tree (numpy leaves) → port parameters."""
    dev = resolve_device(device)
    out, d_prev = {}, None
    for i, p in _layers(tree, {"w", "a_src", "a_dst", "b"}):
        w = np.asarray(p["w"])
        if w.ndim != 3:
            raise ValueError(f"layer{i}.w has shape {w.shape}, expected "
                             "(d_in, heads, d_out)")
        _, heads, d_out = w.shape
        for k in ("a_src", "a_dst"):
            if np.shape(p[k]) != (heads, d_out):
                raise ValueError(f"layer{i}.{k} has shape {np.shape(p[k])}"
                                 f", expected {(heads, d_out)}")
        if np.shape(p["b"]) != (heads * d_out,):
            raise ValueError(f"layer{i}.b has shape {np.shape(p['b'])}, "
                             f"expected {(heads * d_out,)}")
        if d_prev is not None and w.shape[0] != d_prev:
            raise ValueError(f"layer{i}.w takes {w.shape[0]} inputs, the "
                             f"layer before gives {d_prev}")
        d_prev = heads * d_out
        out[f"layer{i}"] = {k: _t(p[k], dev) for k in p}
    return out


def gin_params_from_jax(tree: Mapping[str, Mapping[str, object]],
                        device: DeviceLike = None) -> Dict:
    """Reference GIN parameter tree (numpy leaves) → port parameters."""
    dev = resolve_device(device)
    out = {}
    for i, p in _layers(tree, {"mlp", "eps"}):
        if np.shape(p["eps"]) != ():
            raise ValueError(f"layer{i}.eps has shape "
                             f"{np.shape(p['eps'])}, expected ()")
        out[f"layer{i}"] = {"mlp": _mlp_from_jax(f"layer{i}.mlp", p["mlp"],
                                                 dev),
                            "eps": _t(p["eps"], dev)}
    return out


def sage_params_from_jax(tree: Mapping[str, Mapping[str, np.ndarray]],
                         device: DeviceLike = None) -> Dict:
    """Reference GraphSAGE parameter tree (numpy leaves) → port
    parameters."""
    dev = resolve_device(device)
    out = {}
    for i, p in _layers(tree, {"w_self", "w_nbr", "b"}):
        ws, wn = np.asarray(p["w_self"]), np.asarray(p["w_nbr"])
        if ws.ndim != 2 or ws.shape != wn.shape or np.shape(p["b"]) != (
                ws.shape[1],):
            raise ValueError(f"layer{i}: w_self {ws.shape}, w_nbr "
                             f"{wn.shape} and b {np.shape(p['b'])} do not "
                             "form a (d_in, d_out) layer")
        out[f"layer{i}"] = {k: _t(p[k], dev) for k in p}
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


def _square(name: str, a, d: int):
    if np.shape(a) != (d, d):
        raise ValueError(f"{name} has shape {np.shape(a)}, expected "
                         f"{(d, d)}")


def schnet_params_from_jax(tree: Mapping[str, object],
                           device: DeviceLike = None) -> Dict:
    """Reference SchNet parameter tree (numpy leaves) → port parameters."""
    dev = resolve_device(device)
    n_int = len(tree) - 2
    want = {"embed", "atomwise"} | {f"int{i}" for i in range(n_int)}
    if set(tree) != want:
        raise ValueError(f"SchNet tree has keys {sorted(tree)}, expected "
                         f"{sorted(want)}")
    embed = np.asarray(tree["embed"])
    if embed.ndim != 2:
        raise ValueError(f"embed has shape {embed.shape}, expected "
                         "(n_species, d)")
    d = embed.shape[1]
    out = {"embed": _t(embed, dev),
           "atomwise": _mlp_from_jax("atomwise", tree["atomwise"], dev)}
    if out["atomwise"]["w0"].shape[0] != d:
        raise ValueError(f"atomwise takes {out['atomwise']['w0'].shape[0]}"
                         f" inputs, the embedding gives {d}")
    for i in range(n_int):
        p = tree[f"int{i}"]
        if set(p) != {"w_in", "filter", "w_out1", "w_out2"}:
            raise ValueError(f"int{i} has keys {sorted(p)}, expected "
                             "filter, w_in, w_out1, w_out2")
        for k in ("w_in", "w_out1", "w_out2"):
            _square(f"int{i}.{k}", p[k], d)
        filt = _mlp_from_jax(f"int{i}.filter", p["filter"], dev)
        n = len(filt) // 2
        if filt[f"w{n - 1}"].shape[1] != d:
            raise ValueError(f"int{i}.filter gives "
                             f"{filt[f'w{n - 1}'].shape[1]} channels, the "
                             f"interaction has {d}")
        out[f"int{i}"] = {"w_in": _t(p["w_in"], dev), "filter": filt,
                          "w_out1": _t(p["w_out1"], dev),
                          "w_out2": _t(p["w_out2"], dev)}
    return out


def dimenet_params_from_jax(tree: Mapping[str, object],
                            device: DeviceLike = None) -> Dict:
    """Reference DimeNet parameter tree (numpy leaves) → port
    parameters: the per-block weights stay stacked on their leading
    ``n_blocks`` axis."""
    dev = resolve_device(device)
    top = {"embed", "rbf_embed", "edge_embed", "output", "blocks"}
    if set(tree) != top:
        raise ValueError(f"DimeNet tree has keys {sorted(tree)}, expected "
                         f"{sorted(top)}")
    embed = np.asarray(tree["embed"])
    rbf_embed = np.asarray(tree["rbf_embed"])
    if embed.ndim != 2 or rbf_embed.ndim != 2 or (
            rbf_embed.shape[1] != embed.shape[1]):
        raise ValueError(f"embed {embed.shape} and rbf_embed "
                         f"{rbf_embed.shape} are not (S, d) and (R, d)")
    d = embed.shape[1]
    r = rbf_embed.shape[0]
    blocks = tree["blocks"]
    keys = {"w_src", "w_rbf_gate", "w_sbf", "w_bilinear", "w_self",
            "w_out1", "w_out2", "rbf_out"}
    if set(blocks) != keys:
        raise ValueError(f"blocks has keys {sorted(blocks)}, expected "
                         f"{sorted(keys)}")
    nb = np.shape(blocks["w_src"])[0]
    sbf = np.shape(blocks["w_sbf"])
    if len(sbf) != 3:
        raise ValueError(f"blocks.w_sbf has shape {sbf}, expected "
                         "(n_blocks, n_sbf, n_bilinear)")
    want = {"w_src": (nb, d, d), "w_rbf_gate": (nb, r, d),
            "w_sbf": (nb, sbf[1], sbf[2]),
            "w_bilinear": (nb, sbf[2], d, d), "w_self": (nb, d, d),
            "w_out1": (nb, d, d), "w_out2": (nb, d, d),
            "rbf_out": (nb, r, d)}
    for k, shape in want.items():
        if np.shape(blocks[k]) != shape:
            raise ValueError(f"blocks.{k} has shape {np.shape(blocks[k])}"
                             f", expected {shape}")
    edge = _mlp_from_jax("edge_embed", tree["edge_embed"], dev)
    output = _mlp_from_jax("output", tree["output"], dev)
    if edge["w0"].shape[0] != 3 * d or output["w0"].shape[0] != d:
        raise ValueError(f"edge_embed takes {edge['w0'].shape[0]} inputs "
                         f"(want {3 * d}), output {output['w0'].shape[0]} "
                         f"(want {d})")
    return {"embed": _t(embed, dev), "rbf_embed": _t(rbf_embed, dev),
            "edge_embed": edge, "output": output,
            "blocks": {k: _t(blocks[k], dev) for k in want}}


def _check_shape(name: str, a, want) -> None:
    if tuple(np.shape(a)) != tuple(want):
        raise ValueError(f"{name} has shape {tuple(np.shape(a))}, expected "
                         f"{tuple(want)}")


def lm_params_from_jax(tree: Mapping[str, object],
                       device: DeviceLike = None) -> Dict:
    """Reference LM parameter tree (numpy leaves, bf16 as
    ``ml_dtypes.bfloat16``) → port parameters, after a check of every key
    and shape: ``embed`` (V, D), ``final_norm`` (D,), ``unembed`` (D, V)
    unless the embeddings are tied, and for each ``sub{i}`` of n
    super-layers ``ln1``/``ln2`` (n, D), ``attn`` ``wq`` (n, D, H·hd),
    ``wk``/``wv`` (n, D, KV·hd), ``wo`` (n, H·hd, D) with ``q_norm``/
    ``k_norm`` (n, hd) both or neither, and ``mlp`` dense ``wg``/``wu``
    (n, D, F), ``wd`` (n, F, D) or MoE ``router`` (n, D, E), ``wg``/``wu``
    (n, E, D, F), ``wd`` (n, E, F, D)."""
    dev = resolve_device(device)
    n_sub = sum(1 for k in tree if k.startswith("sub"))
    want = ({"embed", "final_norm"} | {f"sub{i}" for i in range(n_sub)}
            | ({"unembed"} & set(tree)))
    if set(tree) != want or n_sub == 0:
        raise ValueError(f"LM tree has keys {sorted(tree)}, expected "
                         f"{sorted(want)} with at least one sub-layer")
    embed = np.asarray(tree["embed"])
    if embed.ndim != 2:
        raise ValueError(f"embed has shape {embed.shape}, expected (V, D)")
    v, d = embed.shape
    _check_shape("final_norm", tree["final_norm"], (d,))
    out = {"embed": _t(embed, dev),
           "final_norm": _t(tree["final_norm"], dev)}
    if "unembed" in tree:
        _check_shape("unembed", tree["unembed"], (d, v))
        out["unembed"] = _t(tree["unembed"], dev)
    n = None
    for i in range(n_sub):
        sub = tree[f"sub{i}"]
        if set(sub) != {"ln1", "ln2", "attn", "mlp"}:
            raise ValueError(f"sub{i} has keys {sorted(sub)}, expected "
                             "attn, ln1, ln2, mlp")
        if n is None:
            n = np.shape(sub["ln1"])[0] if np.ndim(sub["ln1"]) else 0
        for k in ("ln1", "ln2"):
            _check_shape(f"sub{i}.{k}", sub[k], (n, d))
        attn, mlp = sub["attn"], sub["mlp"]
        norms = {"q_norm", "k_norm"} & set(attn)
        if set(attn) - norms != {"wq", "wk", "wv", "wo"} or len(norms) == 1:
            raise ValueError(f"sub{i}.attn has keys {sorted(attn)}, "
                             "expected wk, wo, wq, wv and q_norm, k_norm "
                             "both or neither")
        hq = np.shape(attn["wq"])[-1]
        kv = np.shape(attn["wk"])[-1]
        _check_shape(f"sub{i}.attn.wq", attn["wq"], (n, d, hq))
        _check_shape(f"sub{i}.attn.wk", attn["wk"], (n, d, kv))
        _check_shape(f"sub{i}.attn.wv", attn["wv"], (n, d, kv))
        _check_shape(f"sub{i}.attn.wo", attn["wo"], (n, hq, d))
        if norms:
            hd = np.shape(attn["q_norm"])[-1]
            if hd == 0 or hq % hd or kv % hd:
                raise ValueError(f"sub{i}.attn: head dim {hd} does not "
                                 f"divide the q width {hq} and kv width "
                                 f"{kv}")
            for k in ("q_norm", "k_norm"):
                _check_shape(f"sub{i}.attn.{k}", attn[k], (n, hd))
        if "router" in mlp:
            if set(mlp) != {"router", "wg", "wu", "wd"}:
                raise ValueError(f"sub{i}.mlp has keys {sorted(mlp)}, "
                                 "expected router, wd, wg, wu")
            e = np.shape(mlp["router"])[-1]
            f = np.shape(mlp["wg"])[-1]
            _check_shape(f"sub{i}.mlp.router", mlp["router"], (n, d, e))
            shapes = {"wg": (n, e, d, f), "wu": (n, e, d, f),
                      "wd": (n, e, f, d)}
        else:
            if set(mlp) != {"wg", "wu", "wd"}:
                raise ValueError(f"sub{i}.mlp has keys {sorted(mlp)}, "
                                 "expected wd, wg, wu")
            f = np.shape(mlp["wg"])[-1]
            shapes = {"wg": (n, d, f), "wu": (n, d, f), "wd": (n, f, d)}
        for k, shape in shapes.items():
            _check_shape(f"sub{i}.mlp.{k}", mlp[k], shape)
        out[f"sub{i}"] = {
            "ln1": _t(sub["ln1"], dev),
            "ln2": _t(sub["ln2"], dev),
            "attn": {k: _t(a, dev) for k, a in attn.items()},
            "mlp": {k: _t(a, dev) for k, a in mlp.items()}}
    return out
