"""Decoder-only transformer family of the five LM archs (port of
``repro.models.lm.transformer``).

GQA (a kv head count of its own), an explicit head_dim (gemma: 256 ≠
d_model/n_heads), RoPE, optional per-head qk RMS-norm (qwen3), GeGLU
(tanh GELU, as ``jax.nn.gelu``) or SwiGLU MLPs, capacity-based top-k MoE
with interleaved MoE layers (llama4: every other layer; grok-1: all),
blocked causal attention, chunked cross-entropy (never the whole (T, V)
logits) and a KV-cache decode path, fixed and ragged.

Parameters are plain dicts of tensors in the reference's stacked layout:
``sub{i}`` holds ``ln1``, ``ln2``, ``attn`` (``wq``, ``wk``, ``wv``,
``wo`` and, with qk-norm, ``q_norm``, ``k_norm``) and ``mlp``, each with a
leading ``n_super`` axis; the reference's scan over super-layers is a
Python loop over that axis (``unbind`` once a call, so the backward
stacks each leaf's gradient once).

Attention: ``forward`` and ``prefill`` take ``attention``:

* ``"flash"`` — B8 through ``kernels/flash_attention/ops.mha_causal``
  with the reference's chunk choice as its blocks (the CUDA kernel tiles
  on its own).  B8 has no backward, so asking for it while a gradient is
  to flow raises.  It takes every head dim (gemma's 256 and the reduced
  configs' 8-24 included) and every real dtype, as the reference's kernel
  does; on a CUDA tensor it launches the kernel, on a CPU tensor it runs
  its plain version;
* ``"blocked"`` — the port of ``blocked_causal_attention``, each q chunk
  under ``torch.utils.checkpoint`` as the reference's ``jax.checkpoint``.
  A kv chunk that lies wholly above the diagonal of its q chunk is
  skipped: it would add exp(−1e30 − m) = 0 to the sums and scale them by
  exp(0) = 1, so skipping it changes no value.

Products that the reference takes with ``preferred_element_type=f32``
upcast their operands instead (the product of two bf16 values is exact in
f32), and P is rounded to v's type before P·v, as there.  The decode
attention stays plain PyTorch, as the reference computes it outside
Pallas.  ``decode_step`` and ``decode_step_ragged`` write the new KV rows
into the cache tensors in place and return the same cache.  On a
``DTensor`` cache whose sequence is split (long_500k's layout: over
every mesh axis; decode_32k's: over ``model``, the batch over dp),
``decode_step`` writes and attends flash-decoding style: each rank on its
own slice of the sequence, the partial softmax sums joined by one
max-reduce and two sum-reduces (``_decode_block_seq``).

Every sum of a training step is order-fixed on the card: the embedding
lookup's backward (``segment_ops.take``), the MoE dispatch
(``segment_ops.segment_sum``) and combine (``segment_ops.gather``).

``param_specs`` and ``cache_specs`` give the parameter and cache trees
as ``meta`` tensors (``tree.eval_shape``, the counterpart of the
reference's ``jax.eval_shape``): what the dry run shards.

Sharding (``cfg.dp_axes``/``cfg.tp_axis``, empty on one device): ``_psc``
is the reference's activation constraint — a ``DTensor`` activation is
redistributed to the spec's placements (``core.distributed.constrain``),
a plain tensor passes as it is.  With ``dp_axes`` set, ``forward`` and
``prefill`` run the MoE layers through ``moe_mlp_sharded``, the
reference's per-device dispatch under ``shard_map``
(``core.distributed.shard_map`` over the mesh of the ``DTensor`` inputs,
or the ambient ``distributed.use_mesh`` mesh for global-view tensors on
SPMD ranks): expert-parallel by ``all_to_all`` over ``tp`` when the
experts divide over it, the FFN hidden dim split over ``tp`` and joined
by a ``psum`` otherwise.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.distributed import constrain, flattens_split
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention.ops import mha_causal
from repro_torch.models.common import rms_norm
from repro_torch.sparse.segment_ops import gather, segment_sum, take

Params = Dict[str, object]
ATTENTION = ("flash", "blocked")


def _batch_rows(y, cfg: "LMConfig"):
    """A (B, S, D) sub-layer output or embedding batch-sharded, the rows
    whole, before it joins the sequence-sharded residual stream: the
    gradient then reaches the product's backward with its (B, S) rows
    whole, which DTensor flattens on every torch version (2.11's cannot
    flatten a batch and a sequence both split)."""
    return _psc(y, cfg, "dp", None, None)


def _rows_whole(x, cfg: "LMConfig"):
    """``x`` (B, S, …) batch-sharded with its sequence whole where this
    torch's DTensor cannot flatten (B, S) rows whose S is split
    (``flattens_split``: 2.11 cannot; 2.13 flattens them into a strided
    shard and moves nothing), else ``x`` as it is."""
    mesh = getattr(x, "device_mesh", None)
    if mesh is None or flattens_split(mesh):
        return x
    return _psc(x, cfg, "dp", *(None,) * (x.ndim - 1))


def _psc(x, cfg: "LMConfig", *spec):
    """The reference's sharding constraint when the config names mesh
    axes, else a no-op.  Spec entries: ``"dp"`` → ``cfg.dp_axes``,
    ``"tp"`` → ``cfg.tp_axis``, ``None`` → unsharded.  On a ``DTensor``
    a dim its axes do not divide stays whole, where GSPMD would pad it:
    long_500k's one batch row over dp in its MLPs and logits.  That
    decode's attention takes no constraint: it runs on each rank's slice
    of the cache's sequence (``_decode_block_seq``), the one row whole on
    every rank."""
    if not cfg.dp_axes and not cfg.tp_axis:
        return x
    resolved = [tuple(cfg.dp_axes) if e == "dp" else (cfg.tp_axis or None)
                if e == "tp" else None for e in spec]
    mesh = getattr(x, "device_mesh", None)
    if mesh is not None:
        from repro_torch.core.distributed import axis_size
        resolved = [e if e and x.shape[d] % axis_size(mesh, e) == 0
                    else None for d, e in enumerate(resolved)]
    return constrain(x, tuple(resolved))


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab: int = 1024
    act: str = "silu"                 # "silu" (SwiGLU) | "gelu" (GeGLU)
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tied_embeddings: bool = False
    # MoE
    n_experts: int = 0                # 0 ⇒ all-dense
    top_k: int = 1
    capacity_factor: float = 1.25
    moe_layer_period: int = 1         # 1 ⇒ every layer MoE (when n_experts>0)
    # numerics
    param_dtype: str = "float32"
    act_dtype: str = "float32"
    # attention blocking
    q_chunk: int = 512
    kv_chunk: int = 512
    # remat: "full" (recompute layer in bwd), "none"
    remat: str = "full"
    # activation-sharding constraints (empty ⇒ one device)
    dp_axes: Tuple[str, ...] = ()
    tp_axis: str = ""
    seq_shard: bool = True

    @property
    def layer_pattern(self) -> Tuple[str, ...]:
        if self.n_experts <= 0:
            return ("dense",)
        if self.moe_layer_period <= 1:
            return ("moe",)
        return ("dense",) * (self.moe_layer_period - 1) + ("moe",)

    @property
    def n_super(self) -> int:
        p = len(self.layer_pattern)
        if self.n_layers % p:
            raise ValueError(f"{self.n_layers} layers do not split into "
                             f"super-layers of {self.layer_pattern}")
        return self.n_layers // p

    @property
    def pdt(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def adt(self) -> torch.dtype:
        return getattr(torch, self.act_dtype)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, cfg: LMConfig, scale: float,
            dev: torch.device) -> torch.Tensor:
    """N(0, 1) drawn in the parameter type on the generator's device,
    times ``scale`` in that type (the reference's ``normal(key, shape,
    pdt) * s``), placed on ``dev``."""
    return torch.randn(shape, generator=gen, dtype=cfg.pdt,
                       device=gen.device).mul_(scale).to(dev)


def _attn_init(gen, cfg: LMConfig, n: int, dev) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    p = {"wq": _normal(gen, (n, d, h * hd), cfg, s, dev),
         "wk": _normal(gen, (n, d, kv * hd), cfg, s, dev),
         "wv": _normal(gen, (n, d, kv * hd), cfg, s, dev),
         "wo": _normal(gen, (n, h * hd, d), cfg, 1.0 / math.sqrt(h * hd),
                       dev)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((n, hd), dtype=cfg.pdt, device=dev)
        p["k_norm"] = torch.ones((n, hd), dtype=cfg.pdt, device=dev)
    return p


def _dense_mlp_init(gen, cfg: LMConfig, n: int, dev) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(d)
    return {"wg": _normal(gen, (n, d, f), cfg, s, dev),
            "wu": _normal(gen, (n, d, f), cfg, s, dev),
            "wd": _normal(gen, (n, f, d), cfg, 1.0 / math.sqrt(f), dev)}


def _moe_mlp_init(gen, cfg: LMConfig, n: int, dev) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = 1.0 / math.sqrt(d)
    return {"router": _normal(gen, (n, d, e), cfg, s, dev),
            "wg": _normal(gen, (n, e, d, f), cfg, s, dev),
            "wu": _normal(gen, (n, e, d, f), cfg, s, dev),
            "wd": _normal(gen, (n, e, f, d), cfg, 1.0 / math.sqrt(f), dev)}


def init_params(cfg: LMConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """The reference's initializer (embeddings N(0, 0.02²), projections
    N(0, 1/fan_in), norms 1) drawn from ``generator`` on its own device in
    ``cfg.param_dtype`` and placed on ``device``: pass a CUDA generator to
    draw a full-width model on the card.  The numbers differ from the
    reference's; parity tests carry its parameters across
    (``convert.lm_params_from_jax``)."""
    dev = resolve_device(device)
    n = cfg.n_super
    params: Params = {
        "embed": _normal(generator, (cfg.vocab, cfg.d_model), cfg, 0.02,
                         dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.pdt, device=dev),
    }
    if not cfg.tied_embeddings:
        params["unembed"] = _normal(generator, (cfg.d_model, cfg.vocab), cfg,
                                    0.02, dev)
    for i, kind in enumerate(cfg.layer_pattern):
        params[f"sub{i}"] = {
            "ln1": torch.ones((n, cfg.d_model), dtype=cfg.pdt, device=dev),
            "ln2": torch.ones((n, cfg.d_model), dtype=cfg.pdt, device=dev),
            "attn": _attn_init(generator, cfg, n, dev),
            "mlp": (_moe_mlp_init if kind == "moe" else _dense_mlp_init)(
                generator, cfg, n, dev),
        }
    return params


def param_specs(cfg: LMConfig) -> Params:
    """The parameter tree as ``meta`` tensors: ``init_params``' shapes and
    dtypes, nothing allocated or drawn."""
    from repro_torch.tree import eval_shape
    return eval_shape(init_params, cfg, torch.Generator(), "cpu")


def _layers(params: Params, cfg: LMConfig):
    """Per super-layer, the tuple of its sub-layers' parameter trees: each
    stacked leaf unbound once along its ``n_super`` axis."""
    subs = []
    for i in range(len(cfg.layer_pattern)):
        sub = params[f"sub{i}"]
        subs.append({
            "ln1": sub["ln1"].unbind(0), "ln2": sub["ln2"].unbind(0),
            "attn": {k: v.unbind(0) for k, v in sub["attn"].items()},
            "mlp": {k: v.unbind(0) for k, v in sub["mlp"].items()}})

    def at(sub, l):
        return {"ln1": sub["ln1"][l], "ln2": sub["ln2"][l],
                "attn": {k: v[l] for k, v in sub["attn"].items()},
                "mlp": {k: v[l] for k, v in sub["mlp"].items()}}
    return [tuple(at(sub, l) for sub in subs) for l in range(cfg.n_super)]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                device: torch.device):
    """(cos, sin) of RoPE's angles in f32 for ``positions`` (S,) or (B,
    S), shaped (1 or B, S, 1, hd/2): computed once a call and shared by
    every layer's q and k (the same values ``rope`` computes)."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=device), exponent)
    ang = positions.to(device=device, dtype=torch.float32)[..., None] * freq
    if ang.ndim == 2:  # (S, half) -> broadcast over batch
        ang = ang[None]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def _rotate(x: torch.Tensor, tables) -> torch.Tensor:
    cos, sin = tables
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) or (B, S).  Rotated in f32, cast
    back to x's type."""
    return _rotate(x, rope_tables(positions, x.shape[-1], theta, x.device))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _uneven(y, cfg: LMConfig, n: int) -> bool:
    """Whether ``y`` is a ``DTensor`` on a mesh whose tp axis does not
    divide ``n`` heads (8 kv heads over 16)."""
    mesh = getattr(y, "device_mesh", None)
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    return (cfg.tp_axis in names
            and n % mesh.size(names.index(cfg.tp_axis)) != 0)


def _heads(y: torch.Tensor, cfg: LMConfig, n: int) -> torch.Tensor:
    """A projection (B, S, n·hd) as (B, S, n, hd).  Where ``_uneven``,
    the projection is first gathered over tp, where GSPMD would pad the
    heads: DTensor cannot view an unevenly split dim."""
    b, s, _ = y.shape
    if _uneven(y, cfg, n):
        y = _psc(y, cfg, "dp", None, None)
    return y.reshape(b, s, n, cfg.head_dim)


def _qkv(p, cfg: LMConfig, x: torch.Tensor, tables):
    """q, k, v of x: (B, S, D), rotated by the RoPE ``tables``."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    q = _heads(x @ p["wq"].to(x.dtype), cfg, h)
    k = _heads(x @ p["wk"].to(x.dtype), cfg, kv)
    v = _heads(x @ p["wv"].to(x.dtype), cfg, kv)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"].to(x.dtype))
        k = rms_norm(k, p["k_norm"].to(x.dtype))
    return _rotate(q, tables), _rotate(k, tables), v


def attention_chunks(cfg: LMConfig, s: int) -> Tuple[int, int]:
    """(q chunk, kv chunk) of a length-``s`` attention: each config chunk
    cut to ``s``, and ``s`` itself where the chunk does not divide it (odd
    lengths, short prompts: one chunk), as in the reference."""
    qc = min(cfg.q_chunk, s)
    kc = min(cfg.kv_chunk, s)
    if s % qc:
        qc = s
    if s % kc:
        kc = s
    return qc, kc


def blocked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """Online-softmax blocked attention.  q: (B, S, H, hd), k/v: (B, S, KV,
    hd), kv heads repeated up to H.  Returns (B, S, H, hd) in q's type.

    On ``DTensor`` inputs the reference's constraint — batch over dp,
    heads over tp (where they divide: llama4's 40 over 16 stay whole,
    where GSPMD pads) — is a ``local_map``: each rank attends its own
    batch rows and heads on local tensors, so no attention product is
    propagated through DTensor's view rules."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    if g > 1:
        # ``jnp.repeat`` along the head axis, as an expand: its backward
        # sums each kv head's g copies in a fixed order (the index_select
        # of ``repeat_interleave`` adds them back by atomics on the card)
        k = k[:, :, :, None].expand(b, s, kvh, g, hd).reshape(b, s, h, hd)
        v = v[:, :, :, None].expand(b, s, kvh, g, hd).reshape(b, s, h, hd)
    mesh = getattr(q, "device_mesh", None)
    if mesh is not None and (cfg.dp_axes or cfg.tp_axis):
        from repro_torch.core import distributed as D
        heads = None if _uneven(q, cfg, h) else (cfg.tp_axis or None)
        spec = (tuple(cfg.dp_axes), None, heads, None)
        return D.shard_map(lambda *t: _blocked_local(*t, cfg), mesh,
                           in_specs=[spec] * 3, out_specs=spec)(q, k, v)
    return _blocked_local(q, k, v, cfg)


def _blocked_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cfg: LMConfig) -> torch.Tensor:
    """The blocked attention on (B, S, H, hd) tensors, heads equal."""
    b, s, h, hd = q.shape
    qc, kc = attention_chunks(cfg, s)
    nq, nk = s // qc, s // kc
    scale = 1.0 / math.sqrt(hd)
    kf = k.float()
    pos = torch.arange(s, device=q.device)

    def per_q_chunk(qq, qi: int):
        qq = qq.float()
        q_pos = pos[qi * qc:(qi + 1) * qc]
        m = torch.full((b, h, qc), float("-inf"), device=q.device)
        l = torch.zeros((b, h, qc), device=q.device)
        acc = torch.zeros((b, h, qc, hd), device=q.device)
        for ki in range(nk):
            if ki * kc > (qi + 1) * qc - 1:
                break                  # wholly above the diagonal: adds 0
            kk = kf[:, ki * kc:(ki + 1) * kc]
            vv = v[:, ki * kc:(ki + 1) * kc]
            sc = torch.einsum("bqhd,bchd->bhqc", qq, kk) * scale
            mask = q_pos[:, None] >= pos[ki * kc:(ki + 1) * kc][None, :]
            sc = torch.where(mask[None, None], sc, -1e30)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bhqc,bchd->bhqd", p.to(vv.dtype).float(),
                              vv.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        return out.transpose(1, 2)     # (b, qc, h, hd)

    # flash-attention memory law: recompute scores in bwd, never store S²
    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    outs = []
    for qi in range(nq):
        qq = q[:, qi * qc:(qi + 1) * qc]
        outs.append(checkpoint(per_q_chunk, qq, qi, use_reentrant=False)
                    if remat else per_q_chunk(qq, qi))
    return torch.cat(outs, dim=1).to(q.dtype)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cfg: LMConfig, attention: str) -> torch.Tensor:
    """(B, S, H, hd) causal GQA attention by ``attention``: ``"flash"``
    (B8, forward only) or ``"blocked"``; both take any hd."""
    if attention == "blocked":
        return blocked_causal_attention(q, k, v, cfg)
    if attention != "flash":
        raise ValueError(f"attention {attention!r}: one of {ATTENTION}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "attention='flash' runs B8, which has no backward: use "
            "attention='blocked' where a gradient is to flow")
    qc, kc = attention_chunks(cfg, q.shape[1])
    return mha_causal(q, k, v, block_q=qc, block_k=kc)


def attention_block(p, cfg: LMConfig, x: torch.Tensor,
                    positions: torch.Tensor,
                    attention: str = "blocked") -> torch.Tensor:
    return _attention(p, cfg, x, rope_tables(
        positions, cfg.head_dim, cfg.rope_theta, x.device), attention)[0]


def _attention(p, cfg: LMConfig, x: torch.Tensor, tables, attention: str,
               anchor: bool = True):
    """(the block's output, k, v).  ``anchor``: the reference's
    ``attention_block`` constraints (batch-sharded at the projections,
    heads over tp before ``wo``); its prefill has none (its sequence
    joins only where DTensor cannot flatten it, ``_rows_whole``)."""
    b, s, _ = x.shape
    x = _psc(x, cfg, "dp", None, None) if anchor else _rows_whole(x, cfg)
    q, k, v = _qkv(p, cfg, x, tables)
    o = causal_attention(q, k, v, cfg, attention).reshape(b, s, -1)
    if anchor:
        o = _psc(o, cfg, "dp", None, "tp")
    return _batch_rows(o @ p["wo"].to(x.dtype), cfg), k, v


def _decode_attend(p, cfg: LMConfig, x, q, k_cache, v_cache, mask):
    """Scores of q (B, 1, H, hd) against the whole cache (B, S_max, KV, hd)
    in f32, masked, softmax, P rounded to the cache's type, P·v in f32,
    then the output projection."""
    b = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qg = q.reshape(b, kvh, h // kvh, hd).float()
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) / math.sqrt(hd)
    sc = torch.where(mask, sc, -1e30)
    w = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", w.to(v_cache.dtype).float(),
                     v_cache.float())
    o = o.reshape(b, 1, h * hd).to(x.dtype)
    return o @ p["wo"].to(x.dtype)


class _Step:
    """What a decode step computes once for all its layers: the RoPE
    tables, each row's cache write (row, position, kept) and the mask of
    the cache rows it reads (built on first use: the sequence-sharded
    decode builds a mask a rank instead)."""

    def __init__(self, cfg: LMConfig, b: int, s_max: int,
                 device: torch.device, cache_index=None, positions=None):
        self.s_max, self.device = s_max, device
        if positions is None:            # one index for every row
            ci = torch.as_tensor(cache_index, device=device).to(torch.int64)
            pos = ci.expand(b, 1)
            self.ci = ci
            # dynamic_update_slice clamps the write into range
            self.at = ci.clamp(0, s_max - 1).reshape(1)
            self.keep = None
        else:                            # a position a row
            positions = positions.to(device=device, dtype=torch.int64)
            pos = positions[:, None]
            self.positions = positions
            # .at[rows, positions].set: negative positions count from the
            # end, rows still out of range are dropped
            at = torch.where(positions < 0, positions + s_max, positions)
            self.keep = ((at >= 0) & (at < s_max))[:, None, None]
            self.at = at.clamp(0, s_max - 1)
            self.rows = torch.arange(b, device=device)
        self.tables = rope_tables(pos, cfg.head_dim, cfg.rope_theta, device)

    @functools.cached_property
    def mask(self) -> torch.Tensor:
        span = torch.arange(self.s_max, device=self.device)
        if self.keep is None:
            return span[None, None, None] <= self.ci
        return span[None, None, None, :] <= self.positions[:, None, None,
                                                           None]


def _dim_axes(t, dim: int) -> Tuple[str, ...]:
    """The mesh axes, in the mesh's order, that dim ``dim`` of a
    ``DTensor`` is split over; ``()`` for a plain tensor.  A cache's
    sequence (dim 1) is split over every axis in long_500k's layout
    (batch 1), over ``model`` beside a batch over dp in decode_32k's."""
    placements = getattr(t, "placements", None)
    if placements is None:
        return ()
    return tuple(n for n, pl in zip(t.device_mesh.mesh_dim_names, placements)
                 if pl.is_shard(dim))


def _decode_block_seq(p, cfg: LMConfig, x, q, k, v, k_cache, v_cache,
                      step: _Step, axes: Tuple[str, ...]):
    """The decode write and attention on a cache whose sequence is split
    over ``axes`` (flash decoding), its batch whole or split over other
    axes (decode_32k: the batch over dp, the sequence over ``model``).
    Each rank holds its batch rows' S_max / n positions from the offset
    ``axis_coord(axes) · S_max / n``: it writes the new k, v row where it
    holds ``cache_index`` (clamped, as ``dynamic_update_slice`` clamps),
    masks its own positions past ``cache_index``, and computes on local
    tensors its f32 row max m_r, l_r = Σ exp(s − m_r) and o_r =
    Σ exp(s − m_r)·v (P rounded to the cache's type before P·v).  One
    max-reduce and two sum-reduces over ``axes`` join them: o =
    Σ e^(m_r − m)·o_r / Σ e^(m_r − m)·l_r, with m the max of the m_r.  A
    rank whose positions all lie past ``cache_index`` has m_r = −1e30 and
    weight 0.  Nothing gathers the cache, and every write lands in the
    cache's own shards (torch 2.11's DTensor refuses an in-place write
    on a split sequence; 2.13's re-labels the shard as the whole)."""
    from repro_torch.core import distributed as D
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mesh = k_cache.device_mesh
    kl, vl = k_cache.to_local(), v_cache.to_local()
    s_loc = kl.shape[1]
    rows = (_dim_axes(k_cache, 0) or None, None, None, None)

    def local(q, k, v, ci):
        b = q.shape[0]
        off = D.axis_index(axes) * s_loc
        at = ci.clamp(0, step.s_max - 1) - off
        inside = (at >= 0) & (at < s_loc)
        at = at.clamp(0, s_loc - 1).reshape(1)
        for cache, new in ((kl, k), (vl, v)):
            cache.index_copy_(1, at, torch.where(
                inside, new.to(cache.dtype), cache.index_select(1, at)))
        qg = q.reshape(b, kvh, h // kvh, hd).float()
        sc = torch.einsum("bkgd,bskd->bkgs", qg, kl.float()) / math.sqrt(hd)
        mine = off + torch.arange(s_loc, device=kl.device) <= ci
        sc = torch.where(mine, sc, -1e30)
        m_r = sc.amax(-1, keepdim=True)
        e = torch.exp(sc - m_r)
        o_r = torch.einsum("bkgs,bskd->bkgd", e.to(vl.dtype).float(),
                           vl.float())
        w = torch.exp(m_r - D.pmax(m_r, axes))
        o = D.psum(o_r * w, axes) / D.psum(e.sum(-1, keepdim=True) * w, axes)
        return o.reshape(b, 1, h * hd).to(x.dtype)

    o = D.shard_map(local, mesh, in_specs=[rows, rows, rows, ()],
                    out_specs=rows[:3])(q, k, v, step.ci)
    # the projection's partial sums joined before the residual add, which
    # torch 2.11's DTensor cannot otherwise place on a 3-D mesh
    return _batch_rows(o @ p["wo"].to(x.dtype), cfg)


def _decode_block(p, cfg: LMConfig, x: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, step: _Step):
    q, k, v = _qkv(p, cfg, x, step.tables)
    axes = _dim_axes(k_cache, 1) if step.keep is None else ()
    if axes:
        return _decode_block_seq(p, cfg, x, q, k, v, k_cache, v_cache, step,
                                 axes), k_cache, v_cache
    for cache, new in ((k_cache, k), (v_cache, v)):
        if step.keep is None:
            cache.index_copy_(1, step.at, new.to(cache.dtype))
        else:
            rows, at = step.rows, step.at
            cache[rows, at] = torch.where(
                step.keep, new[:, 0].to(cache.dtype), cache[rows, at])
    return _decode_attend(p, cfg, x, q, k_cache, v_cache, step.mask), \
        k_cache, v_cache


def decode_attention_block(p, cfg: LMConfig, x: torch.Tensor,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           cache_index):
    """One-token decode.  x: (B, 1, D); caches: (B, S_max, KV, hd), written
    in place at ``cache_index`` (clamped into range for the write, as
    ``dynamic_update_slice`` clamps; the mask reads it as given)."""
    return _decode_block(p, cfg, x, k_cache, v_cache, _Step(
        cfg, x.shape[0], k_cache.shape[1], x.device,
        cache_index=cache_index))


def decode_attention_block_ragged(p, cfg: LMConfig, x: torch.Tensor,
                                  k_cache: torch.Tensor,
                                  v_cache: torch.Tensor,
                                  positions: torch.Tensor):
    """Per-row cache positions (continuous batching).  x: (B, 1, D);
    caches: (B, S_max, KV, hd), row i written in place at
    ``positions[i]`` (negative positions count from the end and rows out
    of range are dropped, as ``.at[rows, positions].set`` does)."""
    return _decode_block(p, cfg, x, k_cache, v_cache, _Step(
        cfg, x.shape[0], k_cache.shape[1], x.device, positions=positions))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _act(cfg: LMConfig):
    if cfg.act == "gelu":
        return lambda t: F.gelu(t, approximate="tanh")   # jax.nn.gelu
    return F.silu


def dense_mlp(p, cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    a = _act(cfg)
    x = _psc(x, cfg, "dp", None, None)
    h = a(x @ p["wg"].to(x.dtype)) * (x @ p["wu"].to(x.dtype))
    h = _psc(h, cfg, "dp", None, "tp")
    return _batch_rows(h @ p["wd"].to(x.dtype), cfg)


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, descending, the
    first index first among equals (a stable sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _whole(fn, data: torch.Tensor, ids: torch.Tensor, n: int):
    """``fn(data, ids, n)``; on ``DTensor`` inputs, on their whole arrays
    on every rank (each gathered, the result replicated), noted as
    ``aten.segment_reduce`` run whole: the ordered segment sum has no
    DTensor sharding rule, and GSPMD all-reduces the reference's
    scatter-add into the whole (E·C + 1, D) buffer on every rank."""
    mesh = getattr(data, "device_mesh", None)
    if mesh is None:
        return fn(data, ids, n)
    from repro_torch.core import distributed as D
    D.ran_whole("aten.segment_reduce.default")
    return D.shard_map(lambda a, b: fn(a, b, n), mesh,
                       in_specs=[(None,) * data.ndim, (None,) * ids.ndim],
                       out_specs=(None,) * data.ndim)(data, ids)


def moe_mlp(p, cfg: LMConfig, x: torch.Tensor,
            capacity: int) -> torch.Tensor:
    """Capacity-based top-k MoE with deterministic tie-breaking.

    x: (B, S, D) → tokens (T, D).  Each (token, choice) takes the next slot
    of its expert's queue in token order; past ``capacity`` it is dropped
    (its slot is the ghost ``E·C``).  Dispatch is an ordered segment sum
    into (E·C, D) slots (each kept slot holds one token, so the f32 sum of
    a bf16 slot is exact), the experts run as batched products, and the
    combine gathers the slots back, weighted by the renormalized top-k
    probabilities."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(t, d)
    logits = (xt @ p["router"].to(x.dtype)).float()             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, k)                             # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # position of each (token, choice) within its expert queue
    flat_oh = F.one_hot(top_e.reshape(t * k), e)                # (T·k, E)
    pos_in_e = torch.cumsum(flat_oh, dim=0) - flat_oh           # exclusive
    pos = (pos_in_e * flat_oh).sum(-1).reshape(t, k)
    keep = pos < capacity
    # a dropped (token, choice) goes to the ghost slot E·C
    slot = torch.where(keep, top_e * capacity + pos,
                       torch.full_like(pos, e * capacity))

    # dispatch: tokens into (E·C, D) slots
    xk = xt[:, None].expand(t, k, d).reshape(t * k, d)
    buf = _whole(segment_sum, xk, slot.reshape(-1), e * capacity + 1)
    buf = buf[:e * capacity].reshape(e, capacity, d).to(x.dtype)
    # expert-parallel layout: experts over tp when they divide (llama4's
    # 128); otherwise (grok's 8) whole experts with the hidden dim over tp
    e_spec = "tp" if (cfg.tp_axis and e % 16 == 0) else None
    f_spec = None if e_spec else "tp"
    buf = _psc(buf, cfg, e_spec, "dp", None)

    a = _act(cfg)
    hidden = a(torch.bmm(buf, p["wg"].to(x.dtype))) \
        * torch.bmm(buf, p["wu"].to(x.dtype))
    hidden = _psc(hidden, cfg, e_spec, "dp", f_spec)
    out_buf = _psc(torch.bmm(hidden, p["wd"].to(x.dtype)), cfg, e_spec,
                   "dp", None)

    # combine: gather the slots back, probability-weighted.  The slots
    # split over dp are joined before they flatten into (E·C, D), as GSPMD
    # joins them at the reshape (an all-gather of C in the reference's
    # HLO), which torch 2.11's DTensor cannot flatten while C is split
    flat = _psc(out_buf, cfg, e_spec, None, None).reshape(e * capacity, d)
    gathered = gather(flat, torch.clamp(slot, max=e * capacity - 1)
                      .reshape(-1)).reshape(t, k, d)
    gathered = torch.where(keep[..., None], gathered, 0)
    y = (gathered * top_p[..., None].to(x.dtype)).sum(dim=1)
    return y.reshape(b, s, d)


def _moe_local(cfg: LMConfig, router, wg, wu, wd, xt, capacity: int,
               n_tokens: int, ep: bool):
    """One rank's MoE on its tokens ``xt`` (T_loc, D): route into a local
    (E, C_loc, D) buffer, run the experts (expert-parallel: slots travel
    to their expert's owner and back by ``all_to_all`` over tp;
    hidden-sharded: each tp rank's F-slice, joined by a ``psum``), and
    combine."""
    from repro_torch.core import distributed as D
    e, k = cfg.n_experts, cfg.top_k
    tp = cfg.tp_axis
    t_loc, d = xt.shape
    c_loc = max(8, capacity * t_loc // n_tokens)
    probs = torch.softmax((xt @ router).float(), dim=-1)
    top_p, top_e = _top_k(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(top_e.reshape(t_loc * k), e)
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1)
    pos = pos.reshape(t_loc, k)
    keep = pos < c_loc
    slot = torch.where(keep, top_e * c_loc + pos,
                       torch.full_like(pos, e * c_loc))
    xk = xt[:, None].expand(t_loc, k, d).reshape(t_loc * k, d)
    buf = segment_sum(xk, slot.reshape(-1), e * c_loc + 1)
    buf = buf[:e * c_loc].reshape(e, c_loc, d).to(xt.dtype)
    a = _act(cfg)
    if ep:
        n_tp = D.axis_size(D.current_mesh(), tp)
        e_loc = e // n_tp
        # slots to their experts' owners: (E/tp, C·tp, D), rank i's at i
        got = D.all_to_all(buf, tp)
        buf = got.reshape(n_tp, e_loc, c_loc, d).transpose(0, 1).reshape(
            e_loc, n_tp * c_loc, d)
        hidden = a(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
        out = torch.bmm(hidden, wd)
        # and back: (E, C_loc, D), owner i's experts at block i
        out = out.reshape(e_loc, n_tp, c_loc, d).transpose(0, 1).reshape(
            n_tp * e_loc, c_loc, d)
        out = D.all_to_all(out, tp)
    else:
        hidden = a(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
        out = D.psum(torch.bmm(hidden, wd), tp)
    flat = out.reshape(e * c_loc, d)
    gathered = gather(flat, torch.clamp(slot, max=e * c_loc - 1)
                      .reshape(-1)).reshape(t_loc, k, d)
    gathered = torch.where(keep[..., None], gathered, 0)
    return (gathered * top_p[..., None].to(xt.dtype)).sum(dim=1)


def moe_mlp_sharded(p, cfg: LMConfig, x: torch.Tensor, capacity: int,
                    tp_size: int = 16) -> torch.Tensor:
    """The reference's manual MoE under ``shard_map``: token-local
    dispatch with a per-rank capacity.

    Tokens are sharded over the dp axes, and over tp too when the experts
    divide over it (expert-parallel: ``all_to_all`` over tp carries each
    slot to its expert's owner, llama4); otherwise the FFN hidden dim is
    split over tp and the down-projection ``psum``s over it (grok), with
    the tokens over dp alone.  The mesh is the ``DTensor`` inputs' own or
    the ambient ``distributed.use_mesh``; its tp size replaces
    ``tp_size``."""
    from repro_torch.core import distributed as D
    b, s, d = x.shape
    e = cfg.n_experts
    tp = cfg.tp_axis
    mesh = getattr(x, "device_mesh", None) or D.current_mesh()
    if mesh is None:
        raise ValueError(
            "moe_mlp_sharded dispatches over a mesh: pass DTensor inputs or "
            "run it under core.distributed.use_mesh(mesh)")
    if tp in mesh.mesh_dim_names:
        tp_size = D.axis_size(mesh, tp)
    ep = e % tp_size == 0
    token_axes = tuple(cfg.dp_axes) + ((tp,) if ep else ())
    if ep:
        w_spec = ((tp, None, None),) * 3
    else:
        w_spec = ((None, None, tp), (None, None, tp), (None, tp, None))

    def local_fn(router, wg, wu, wd, xt):
        return _moe_local(cfg, router, wg, wu, wd, xt, capacity, b * s, ep)

    fn = D.shard_map(local_fn, mesh,
                     in_specs=((), *w_spec, (token_axes, None)),
                     out_specs=(token_axes, None))
    x = _rows_whole(x, cfg)
    y = fn(p["router"].to(x.dtype), p["wg"].to(x.dtype),
           p["wu"].to(x.dtype), p["wd"].to(x.dtype), x.reshape(b * s, d))
    if ep:
        # tokens back over dp alone before they unflatten into (B, S): a
        # DTensor splits the batch dim wrongly when one flat dim is split
        # over dp and tp and the batch is shorter than dp × tp
        y = D.constrain(y, (tuple(cfg.dp_axes), None))
    # the gradient reaches the unflatten with its (B, S) rows whole where
    # DTensor cannot flatten the sequence-split residual's
    return _rows_whole(y.reshape(b, s, d), cfg)


def moe_capacity(cfg: LMConfig, n_tokens: int) -> int:
    c = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, ((c + 127) // 128) * 128)


def _mlp(kind: str, p, cfg: LMConfig, h: torch.Tensor, cap: int,
         sharded: bool = False):
    """The layer's MLP; ``sharded``: the MoE through ``moe_mlp_sharded``
    (``forward`` and ``prefill`` under ``cfg.dp_axes``, as the
    reference's)."""
    if kind == "moe":
        if sharded and cfg.dp_axes:
            return moe_mlp_sharded(p["mlp"], cfg, h, cap)
        return moe_mlp(p["mlp"], cfg, h, cap)
    return dense_mlp(p["mlp"], cfg, h)


# ---------------------------------------------------------------------------
# Forward (train), prefill
# ---------------------------------------------------------------------------

def _embed(params: Params, cfg: LMConfig, tokens: torch.Tensor):
    return take(params["embed"], tokens.reshape(-1)).reshape(
        tokens.shape + (cfg.d_model,)).to(cfg.adt)


def forward(params: Params, cfg: LMConfig, tokens: torch.Tensor,
            attention: str = "blocked") -> torch.Tensor:
    """tokens (B, S) → final hidden states (B, S, D).  With ``remat ==
    "full"`` and a gradient to flow, each super-layer runs under
    ``torch.utils.checkpoint``."""
    b, s = tokens.shape
    x = _batch_rows(_embed(params, cfg, tokens), cfg)
    tables = rope_tables(torch.arange(s, device=x.device), cfg.head_dim,
                         cfg.rope_theta, x.device)
    cap = moe_capacity(cfg, b * s) if cfg.n_experts > 0 else 0

    seq = "tp" if cfg.seq_shard else None

    def super_layer(x, layer):
        x = _psc(x, cfg, "dp", seq, None)
        for kind, p in zip(cfg.layer_pattern, layer):
            h = rms_norm(x, p["ln1"].to(x.dtype))
            # the residual stream stays sequence-sharded (Megatron-SP)
            x = _psc(x + _attention(p["attn"], cfg, h, tables, attention)[0],
                     cfg, "dp", seq, None)
            h = rms_norm(x, p["ln2"].to(x.dtype))
            x = _psc(x + _mlp(kind, p, cfg, h, cap, sharded=True), cfg,
                     "dp", seq, None)
        return x

    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for layer in _layers(params, cfg):
        x = (checkpoint(super_layer, x, layer, use_reentrant=False)
             if remat else super_layer(x, layer))
    return rms_norm(x, params["final_norm"].to(x.dtype))


def prefill(params: Params, cfg: LMConfig, tokens: torch.Tensor,
            attention: str = "flash"):
    """Forward pass that also materializes the KV cache (serving prefill).

    Returns (last-token logits (B, V) f32, cache as in ``init_cache`` at
    S_max = S)."""
    b, s = tokens.shape
    x = _embed(params, cfg, tokens)
    tables = rope_tables(torch.arange(s, device=x.device), cfg.head_dim,
                         cfg.rope_theta, x.device)
    cap = moe_capacity(cfg, b * s) if cfg.n_experts > 0 else 0
    kvs = [{"k": [], "v": []} for _ in cfg.layer_pattern]
    seq = "tp" if cfg.seq_shard else None
    for layer in _layers(params, cfg):
        x = _psc(x, cfg, "dp", seq, None)
        for i, (kind, p) in enumerate(zip(cfg.layer_pattern, layer)):
            h = rms_norm(x, p["ln1"].to(x.dtype))
            o, k, v = _attention(p["attn"], cfg, h, tables, attention,
                                 anchor=False)
            x = x + o
            h = rms_norm(x, p["ln2"].to(x.dtype))
            x = x + _mlp(kind, p, cfg, h, cap, sharded=True)
            kvs[i]["k"].append(k)
            kvs[i]["v"].append(v)
    x = rms_norm(x, params["final_norm"].to(x.dtype))
    logits = x[:, -1] @ unembed_matrix(params, cfg).to(x.dtype)
    cache = {f"sub{i}": {n: torch.stack(kv[n]) for n in ("k", "v")}
             for i, kv in enumerate(kvs)}
    return logits.float(), cache


def unembed_matrix(params: Params, cfg: LMConfig) -> torch.Tensor:
    if cfg.tied_embeddings:
        return params["embed"].T
    return params["unembed"]


def _xent_sum(hc: torch.Tensor, yc: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    logits = (hc @ w).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, 1, yc[:, None].to(torch.int64))[:, 0]
    return torch.sum(lse - ll)


def chunked_xent_loss(params: Params, cfg: LMConfig, hidden: torch.Tensor,
                      labels: torch.Tensor, chunk: int = 4096
                      ) -> torch.Tensor:
    """Mean next-token cross-entropy without materializing (T, V) logits:
    each chunk's (chunk, V) logits are recomputed in the backward."""
    b, s, d = hidden.shape
    h = hidden[:, :-1].reshape(-1, d)
    y = labels[:, 1:].reshape(-1)
    t = h.shape[0]
    w = unembed_matrix(params, cfg).to(hidden.dtype)
    chunk = min(chunk, t)
    n_chunks = t // chunk
    remat = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        hc, yc = h[i * chunk:(i + 1) * chunk], y[i * chunk:(i + 1) * chunk]
        tot = tot + (checkpoint(_xent_sum, hc, yc, w, use_reentrant=False)
                     if remat else _xent_sum(hc, yc, w))
    if t - n_chunks * chunk:
        tot = tot + _xent_sum(h[n_chunks * chunk:], y[n_chunks * chunk:], w)
    return tot / t


def loss_fn(params: Params, cfg: LMConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    hidden = forward(params, cfg, tokens, attention="blocked")
    return chunked_xent_loss(params, cfg, hidden, tokens)


# ---------------------------------------------------------------------------
# Decode path (serve shapes)
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, s_max: int,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = None) -> Params:
    """KV cache: per sub-layer kind, ``k`` and ``v`` of (n_super, batch,
    s_max, KV, hd), zero, in ``dtype`` (the activation type by
    default)."""
    dt = dtype or cfg.adt
    dev = resolve_device(device)
    shape = (cfg.n_super, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {f"sub{i}": {"k": torch.zeros(shape, dtype=dt, device=dev),
                        "v": torch.zeros(shape, dtype=dt, device=dev)}
            for i in range(len(cfg.layer_pattern))}


def cache_specs(cfg: LMConfig, batch: int, s_max: int,
                dtype: Optional[torch.dtype] = None) -> Params:
    """``init_cache``'s tree as ``meta`` tensors."""
    from repro_torch.tree import eval_shape
    return eval_shape(init_cache, cfg, batch, s_max, dtype, "cpu")


def _decode(params: Params, cfg: LMConfig, tokens: torch.Tensor, cache,
            cache_index=None, positions=None) -> Tuple[torch.Tensor, Params]:
    b = tokens.shape[0]
    x = _embed(params, cfg, tokens)
    cap = moe_capacity(cfg, b) if cfg.n_experts > 0 else 0
    step = _Step(cfg, b, cache["sub0"]["k"].shape[2], x.device,
                 cache_index=cache_index, positions=positions)
    for l, layer in enumerate(_layers(params, cfg)):
        for i, (kind, p) in enumerate(zip(cfg.layer_pattern, layer)):
            c = cache[f"sub{i}"]
            h = rms_norm(x, p["ln1"].to(x.dtype))
            o, _, _ = _decode_block(p["attn"], cfg, h, c["k"][l], c["v"][l],
                                    step)
            x = x + o
            h = rms_norm(x, p["ln2"].to(x.dtype))
            x = x + _mlp(kind, p, cfg, h, cap)
    x = rms_norm(x, params["final_norm"].to(x.dtype))
    logits = x[:, 0] @ unembed_matrix(params, cfg).to(x.dtype)
    return logits.float(), cache


def decode_step(params: Params, cfg: LMConfig, tokens: torch.Tensor,
                cache, cache_index):
    """tokens (B, 1) + cache → (logits (B, V) f32, the cache, updated in
    place at ``cache_index``)."""
    return _decode(params, cfg, tokens, cache, cache_index=cache_index)


def decode_step_ragged(params: Params, cfg: LMConfig, tokens: torch.Tensor,
                       cache, positions: torch.Tensor):
    """One-token decode with a cache position per row — the
    continuous-batching engine step (``train/serving.py``)."""
    return _decode(params, cfg, tokens, cache, positions=positions)
