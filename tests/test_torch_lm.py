"""The LM family in the port against the JAX reference, on the CPU (B8's
plain version under ``attention="flash"``), on the reference's parameters
carried across by ``convert.lm_params_from_jax``:

* ``blocked_causal_attention`` and ``mha_causal`` (inside ``prefill``)
  against the reference's blocked attention at odd and chunked lengths
  (≤1e-5 in f32);
* each of the five reduced configs in f32: ``forward`` and ``prefill``
  (≤1e-4), ``loss_fn`` (≤1e-5 relative), every parameter gradient (rtol
  1e-3, atol 1e-4), ``decode_step`` and ``decode_step_ragged`` logits and
  caches (≤1e-4), out-of-range cache writes included;
* the reduced qwen3 in bf16 (``BF16_*_TOL``);
* ``moe_mlp`` against the reference in a case that drops tokens, with its
  gradients;
* the counterparts of the reference's ``test_models.py`` LM tests and
  ``test_moe.py``, run against the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models.lm import transformer as JT
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_jax
from repro_torch.data import synthetic as syn
from repro_torch.kernels.flash_attention import mha_causal
from repro_torch.models.lm import transformer as T

CPU = "cpu"
ATTN_TOL = 1e-5
FWD_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4
# bf16: XLA's CPU fuses bf16 chains and keeps them in f32 between ops,
# where torch rounds after each op, so the two differ by a few bf16 ulps
# (2⁻⁷ relative) that three layers carry on.  Measured at seeds 5-7:
# hidden states (values up to ~4.3) ≤0.055, i.e. under 2 ulps of the
# largest; prefill logits (up to ~0.6) ≤0.0123; the loss ≤4e-5 relative.
# The bars are about twice that.
BF16_HIDDEN_TOL = 0.1
BF16_LOGIT_TOL = 2.5e-2
BF16_LOSS_RTOL = 1e-4
LM_ARCHS = ["llama4-maverick-400b-a17b", "grok-1-314b", "gemma-7b",
            "qwen3-0.6b", "deepseek-67b"]
B, S, PROMPT, S_MAX = 2, 32, 8, 16


def _np(t):
    return t.detach().float().numpy()


def _flat(tree_):
    """{path: leaf} of a nested dict."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], path + (k,))
        else:
            out["/".join(path)] = t
    walk(tree_, ())
    return out


def _convert(jparams):
    return lm_params_from_jax(jax.tree.map(np.asarray, jparams), CPU)


def _cache_to_torch(cache):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), cache)


def _filled_cache(cfg, kv, batch, s_max):
    """The reference test's pattern: a zero cache with a prefill's KV
    written at the front."""
    cache = JT.init_cache(cfg, batch, s_max)
    return jax.tree.map(lambda dst, src: jax.lax.dynamic_update_slice(
        dst, src.astype(dst.dtype), (0,) * dst.ndim), cache, kv)


@pytest.fixture(scope="module", params=LM_ARCHS)
def arch_case(request):
    """One reduced arch: the reference's parameters, both configs, the
    converted parameters and the reference's results on one token batch."""
    arch = request.param
    jcfg = jregistry.get_config(arch, reduced=True)
    tcfg = registry.get_config(arch, reduced=True)
    jp = JT.init_params(jax.random.key(0), jcfg)
    toks = syn.token_batch(B, S, jcfg.vocab, seed=3)
    jt = jnp.asarray(toks)
    # jitted: one compile each, faster than op-by-op dispatch here
    loss, grads = jax.jit(jax.value_and_grad(JT.loss_fn),
                          static_argnums=1)(jp, jcfg, jt)
    logits, kv = jax.jit(JT.prefill, static_argnums=1)(jp, jcfg,
                                                       jt[:, :PROMPT])
    cache = _filled_cache(jcfg, kv, B, S_MAX)
    step = jt[:, PROMPT:PROMPT + 1]
    decode = jax.jit(JT.decode_step, static_argnums=1)
    dec = decode(jp, jcfg, step, cache, jnp.int32(PROMPT))
    dec_clamped = decode(jp, jcfg, step, cache, jnp.int32(S_MAX + 3))
    ragged_pos = np.array([PROMPT, S_MAX + 2], np.int32)   # row 1: dropped
    ragged = jax.jit(JT.decode_step_ragged, static_argnums=1)(
        jp, jcfg, step, cache, jnp.asarray(ragged_pos))
    hidden = jax.jit(JT.forward, static_argnums=1)(jp, jcfg, jt)
    return dict(
        arch=arch, jcfg=jcfg, cfg=tcfg, params=_convert(jp), toks=toks,
        hidden=np.asarray(hidden), loss=float(loss),
        grads={k: np.asarray(v) for k, v in _flat(grads).items()},
        prefill=(np.asarray(logits), kv), cache=cache, dec=dec,
        dec_clamped=dec_clamped, ragged_pos=ragged_pos, ragged=ragged)


def test_configs_equal_reference(arch_case):
    jcfg, cfg = arch_case["jcfg"], arch_case["cfg"]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.layer_pattern == jcfg.layer_pattern
    assert cfg.n_super == jcfg.n_super
    assert cfg.pdt == torch.float32 and cfg.adt == torch.float32


def test_forward_matches_reference(arch_case):
    got = T.forward(arch_case["params"], arch_case["cfg"],
                    torch.from_numpy(arch_case["toks"]))
    np.testing.assert_allclose(_np(got), arch_case["hidden"], rtol=0,
                               atol=FWD_TOL)


@pytest.mark.parametrize("attention", T.ATTENTION)
def test_prefill_matches_reference(arch_case, attention):
    want_logits, want_kv = arch_case["prefill"]
    with torch.no_grad():
        logits, kv = T.prefill(arch_case["params"], arch_case["cfg"],
                               torch.from_numpy(arch_case["toks"][:, :PROMPT]),
                               attention=attention)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(_np(logits), np.asarray(want_logits), rtol=0,
                               atol=FWD_TOL)
    want = _flat(jax.tree.map(np.asarray, want_kv))
    got = _flat(kv)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), want[k], rtol=0,
                                   atol=FWD_TOL, err_msg=k)


def test_loss_and_gradients_match_reference(arch_case):
    params = arch_case["params"]
    leaves, structure = tree.flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss = T.loss_fn(tree.unflatten(structure, live), arch_case["cfg"],
                     torch.from_numpy(arch_case["toks"]))
    grads = torch.autograd.grad(loss, live)
    assert abs(float(loss.detach()) - arch_case["loss"]) <= LOSS_RTOL * abs(
        arch_case["loss"])
    got = _flat(tree.unflatten(structure, list(grads)))
    assert set(got) == set(arch_case["grads"])
    for k, want in arch_case["grads"].items():
        np.testing.assert_allclose(_np(got[k]), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


def _check_decode(got, want):
    logits, cache = got
    np.testing.assert_allclose(_np(logits), np.asarray(want[0]), rtol=0,
                               atol=FWD_TOL)
    want_cache = _flat(jax.tree.map(np.asarray, want[1]))
    got_cache = _flat(cache)
    for k in want_cache:
        np.testing.assert_allclose(_np(got_cache[k]), want_cache[k], rtol=0,
                                   atol=FWD_TOL, err_msg=k)


@pytest.mark.parametrize("index", ["in_range", "clamped"])
def test_decode_step_matches_reference(arch_case, index):
    """One token at cache index 8, and at an index past the cache (the
    write clamps to the last row, as ``dynamic_update_slice`` does, and the
    mask reads every row)."""
    at, want = ((PROMPT, arch_case["dec"]) if index == "in_range"
                else (S_MAX + 3, arch_case["dec_clamped"]))
    step = torch.from_numpy(arch_case["toks"][:, PROMPT:PROMPT + 1])
    with torch.no_grad():
        got = T.decode_step(arch_case["params"], arch_case["cfg"], step,
                            _cache_to_torch(arch_case["cache"]), at)
    _check_decode(got, want)


def test_decode_step_ragged_matches_reference(arch_case):
    """Row 0 at position 8, row 1 past the cache (its write is dropped)."""
    step = torch.from_numpy(arch_case["toks"][:, PROMPT:PROMPT + 1])
    with torch.no_grad():
        got = T.decode_step_ragged(
            arch_case["params"], arch_case["cfg"], step,
            _cache_to_torch(arch_case["cache"]),
            torch.from_numpy(arch_case["ragged_pos"]))
    _check_decode(got, arch_case["ragged"])


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [13, 32, 48])
def test_blocked_and_flash_attention_match_reference(s):
    """q (2, S, 4, 16), k/v (2, S, 2, 16): S = 13 is one chunk (16 does not
    divide it), 32 and 48 two and three chunks of 16."""
    cfg = registry.get_config("qwen3-0.6b", reduced=True)
    jcfg = jregistry.get_config("qwen3-0.6b", reduced=True)
    rng = np.random.default_rng(s)
    q = rng.normal(size=(2, s, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, s, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(JT.blocked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = T.blocked_causal_attention(tq, tk, tv, cfg)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=ATTN_TOL)
    qc, kc = T.attention_chunks(cfg, s)
    flash = mha_causal(tq, tk, tv, block_q=qc, block_k=kc)
    np.testing.assert_allclose(_np(flash), want, rtol=0, atol=ATTN_TOL)


@pytest.mark.parametrize("s", [13, 32])
def test_prefill_flash_logits_match_reference_tightly(s):
    """``mha_causal`` inside ``prefill`` (its plain version on the CPU)
    against the reference's blocked attention, at an odd and a chunked
    length: ≤1e-5 in f32."""
    cfg = registry.get_config("qwen3-0.6b", reduced=True)
    jcfg = jregistry.get_config("qwen3-0.6b", reduced=True)
    jp = JT.init_params(jax.random.key(4), jcfg)
    toks = syn.token_batch(2, s, cfg.vocab, seed=s)
    want, _ = JT.prefill(jp, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        got, _ = T.prefill(_convert(jp), cfg, torch.from_numpy(toks),
                           attention="flash")
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=ATTN_TOL)


@pytest.mark.parametrize("s", [13, 32])
def test_gemma_head_dim_256_prefill_flash_matches_reference(s):
    """A narrow gemma with gemma-7b's true head_dim, 256 (2 layers, d_model
    64, 2 heads; tied, GeGLU): the reference's parameters carried across,
    the port's ``prefill(attention="flash")`` (B8's plain version on the
    CPU) against the reference's ``prefill``, logits and cache ≤1e-4."""
    changes = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                   head_dim=256)
    cfg = dataclasses.replace(registry.get_config("gemma-7b", reduced=True),
                              **changes)
    jcfg = dataclasses.replace(
        jregistry.get_config("gemma-7b", reduced=True), **changes)
    jp = JT.init_params(jax.random.key(6), jcfg)
    toks = syn.token_batch(2, s, cfg.vocab, seed=s + 1)
    want, want_kv = jax.jit(JT.prefill, static_argnums=1)(
        jp, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        got, kv = T.prefill(_convert(jp), cfg, torch.from_numpy(toks),
                            attention="flash")
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=FWD_TOL)
    want_kv = _flat(jax.tree.map(np.asarray, want_kv))
    got_kv = _flat(kv)
    assert set(got_kv) == set(want_kv)
    for k in want_kv:
        assert got_kv[k].shape[-1] == 256
        np.testing.assert_allclose(_np(got_kv[k]), want_kv[k], rtol=0,
                                   atol=FWD_TOL, err_msg=k)


def test_flash_past_head_dim_256_raises():
    """Past 256 B8 computes, as the reference's kernel does (it raised
    until its wide kernels): a gemma at head_dim 264 (1 layer, d_model 64,
    2 heads), the reference's parameters carried across, the port's
    ``prefill(attention="flash")`` (B8's plain version on the CPU) against
    the reference's ``prefill`` and the port's blocked attention, logits
    ≤1e-4."""
    changes = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=2,
                   head_dim=264)
    cfg = dataclasses.replace(registry.get_config("gemma-7b", reduced=True),
                              **changes)
    jcfg = dataclasses.replace(
        jregistry.get_config("gemma-7b", reduced=True), **changes)
    jp = JT.init_params(jax.random.key(7), jcfg)
    toks = syn.token_batch(1, 8, cfg.vocab, seed=0)
    want, _ = jax.jit(JT.prefill, static_argnums=1)(jp, jcfg,
                                                     jnp.asarray(toks))
    params = _convert(jp)
    with torch.no_grad():
        got, _ = T.prefill(params, cfg, torch.from_numpy(toks),
                           attention="flash")
        blocked, _ = T.prefill(params, cfg, torch.from_numpy(toks),
                               attention="blocked")
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=FWD_TOL)
    np.testing.assert_allclose(_np(got), _np(blocked), rtol=0,
                               atol=FWD_TOL)


def test_blocked_attention_gradients_match_reference():
    cfg = registry.get_config("qwen3-0.6b", reduced=True)
    jcfg = jregistry.get_config("qwen3-0.6b", reduced=True)
    rng = np.random.default_rng(7)
    q = rng.normal(size=(1, 32, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(1, 32, 2, 16)).astype(np.float32)
            for _ in range(2))
    w = rng.normal(size=(1, 32, 4, 16)).astype(np.float32)
    want = jax.grad(lambda a, b, c: jnp.sum(JT.blocked_causal_attention(
        a, b, c, jcfg) * w), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    live = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = T.blocked_causal_attention(*live, cfg)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), live)
    for g, gw in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(gw), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("batched", [False, True])
def test_rope_matches_reference(batched):
    """RoPE at qwen3's θ on positions (S,) and (B, S), f32 and bf16."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    pos = (rng.integers(0, 4096, (2, 12)) if batched else np.arange(12)
           ).astype(np.int32)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        want = JT.rope(jnp.asarray(x, jdt), jnp.asarray(pos), 1e6)
        got = T.rope(torch.from_numpy(x).to(dt), torch.from_numpy(pos), 1e6)
        assert got.dtype == dt
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   rtol=0, atol=1e-5 if dt == torch.float32
                                   else 2e-2)


def test_attention_and_decode_blocks_match_reference():
    """The public one-layer blocks: ``attention_block`` (both
    attentions), ``decode_attention_block`` and
    ``decode_attention_block_ragged`` with their in-place cache writes."""
    cfg, jcfg = (registry.get_config("qwen3-0.6b", reduced=True),
                 jregistry.get_config("qwen3-0.6b", reduced=True))
    jp = JT.init_params(jax.random.key(9), jcfg)
    jattn = jax.tree.map(lambda a: a[0], jp["sub0"]["attn"])
    attn = {k: v[0] for k, v in _convert(jp)["sub0"]["attn"].items()}
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 24, 64)).astype(np.float32)
    want = JT.attention_block(jattn, jcfg, jnp.asarray(x), jnp.arange(24))
    for attention in T.ATTENTION:
        with torch.no_grad():
            got = T.attention_block(attn, cfg, torch.from_numpy(x),
                                    torch.arange(24), attention)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=FWD_TOL)
    kc = rng.normal(size=(2, 16, 2, 16)).astype(np.float32)
    vc = rng.normal(size=(2, 16, 2, 16)).astype(np.float32)
    x1 = x[:, :1]
    for name, arg in (("fixed", 5), ("ragged", np.array([3, 11], np.int32))):
        jfn = (JT.decode_attention_block if name == "fixed"
               else JT.decode_attention_block_ragged)
        tfn = (T.decode_attention_block if name == "fixed"
               else T.decode_attention_block_ragged)
        want = jfn(jattn, jcfg, jnp.asarray(x1), jnp.asarray(kc),
                   jnp.asarray(vc), jnp.asarray(arg))
        tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        with torch.no_grad():
            got = tfn(attn, cfg, torch.from_numpy(x1), tk, tv,
                      arg if name == "fixed" else torch.from_numpy(arg))
        assert got[1] is tk and got[2] is tv       # written in place
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0,
                                       atol=FWD_TOL, err_msg=name)


def test_flash_with_a_gradient_raises():
    cfg = registry.get_config("qwen3-0.6b", reduced=True)
    q = torch.zeros((1, 8, 4, 16), requires_grad=True)
    kv = torch.zeros((1, 8, 2, 16))
    with pytest.raises(RuntimeError, match="attention='blocked'"):
        T.causal_attention(q, kv, kv, cfg, "flash")
    with pytest.raises(ValueError, match="attention"):
        T.causal_attention(q, kv, kv, cfg, "sdpa")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    leaves, structure = tree.flatten(params)
    live = tree.unflatten(structure,
                          [p.requires_grad_() for p in leaves])
    with pytest.raises(RuntimeError, match="no backward"):
        T.forward(live, cfg, torch.zeros((1, 8), dtype=torch.int32),
                  attention="flash")


def test_multi_device_paths_raise():
    """With ``dp_axes`` set, the MoE layers dispatch over a mesh
    (``moe_mlp_sharded``, ported): without DTensor inputs or an ambient
    mesh they raise, naming the mesh (the sharded paths' parity is
    ``tests/test_torch_lm_sharded.py``)."""
    cfg = dataclasses.replace(registry.get_config("grok-1-314b", reduced=True),
                              dp_axes=("data",))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    for fn in (T.forward, T.prefill):
        with pytest.raises(ValueError, match="mesh"):
            fn(params, cfg, toks, attention="blocked")
    with pytest.raises(ValueError, match="mesh"):
        T.moe_mlp_sharded({}, cfg, torch.zeros((1, 4, 64)), 8)


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------

def test_qwen3_bf16_matches_reference():
    """The reduced qwen3 with bf16 parameters and activations, carried
    across bit for bit: hidden states, prefill logits and the loss within
    the ``BF16_*`` bars."""
    bf16 = dict(param_dtype="bfloat16", act_dtype="bfloat16")
    cfg = dataclasses.replace(registry.get_config("qwen3-0.6b", reduced=True),
                              **bf16)
    jcfg = dataclasses.replace(
        jregistry.get_config("qwen3-0.6b", reduced=True), **bf16)
    jp = JT.init_params(jax.random.key(5), jcfg)
    params = _convert(jp)
    for k, leaf in _flat(params).items():
        ref = np.asarray(_flat(jp)[k])
        assert leaf.dtype == torch.bfloat16
        assert np.array_equal(leaf.view(torch.int16).numpy(),
                              ref.view(np.int16)), k
    toks = syn.token_batch(2, 32, cfg.vocab, seed=6)
    jt = jnp.asarray(toks)
    tt = torch.from_numpy(toks)
    hidden = T.forward(params, cfg, tt)
    assert hidden.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(hidden), np.asarray(
        JT.forward(jp, jcfg, jt)).astype(np.float32), rtol=0,
        atol=BF16_HIDDEN_TOL)
    want_logits, _ = JT.prefill(jp, jcfg, jt)
    with torch.no_grad():
        logits, kv = T.prefill(params, cfg, tt)
    assert kv["sub0"]["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(logits), np.asarray(want_logits), rtol=0,
                               atol=BF16_LOGIT_TOL)
    want = float(JT.loss_fn(jp, jcfg, jt))
    got = float(T.loss_fn(params, cfg, tt))
    assert abs(got - want) <= BF16_LOSS_RTOL * abs(want)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_cfg(**kw):
    base = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
                d_ff=64, vocab=128, n_experts=4, top_k=2, moe_layer_period=1,
                q_chunk=8, kv_chunk=8)
    base.update(kw)
    return T.LMConfig(**base)


def _moe_params(seed, cfg):
    """One layer of the reference's MoE parameters, both packages."""
    jcfg = JT.LMConfig(**dataclasses.asdict(cfg))
    p = jax.tree.map(lambda a: a[0], JT._moe_mlp_init(jax.random.key(seed),
                                                      jcfg, 1))
    return jcfg, p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("top_k,n_experts,capacity", [(1, 2, 8), (2, 4, 8),
                                                      (2, 4, 1024)])
def test_moe_mlp_matches_reference(top_k, n_experts, capacity):
    """64 tokens; capacity 8 drops most of them, so any difference in the
    slot order shows; the gradients through dispatch and combine too."""
    cfg = _moe_cfg(top_k=top_k, n_experts=n_experts)
    jcfg, jp, tp = _moe_params(11, cfg)
    x = np.random.default_rng(1).normal(size=(4, 16, 32)).astype(np.float32)
    w = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(JT.moe_mlp(p, jcfg, xx, capacity) * w)
    want = jax.jit(lambda p, xx: JT.moe_mlp(p, jcfg, xx, capacity))(
        jp, jnp.asarray(x))
    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    live = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    got = T.moe_mlp(live, cfg, tx, capacity)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=FWD_TOL)
    grads = torch.autograd.grad((got * torch.from_numpy(w)).sum(),
                                [tx] + [live[k] for k in sorted(live)])
    np.testing.assert_allclose(_np(grads[0]), np.asarray(jg_x),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for k, g in zip(sorted(live), grads[1:]):
        np.testing.assert_allclose(_np(g), np.asarray(jg_p[k]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


def test_top_k_takes_the_first_of_equals():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]])
    vals, idx = T._top_k(probs, 2)
    j_vals, j_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(j_idx).tolist() == [[0, 1], [1, 2]]
    assert torch.equal(vals, torch.from_numpy(np.array(j_vals)))


@pytest.mark.parametrize("seed,top_k,n_experts", [(0, 1, 2), (17, 2, 8),
                                                  (9000, 2, 3)])
def test_moe_output_finite_and_shaped(seed, top_k, n_experts):
    """``test_moe.py::test_moe_output_finite_and_shaped`` on the port."""
    cfg = _moe_cfg(top_k=top_k, n_experts=n_experts)
    p = T._moe_mlp_init(torch.Generator().manual_seed(seed), cfg, 1,
                        torch.device(CPU))
    p = {k: v[0] for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32))
    y = T.moe_mlp(p, cfg, x, T.moe_capacity(cfg, 32))
    assert y.shape == x.shape
    assert bool(torch.isfinite(y).all())


def test_huge_capacity_equals_dense_expert_mix():
    """With capacity ≥ T·k nothing drops: output = Σ p_e · FFN_e(x)."""
    cfg = _moe_cfg(top_k=4, n_experts=4)
    _, _, p = _moe_params(0, cfg)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 8, cfg.d_model)).astype(np.float32))
    y = T.moe_mlp(p, cfg, x, capacity=1024)
    xt = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xt @ p["router"], -1)
    ref = torch.zeros_like(xt)
    for e in range(4):
        h = torch.nn.functional.silu(xt @ p["wg"][e]) * (xt @ p["wu"][e])
        ref = ref + probs[:, e:e + 1] * (h @ p["wd"][e])
    np.testing.assert_allclose(_np(y.reshape(-1, cfg.d_model)), _np(ref),
                               rtol=2e-3, atol=2e-3)


def test_capacity_drop_bounds_buffer():
    """No expert receives more than ``capacity`` tokens (overflow
    dropped): capacity 8 with 64 tokens stays finite."""
    cfg = _moe_cfg(top_k=1, n_experts=2)
    _, _, p = _moe_params(1, cfg)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 16, cfg.d_model)).astype(np.float32))
    assert bool(torch.isfinite(T.moe_mlp(p, cfg, x, capacity=8)).all())


def test_moe_capacity_rounding():
    cfg = _moe_cfg(top_k=2, n_experts=4, capacity_factor=1.25)
    c = T.moe_capacity(cfg, 1024)
    assert c % 128 == 0
    assert c >= 1024 * 2 / 4 * 1.25
    assert c == JT.moe_capacity(JT.LMConfig(**dataclasses.asdict(cfg)), 1024)


# ---------------------------------------------------------------------------
# the reference's test_models.py LM tests, on the port
# ---------------------------------------------------------------------------

def _finite(tree_):
    return all(bool(torch.isfinite(t).all()) for t in tree.leaves(tree_)
               if t.is_floating_point())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_reduced_train_step(arch):
    cfg = registry.get_config(arch, reduced=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    leaves, structure = tree.flatten(params)
    live = [p.requires_grad_() for p in leaves]
    toks = torch.from_numpy(syn.token_batch(2, 32, cfg.vocab))
    loss = T.loss_fn(tree.unflatten(structure, live), cfg, toks)
    grads = torch.autograd.grad(loss, live)
    loss = float(loss.detach())
    assert np.isfinite(loss) and loss > 0
    assert _finite(list(grads))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_reduced_decode(arch):
    cfg = registry.get_config(arch, reduced=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    cache = T.init_cache(cfg, 2, 16, device=CPU)
    with torch.no_grad():
        logits, cache = T.decode_step(
            params, cfg, torch.zeros((2, 1), dtype=torch.int32), cache, 0)
    assert logits.shape == (2, cfg.vocab)
    assert _finite(logits)


def test_lm_prefill_decode_consistency():
    """decode(t+1) after prefill(≤t) must match the teacher-forced
    forward."""
    cfg = dataclasses.replace(registry.get_config("qwen3-0.6b", reduced=True),
                              q_chunk=8, kv_chunk=8)
    params = T.init_params(cfg, torch.Generator().manual_seed(1), CPU)
    toks = torch.from_numpy(syn.token_batch(2, 16, cfg.vocab, seed=3))
    with torch.no_grad():
        _, kv = T.prefill(params, cfg, toks[:, :8])
        cache = T.init_cache(cfg, 2, 16, device=CPU)
        for dst, src in zip(tree.leaves(cache), tree.leaves(kv)):
            dst[:, :, :8] = src
        logits_d, _ = T.decode_step(params, cfg, toks[:, 8:9], cache, 8)
        h = T.forward(params, cfg, toks[:, :9])
        ref = h[:, 8] @ T.unembed_matrix(params, cfg)
    np.testing.assert_allclose(_np(logits_d), _np(ref), rtol=2e-4,
                               atol=2e-4)
