"""LM serving, training steps, launchers, data, registry and bf16
checkpoints in the port, against the JAX reference where it has the
counterpart, on the CPU:

* the port's ``ContinuousBatcher`` against offline one-at-a-time decoding
  (tokens equal), and against the reference's batcher on the same
  requests and converted weights (tokens equal);
* ``token_batch``/``TokenStream`` bitwise the reference's;
* ``build_lm_step``'s train, prefill and decode steps against the
  reference's (three train steps: loss ≤1e-5 relative, parameters ≤1e-4);
  the loss falls (``test_system.py::test_lm_loss_decreases``);
* ``launch/serve.main`` and ``launch/train.main`` (``--arch qwen3-0.6b``,
  ``--preset lm100m``) with ``--device cpu``, and their errors;
* the registry's five LM archs and config equality;
* bf16 leaves through the checkpoint store: a round trip, a checkpoint the
  reference wrote, and an LM training run resumed from a bf16 commit
  bitwise the unbroken run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import registry as jregistry
from repro.configs import shapes as jshapes
from repro.data import synthetic as jsyn
from repro.launch import steps as jsteps
from repro.models.lm import transformer as JT
from repro.optim import adamw as jadamw
from repro.train.serving import ContinuousBatcher as JBatcher
from repro.train.serving import Request as JRequest
from repro_torch import tree
from repro_torch.checkpoint import store
from repro_torch.configs import registry, shapes
from repro_torch.convert import lm_params_from_jax
from repro_torch.data import synthetic as syn
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models.lm import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import loop as train_loop
from repro_torch.train.serving import ContinuousBatcher, Request

CPU = "cpu"
LM_ARCHS = ["llama4-maverick-400b-a17b", "grok-1-314b", "gemma-7b",
            "qwen3-0.6b", "deepseek-67b"]
STEP_RTOL = 1e-5
# the repo's trajectory bar: AdamW's m̂/√v̂ turns a 1e-6 gradient
# difference on a near-zero gradient into a visible step difference
PARAM_TOL = 1e-4


def _qwen3():
    return (registry.get_config("qwen3-0.6b", reduced=True),
            jregistry.get_config("qwen3-0.6b", reduced=True))


def _convert(jparams):
    return lm_params_from_jax(jax.tree.map(np.asarray, jparams), CPU)


def _requests(vocab, cls):
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(0, vocab, 8 + 3 * i,
                                           dtype=np.int64).astype(np.int32),
                max_new=5 + 2 * i)
            for i in range(5)]          # 5 requests > 3 slots ⇒ queueing


def _offline(params, cfg, prompt, max_new, s_max):
    """One request alone: prefill, its KV at the front of a fresh cache,
    then ``decode_step`` a token at a time."""
    with torch.no_grad():
        logits, kv = T.prefill(params, cfg, torch.from_numpy(prompt[None]))
        cache = T.init_cache(cfg, 1, s_max, device=CPU)
        for dst, src in zip(tree.leaves(cache), tree.leaves(kv)):
            dst[:, :, :prompt.shape[0]] = src
        toks = [int(torch.argmax(logits[0]))]
        pos = prompt.shape[0]
        for _ in range(max_new - 1):
            logits, cache = T.decode_step(
                params, cfg, torch.tensor([[toks[-1]]], dtype=torch.int32),
                cache, pos)
            toks.append(int(torch.argmax(logits[0])))
            pos += 1
    return toks


def test_continuous_batching_matches_offline():
    """``test_serving.py::test_continuous_batching_matches_offline`` on the
    port: 5 requests of mixed lengths on 3 slots, tokens equal to each
    request decoded alone."""
    cfg, _ = _qwen3()
    s_max, n_slots = 48, 3
    params = T.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    reqs = _requests(cfg.vocab, Request)
    eng = tserve.build_engine(params, cfg, n_slots, s_max)
    for r in reqs:
        eng.submit(r)
    finished = eng.run()
    assert all(r.done for r in reqs)
    assert sorted(r.rid for r in finished) == [r.rid for r in reqs]
    for r in reqs:
        assert r.out == _offline(params, cfg, r.prompt, r.max_new, s_max), \
            r.rid


@pytest.mark.parametrize("attention", T.ATTENTION)
def test_batcher_tokens_equal_reference(attention):
    """The port's batcher and the reference's on the same requests and the
    reference's weights: every request's tokens equal."""
    cfg, jcfg = _qwen3()
    s_max, n_slots = 48, 3
    jp = JT.init_params(jax.random.key(0), jcfg)
    prefill = jax.jit(lambda t: JT.prefill(jp, jcfg, t))
    decode = jax.jit(lambda tok, cache, pos: JT.decode_step_ragged(
        jp, jcfg, tok, cache, pos))
    jeng = JBatcher(n_slots, s_max, lambda b, s: JT.init_cache(jcfg, b, s),
                    prefill, decode)
    jreqs = _requests(cfg.vocab, JRequest)
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    eng = tserve.build_engine(_convert(jp), cfg, n_slots, s_max,
                              attention=attention)
    reqs = _requests(cfg.vocab, Request)
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert [r.out for r in reqs] == [r.out for r in jreqs]


def test_batcher_eos_and_cache_end():
    """A request stops at ``eos_id`` and at the cache's end."""
    cfg, _ = _qwen3()
    params = T.init_params(cfg, torch.Generator().manual_seed(2), CPU)
    prompt = syn.token_batch(1, 10, cfg.vocab, seed=1)[0]
    first = _offline(params, cfg, prompt, 4, 32)
    eng = tserve.build_engine(params, cfg, 2, 32, eos_id=first[1])
    eng.submit(Request(rid=0, prompt=prompt, max_new=20))
    short = Request(rid=1, prompt=prompt, max_new=50)
    eng2 = tserve.build_engine(params, cfg, 1, 14)
    eng2.submit(short)
    eng.run()
    eng2.run()
    assert eng.finished[0].out == first[:2]
    # the cache holds 14 rows: prompt 10, then decode until position 13
    assert short.done and len(short.out) == 14 - 1 - 10 + 1


def test_token_data_bitwise_reference():
    for args in ((2, 16, 512, 0), (3, 7, 151936, 9)):
        assert np.array_equal(syn.token_batch(*args),
                              jsyn.token_batch(*args))
    ours, ref = syn.TokenStream(2, 8, 100, seed=4), \
        jsyn.TokenStream(2, 8, 100, seed=4)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)


def test_lm_shapes_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in shapes.LM_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jshapes.LM_SHAPES.items()}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_registry_resolves_lm_archs(arch):
    entry = registry.entry(arch)
    assert entry.family == "lm" and entry.module.startswith("repro_torch.")
    for reduced in (False, True):
        cfg = registry.get_config(arch, reduced=reduced)
        ref = jregistry.get_config(arch, reduced=reduced)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert registry.NOT_PORTED == {}


def test_build_lm_step_train_matches_reference():
    """Three AdamW steps through ``build_lm_step`` on the reference's
    parameters, against the reference's jitted step."""
    cfg, jcfg = _qwen3()
    shape = shapes.LM_SHAPES["train_4k"]
    jp = JT.init_params(jax.random.key(1), jcfg)
    jstep = jax.jit(jsteps.build_lm_step(jcfg, jshapes.LM_SHAPES["train_4k"],
                                         jadamw.AdamWConfig(lr=1e-3)))
    step = tsteps.build_lm_step(cfg, shape, adamw.AdamWConfig(lr=1e-3))
    params = _convert(jp)
    jopt, opt = jadamw.init_state(jp), adamw.init_state(params)
    for i in range(3):
        toks = syn.token_batch(2, 32, cfg.vocab, seed=i)
        jp, jopt, jm = jstep(jp, jopt, {"tokens": jnp.asarray(toks)})
        params, opt, m = step(params, opt, {"tokens": torch.from_numpy(toks)})
        want = float(jm["loss"])
        assert abs(float(m["loss"]) - want) <= STEP_RTOL * want
    for got, ref in zip(tree.leaves(params), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=PARAM_TOL)


def test_build_lm_step_serving_steps_match_reference():
    cfg, jcfg = _qwen3()
    jp = JT.init_params(jax.random.key(2), jcfg)
    params = _convert(jp)
    toks = syn.token_batch(2, 8, cfg.vocab, seed=5)
    pre = shapes.LMShape("p", "prefill", 8, 2)
    want_logits, kv = jsteps.build_lm_step(jcfg, pre)(
        jp, {"tokens": jnp.asarray(toks)})
    got_logits, _ = tsteps.build_lm_step(cfg, pre)(
        params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=1e-4)
    with torch.no_grad():
        got_logits, _ = T.prefill(params, cfg, torch.from_numpy(toks),
                                  attention="blocked")
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=1e-4)
    dec = shapes.LMShape("d", "decode", 16, 2)
    jcache = jax.tree.map(lambda dst, src: jax.lax.dynamic_update_slice(
        dst, src, (0,) * dst.ndim), JT.init_cache(jcfg, 2, 16), kv)
    nxt = toks[:, :1]
    want, _ = jsteps.build_lm_step(jcfg, dec)(
        jp, {"tokens": jnp.asarray(nxt), "cache": jcache,
             "cache_index": jnp.int32(8)})
    cache = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jcache)
    got, _ = tsteps.build_lm_step(cfg, dec)(
        params, {"tokens": torch.from_numpy(nxt), "cache": cache,
                 "cache_index": 8})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    with pytest.raises(ValueError, match="kind"):
        tsteps.build_lm_step(cfg, shapes.LMShape("x", "score", 8, 1))


def test_lm_loss_decreases():
    """``test_system.py::test_lm_loss_decreases`` on the port: 12 AdamW
    steps at lr 1e-3 on one (4, 64) batch take the loss down by 0.3."""
    cfg, _ = _qwen3()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    opt = adamw.init_state(params)
    step = tsteps.build_lm_step(cfg, shapes.LMShape("t", "train", 64, 4),
                                adamw.AdamWConfig(lr=1e-3))
    batch = {"tokens": torch.from_numpy(syn.token_batch(4, 64, cfg.vocab))}
    losses = []
    for _ in range(12):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

def test_serve_main_on_cpu(capsys, monkeypatch):
    argv = ["--requests", "5", "--slots", "2", "--prompt-len", "12",
            "--gen", "6", "--device", "cpu"]
    assert tserve.main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[serve] qwen3-0.6b (reduced) on cpu: 5 requests")
    # gemma's reduced head dim (24) runs B8's plain version on the CPU
    assert tserve.main(argv + ["--arch", "gemma-7b"]) == 0
    assert tserve.main(argv + ["--arch", "deepseek-67b", "--attention",
                               "blocked"]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--requests", "1"])


@pytest.mark.parametrize("arch", ["gemma-7b", "deepseek-67b"])
def test_serve_names_the_attention_flag(arch):
    """``--attention flash`` serves any head dim: the arch's reduced config
    at head_dim 320 (past 256, where B8 once raised) serves 5 requests on
    3 slots on the CPU through ``build_engine(attention="flash")``, and a
    flash prefill's logits and cache are within 1e-4 of the blocked
    one's."""
    cfg = dataclasses.replace(registry.get_config(arch, reduced=True),
                              head_dim=320)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    toks = torch.from_numpy(syn.token_batch(2, 24, cfg.vocab, seed=4))
    with torch.no_grad():
        got, kv = T.prefill(params, cfg, toks, attention="flash")
        want, kv_b = T.prefill(params, cfg, toks, attention="blocked")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for a, b in zip(tree.leaves(kv), tree.leaves(kv_b)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    reqs = _requests(cfg.vocab, Request)
    eng = tserve.build_engine(params, cfg, 3, 48, attention="flash")
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done and len(r.out) == r.max_new for r in reqs)


def test_train_main_lm_on_cpu(tmp_path, capsys, monkeypatch):
    argv = ["--arch", "qwen3-0.6b", "--steps", "3", "--batch", "2", "--seq",
            "32", "--device", "cpu", "--ckpt-dir", str(tmp_path / "a"),
            "--ckpt-every", "2"]
    assert ttrain.main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[train] 3 steps in") and "retries=0" in line
    assert store.committed_steps(tmp_path / "a") == [2, 3]
    assert ttrain.main(["--preset", "lm100m", "--steps", "1", "--batch", "1",
                        "--seq", "16", "--device", "cpu", "--ckpt-dir",
                        str(tmp_path / "b")]) == 0
    out = capsys.readouterr().out
    assert "[train] lm100m: 103." in out and "[train] 1 steps in" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--arch", "qwen3-0.6b", "--steps", "1"])


def test_lm100m_matches_reference_preset():
    from repro.launch import train as jtrain
    assert dataclasses.asdict(ttrain.LM100M) == dataclasses.asdict(
        jtrain.LM100M)


# ---------------------------------------------------------------------------
# conversion and bf16 checkpoints
# ---------------------------------------------------------------------------

def test_lm_params_from_jax_checks_keys_and_shapes():
    _, jcfg = _qwen3()
    good = jax.tree.map(np.asarray, JT.init_params(jax.random.key(0), jcfg))
    assert set(lm_params_from_jax(good, CPU)) == set(good)
    bad = jax.tree.map(lambda a: a, good)
    bad["sub0"]["attn"]["wk"] = good["sub0"]["attn"]["wk"][:, :, :-1]
    with pytest.raises(ValueError, match="wv"):
        lm_params_from_jax(bad, CPU)
    bad = jax.tree.map(lambda a: a, good)
    del bad["sub0"]["attn"]["k_norm"]
    with pytest.raises(ValueError, match="both or neither"):
        lm_params_from_jax(bad, CPU)
    bad = jax.tree.map(lambda a: a, good)
    bad["final_norm"] = good["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        lm_params_from_jax(bad, CPU)


def _bf16_tree():
    gen = torch.Generator().manual_seed(3)
    return {"w": torch.randn((3, 5), generator=gen).bfloat16(),
            "inner": {"b": torch.randn(7, generator=gen).bfloat16(),
                      "f": torch.randn(2, generator=gen)},
            "n": np.arange(4, dtype=np.int32)}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_checkpoint_bf16_roundtrip(tmp_path, mode):
    t = _bf16_tree()
    if mode == "sync":
        store.save(tmp_path, 1, t)
    else:
        ck = store.AsyncCheckpointer(tmp_path)
        ck.save_async(1, t)
        ck.wait()
    manifest = store.validate_step(tmp_path, 1, t)
    assert [m["dtype"] for m in manifest["leaves"]] == [
        "bfloat16", "float32", "int32", "bfloat16"]
    assert np.load(tmp_path / "step_000001" / "leaf_00000.npy").dtype.str \
        == "|V2"
    got, _ = store.restore(tmp_path, 1, t)
    for a, b in zip(tree.leaves(got), tree.leaves(t)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
        else:
            assert np.array_equal(a, b)
    # a bf16 leaf restored into an f32 like tree widens exactly
    wide, _ = store.restore(tmp_path, 1, {
        "w": torch.zeros(3, 5), "inner": {"b": torch.zeros(7),
                                          "f": torch.zeros(2)},
        "n": np.zeros(4, np.int32)})
    assert torch.equal(wide["w"], t["w"].float())


def test_checkpoint_bf16_written_by_reference(tmp_path):
    """The reference's store writes a bf16 leaf as ``|V2`` under the name
    ``bfloat16``; the port restores it bit for bit, and writes the same
    files itself."""
    ref = {"w": jnp.asarray(np.random.default_rng(0).normal(size=(4, 6)),
                            jnp.bfloat16),
           "f": jnp.arange(3, dtype=jnp.float32)}
    jstore.save(tmp_path / "ref", 2, ref)
    like = {"w": torch.zeros((4, 6), dtype=torch.bfloat16),
            "f": torch.zeros(3)}
    got, _ = store.restore(tmp_path / "ref", 2, like)
    want_bits = np.asarray(ref["w"]).view(np.int16)
    assert got["w"].dtype == torch.bfloat16
    assert np.array_equal(got["w"].view(torch.int16).numpy(), want_bits)
    assert torch.equal(got["f"], torch.arange(3, dtype=torch.float32))
    store.save(tmp_path / "port", 2, got)
    for i in range(2):
        a = np.load(tmp_path / "ref" / "step_000002" / f"leaf_{i:05d}.npy")
        b = np.load(tmp_path / "port" / "step_000002" / f"leaf_{i:05d}.npy")
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert store.validate_step(tmp_path / "ref", 2)["leaves"] == \
        store.validate_step(tmp_path / "port", 2)["leaves"]


def _lm_run(params, cfg, ckpt_dir, n_steps):
    step = tsteps.build_lm_step(cfg, shapes.LMShape("t", "train", 16, 2),
                                adamw.AdamWConfig(lr=1e-3))
    state = train_loop.TrainState(params=params,
                                  opt_state=adamw.init_state(params))
    batch = {"tokens": torch.from_numpy(syn.token_batch(2, 16, cfg.vocab))}

    def batches():
        while True:
            yield batch
    return train_loop.run(state, step, batches(), train_loop.TrainLoopConfig(
        n_steps=n_steps, ckpt_every=2, ckpt_dir=str(ckpt_dir),
        keep_ckpts=5), log=lambda *_: None)


def test_bf16_lm_training_resumes_bitwise(tmp_path):
    """The reduced qwen3 in bf16 (AdamW's moments f32) through
    ``train.loop.run``: a run resumed from its step-2 commit reproduces the
    unbroken run's losses, parameters and moments bit for bit."""
    cfg = dataclasses.replace(_qwen3()[0], param_dtype="bfloat16",
                              act_dtype="bfloat16")

    def fresh():
        return T.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    state, hist = _lm_run(fresh(), cfg, tmp_path / "a", 4)
    assert state.params["embed"].dtype == torch.bfloat16
    assert state.opt_state.m["embed"].dtype == torch.float32
    (tmp_path / "b").mkdir()
    import shutil
    shutil.copytree(tmp_path / "a" / "step_000002",
                    tmp_path / "b" / "step_000002")
    state2, hist2 = _lm_run(fresh(), cfg, tmp_path / "b", 4)
    assert hist2["loss"] == hist["loss"][2:]
    for a, b in zip(tree.leaves((state.params, state.opt_state)),
                    tree.leaves((state2.params, state2.opt_state))):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
