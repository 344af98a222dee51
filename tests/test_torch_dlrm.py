"""The port's DLRM (``models/recsys/dlrm.py`` on the EmbeddingBag kernel's
plain version) against ``repro.models.recsys.dlrm`` on the same parameters
and batches: logits, loss and retrieval scores at rtol = atol = 1e-5, for
``reduced()`` and for dlrm-rm2's published widths with every vocabulary cut
to ≤ 1000 rows (the full table is 12.6 GB).  The data generator must be
bitwise the reference's, and the full config's table geometry equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_rm2 as ref_cfgs
from repro.configs.shapes import RECSYS_SHAPES as REF_SHAPES
from repro.data import synthetic as ref_syn
from repro.models.recsys import dlrm as ref_dlrm
from repro_torch.configs import dlrm_rm2
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.convert import dlrm_params_from_jax
from repro_torch.data.synthetic import dlrm_batch
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.launch.steps import build_recsys_step
from repro_torch.models.recsys import dlrm

TOL = dict(rtol=1e-5, atol=1e-5)


def _cut(cfg, cap=1000):
    return dataclasses.replace(cfg, vocab_sizes=tuple(
        min(v, cap) for v in cfg.vocab_sizes))


CASES = {
    "reduced": (ref_cfgs.reduced(), dlrm_rm2.reduced()),
    "rm2_widths": (_cut(ref_cfgs.FULL), _cut(dlrm_rm2.FULL)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def model(request):
    ref_cfg, cfg = CASES[request.param]
    tree = ref_dlrm.init_params(jax.random.key(0), ref_cfg)
    np_tree = jax.tree.map(np.asarray, tree)
    return ref_cfg, cfg, tree, dlrm_params_from_jax(np_tree, device="cpu")


def _batch(cfg, b, multi_hot=1, seed=3):
    return dlrm_batch(b, cfg.n_dense, cfg.vocab_sizes, multi_hot=multi_hot,
                      seed=seed)


def test_config_numbers_match_reference():
    for ref_cfg, cfg in [(ref_cfgs.FULL, dlrm_rm2.FULL),
                         (ref_cfgs.reduced(), dlrm_rm2.reduced())]:
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
        assert cfg.padded_vocab == ref_cfg.padded_vocab
        assert np.array_equal(cfg.field_offsets, ref_cfg.field_offsets)
        assert cfg.field_offsets.dtype == ref_cfg.field_offsets.dtype
        assert cfg.n_interactions == ref_cfg.n_interactions
        assert cfg.top_mlp_in == ref_cfg.top_mlp_in
    full = dlrm_rm2.FULL
    assert full.padded_vocab == 49_127_424 and full.top_mlp_in == 415
    # field 20 crosses row 2**31 / 64 and fields 21-25 lie past it: their
    # row offsets need 64 bits
    offs = full.field_offsets.astype(np.int64) * full.embed_dim
    assert offs[20] < 2 ** 31 <= offs[21]


def test_shapes_match_reference():
    assert RECSYS_SHAPES.keys() == REF_SHAPES.keys()
    for name, shape in RECSYS_SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            REF_SHAPES[name])


@pytest.mark.parametrize("batch,multi_hot,seed", [(16, 1, 0), (5, 4, 7)])
def test_dlrm_batch_is_bitwise_the_reference(batch, multi_hot, seed):
    vocabs = dlrm_rm2.FULL.vocab_sizes
    got = dlrm_batch(batch, 13, vocabs, multi_hot=multi_hot, seed=seed)
    want = ref_syn.dlrm_batch(batch, 13, vocabs, multi_hot=multi_hot,
                              seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("multi_hot", [1, 3])
def test_forward_and_loss_match_reference(model, multi_hot):
    ref_cfg, cfg, tree, params = model
    dense, ids, labels = _batch(cfg, 16, multi_hot)
    want = np.asarray(ref_dlrm.forward(tree, ref_cfg, jnp.asarray(dense),
                                       jnp.asarray(ids)))
    got = dlrm.forward(params, cfg, torch.from_numpy(dense),
                       torch.from_numpy(ids))
    assert got.shape == (16,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want_loss = float(ref_dlrm.loss_fn(tree, ref_cfg, jnp.asarray(dense),
                                       jnp.asarray(ids),
                                       jnp.asarray(labels)))
    got_loss = float(dlrm.loss_fn(params, cfg, torch.from_numpy(dense),
                                  torch.from_numpy(ids),
                                  torch.from_numpy(labels)))
    np.testing.assert_allclose(got_loss, want_loss, **TOL)


def test_embedding_bag_and_interaction_match_reference(model):
    ref_cfg, cfg, tree, params = model
    dense, ids, _ = _batch(cfg, 8, 2)
    offs = cfg.field_offsets
    want = np.asarray(ref_dlrm.embedding_bag(tree["table"], jnp.asarray(ids),
                                             jnp.asarray(offs)))
    got = dlrm.embedding_bag(params["table"], torch.from_numpy(ids),
                             torch.from_numpy(offs))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    x = np.random.default_rng(1).normal(
        size=(8, cfg.embed_dim)).astype(np.float32)
    np.testing.assert_allclose(
        dlrm.interact(torch.from_numpy(x), got).numpy(),
        np.asarray(ref_dlrm.interact(jnp.asarray(x), jnp.asarray(want))),
        **TOL)


def test_retrieval_matches_reference(model):
    ref_cfg, cfg, tree, params = model
    dense, ids, _ = _batch(cfg, 1)
    cand = np.random.default_rng(2).normal(
        size=(500, cfg.embed_dim)).astype(np.float32)
    want = np.asarray(ref_dlrm.retrieval_step(
        tree, ref_cfg, jnp.asarray(dense), jnp.asarray(ids),
        jnp.asarray(cand)))
    got = dlrm.retrieval_step(params, cfg, torch.from_numpy(dense),
                              torch.from_numpy(ids), torch.from_numpy(cand))
    assert got.shape == (1, 500)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shape", ["serve_p99", "retrieval_cand"])
def test_recsys_steps_match_reference_steps(model, shape):
    from repro.launch.steps import build_recsys_step as ref_build
    ref_cfg, cfg, tree, params = model
    b = 8 if shape == "serve_p99" else 1      # the shape's batch, cut
    dense, ids, _ = _batch(cfg, b)
    cand = np.random.default_rng(4).normal(
        size=(64, cfg.embed_dim)).astype(np.float32)
    batch = {"dense": dense, "sparse_ids": ids, "candidates": cand}
    want = np.asarray(ref_build(ref_cfg, REF_SHAPES[shape])(
        tree, {k: jnp.asarray(v) for k, v in batch.items()}))
    before = embedding_bag.launches
    got = build_recsys_step(cfg, RECSYS_SHAPES[shape])(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert embedding_bag.launches == before     # plain versions do not count
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_train_step_is_not_ported_yet():
    """DLRM training is ported now (``tests/test_torch_dlrm_train.py``
    holds it against the reference): the train kind builds a step that
    updates every parameter, where it used to raise."""
    cfg = dlrm_rm2.reduced()
    params = dlrm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    from repro_torch.optim import adamw
    d, ids, y = _batch(cfg, 8)
    new, _, m = build_recsys_step(cfg, RECSYS_SHAPES["train_batch"])(
        params, adamw.init_state(params),
        {"dense": torch.from_numpy(d), "sparse_ids": torch.from_numpy(ids),
         "labels": torch.from_numpy(y)})
    assert np.isfinite(float(m["loss"]))
    assert not torch.equal(new["table"], params["table"])


def test_init_params_shapes_and_scale():
    cfg = _cut(dlrm_rm2.FULL)
    p = dlrm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert p["table"].shape == (cfg.padded_vocab, 64)
    assert 0.008 < float(p["table"].std()) < 0.012
    assert [p["bot"][f"w{i}"].shape for i in range(3)] == [
        (13, 512), (512, 256), (256, 64)]
    assert [p["top"][f"w{i}"].shape for i in range(4)] == [
        (415, 512), (512, 512), (512, 256), (256, 1)]
    assert all(float(p["top"][f"b{i}"].abs().max()) == 0 for i in range(4))


@pytest.mark.parametrize("bad", ["keys", "mlp_chain", "bias", "bot_width"])
def test_convert_checks_shapes(bad):
    rng = np.random.default_rng(0)
    tree = {"table": rng.normal(size=(20, 8)).astype(np.float32),
            "bot": {"w0": np.zeros((13, 8), np.float32),
                    "b0": np.zeros(8, np.float32)},
            "top": {"w0": np.zeros((10, 4), np.float32),
                    "b0": np.zeros(4, np.float32),
                    "w1": np.zeros((4, 1), np.float32),
                    "b1": np.zeros(1, np.float32)}}
    assert dlrm_params_from_jax(tree, device="cpu")["table"].shape == (20, 8)
    if bad == "keys":
        tree["emb"] = tree.pop("table")
    elif bad == "mlp_chain":
        tree["top"]["w1"] = np.zeros((5, 1), np.float32)
    elif bad == "bias":
        tree["top"]["b0"] = np.zeros(5, np.float32)
    else:
        tree["bot"]["w0"] = np.zeros((13, 6), np.float32)
        tree["bot"]["b0"] = np.zeros(6, np.float32)
    with pytest.raises(ValueError):
        dlrm_params_from_jax(tree, device="cpu")
