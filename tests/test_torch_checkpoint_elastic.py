"""The port's elastic restore (``checkpoint.store.restore(...,
shardings=)``) against the reference's, on the CPU — the counterpart of
``tests/test_checkpoint.py::test_elastic_restore_new_sharding`` and of
``tests/test_variants.py``'s elastic half.

A checkpoint holds whole arrays, whatever layout wrote it, and
``shardings`` (a tree of ``core.distributed.NamedSharding``, or ``None``
leaves) places each leaf as a DTensor on a mesh by a spec.  Worlds are
gloo ranks started by ``launch.spmd.spawn``: a world of 2 ranks on a
``(2,)`` mesh shards a tree on dim 0, gathers it, saves it from rank 0 and
restores it onto the other layout (dim 1 split, replicated, and a plain
leaf); a world of 1 rank restores the same files onto its one-rank mesh,
held against the reference's ``restore`` with a ``NamedSharding`` on a
one-device jax mesh.  This file imports no JAX at the top: the ranks
import it by name.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import store
from repro_torch.core.distributed import NamedSharding
from repro_torch.launch import spmd


def _tree():
    """Leaves a 2-rank mesh splits on either dim: (4, 6) f32, (2, 8) f32,
    (6,) int32."""
    rng = np.random.default_rng(7)
    return {"a": torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32)),
            "b": (torch.from_numpy(rng.normal(size=(2, 8)).astype(
                np.float32)),
                  torch.arange(6, dtype=torch.int32))}


def _local(t):
    return t.to_local().numpy() if hasattr(t, "to_local") else t.numpy()


def save_and_restore_two_ranks(rank, mesh, ckpt_dir):
    """Shard the tree on dim 0, gather it, save from rank 0, then restore
    it with dim 1 split for ``a``, ``b[0]`` replicated and ``b[1]`` plain
    → this rank's blocks and placements."""
    from torch.distributed.tensor import Shard, distribute_tensor
    t = _tree()
    sharded = {"a": distribute_tensor(t["a"], mesh, [Shard(0)]),
               "b": tuple(distribute_tensor(x, mesh, [Shard(0)])
                          for x in t["b"])}
    full = {"a": sharded["a"].full_tensor(),
            "b": tuple(x.full_tensor() for x in sharded["b"])}
    if rank == 0:
        store.save(ckpt_dir, 3, full, metadata={"world": 2})
    torch.distributed.barrier()
    shardings = {"a": NamedSharding(mesh, (None, "data")),
                 "b": (NamedSharding(mesh, ()), None)}
    out, meta = store.restore(ckpt_dir, 3, t, shardings=shardings)
    return dict(meta=meta, a=_local(out["a"]), b0=_local(out["b"][0]),
                b1=_local(out["b"][1]), dtensor=[
                    hasattr(x, "to_local")
                    for x in (out["a"], out["b"][0], out["b"][1])],
                placements=[str(out["a"].placements),
                            str(out["b"][0].placements)])


def restore_one_rank(rank, mesh, ckpt_dir):
    """The 2-rank world's checkpoint onto a one-rank mesh, every leaf
    replicated."""
    sh = NamedSharding(mesh, ())
    out, _ = store.restore(ckpt_dir, 3, _tree(),
                           shardings={"a": sh, "b": (sh, sh)})
    return dict(a=_local(out["a"]), b0=_local(out["b"][0]),
                b1=_local(out["b"][1]), dtype=str(out["b"][1].dtype),
                mesh=tuple(out["a"].device_mesh.shape))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("elastic"))
    two = spmd.spawn(save_and_restore_two_ranks, 2, args=(ckpt,))
    one = spmd.spawn(restore_one_rank, 1, args=(ckpt,))
    return ckpt, two, one[0]


def test_two_rank_save_restores_onto_the_other_layout(worlds):
    """Saved from dim-0 shards, restored with ``a``'s dim 1 split over the
    2 ranks, ``b[0]`` replicated and ``b[1]`` (a ``None`` sharding) a plain
    tensor: each rank's block is its slice of the saved array, bitwise."""
    _, two, _ = worlds
    t = _tree()
    for rank, r in enumerate(two):
        assert r["meta"] == {"world": 2}
        assert r["dtensor"] == [True, True, False]
        assert r["placements"] == ["(Shard(dim=1),)", "(Replicate(),)"]
        np.testing.assert_array_equal(r["a"], t["a"].numpy()[:, 3 * rank:
                                                               3 * rank + 3])
        np.testing.assert_array_equal(r["b0"], t["b"][0].numpy())
        np.testing.assert_array_equal(r["b1"], t["b"][1].numpy())


def test_one_rank_mesh_restore_equals_reference(worlds):
    """The same files onto a one-rank gloo mesh in the port and onto a
    one-device jax mesh (``NamedSharding(mesh, P())``) in the reference:
    every leaf equal, dtypes kept."""
    import jax
    from jax.sharding import NamedSharding as JNamed
    from jax.sharding import PartitionSpec as P

    from repro.checkpoint import store as jstore
    ckpt, _, one = worlds
    t = _tree()
    like = {"a": jax.ShapeDtypeStruct((4, 6), np.float32),
            "b": (jax.ShapeDtypeStruct((2, 8), np.float32),
                  jax.ShapeDtypeStruct((6,), np.int32))}
    mesh = jax.make_mesh((1,), ("data",))
    sh = jax.tree.map(lambda _: JNamed(mesh, P()), like)
    ref, _ = jstore.restore(ckpt, 3, like, shardings=sh)
    assert one["mesh"] == (1,) and one["dtype"] == "torch.int32"
    for got, want, orig in ((one["a"], ref["a"], t["a"]),
                            (one["b0"], ref["b"][0], t["b"][0]),
                            (one["b1"], ref["b"][1], t["b"][1])):
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(got, orig.numpy())
    assert ref["a"].sharding == sh["a"]


def test_restore_with_none_shardings_places_like_the_tree(tmp_path):
    """A ``shardings`` tree of ``None`` (whole, or leaf by leaf) restores
    as ``restore`` without it: each leaf on its ``like_tree`` leaf's device
    and dtype, bitwise."""
    t = _tree()
    store.save(tmp_path, 1, t)
    plain, _ = store.restore(tmp_path, 1, t)
    for shardings in (None, {"a": None, "b": None},
                      {"a": None, "b": (None, None)}):
        got, _ = store.restore(tmp_path, 1, t, shardings=shardings)
        for x, y in zip((got["a"],) + got["b"], (plain["a"],) + plain["b"]):
            assert type(x) is torch.Tensor and x.dtype == y.dtype
            assert torch.equal(x, y)
