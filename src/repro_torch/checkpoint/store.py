"""Async committed checkpoints on disk (port of
``repro.checkpoint.store``).

Layout on disk (one directory per step), the reference's:

  ckpt_dir/step_000123/
    manifest.json     — leaf shapes/dtypes, step metadata
    leaf_00000.npy    — one array per leaf, in ``repro_torch.tree`` order
    ...
    COMMIT            — written last; a checkpoint without COMMIT is torn
                        (crash mid-save) and ignored on restore

Leaves are flattened in the reference's order (sorted dict keys, tuples and
NamedTuples by position: ``(params, (step, m, v))``), so a step the
reference wrote restores into the port, and the reverse.

* atomic-by-marker: a step is written to a temporary directory and renamed
  into place after its ``COMMIT``; readers trust committed steps only;
* validated restore: ``restore`` raises ``CheckpointError`` on a missing
  commit marker, an unreadable or incomplete manifest, a missing leaf file
  or a leaf whose shape does not match ``like_tree``;
* async: ``AsyncCheckpointer.save_async`` copies the tree to host memory
  synchronously and writes it in a background thread;
* placement: ``restore`` puts each leaf on the device and in the dtype of
  the matching ``like_tree`` leaf, whatever wrote it, or, with
  ``shardings``, as a DTensor on a mesh by a spec (elastic restore);
* bfloat16: a bf16 leaf is saved as the reference saves one, its 2-byte
  payloads (``|V2``) under the manifest dtype ``bfloat16``, and restored
  bit for bit, the reference's files included;
* retention: ``gc_keep_last`` prunes old steps and coordinates with
  in-flight async saves through a process-wide registry: a step whose save
  has not committed is protected from deletion and counted toward the
  newest-``keep`` window.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as tree_util


class CheckpointError(RuntimeError):
    """A checkpoint step failed validation (torn save, missing leaves, or a
    manifest that does not match the requested ``like_tree``)."""


# steps with an in-flight (pre-COMMIT) save, keyed per checkpoint dir so GC
# for one store never shields steps of another: {resolved dir: {step, ...}}
_INFLIGHT_LOCK = threading.Lock()
_INFLIGHT_SAVES: dict = {}


def _inflight_key(ckpt_dir) -> str:
    return str(Path(ckpt_dir).resolve())


def _register_inflight(ckpt_dir, step: int):
    with _INFLIGHT_LOCK:
        _INFLIGHT_SAVES.setdefault(_inflight_key(ckpt_dir), set()).add(
            int(step))


def _unregister_inflight(ckpt_dir, step: int):
    with _INFLIGHT_LOCK:
        key = _inflight_key(ckpt_dir)
        steps = _INFLIGHT_SAVES.get(key)
        if steps is not None:
            steps.discard(int(step))
            if not steps:
                _INFLIGHT_SAVES.pop(key, None)


def inflight_steps(ckpt_dir) -> list:
    """Steps whose save has started but not committed yet (sorted)."""
    with _INFLIGHT_LOCK:
        return sorted(_INFLIGHT_SAVES.get(_inflight_key(ckpt_dir), ()))


def _to_host(leaf):
    """A host copy of ``leaf``: a numpy array, or a CPU tensor for a
    bfloat16 tensor (numpy has no such type)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        return leaf if leaf.dtype == torch.bfloat16 else leaf.numpy()
    return np.asarray(leaf)


def _is_bf16(arr) -> bool:
    """A bfloat16 tensor, or an ``ml_dtypes.bfloat16`` array (known by
    name and size: the port does not import ml_dtypes)."""
    if isinstance(arr, torch.Tensor):
        return arr.dtype == torch.bfloat16
    return arr.dtype.name == "bfloat16" and arr.dtype.itemsize == 2


def _to_disk(leaf):
    """(array to ``np.save``, manifest dtype name).  A bfloat16 leaf is
    saved as the reference saves it: its 2-byte payloads (``|V2``) under
    the name ``bfloat16``."""
    arr = _to_host(leaf)
    if _is_bf16(arr):
        bits = (arr.view(torch.int16).numpy() if isinstance(arr, torch.Tensor)
                else np.ascontiguousarray(arr).view(np.int16))
        return bits.view(np.dtype("V2")), "bfloat16"
    return arr, str(arr.dtype)


def save(ckpt_dir, step: int, tree, metadata: Optional[dict] = None) -> Path:
    """Synchronous save with commit marker."""
    ckpt_dir = Path(ckpt_dir)
    step_dir = ckpt_dir / f"step_{step:06d}"
    tmp_dir = ckpt_dir / f".tmp_step_{step:06d}_{time.time_ns() // 1000}"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    _register_inflight(ckpt_dir, step)
    try:
        leaves, structure = tree_util.flatten(tree)
        manifest = {
            "step": step,
            "treedef": repr(structure),
            "n_leaves": len(leaves),
            "leaves": [],
            "metadata": metadata or {},
        }
        for i, leaf in enumerate(leaves):
            arr, dtype = _to_disk(leaf)
            np.save(tmp_dir / f"leaf_{i:05d}.npy", arr)
            manifest["leaves"].append(
                {"shape": list(arr.shape), "dtype": dtype})
        (tmp_dir / "manifest.json").write_text(json.dumps(manifest))
        (tmp_dir / "COMMIT").write_text(str(time.time()))
        if step_dir.exists():
            shutil.rmtree(step_dir)
        tmp_dir.rename(step_dir)
    finally:
        _unregister_inflight(ckpt_dir, step)
    return step_dir


class AsyncCheckpointer:
    """Snapshot to host memory synchronously; persist in a background
    thread.  ``wait`` joins it and raises what the write raised."""

    def __init__(self, ckpt_dir):
        self.ckpt_dir = Path(ckpt_dir)
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save_async(self, step: int, tree, metadata=None):
        self.wait()
        leaves, structure = tree_util.flatten(tree)
        host_tree = tree_util.unflatten(structure,
                                        [_to_host(x) for x in leaves])
        # registered here, not only inside save(), so the step is shielded
        # from gc_keep_last the moment save_async returns
        _register_inflight(self.ckpt_dir, step)

        def worker():
            try:
                save(self.ckpt_dir, step, host_tree, metadata)
            except BaseException as e:  # noqa: BLE001 — surfaced by wait()
                self.last_error = e
            finally:
                _unregister_inflight(self.ckpt_dir, step)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


def committed_steps(ckpt_dir) -> list:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for d in sorted(ckpt_dir.glob("step_*")):
        if (d / "COMMIT").exists():
            out.append(int(d.name.split("_")[1]))
    return out


def latest_step(ckpt_dir) -> Optional[int]:
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def validate_step(ckpt_dir, step: int, like_tree: Any = None) -> dict:
    """Validate a step on disk; returns its manifest or raises
    ``CheckpointError``.  Checks: commit marker present, manifest readable
    and complete, every leaf file present, and — when ``like_tree`` is
    given — leaf count and per-leaf shapes matching the target tree."""
    step_dir = Path(ckpt_dir) / f"step_{step:06d}"
    if not (step_dir / "COMMIT").exists():
        raise CheckpointError(
            f"step {step} at {step_dir} has no COMMIT marker "
            f"(torn or in-flight save) — refusing to restore")
    try:
        manifest = json.loads((step_dir / "manifest.json").read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(
            f"step {step}: unreadable manifest ({e})") from e
    leaf_meta = manifest.get("leaves")
    if leaf_meta is None or manifest.get("n_leaves") != len(leaf_meta):
        raise CheckpointError(
            f"step {step}: manifest incomplete "
            f"(n_leaves={manifest.get('n_leaves')!r} vs "
            f"{None if leaf_meta is None else len(leaf_meta)} entries)")
    for i in range(len(leaf_meta)):
        if not (step_dir / f"leaf_{i:05d}.npy").exists():
            raise CheckpointError(f"step {step}: missing leaf file {i}")
    if like_tree is not None:
        leaves = tree_util.leaves(like_tree)
        if len(leaf_meta) != len(leaves):
            raise CheckpointError(
                f"step {step}: leaf count mismatch — checkpoint has "
                f"{len(leaf_meta)}, like_tree has {len(leaves)}")
        for i, (meta, like) in enumerate(zip(leaf_meta, leaves)):
            want = tuple(like.shape)
            got = tuple(meta.get("shape", ()))
            if got != want:
                raise CheckpointError(
                    f"step {step}: leaf {i} shape mismatch — "
                    f"checkpoint {got} vs like_tree {want}")
    return manifest


def _place(arr: np.ndarray, dtype: str, like):
    """``arr`` (saved as ``dtype``) as ``like``: a tensor on its device in
    its dtype, or a numpy array in its dtype.  A bfloat16 leaf's 2-byte
    payloads become a ``torch.bfloat16`` tensor bit for bit (or a view in
    a bfloat16 ``like`` array's own type)."""
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise CheckpointError(f"a bfloat16 leaf holds {arr.dtype} "
                                  "items")
        bits = np.ascontiguousarray(arr).view(np.int16)
        if not isinstance(like, torch.Tensor) and _is_bf16(like):
            return bits.view(like.dtype)
        arr = torch.from_numpy(bits).view(torch.bfloat16)
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr).to(device=like.device, dtype=like.dtype)
    if isinstance(arr, torch.Tensor):
        arr = arr.float().numpy()
    return arr.astype(like.dtype)


def _sharding_leaves(shardings, like_tree) -> list:
    """One entry a ``like_tree`` leaf, in its order: the sharding that
    ``shardings`` (a tree of ``like_tree``'s structure) holds for it, or
    ``None`` where it or a subtree above it is ``None``."""
    out: list = []

    def walk(sh, t):
        if isinstance(t, dict):
            for key in sorted(t):
                walk(None if sh is None else sh[key], t[key])
        elif isinstance(t, (tuple, list)):
            for i, child in enumerate(t):
                walk(None if sh is None else sh[i], child)
        elif t is not None:
            out.append(sh)
    walk(shardings, like_tree)
    return out


def _distribute(leaf: torch.Tensor, sharding) -> torch.Tensor:
    """``leaf`` (the whole array, the same on every rank: each read the
    same file) as a DTensor on ``sharding``'s mesh: each rank keeps its own
    block, with no communication."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(leaf, sharding.mesh,
                             sharding.placements(leaf.ndim),
                             src_data_rank=None)


def restore(ckpt_dir, step: int, like_tree: Any, shardings=None):
    """Load a committed step into the structure of ``like_tree`` →
    (tree, metadata).  Each leaf takes the device and dtype of its
    ``like_tree`` leaf; ``shardings``, a tree matching ``like_tree`` whose
    leaves are ``None`` or ``core.distributed.NamedSharding``s, places a
    leaf as a DTensor on that mesh by that spec instead: the elastic
    restore onto a mesh other than the writer's (the files hold whole
    arrays, whatever layout wrote them).  Raises ``CheckpointError``
    (never loads garbage) if the step is torn, its manifest is unreadable,
    or any leaf mismatches ``like_tree``."""
    step_dir = Path(ckpt_dir) / f"step_{step:06d}"
    manifest = validate_step(ckpt_dir, step, like_tree)
    leaves, structure = tree_util.flatten(like_tree)
    placed = _sharding_leaves(shardings, like_tree)
    loaded = []
    for i, (like, sharding) in enumerate(zip(leaves, placed)):
        arr = np.load(step_dir / f"leaf_{i:05d}.npy")
        if tuple(arr.shape) != tuple(like.shape):
            raise CheckpointError(
                f"step {step}: leaf {i} on-disk shape {tuple(arr.shape)} "
                f"mismatches like_tree {tuple(like.shape)}")
        dtype = manifest["leaves"][i].get("dtype", "")
        if sharding is None:
            loaded.append(_place(arr, dtype, like))
        else:               # the whole leaf on the host, then its block
            host = torch.empty(0, dtype=like.dtype)
            loaded.append(_distribute(_place(arr, dtype, host), sharding))
    return tree_util.unflatten(structure, loaded), manifest["metadata"]


def gc_keep_last(ckpt_dir, keep: int = 3):
    """Prune all but the newest ``keep`` steps.  Steps with an in-flight
    async save count toward the window and are never deleted."""
    if keep <= 0:
        return
    inflight = set(inflight_steps(ckpt_dir))
    steps = sorted(set(committed_steps(ckpt_dir)) | inflight)
    for s in steps[:-keep]:
        if s in inflight:
            continue
        shutil.rmtree(Path(ckpt_dir) / f"step_{s:06d}", ignore_errors=True)
