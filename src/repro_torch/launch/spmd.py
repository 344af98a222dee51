"""Run a function on every rank of a fresh process group (SPMD worlds).

    results = spmd.spawn(fn, 8, mesh_shape=(4, 2),
                         mesh_names=("data", "model"), args=(x,))

``spawn`` starts ``world_size`` processes (the ``spawn`` start method),
each joins a process group through a ``FileStore`` in a new temporary
directory (no network address to pick), builds the ``DeviceMesh`` of
``mesh_shape`` over it, and calls ``fn(rank, mesh, *args)``; it returns
the ranks' results in rank order and raises, with the failing rank's
traceback, if any rank fails.  ``fn`` must be importable by name from the
child processes (a module-level function).

``backend="gloo"`` with ``device_type="cpu"`` is how the CPU tests run
several ranks on one machine; ``device_type="cuda"`` with gloo puts every
rank on the card ``cuda:0`` (several ranks share one card: NCCL refuses
two ranks on one device), where the collectives go through pinned host
buffers (``core.distributed.transport``).  ``backend="nccl"`` takes one
card a rank.  Each rank runs torch with ``threads`` intra-op threads.
"""
from __future__ import annotations

import os
import queue
import tempfile
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def init_world(rank: int, world_size: int, store_path: str,
               backend: str = "gloo"):
    """Join the process group of ``world_size`` ranks whose rendezvous is
    the ``FileStore`` at ``store_path``."""
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)


def world_mesh(mesh_shape: Sequence[int], mesh_names: Sequence[str],
               device_type: str = "cpu"):
    """The ``DeviceMesh`` of ``mesh_shape`` over the initialized group."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(mesh_shape),
                            mesh_dim_names=tuple(mesh_names))


def _rank_main(rank, fn, world_size, store_path, backend, mesh_shape,
               mesh_names, device_type, threads, args, results):
    try:
        torch.set_num_threads(threads)
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count()
                                  if backend == "nccl" else 0)
        init_world(rank, world_size, store_path, backend)
        mesh = world_mesh(mesh_shape, mesh_names,
                          "cuda" if backend == "nccl" else "cpu")
        out = fn(rank, mesh, *args)
        dist.barrier()
        results.put((rank, "ok", out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, *, backend: str = "gloo",
          mesh_shape: Optional[Sequence[int]] = None,
          mesh_names: Sequence[str] = ("data",), device_type: str = "cpu",
          args: tuple = (), threads: int = 1,
          timeout: float = 600.0) -> list:
    """``fn(rank, mesh, *args)`` on each of ``world_size`` fresh ranks →
    their results, in rank order."""
    mesh_shape = tuple(mesh_shape or (world_size,))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        store_path = os.path.join(d, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, fn, world_size, store_path, backend,
                                   mesh_shape, tuple(mesh_names),
                                   device_type, threads, args, results),
                             daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got, errors = {}, []
        try:
            for _ in range(world_size):
                try:
                    rank, status, out = results.get(timeout=timeout)
                except queue.Empty:
                    errors.append(f"no result within {timeout} s")
                    break
                if status == "ok":
                    got[rank] = out
                else:
                    errors.append(f"rank {rank}:\n{out}")
                    break
        finally:
            for p in procs:
                p.join(timeout=10 if not errors else 1)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("SPMD world failed: " + "\n".join(errors))
    return [got[r] for r in range(world_size)]
