"""Production mesh builders (port of ``repro.launch.mesh``).

Single pod: 256 devices as (data=16, model=16).  Multi-pod: 2 × 256 as
(pod=2, data=16, model=16); the ``pod`` axis carries hierarchical data
parallelism (the gradient all-reduce that crosses pods; see
``repro_torch.optim.compression`` for its int8 form).

A ``DeviceMesh`` needs a process group of the mesh's size:
``fake_world(n)`` starts one of ``n`` ranks on torch.distributed's
``fake`` backend (collectives return at once and move nothing), which is
how the dry run builds a 256- or 512-rank mesh in one process.
``MeshShape`` is a mesh's axis names and sizes alone, which is all the
sharding rules read.  Functions, not module constants: importing this
module touches no process group.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Tuple

import torch
import torch.distributed as dist

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh, without devices or a process
    group."""
    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def production_mesh_shape(multi_pod: bool = False) -> MeshShape:
    return MeshShape(*PRODUCTION_SHAPES[multi_pod])


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in axis_sizes(mesh).values())


def axis_names(mesh) -> Tuple[str, ...]:
    """A ``DeviceMesh``'s or a ``MeshShape``'s axis names."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return dict(zip(axis_names(mesh), mesh.shape))


@contextlib.contextmanager
def fake_world(world_size: int):
    """A process group of ``world_size`` ranks on the ``fake`` backend,
    this process rank 0, destroyed on exit whatever happens inside."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _device_mesh(sizes, names, device_type: str = "cpu"):
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in sizes:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(
            f"a {'x'.join(map(str, sizes))} mesh needs a process group of "
            f"{n} ranks, have {have} (fake_world({n}) starts one)")
    return init_device_mesh(device_type, tuple(sizes),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``, over the initialized process group
    (host devices, as the fake world has no card)."""
    sizes, names = PRODUCTION_SHAPES[multi_pod]
    return _device_mesh(sizes, names)


def make_host_mesh(data: int = 1, model: int = 1):
    """A (data, model) mesh over the ranks of the initialized process
    group (tests, examples), on the card where there is one."""
    return _device_mesh((data, model), ("data", "model"),
                        "cuda" if torch.cuda.is_available() else "cpu")


def make_mesh(sizes, names):
    """A mesh of any shape over the initialized process group, on host
    devices."""
    return _device_mesh(sizes, names)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The (possibly hierarchical) batch-parallel axes of a mesh."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def all_axes(mesh) -> Tuple[str, ...]:
    return axis_names(mesh)
