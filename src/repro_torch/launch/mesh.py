"""Mesh construction for the production pods, over ``torch.distributed``.

The port of ``repro/launch/mesh.py`` and of the ``make_mesh`` half of
``repro/jax_compat.py``.  A mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` whose dimension names
are the reference's axis names.  Single pod: a 16×16 mesh over (data,
model).  Multi-pod: 2×16×16 over (pod, data, model); the ``pod`` axis
composes with ``data`` for gradient reduction while FSDP and TP stay
inside a pod.

JAX sees every device of the host from one process; torch runs one
process per device, joined in a process group.  So a mesh is built over
the initialised world, whose size must be the mesh's: nothing builds a
smaller mesh quietly.  :func:`process_group` joins and leaves such a world
from a file rendezvous (no TCP port to collide on).  :func:`fake_world`
joins a world of any size as its rank 0 alone, over torch's "fake"
backend, whose collectives return at once: a dry run
(``launch/dryrun.py``) traces one rank of a production mesh in one
process.  Nothing here runs at import: the functions touch the process
group only when called.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["fake_world", "make_mesh_compat", "make_production_mesh",
           "make_smoke_mesh", "production_mesh_shape", "process_group"]


def _device_type(device_type: Optional[str]) -> str:
    return "cuda" if device_type is None else device_type


@contextlib.contextmanager
def process_group(rank: int, world_size: int, init_file: str,
                  device_type: Optional[str] = None) -> Iterator[None]:
    """Join the world ``world_size`` as ``rank`` through the rendezvous file
    ``init_file`` (absent or empty before the first rank joins), and leave
    it on exit, also when the body raises.  ``device_type`` None or
    "cuda" is NCCL with rank r on card ``r % device_count``; "cpu" is gloo."""
    device_type = _device_type(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """Join a world of ``world_size`` ranks as rank 0, alone, through
    torch's "fake" backend (a ``FakeStore``): every collective returns at
    once without touching its tensors, so :func:`make_mesh_compat` builds
    the production mesh in one process and a step traces as its rank 0.
    Left on exit, also when the body raises.  A process that is already
    in a world is refused: a dry run never shares it with a real one."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised: a fake "
                           "world never joins a process that is in a real one")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh_compat(shape: Sequence[int], axes: Sequence[str],
                     device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the initialised world.
    ``device_type`` None is "cuda" (NCCL); the tests ask for "cpu" (gloo)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise ValueError(f"a mesh of shape {shape} needs an initialised process "
                         "group (see process_group)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} "
                         f"ranks; the world has {world}")
    return init_device_mesh(_device_type(device_type), shape, mesh_dim_names=axes)


def production_mesh_shape(multi_pod: bool = False) -> Tuple[Tuple[int, ...],
                                                            Tuple[str, ...]]:
    """(shape, axes) of the production mesh, with no ranks needed."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    return make_mesh_compat(*production_mesh_shape(multi_pod), device_type)


def make_smoke_mesh(data: int = 1, model: int = 1,
                    device_type: Optional[str] = None) -> DeviceMesh:
    """A small (data, model) mesh over the initialised world: tests only."""
    return make_mesh_compat((data, model), ("data", "model"), device_type)
