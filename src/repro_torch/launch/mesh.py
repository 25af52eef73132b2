"""Meshes (port of ``repro.launch.mesh``): the production meshes and the
process group they stand on.

A ``DeviceMesh`` spans every rank of the default process group, one device
a rank.  :func:`init_process_group` opens that group from the usual
``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` variables (as
``torchrun`` sets them), or as a world of one where they are not set: NCCL
on the card, gloo only where ``device="cpu"`` is asked for.

:func:`fake_mesh` builds a mesh of any shape, the production meshes (16,
16) and (2, 16, 16) among them, in one process on torch's ``fake`` process
group: every rank's
collective returns at once and moves no bytes, so a program traced there
(the dry-run's rank 0, on meta tensors or on a card) shows its shapes,
launches, collectives and memory, never values.
"""

from __future__ import annotations

import contextlib
import os
import socket

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..parallel.sharding import MeshAxes


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def world_size() -> int:
    """The default group's size, or ``WORLD_SIZE`` (1 where unset) before
    the group is open."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_process_group(device: str | torch.device = "cuda",
                       init_method: str | None = None) -> None:
    """Open the default process group for ``device`` if it is not open:
    NCCL for ``cuda`` (which must be present: ``resolve_device`` raises
    otherwise), gloo for ``cpu``.  ``init_method`` defaults to ``env://``
    where ``MASTER_ADDR`` is set, else to a free localhost port for a world
    of one."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return
    rank, world = int(os.environ.get("RANK", "0")), world_size()
    if init_method is None:
        if "MASTER_ADDR" in os.environ:
            init_method = "env://"
        elif world == 1:
            init_method = f"tcp://localhost:{_free_port()}"
        else:
            raise RuntimeError(f"WORLD_SIZE {world} with no MASTER_ADDR: run under torchrun "
                               "or pass init_method")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank, world_size=world)


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...],
              device: str | torch.device = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over axes ``names`` on every rank of the
    default group (opened by :func:`init_process_group` if needed); the
    world must hold exactly prod(shape) ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    n = 1
    for s in shape:
        n *= s
    if world_size() != n:
        raise RuntimeError(f"mesh {tuple(shape)} needs {n} ranks, one a device, the world has "
                           f"{world_size()}: run under torchrun on that many devices")
    init_process_group(dev)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device: str | torch.device = "cuda"):
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device)
    return make_mesh((16, 16), ("data", "model"), device)


@contextlib.contextmanager
def fake_mesh(shape: tuple[int, ...], names: tuple[str, ...], device: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` over ``names`` seen from rank 0, on a
    ``fake`` default process group of prod(shape) ranks opened for the
    block and destroyed after it; ``device`` is the mesh's device type.
    Refuses to run where a default group is already open."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a default process group is open; destroy it first")
    n = 1
    for s in shape:
        n *= s
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()
        _forget_meshes()


def _forget_meshes() -> None:
    """Drop DTensor's caches of sharding decisions: they hold the meshes
    they were made on, whose process groups a destroyed world took along,
    and a later world's equal mesh would find them."""
    from torch.distributed.tensor import DTensor
    DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding.cache_clear()
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)
    if native is not None:  # the C++ dispatch path's own cache (recent torch)
        native()
    from torch.distributed.tensor import _redistribute
    for name in ("clear_redistribute_planner_cache",):
        fn = getattr(_redistribute, name, None)
        if fn is not None:
            fn()
    gen = getattr(_redistribute, "_gen_transform_infos", None)
    if gen is not None and hasattr(gen, "cache_clear"):
        gen.cache_clear()


def mesh_axes(mesh) -> MeshAxes:
    if "pod" in mesh.mesh_dim_names:
        return MeshAxes(data=("pod", "data"), model="model")
    return MeshAxes(data=("data",), model="model")


def chips(mesh) -> int:
    return mesh.size()
