"""Production meshes (port of ``repro.launch.mesh``). Single pod: 16×16 =
256 chips (data, model). Multi-pod: 2×16×16 = 512 chips (pod, data, model)
— the 'pod' axis carries only hierarchical data parallelism.

A mesh is a torch ``DeviceMesh`` over the default process group, which
needs one rank a chip. ``fake_world(n)`` brings up torch's fake process
group of `n` ranks in this one process (rank 0; its collectives do nothing),
where the JAX package's dry run pins 512 fake XLA host devices: with the
tensors on the meta device, a step runs its DTensor sharding rules and
issues its collectives without memory or data. ``make_host_mesh`` is a real
mesh over the ranks there are (one, on one card).

Defined as functions, never module-level constants: importing this module
touches no process group. A process has one default group, so the fake world
and a real one never meet: ``fake_world`` refuses to start while another
group is up.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A DeviceMesh of `shape` named `axes` over the default group's ranks
    (row-major), whose world size must be the mesh's size."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; start one "
                           "(fake_world, make_host_mesh or "
                           "torch.distributed.init_process_group) first")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"make_mesh: a {tuple(shape)} mesh needs {n} ranks, "
                         f"the world has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def production_shape(*, multi_pod: bool = False, kind: str = "train"):
    """(shape, axes) of a production mesh. kind="train": 16×16 (balanced
    FSDP×TP). kind="serve": 32×8 — tp=8 divides every assigned arch's
    kv_heads, so decode caches shard on the kv-head dim. Same 256 chips a pod
    either way."""
    if kind == "serve":
        shape = (2, 32, 8) if multi_pod else (32, 8)
    else:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False, kind: str = "train",
                         device_type: str = "cuda"):
    """The production mesh over a world of its size (``fake_world``)."""
    shape, axes = production_shape(multi_pod=multi_pod, kind=kind)
    return make_mesh(shape, axes, device_type)


@contextlib.contextmanager
def fake_world(n: int):
    """Torch's fake process group of `n` ranks (this process is rank 0) for
    the block's life; destroyed on exit."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already up; "
                           "destroy it first (one default group a process)")
    # torch.testing._internal is not a public API: its fake group is
    # imported here only (importing it registers the "fake" backend)
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_host_mesh(device_type: str = None):
    """(n, 1) over the ranks of the default group, or over this process
    alone (a world of one, its store in memory: no file, no network) when
    no group is up; the caller then owns that group and ends it with
    ``torch.distributed.destroy_process_group()``. On the card (NCCL)
    unless `device_type` is "cpu" (gloo); raises when no card is present
    and the CPU was not asked for."""
    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh: no CUDA device is available; "
                           "pass device_type='cpu' to run on the CPU")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"make_host_mesh: device_type {device_type!r}")
    if not dist.is_initialized():
        if device_type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return make_mesh((dist.get_world_size(), 1), ("data", "model"),
                     device_type)
