"""The process world and its mesh, the counterpart of
:mod:`horovod_tpu.parallel.mesh` for one process per GPU.

The reference names the axes of a ``jax.sharding.Mesh`` over the device
grid; here each process drives one card and the mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` over the processes of
the world, over the reference's axis order ``(dp, fsdp, pp, sp, tp,
ep)``, row-major: the rank at ``(d, f, s, t)`` is ``((d * fsdp + f) *
sp + s) * tp + t``, so tp is innermost, as the reference lays it out.
dp, fsdp, sp and tp are ported; pp and ep must be 1 (ROADMAP Queue 1
items 12 and 11). Axes of size 1 other than dp are left out of the
``DeviceMesh`` (torch makes a process group for each of its dims);
:func:`mesh_axis_size` reads an absent axis as 1, as the reference's
size-1 axes are read.

    device = init_process_group()      # nccl on cuda:<local_rank>
    mesh = build_mesh(dp=-1)           # or build_mesh(dp=2, sp=2, tp=2)

Groups: :func:`tp_group` and :func:`sp_group` carry the model's own
collectives; :func:`replica_group` is the group the gradients are
Averaged over (the ranks that hold the same parameter shards).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from horovod_tpu_torch.common.topology import (Topology, card_index,
                                               topology_from_env)
from horovod_tpu_torch.device import resolve_device

SHARDING_TODO = ("the dp, fsdp, sp and tp axes are ported; ep (MoE) is "
                 "ROADMAP Queue 1 item 11, pp (the pipeline) item 12")

AXES = ("dp", "fsdp", "pp", "sp", "tp", "ep")


def init_process_group(device=None, *, init_method: Optional[str] = None,
                       timeout: Optional[float] = None, store=None,
                       topology: Optional[Topology] = None) -> torch.device:
    """Bring up the world that ``topology`` (default: the launcher's
    environment, :func:`~horovod_tpu_torch.common.topology.
    topology_from_env`) describes and return this process's device.

    On CUDA (the default) the backend is ``nccl`` and the device is
    ``cuda:<card_index>``, made current with ``torch.cuda.set_device``.
    ``gloo`` is used only when the caller names the CPU. The rendezvous
    is ``store`` or ``init_method`` if given, else
    ``MASTER_ADDR``/``MASTER_PORT`` (``env://``). A world of one process
    needs none and uses an in-process store; a larger world without one
    raises, and so does a rendezvous that does not complete within
    ``timeout`` seconds. If the world is already up, it is checked
    against the topology and reused."""
    topo = topology or topology_from_env()
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", card_index(topo))
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    if dist.is_initialized():
        have = (dist.get_backend(), dist.get_world_size(), dist.get_rank())
        if have != (backend, topo.size, topo.rank):
            raise RuntimeError(
                f"a process group is already up as (backend, size, rank) "
                f"{have}; the environment asks for "
                f"{(backend, topo.size, topo.rank)}")
        return device
    kw = {}
    if store is not None:
        kw["store"] = store
    elif init_method is not None:
        kw["init_method"] = init_method
    elif "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        kw["init_method"] = "env://"
    elif topo.size == 1:
        kw["store"] = dist.HashStore()
    else:
        raise RuntimeError(
            f"a world of {topo.size} processes (HOROVOD_SIZE) needs a "
            f"rendezvous: set MASTER_ADDR and MASTER_PORT or pass "
            f"init_method")
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if backend == "nccl":
        kw["device_id"] = device   # bring NCCL up now, not at first use
    dist.init_process_group(backend, rank=topo.rank, world_size=topo.size,
                            **kw)
    return device


def build_mesh(*, dp: int = -1, fsdp: int = 1, pp: int = 1, sp: int = 1,
               tp: int = 1, ep: int = 1) -> DeviceMesh:
    """A ``DeviceMesh`` over the world with dims ``"dp"`` and those of
    ``"fsdp"``, ``"sp"`` and ``"tp"`` above 1, in that order.
    ``dp=-1`` takes every process the other axes leave; ``dp * fsdp *
    sp * tp`` must be the world size. pp/ep > 1 raise until their
    slices are ported."""
    others = {"pp": pp, "ep": ep}
    bad = {a: s for a, s in others.items() if s != 1}
    if bad:
        raise NotImplementedError(f"build_mesh{bad}: {SHARDING_TODO}")
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs the world: call "
                           "init_process_group() first")
    n = dist.get_world_size()
    model = {"fsdp": fsdp, "sp": sp, "tp": tp}
    for a, size in model.items():
        if size < 1 or n % size:
            raise ValueError(f"mesh {a}={size} does not divide the world "
                             f"of {n}")
    inner = fsdp * sp * tp
    if dp == -1:
        if n % inner:
            raise ValueError(f"mesh fsdp x sp x tp = {inner} does not "
                             f"divide the world of {n}")
        dp = n // inner
    elif dp * inner != n:
        raise ValueError(f"mesh dp={dp} x fsdp={fsdp} x sp={sp} x tp={tp} "
                         f"needs {dp * inner} processes; the world has {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    names = ("dp",) + tuple(a for a, size in model.items() if size > 1)
    shape = (dp,) + tuple(size for size in model.values() if size > 1)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def data_parallel_mesh() -> DeviceMesh:
    """Pure-DP mesh over every process — the Horovod default world."""
    return build_mesh(dp=-1)


def mesh_axis_size(mesh: DeviceMesh, name: str) -> int:
    """Size of the mesh axis ``name``; an axis the mesh does not name
    has size 1."""
    names = tuple(mesh.mesh_dim_names or ())
    return mesh.size(names.index(name)) if name in names else 1


def unported_axes(mesh: DeviceMesh) -> dict:
    """The axes of ``mesh`` that are not ported (pp, ep) with size > 1."""
    names = tuple(mesh.mesh_dim_names or ())
    return {a: mesh.size(i) for i, a in enumerate(names)
            if a in ("pp", "ep") and mesh.size(i) != 1}


def _axis_group(mesh: DeviceMesh, name: str):
    names = tuple(mesh.mesh_dim_names or ())
    return mesh.get_group(name) if name in names else None


def tp_group(mesh: DeviceMesh):
    """The process group of ``mesh``'s tp axis (the ranks of one ``(d,
    f, s)``, consecutive), or None where the mesh has no tp axis (size
    1): the model's tensor-parallel all-reduces ride it."""
    return _axis_group(mesh, "tp")


def sp_group(mesh: DeviceMesh):
    """The process group of ``mesh``'s sp axis (the ranks of one ``(d,
    f, t)``, in sequence-chunk order), or None where the mesh has no sp
    axis: the ring's rotations and Ulysses' all-to-alls ride it."""
    return _axis_group(mesh, "sp")


def replica_group(mesh: DeviceMesh):
    """The group the train step Averages gradients over: every rank
    that holds this rank's parameter shards, i.e. the ranks of this
    rank's ``(f, t)`` over the dp and sp axes. On a dp-only mesh it is
    the dp group; with sp alone, the sp group; with both, the mesh's dp
    and sp dims flattened into one (made on the first call, which every
    rank makes; the mesh keeps it). (The fsdp step reduces over fsdp
    and then dp itself.)"""
    axes = tuple(a for a in ("dp", "sp") if mesh_axis_size(mesh, a) > 1)
    if len(axes) == 2:
        return mesh[axes]._flatten("dp_sp").get_group()
    return mesh.get_group(axes[0] if axes else "dp")


def without_axes(mesh: DeviceMesh, *names: str) -> DeviceMesh:
    """``mesh`` as a forward sees it when the ``names`` axes are handled
    outside it (the fsdp step gathers its leaves over fsdp first): the
    submesh of its other dims."""
    return mesh[tuple(a for a in mesh.mesh_dim_names if a not in names)]


def axis_index(mesh: DeviceMesh, name: str) -> int:
    """This rank's index along the axis ``name`` (0 for an absent
    axis)."""
    names = tuple(mesh.mesh_dim_names or ())
    return mesh.get_local_rank(name) if name in names else 0


def dp_group(mesh: DeviceMesh):
    """The process group of ``mesh``'s dp axis, for a data-parallel
    mesh. Raises if the mesh has no dp axis or any other axis > 1 (the
    fsdp step takes :func:`data_groups`, the tp/sp step
    :func:`replica_group`)."""
    names = tuple(mesh.mesh_dim_names or ())
    bad = {a: mesh.size(i) for i, a in enumerate(names)
           if a != "dp" and mesh.size(i) != 1}
    if bad:
        raise ValueError(f"dp_group takes a data-parallel mesh; this one "
                         f"has axes {bad}")
    if "dp" not in names:
        raise ValueError(f"the mesh has no dp axis (dims {names})")
    return mesh.get_group("dp")


def fsdp_group(mesh: DeviceMesh):
    """The process group of ``mesh``'s fsdp axis (the ranks ``d * fsdp
    + f`` of one ``d``). Raises if the mesh has no fsdp axis."""
    if "fsdp" not in tuple(mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no fsdp axis (dims "
                         f"{mesh.mesh_dim_names})")
    return mesh.get_group("fsdp")


def data_groups(mesh: DeviceMesh):
    """``(dp_group, fsdp_group)`` of a dp/fsdp mesh; either is None
    where the mesh does not name that axis."""
    names = tuple(mesh.mesh_dim_names or ())
    return (mesh.get_group("dp") if "dp" in names else None,
            fsdp_group(mesh) if "fsdp" in names else None)
