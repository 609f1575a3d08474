"""The process world and its mesh, the counterpart of
:mod:`horovod_tpu.parallel.mesh` for one process per GPU.

The reference names the axes of a ``jax.sharding.Mesh`` over the device
grid; here each process drives one card and the mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` over the processes of
the world. This slice ports the data-parallel mesh only: every axis but
``dp`` must be 1 (fsdp/pp/sp/tp/ep are ROADMAP Queue 1 items 9-12).
Axes of size 1 are left out of the ``DeviceMesh`` (torch makes a
process group for each of its dims); :func:`mesh_axis_size` reads them
as 1, as the reference's size-1 axes are read.

    device = init_process_group()      # nccl on cuda:<local_rank>
    mesh = build_mesh(dp=-1)
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from horovod_tpu_torch.common.topology import topology_from_env
from horovod_tpu_torch.device import resolve_device

SHARDING_TODO = ("only the data-parallel mesh is ported; fsdp/tp sharding "
                 "is ROADMAP Queue 1 item 9, sp item 10, ep item 11, pp "
                 "item 12")


def init_process_group(device=None, *, init_method: Optional[str] = None,
                       timeout: Optional[float] = None) -> torch.device:
    """Bring up the world that the launcher's environment describes
    (:func:`~horovod_tpu_torch.common.topology.topology_from_env`) and
    return this process's device.

    On CUDA (the default) the backend is ``nccl`` and the device is
    ``cuda:<local_rank>``, made current with ``torch.cuda.set_device``.
    ``gloo`` is used only when the caller names the CPU. The rendezvous
    is ``init_method`` if given, else ``MASTER_ADDR``/``MASTER_PORT``
    (``env://``). A world of one process needs neither and uses an
    in-process store; a larger world without one raises, and so does a
    rendezvous that does not complete within ``timeout`` seconds. If the
    world is already up, it is checked against the environment and
    reused."""
    topo = topology_from_env()
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", topo.local_rank)
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
    if init_method is not None:
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
    """A ``DeviceMesh`` over the world with the dim name ``"dp"``.
    ``dp=-1`` takes every process; any other axis > 1 raises until its
    slice is ported."""
    others = {"fsdp": fsdp, "pp": pp, "sp": sp, "tp": tp, "ep": ep}
    bad = {a: s for a, s in others.items() if s != 1}
    if bad:
        raise NotImplementedError(f"build_mesh{bad}: {SHARDING_TODO}")
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs the world: call "
                           "init_process_group() first")
    n = dist.get_world_size()
    if dp == -1:
        dp = n
    elif dp != n:
        raise ValueError(f"mesh dp={dp} needs {dp} processes; the world "
                         f"has {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp,), mesh_dim_names=("dp",))


def data_parallel_mesh() -> DeviceMesh:
    """Pure-DP mesh over every process — the Horovod default world."""
    return build_mesh(dp=-1)


def mesh_axis_size(mesh: DeviceMesh, name: str) -> int:
    """Size of the mesh axis ``name``; an axis the mesh does not name
    has size 1."""
    names = tuple(mesh.mesh_dim_names or ())
    return mesh.size(names.index(name)) if name in names else 1


def dp_group(mesh: DeviceMesh):
    """The process group of ``mesh``'s dp axis. Raises if the mesh has
    no dp axis or any other axis > 1."""
    names = tuple(mesh.mesh_dim_names or ())
    bad = {a: mesh.size(i) for i, a in enumerate(names)
           if a != "dp" and mesh.size(i) != 1}
    if bad:
        raise NotImplementedError(f"mesh axes {bad}: {SHARDING_TODO}")
    if "dp" not in names:
        raise ValueError(f"the mesh has no dp axis (dims {names})")
    return mesh.get_group("dp")
