"""The process world and its mesh, the counterpart of
:mod:`horovod_tpu.parallel.mesh` for one process per GPU.

The reference names the axes of a ``jax.sharding.Mesh`` over the device
grid; here each process drives one card and the mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` over the processes of
the world, over the reference's axis order ``(dp, fsdp, pp, sp, tp,
ep)``, row-major: the rank at ``(d, f, p, s, t, e)`` is ``((((d * fsdp
+ f) * pp + p) * sp + s) * tp + t) * ep + e``, so ep is innermost, then
tp, as the reference lays them out. Axes of size 1 other than dp are
left out of the ``DeviceMesh`` (torch makes a process group for each of
its dims); :func:`mesh_axis_size` reads an absent axis as 1, as the
reference's size-1 axes are read.

    device = init_process_group()      # nccl on cuda:<local_rank>
    mesh = build_mesh(dp=-1)           # or build_mesh(dp=2, sp=2, tp=2)

Every axis is built. The train steps take pp with dp and tp, and ep
with dp, tp and pp; :func:`check_ported` raises for the compositions
of pp and ep with sp and fsdp (:data:`SHARDING_TODO`).

Groups: :func:`tp_group`, :func:`sp_group`, :func:`pp_group` and
:func:`ep_group` carry the model's own collectives; :func:`replica_group`
is the group a leaf's gradient is reduced over (the ranks that hold the
same shard of it), by the leaf's kind.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from horovod_tpu_torch.common.topology import (Topology, card_index,
                                               topology_from_env)
from horovod_tpu_torch.device import resolve_device

SHARDING_TODO = ("pp and ep do not compose with sp or fsdp yet (ROADMAP "
                 "Queue 1 item 16, the sp and fsdp compositions of pp "
                 "and ep)")

#: Compositions the train steps do not take yet (item 16).
UNPORTED_PAIRS = (("pp", "sp"), ("pp", "fsdp"), ("ep", "fsdp"),
                  ("ep", "sp"))

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
    ``"fsdp"``, ``"pp"``, ``"sp"``, ``"tp"`` and ``"ep"`` above 1, in
    that order. ``dp=-1`` takes every process the other axes leave;
    ``dp * fsdp * pp * sp * tp * ep`` must be the world size."""
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs the world: call "
                           "init_process_group() first")
    n = dist.get_world_size()
    model = {"fsdp": fsdp, "pp": pp, "sp": sp, "tp": tp, "ep": ep}
    for a, size in model.items():
        if size < 1 or n % size:
            raise ValueError(f"mesh {a}={size} does not divide the world "
                             f"of {n}")
    inner = math.prod(model.values())
    if dp == -1:
        if n % inner:
            raise ValueError(f"mesh fsdp x pp x sp x tp x ep = {inner} does "
                             f"not divide the world of {n}")
        dp = n // inner
    elif dp * inner != n:
        sizes = " x ".join(f"{a}={v}" for a, v in {"dp": dp, **model}.items())
        raise ValueError(f"mesh {sizes} needs {dp * inner} processes; the "
                         f"world has {n}")
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


def unported_pairs(mesh: DeviceMesh) -> list:
    """The compositions of ``mesh`` the train steps do not take yet
    (:data:`UNPORTED_PAIRS` with both axes above 1)."""
    return [(a, b) for a, b in UNPORTED_PAIRS
            if mesh_axis_size(mesh, a) > 1 and mesh_axis_size(mesh, b) > 1]


def check_ported(mesh: DeviceMesh) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP item 16 where
    ``mesh`` composes pp or ep with sp or fsdp."""
    bad = unported_pairs(mesh)
    if bad:
        sizes = {a: mesh_axis_size(mesh, a) for pair in bad for a in pair}
        raise NotImplementedError(f"mesh axes {sizes}: {SHARDING_TODO}")


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


def pp_group(mesh: DeviceMesh):
    """The process group of ``mesh``'s pp axis (the stages of one ``(d,
    f, s, t, e)``, in stage order), or None where the mesh has no pp
    axis: the pipeline's activations and their gradients hop along it."""
    return _axis_group(mesh, "pp")


def ep_group(mesh: DeviceMesh):
    """The process group of ``mesh``'s ep axis (the expert shards of one
    ``(d, f, p, s, t)``, consecutive), or None where the mesh has no ep
    axis: the MoE layer's expert sums and the island's all-to-alls ride
    it."""
    return _axis_group(mesh, "ep")


def axes_group(mesh: DeviceMesh, axes):
    """The process group over the mesh axes ``axes`` (those above 1;
    ranks in the mesh's row-major order): one axis' own group, or for
    several, one group per combination of the other axes, made with
    ``new_group`` by every rank in the same order on the first call
    and kept on the mesh. With no axis above 1, the dp group (size 1
    where dp is 1)."""
    names = tuple(mesh.mesh_dim_names or ())
    axes = tuple(a for a in AXES if a in axes and a in names
                 and mesh.size(names.index(a)) > 1)
    if len(axes) < 2:
        return mesh.get_group(axes[0] if axes else "dp")
    cache = mesh.__dict__.setdefault("_horovod_groups", {})
    if axes not in cache:
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        size = math.prod(mesh.size(i) for i in dims)
        me = dist.get_rank()
        for row in mesh.mesh.permute(rest + dims).reshape(-1, size).tolist():
            group = dist.new_group(row)
            if me in row:
                cache[axes] = group
    return cache[axes]


#: The axes each kind of leaf is replicated over (the ranks that hold
#: the same shard of it): ``"expert"`` — the MoE experts, sharded over
#: ep and pp; ``"layer"`` — every other per-layer leaf (router
#: included), sharded over pp; ``"top"`` — embed, final_norm and
#: lm_head, held by every stage.
REPLICA_AXES = {"expert": ("dp", "sp"), "layer": ("dp", "sp", "ep"),
                "top": ("dp", "pp", "sp", "ep")}


#: Every set of axes a train step reduces over: the replica groups and
#: the MoE layer's (its output over tp x ep, the island's routing
#: statistics over dp x ep).
GROUP_AXES = tuple(REPLICA_AXES.values()) + (("tp", "ep"), ("dp", "ep"))


def prepare_groups(mesh: DeviceMesh) -> None:
    """Make every group of :data:`GROUP_AXES` now, on every rank in the
    same order. A group made inside a forward could deadlock a pipeline,
    whose stages reach a layer at different times while ``new_group``
    waits for the whole world."""
    for axes in GROUP_AXES:
        axes_group(mesh, axes)


def replica_group(mesh: DeviceMesh, kind: str = "layer"):
    """The group of the ranks that hold this rank's shard of a leaf of
    ``kind`` (:data:`REPLICA_AXES`): the group its gradient is reduced
    over. On a mesh without pp or ep every kind gives the ranks of this
    rank's ``(f, t)`` over dp and sp: the dp group on a dp-only mesh,
    the sp group with sp alone, and both axes' ranks with both. (The
    fsdp step reduces over fsdp and then this group itself.)"""
    return axes_group(mesh, REPLICA_AXES[kind])


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
