"""Attention selection for the port's model, the counterpart of
:mod:`horovod_tpu.parallel.ring_attention`.

:func:`make_sp_attention` builds the ``"flash"`` kernel path or the
plain ``"local"`` einsum path. With no mesh, or a mesh whose ``sp`` axis
is 1 (every data-parallel mesh), the sequence is not split, so the
sequence-parallel impls (``"ring"``, ``"ring_flash"``, ``"ulysses"``)
reduce to ``local_attention``, as in the reference. A mesh with sp > 1
is the sequence-parallelism slice (ROADMAP Queue 1 item 10) and raises
until it lands.

Layout convention: ``[batch, seq, heads, head_dim]`` for q/k/v.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from horovod_tpu_torch.parallel.mesh import mesh_axis_size

_NEG_BIG = -1e30  # finite "-inf", as in the reference

_SP_IMPLS = ("ring", "ring_flash", "ulysses")


def local_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """Plain attention over ``[B, T, H, D]`` (equal q and kv heads):
    f32 scores and softmax, P cast to v's dtype for the P·V product
    with f32 accumulation, the result in q's dtype — as the reference's
    ``preferred_element_type=f32`` einsums compute it."""
    B, T, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((T, k.shape[1]), dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, _NEG_BIG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def make_sp_attention(mesh=None, *, axis_name: str = "sp",
                      impl: str = "ring", causal: bool = True):
    """Build ``attend(q, k, v)`` for the model layer.

    ``impl="flash"`` is the Hopper kernel (:func:`flash_attention`,
    GQA-native, so ``attend.handles_gqa`` is set); ``impl="local"`` is
    :func:`local_attention`, and so is every sequence-parallel impl
    while the ``axis_name`` axis is 1 (``mesh=None`` or a mesh without
    sequence parallelism: the reference's fallback). On a data-parallel
    mesh each rank attends over its own rows, so the mesh changes
    nothing here."""
    if mesh is not None and mesh_axis_size(mesh, axis_name) != 1:
        raise NotImplementedError(
            f"make_sp_attention: a mesh with {axis_name}="
            f"{mesh_axis_size(mesh, axis_name)} needs sequence "
            f"parallelism, which is not ported yet (ROADMAP Queue 1 "
            f"item 10)")
    if impl == "flash":
        from horovod_tpu_torch.ops.flash_attention import flash_attention
        fa = functools.partial(flash_attention, causal=causal)
        fa.handles_gqa = True
        return fa
    if impl == "local" or impl in _SP_IMPLS:
        return functools.partial(local_attention, causal=causal)
    raise ValueError(f"unknown SP attention impl {impl!r}")
