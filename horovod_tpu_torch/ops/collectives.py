"""Functional collectives over a process group — the counterpart of
:mod:`horovod_tpu.ops.collectives`.

The reference traces ``lax.psum``/``all_gather``/``psum_scatter``/
``all_to_all``/``ppermute`` over a named mesh axis into the XLA program.
Here each process holds one shard and the collectives are
``torch.distributed`` calls over a process group (``group=None`` is the
world): NCCL on CUDA tensors, gloo on CPU tensors. Every function
returns new tensors and leaves its input alone, as the reference's do,
and every one of them runs its collective whatever the group's size.

``Average`` is a SUM followed by a scale of ``1/n``, as the reference
computes it (so gloo, NCCL and XLA round alike); scaling a tensor
narrower than 4 bytes happens in f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from horovod_tpu_torch.common.ops_enum import ReduceOp, Average
from horovod_tpu_torch.compression import QUANTIZED_TODO, in_jit_codec

ADASUM_TODO = ("op=Adasum is not ported yet (ROADMAP Queue 1 item 15, "
               "ops/adasum.py)")

_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVERAGE:
             dist.ReduceOp.SUM, ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}


def axis_rank(group=None) -> int:
    """This process's rank in ``group`` (cf. ``hvd.rank()``)."""
    return dist.get_rank(group)


def axis_size(group=None) -> int:
    """Number of processes in ``group`` (cf. ``hvd.size()``)."""
    return dist.get_world_size(group)


def _check_scalable(x, factor) -> None:
    if factor not in (None, 1.0) and not (x.is_floating_point()
                                          or x.is_complex()):
        raise TypeError(
            f"scaling (average/prescale/postscale) is not defined for "
            f"integer dtype {x.dtype}; use op=Sum or cast to a float dtype "
            f"first")


def _scale(x, factor, *, inplace: bool = False):
    """``x * factor`` (in place with ``inplace``). For bf16/fp16 PyTorch
    computes the product in f32 and rounds once, which is the
    reference's cast-multiply-cast. Integer tensors take no factor."""
    _check_scalable(x, factor)
    if factor is None or factor == 1.0:
        return x
    return x.mul_(factor) if inplace else x * factor


def _global_rank(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def _reduce_(buf, op: ReduceOp, group, prescale_factor, postscale_factor):
    """Reduce ``buf`` in place across ``group``; ``buf`` is a fresh
    tensor the caller owns."""
    if op == ReduceOp.ADASUM:
        raise NotImplementedError(ADASUM_TODO)
    if op not in _TORCH_OP:
        raise ValueError(f"unknown reduce op {op!r}")
    inv = 1.0 / axis_size(group) if op == ReduceOp.AVERAGE else None
    for factor in (prescale_factor, inv, postscale_factor):
        _check_scalable(buf, factor)   # before any traffic
    _scale(buf, prescale_factor, inplace=True)
    dist.all_reduce(buf, op=_TORCH_OP[op], group=group)
    _scale(buf, inv, inplace=True)
    return _scale(buf, postscale_factor, inplace=True)


def _check_codec(compression) -> None:
    codec = in_jit_codec(compression)
    if codec != "none":
        raise NotImplementedError(
            f"compression={codec} on a collective: {QUANTIZED_TODO}; "
            f"binding.allreduce_gradients casts gradients to bf16/fp16")


def allreduce(x, op: ReduceOp = Average, group=None, *,
              prescale_factor: Optional[float] = None,
              postscale_factor: Optional[float] = None,
              compression=None):
    """Reduce ``x`` across ``group`` on every rank (reference
    ``allreduce``). ``compression`` other than None/none raises until
    the reference's codec routes are ported."""
    _check_codec(compression)
    return _reduce_(x.clone(), op, group, prescale_factor, postscale_factor)


def grouped_allreduce(xs, op: ReduceOp = Average, group=None, *,
                      prescale_factor: Optional[float] = None,
                      postscale_factor: Optional[float] = None,
                      compression=None):
    """Allreduce a tree (list, tuple or dict) of tensors as one logical
    step, the reference's fused ``psum`` of a pytree: the leaves of each
    dtype are packed into one buffer, reduced by one collective, and
    returned as views of it in the tree's layout.

    ``grouped_allreduce.calls`` and ``grouped_allreduce.bytes`` count
    the calls that reduce and the bytes they reduce. ``compression``
    other than None/none raises, as in :func:`allreduce`."""
    _check_codec(compression)
    leaves, spec = pytree.tree_flatten(xs)
    out = [None] * len(leaves)
    by_dtype = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    for idx in by_dtype.values():
        buf = torch.cat([leaves[i].reshape(-1) for i in idx])
        _reduce_(buf, op, group, prescale_factor, postscale_factor)
        grouped_allreduce.bytes += buf.numel() * buf.element_size()
        pieces = buf.split([leaves[i].numel() for i in idx])
        for i, piece in zip(idx, pieces):
            out[i] = piece.view(leaves[i].shape)
    grouped_allreduce.calls += 1
    return pytree.tree_unflatten(out, spec)


grouped_allreduce.calls = 0
grouped_allreduce.bytes = 0


def allgather(x, group=None, axis: int = 0):
    """Concatenate every rank's ``x`` along ``axis``, in rank order
    (``lax.all_gather(..., tiled=True)``)."""
    n = axis_size(group)
    xt = x.movedim(axis, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, axis)


def broadcast(x, root_rank: int = 0, group=None):
    """Every rank receives rank ``root_rank``'s ``x`` (bool included)."""
    n = axis_size(group)
    if not (0 <= root_rank < n):
        raise ValueError(f"root_rank {root_rank} out of range for a group "
                         f"of size {n}")
    y = x.to(torch.uint8) if x.dtype == torch.bool else x.clone()
    dist.broadcast(y, src=_global_rank(group, root_rank), group=group)
    return y.bool() if x.dtype == torch.bool else y


def alltoall(x, group=None, split_axis: int = 0, concat_axis: int = 0):
    """Split ``x`` along ``split_axis`` into one slice per rank, send
    slice ``j`` to rank ``j``, and concatenate the slices received along
    ``concat_axis`` in rank order (``lax.all_to_all(..., tiled=True)``).
    """
    n = axis_size(group)
    xt = x.movedim(split_axis, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"alltoall: dim {split_axis} of size {xt.shape[0]} "
                         f"does not split into {n} slices")
    out = torch.empty_like(xt)
    dist.all_to_all_single(out, xt, group=group)
    pieces = out.movedim(0, split_axis).chunk(n, dim=split_axis)
    return torch.cat(pieces, dim=concat_axis)


def reducescatter(x, op: ReduceOp = Average, group=None,
                  scatter_axis: int = 0):
    """Sum across ``group``, leaving each rank its 1/n slice along
    ``scatter_axis`` (``lax.psum_scatter(..., tiled=True)``); Average
    scales the slice by 1/n."""
    if op not in (ReduceOp.AVERAGE, ReduceOp.SUM):
        raise ValueError("reducescatter supports SUM/AVERAGE")
    n = axis_size(group)
    xt = x.movedim(scatter_axis, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"reducescatter: dim {scatter_axis} of size "
                         f"{xt.shape[0]} does not split into {n} slices")
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, op=dist.ReduceOp.SUM, group=group)
    if op == ReduceOp.AVERAGE:
        out = _scale(out, 1.0 / n, inplace=True)
    return out.movedim(0, scatter_axis)


def ring_permute(x, group=None, shift: int = 1):
    """Send ``x`` to the rank ``shift`` hops along the ring and return
    what arrives from ``shift`` hops back (``lax.ppermute``)."""
    n, r = axis_size(group), axis_rank(group)
    src = x.contiguous()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, _global_rank(group, (r + shift) % n),
                      group),
           dist.P2POp(dist.irecv, out, _global_rank(group, (r - shift) % n),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out
