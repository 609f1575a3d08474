"""Differentiable collectives of the model's own parallelism: the
tensor-parallel "copy" and "reduce" pair (also over the MoE layer's ep
and tp x ep groups), the sequence ring's rotation, the Ulysses
all-to-all, and the MoE island's row split and gather, each a
``torch.autograd.Function`` over a process group.

The JAX package has no module to mirror. There GSPMD inserts the tp
psums from the parameters' sharding specs
(``horovod_tpu/models/transformer.py::param_specs``), and JAX
differentiates ``lax.ppermute`` (``parallel/ring_attention.py:52-56``)
and ``lax.all_to_all`` (:251-261) itself. Here each is written out:

* :func:`copy_to_tp` — identity forward, Sum all-reduce of the gradient
  over tp: the input of a column-parallel matmul (and a weight every tp
  rank holds whole, whose gradient is partial on each);
* :func:`reduce_from_tp` — Sum all-reduce forward, identity backward:
  the output of a row-parallel matmul;
* :func:`rotate` — pass a tensor ``shift`` hops around the ring
  (:func:`~horovod_tpu_torch.ops.collectives.ring_permute`); the
  backward rotates the gradient by ``-shift``;
* :func:`all_to_all` — the tiled all-to-all
  (:func:`~horovod_tpu_torch.ops.collectives.alltoall`); the backward
  swaps ``split_axis`` and ``concat_axis``.

* :func:`split_rows` / :func:`gather_rows` — this rank's block of the
  leading dim, whose backward all-gathers the gradient; and the
  all-gather of every rank's block, whose backward keeps this rank's
  block (the MoE island's rows, split over ep and gathered back);
* :func:`mean_over` — the Average over a group, whose backward hands
  each rank ``g`` scaled for the gradient reduction that follows (the
  MoE routing statistics of the whole batch).

A group of None (the axis is absent: size 1) makes each the identity,
with no collective.

:data:`counters` counts what they issue, forward and backward, by kind:
``tp`` (all-reduces over tp: these and the vocab-parallel loss's),
``sp_p2p`` (rotations; bytes are what this rank sends),
``sp_a2a`` (all-to-alls; bytes are the send buffer), ``moe`` (the MoE
layer's all-reduces and gathers over ep, tp x ep or dp), ``moe_a2a``
(the island's dispatch and combine all-to-alls; bytes are the payload
before the codec) and ``pp_p2p`` (the pipeline's hops; bytes are what
this rank sends). With
``reset_counters(timing=True)`` on CUDA each collective is also
bracketed by CUDA events on the current stream, and
:func:`collective_ms` sums their times by kind.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.common.ops_enum import Average, ReduceOp, Sum
from horovod_tpu_torch.ops import collectives

KINDS = ("tp", "sp_p2p", "sp_a2a", "moe", "moe_a2a", "pp_p2p")

#: ``{kind: {"calls": n, "bytes": b}}`` since the last reset.
counters = {k: {"calls": 0, "bytes": 0} for k in KINDS}
_timing = {"on": False, "events": {k: [] for k in KINDS}}


def reset_counters(timing: bool = False) -> None:
    """Zero :data:`counters`; with ``timing``, record CUDA events around
    every collective from now on (until the next reset)."""
    for k in KINDS:
        counters[k]["calls"] = counters[k]["bytes"] = 0
        _timing["events"][k] = []
    _timing["on"] = timing


def collective_ms(clear: bool = False) -> dict:
    """``{kind: ms}``: the summed device time of the collectives timed
    since :func:`reset_counters` (``timing=True``) or the last call with
    ``clear``, which forgets them (the counters run on). Synchronises."""
    out = {}
    for k, pairs in _timing["events"].items():
        for _, end in pairs:
            end.synchronize()
        out[k] = sum(s.elapsed_time(e) for s, e in pairs)
        if clear:
            _timing["events"][k] = []
    return out


def _issue(kind: str, x: torch.Tensor, fn, nbytes=None):
    """Run the collective ``fn()`` on ``x``, counting (and timing) it;
    ``nbytes`` (default: ``x``'s) is what it counts as sent."""
    counters[kind]["calls"] += 1
    counters[kind]["bytes"] += (x.numel() * x.element_size() if nbytes is None
                                else nbytes)
    if not (_timing["on"] and x.is_cuda):
        return fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    _timing["events"][kind].append((start, end))
    return out


def tp_allreduce(x: torch.Tensor, group, op: ReduceOp = Sum,
                 kind: str = "tp"):
    """``collectives.allreduce`` over ``group``, counted as a ``kind``
    all-reduce; the identity (no copy) where ``group`` is None."""
    if group is None:
        return x
    return _issue(kind, x, lambda: collectives.allreduce(x, op, group))


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (tp_allreduce(g.contiguous(), ctx.group, kind=ctx.kind),
                None, None)


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, kind):
        return tp_allreduce(x.contiguous(), group, kind=kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_tp(x: torch.Tensor, group, kind: str = "tp") -> torch.Tensor:
    """Identity forward; the backward Sum-reduces the gradient over the
    tp ``group`` (Megatron's ``f``), counted as ``kind``."""
    return x if group is None else _CopyToTP.apply(x, group, kind)


def reduce_from_tp(x: torch.Tensor, group, kind: str = "tp") -> torch.Tensor:
    """Sum over the tp ``group`` forward; identity backward (Megatron's
    ``g``), counted as ``kind``."""
    return x if group is None else _ReduceFromTP.apply(x, group, kind)


def _gather0(x, group):
    return _issue("moe", x, lambda: collectives.allgather(x.contiguous(),
                                                         group))


def _block(x, group):
    n, r = collectives.axis_size(group), collectives.axis_rank(group)
    b = x.shape[0] // n
    return x[r * b:(r + 1) * b]


class _SplitRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _block(x, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather0(g, ctx.group), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group), None


def split_rows(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of ``x``'s leading dim (``x`` equal on every
    rank of ``group``); the backward all-gathers the blocks' gradients,
    so every rank gets the whole gradient of ``x``."""
    return x if group is None else _SplitRows.apply(x, group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated on the leading dim, in rank
    order; the backward keeps this rank's block of the gradient, which
    every rank holds whole (what comes after is computed alike on every
    rank of ``group``), and sums nothing."""
    return x if group is None else _GatherRows.apply(x, group)


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scale):
        ctx.scale = scale
        return tp_allreduce(x.contiguous(), group, Average, kind="moe")

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None, None


def mean_over(x: torch.Tensor, group, scale: float = 1.0) -> torch.Tensor:
    """The Average of ``x`` over ``group``; the backward gives each rank
    ``g * scale`` (each rank holds the same cotangent ``g`` of the
    mean): ``1 / n`` where the ranks' gradients are then summed over the
    group, 1 where they are Averaged over it."""
    return x if group is None else _MeanOver.apply(x, group, scale)


def _permute(x, group, shift):
    return _issue("sp_p2p", x,
                  lambda: collectives.ring_permute(x, group, shift))


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _permute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g.contiguous(), ctx.group, -ctx.shift), None, None


def rotate(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Send ``x`` ``shift`` hops along the ``group`` ring and return what
    arrives (the reference's ``_rotate``); differentiable."""
    return x if group is None else _Rotate.apply(x, group, shift)


def _a2a(x, group, split_axis, concat_axis):
    return _issue("sp_a2a", x, lambda: collectives.alltoall(
        x, group, split_axis=split_axis, concat_axis=concat_axis))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _a2a(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _a2a(g, group, concat_axis, split_axis), None, None, None


def all_to_all(x: torch.Tensor, group, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Tiled all-to-all over ``group`` (``lax.all_to_all(...,
    tiled=True)``); differentiable."""
    if group is None:
        return x
    return _AllToAll.apply(x, group, split_axis, concat_axis)


class _GatherAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.args = (group, axis)
        return collectives.allgather(x, group, axis=axis)

    @staticmethod
    def backward(ctx, g):
        group, axis = ctx.args
        # Reduce-scatter as an all-to-all and a sum: slice j of every
        # rank's gradient comes to rank j (gloo has no reduce-scatter).
        parts = collectives.alltoall(g.unsqueeze(0), group,
                                     split_axis=axis % g.dim() + 1,
                                     concat_axis=0)
        return parts.sum(0), None, None


def fsdp_allgather(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``axis`` over ``group``
    (``lax.all_gather(..., tiled=True)``); the backward Sum-reduces the
    gradient and hands each rank its slice. Not counted."""
    return x if group is None else _GatherAxis.apply(x, group, axis)


class _Keep(torch.autograd.Function):
    """``x`` unchanged, with ``y`` made an input whose gradient is zero,
    so the backward of whatever produced ``y`` still runs."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.y_meta = (y.shape, y.dtype, y.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.y_meta
        return g, torch.zeros(shape, dtype=dtype, device=device)


def keep(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x``, with ``y`` kept in the graph (zero gradient). A ring step
    that leaves its chunk out uses it, so the chunk's rotation is
    differentiated on every rank and the ranks' backward rotations
    stay paired."""
    if not (torch.is_grad_enabled() and y.requires_grad):
        return x
    return _Keep.apply(x, y)
