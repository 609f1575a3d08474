"""The port's framework binding: the counterpart of the JAX binding
``horovod_tpu/jax/__init__.py`` (the gradient plane of Horovod's
``DistributedOptimizer`` and ``DistributedGradientTape``).

The reference has two tiers: in-jit (``axis_name=``, collectives traced
into the XLA program) and eager (one process per rank, a grouped
allreduce of the gradient leaves after the backward). A PyTorch process
drives one card eagerly, so the port is the eager tier over a process
group (``group=None`` is the world):

* :func:`allreduce_gradients` — one grouped allreduce of a gradient
  tree, with the cast codecs (bf16/fp16) around it;
* :class:`DistributedOptimizer` — wraps a ``torch.optim.Optimizer`` and
  reduces every ``.grad`` before the inner step, with
  ``backward_passes_per_step`` local aggregation;
* :func:`distributed_value_and_grad` — the local value and the reduced
  gradients of a function;
* :func:`broadcast_parameters`, :func:`broadcast_object`,
  :func:`allgather_object` — bootstrap helpers;
* :func:`sync_batch_norm` — batch statistics over the group.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed.nn.functional as dist_fn
from torch.utils import _pytree as pytree

from horovod_tpu_torch.common.ops_enum import (  # noqa: F401
    Adasum, Average, Max, Min, Product, ReduceOp, Sum,
)
from horovod_tpu_torch.compression import Compression, QUANTIZED_TODO
from horovod_tpu_torch.functions import (  # noqa: F401
    allgather_object, broadcast_object,
)
from horovod_tpu_torch.ops import collectives


def allreduce_gradients(grads, *, group=None, op: ReduceOp = Average,
                        compression=None, ef=None):
    """Reduce a gradient tree across ``group`` in one grouped allreduce
    (the reference's eager tier). ``compression`` casts each leaf to the
    wire dtype before and back after (bf16/fp16); ``Compression.int8``
    has no cast form and raises until the quantized plane is ported."""
    if ef is not None:
        raise ValueError(
            "ef= residuals are an in-graph concern; the eager tier's int8 "
            "error feedback lives inside the wire codec")
    if compression is None:
        compression = Compression.none
    if not getattr(compression, "cast_tier", True):
        raise NotImplementedError(f"compression=int8: {QUANTIZED_TODO}")
    leaves, spec = pytree.tree_flatten(grads)
    if not leaves:
        return grads
    compressed, ctxs = zip(*(compression.compress(g) for g in leaves))
    reduced = collectives.grouped_allreduce(list(compressed), op, group)
    return pytree.tree_unflatten(
        [compression.decompress(r, c) for r, c in zip(reduced, ctxs)], spec)


class DistributedOptimizer:
    """Wrap ``optimizer`` so that :meth:`step` averages (``op``) the
    ``.grad`` of every parameter it holds across ``group``, in one
    grouped allreduce, before the inner step — the torch form of the
    reference's ``distributed_optimizer``. A parameter with no gradient
    joins with zeros, so every rank reduces the same layout.

    With ``backward_passes_per_step=N`` each call of :meth:`step` adds
    the current gradients to a local sum; only every N-th call reduces
    that sum and applies it, so the parameters and the inner optimizer's
    state do not move between boundaries and the boundary update is one
    update on the SUM of the N microbatch gradients (average the loss
    over the passes, or scale the learning rate, as with the
    reference)."""

    def __init__(self, optimizer: torch.optim.Optimizer, *, group=None,
                 op: ReduceOp = Average, compression=None,
                 backward_passes_per_step: int = 1):
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.optimizer = optimizer
        self.group = group
        self.op = op
        self.compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self.count = 0        # passes summed since the last boundary
        self._acc = None      # their gradient sum, one tensor a parameter

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def state(self):
        return self.optimizer.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        params = [p for g in self.optimizer.param_groups
                  for p in g["params"]]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        if self.backward_passes_per_step > 1:
            if self._acc is None:
                self._acc = [g.clone() for g in grads]
            else:
                torch._foreach_add_(self._acc, grads)
            self.count += 1
            if self.count < self.backward_passes_per_step:
                return
            grads, self._acc, self.count = self._acc, None, 0
        reduced = allreduce_gradients(grads, group=self.group, op=self.op,
                                      compression=self.compression)
        for p, g in zip(params, reduced):
            p.grad = g
        self.optimizer.step()


def distributed_value_and_grad(fun: Callable, argnums=0, *,
                               has_aux: bool = False, group=None,
                               op: ReduceOp = Average,
                               compression=None) -> Callable:
    """``jax.value_and_grad`` for torch with the gradients reduced
    across ``group`` (the reference's eager tier): the wrapped function
    returns ``(value, grads)``, ``value`` this rank's own (``(loss,
    aux)`` with ``has_aux``) and ``grads`` the reduced gradients of the
    arguments at ``argnums`` (an int, or a tuple for a tuple of trees).
    The arguments are tensor trees; they are differentiated as detached
    copies, so the caller's tensors are not touched."""
    nums = (argnums,) if isinstance(argnums, int) else tuple(argnums)

    def wrapped(*args, **kwargs):
        args = list(args)
        leaves, layout = [], []
        for i in nums:
            ls, spec = pytree.tree_flatten(args[i])
            ls = [t.detach().requires_grad_(True) for t in ls]
            args[i] = pytree.tree_unflatten(ls, spec)
            leaves += ls
            layout.append((spec, len(ls)))
        with torch.enable_grad():
            out = fun(*args, **kwargs)
        loss = out[0] if has_aux else out
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = allreduce_gradients(
            [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)],
            group=group, op=op, compression=compression)
        trees, k = [], 0
        for spec, m in layout:
            trees.append(pytree.tree_unflatten(grads[k:k + m], spec))
            k += m
        value = (loss.detach(), out[1]) if has_aux else loss.detach()
        return value, (trees[0] if isinstance(argnums, int)
                       else tuple(trees))

    return wrapped


def broadcast_parameters(params, root_rank: int = 0, group=None):
    """Overwrite every tensor of the tree ``params`` with rank
    ``root_rank``'s, in place, and return the tree."""
    with torch.no_grad():
        for leaf in pytree.tree_leaves(params):
            leaf.copy_(collectives.broadcast(leaf, root_rank, group))
    return params


def sync_batch_norm(x, *, group=None, scale=None, bias=None,
                    eps: float = 1e-5, reduce_dims=None):
    """Normalize ``x`` with batch statistics over the local
    ``reduce_dims`` (default: every dim but the last) and every rank of
    ``group``. The per-rank ``[sum, sum of squares]`` ride one
    allreduce, which autograd differentiates. Returns ``(y, mean,
    var)`` so callers can keep running statistics."""
    if reduce_dims is None:
        reduce_dims = tuple(range(x.dim() - 1))
    reduce_dims = tuple(d % x.dim() for d in reduce_dims)
    h = x.float()
    n_local = math.prod(x.shape[d] for d in reduce_dims)
    stats = torch.stack([h.sum(dim=reduce_dims),
                         (h * h).sum(dim=reduce_dims)])
    stats = dist_fn.all_reduce(stats, group=group or
                               torch.distributed.group.WORLD)
    n = n_local * collectives.axis_size(group)
    mean = stats[0] / n
    var = stats[1] / n - mean * mean
    bshape = [1 if d in reduce_dims else x.shape[d] for d in range(x.dim())]
    y = (h - mean.reshape(bshape)) * torch.rsqrt(var.reshape(bshape) + eps)
    if scale is not None:
        y = y * scale.float().reshape(bshape)
    if bias is not None:
        y = y + bias.float().reshape(bshape)
    return y.to(x.dtype), mean, var
