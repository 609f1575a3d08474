"""1F1B (one-forward-one-backward) pipeline schedule over the pp process
group — the counterpart of :mod:`horovod_tpu.parallel.pipeline_1f1b`.

GPipe (:mod:`horovod_tpu_torch.parallel.pipeline`) runs every forward
and then autograd replays the schedule backwards, so each stage holds
the activations of all ``M`` microbatches. 1F1B (PipeDream-Flush order)
starts a microbatch's backward as soon as the last stage has its loss,
which bounds the microbatches in flight on a stage by ``2S`` whatever
``M`` is.

Schedule (``S`` stages, ``M`` microbatches, one forward and one backward
unit a tick, ``M + 2S - 1`` ticks):

* the forward of microbatch ``m`` at stage ``s`` runs on tick ``m + s``;
* its backward on tick ``m + 2S - 1 - s`` (the last stage backs ``m``
  up one tick after its forward);
* activations hop down and gradients hop up at the end of each tick, in
  one exchange (:func:`~horovod_tpu_torch.parallel.pipeline.exchange`),
  and are used on the next;
* a stage holds a microbatch for ``2(S - s) - 1 < 2S`` ticks.

The reference cannot interleave reverse-mode AD, so it computes each
backward unit by hand (recomputing the stage forward from the stored
stage input) inside a ``custom_vjp``. Here a stage keeps the autograd
graph of each microbatch in flight (at most ``2S``; the loss function
counts them in its ``stats``) from its forward unit to its backward unit, where
``torch.autograd.grad`` differentiates it: no recompute (with
``remat`` the layers' own checkpoints still recompute). As in the
reference, :func:`make_1f1b_loss` wraps the schedule so its forward
runs both units and returns the loss, and its backward hands back the
gradients it stashed, scaled by the loss cotangent; the gradient of the
stage-0 input (the embedding) comes out as the microbatches' gradient.
Bubble ticks are skipped: a stage runs only the units it has.
"""

from __future__ import annotations

from typing import Callable

import torch

from horovod_tpu_torch.common.ops_enum import Sum
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.parallel.pipeline import exchange, gather_stages

def _leaves(tree):
    from horovod_tpu_torch.models.transformer import param_leaves
    return [] if tree is None else param_leaves(tree)


def pipeline_1f1b(stage_fn: Callable, last_fn: Callable, stage_params,
                  last_params, microbatches, group, stats=None):
    """Run this stage's part of the 1F1B schedule; returns ``(loss,
    stage_grads, last_grads, d_microbatches)``: this stage's part of the
    loss (the last stage's losses and every stage's aux, summed over its
    microbatches) and the f32 gradients of ``stage_params``' leaves, of
    ``last_params``' leaves (last stage; None elsewhere) and of
    ``microbatches`` (stage 0; None elsewhere).

    ``stage_fn(params, x) -> (y, aux)`` is this stage's block (shape and
    dtype preserving) and a scalar aux added to the objective;
    ``last_fn(last_params, y, m) -> scalar`` the last stage's head and
    loss of microbatch ``m``; ``microbatches`` ``[M, mb, ...]`` (read on
    stage 0; elsewhere only its shape and dtype). ``stats["stash_peak"]``,
    where given, is set to the most microbatches held in flight."""
    n, s = collectives.axis_size(group), collectives.axis_rank(group)
    gather_stages(group, microbatches.device)
    M = microbatches.shape[0]
    last = s == n - 1
    params = _leaves(stage_params)
    lparams = _leaves(last_params) if last else []
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in params + lparams]
    dmb = [None] * M
    loss = torch.zeros((), dtype=torch.float32, device=microbatches.device)
    stash, peak = {}, 0
    act = g_up = None
    for t in range(M + 2 * n - 1):
        mf, mb = t - s, t - (2 * n - 1 - s)
        y_out = dx = None
        if 0 <= mf < M:                                # forward unit
            x = (microbatches[mf] if s == 0 else act).detach()
            x.requires_grad_(True)
            with torch.enable_grad():
                y, aux = stage_fn(stage_params, x)
                obj = (last_fn(last_params, y, mf) + aux if last else None)
            stash[mf] = (x, y, aux, obj)
            peak = max(peak, len(stash))
            y_out = None if last else y.detach()
        if 0 <= mb < M:                                # backward unit
            x, y, aux, obj = stash.pop(mb)
            outs, cots = ([obj], [None]) if last else ([y], [g_up])
            if not last and aux.requires_grad:
                outs, cots = outs + [aux], cots + [torch.ones_like(aux)]
            got = torch.autograd.grad(outs, [x] + params + lparams, cots,
                                      allow_unused=True)
            dx = got[0]
            for acc, g in zip(grads, got[1:]):
                if g is not None:
                    acc += g.float()
            loss = loss + (obj if last else aux).detach().float()
            if s == 0:
                dmb[mb] = dx
        # The hops of this tick: what the neighbours use on the next.
        recv_act = s > 0 and 0 <= t - (s - 1) < M
        recv_g = not last and 0 <= t - (2 * n - 2 - s) < M
        act = torch.empty_like(microbatches[0]) if recv_act else None
        g_up = torch.empty_like(microbatches[0]) if recv_g else None
        exchange(group, send_down=y_out, recv_up=act,
                 send_up=dx.contiguous() if s > 0 and dx is not None
                 else None, recv_down=g_up)
    if stats is not None:
        stats["stash_peak"] = peak
    n_p = len(params)
    return (loss, grads[:n_p], grads[n_p:] if last else None,
            torch.stack(dmb) if s == 0 else None)


def make_1f1b_loss(stage_fn, last_fn, group):
    """``loss(stage_params, last_params, microbatches)``: its forward runs
    the 1F1B schedule (:func:`pipeline_1f1b`) and returns the loss summed
    over the stages, on every stage; its backward hands back this
    stage's stashed gradients scaled by the loss cotangent (the
    gradients are linear in it): the stage parameters', the last
    stage's head parameters' (``last_params`` is None elsewhere) and,
    on stage 0, the microbatches'. ``loss.stats["stash_peak"]`` is the
    most microbatches the last call held in flight on this stage."""
    def loss(stage_params, last_params, microbatches):
        return _OneFOneB.apply(stage_fn, last_fn, group, loss.stats,
                               stage_params, last_params, microbatches,
                               *_leaves(stage_params), *_leaves(last_params))

    loss.stats = {}
    return loss


class _OneFOneB(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, last_fn, group, stats, stage_params,
                last_params, microbatches, *leaves):
        total, grads, lgrads, dmb = pipeline_1f1b(
            stage_fn, last_fn, stage_params, last_params, microbatches,
            group, stats)
        ctx.grads = [g.to(p.dtype) for g, p in zip(
            grads + (lgrads or []), leaves)]
        ctx.dmb = None if dmb is None else dmb.to(microbatches.dtype)
        return collectives.allreduce(total, Sum, group)

    @staticmethod
    def backward(ctx, g):
        scale = g.float()

        def sc(x):
            return (x.float() * scale).to(x.dtype)

        dmb = None if ctx.dmb is None else sc(ctx.dmb)
        return (None, None, None, None, None, None, dmb,
                *[sc(x) for x in ctx.grads])
