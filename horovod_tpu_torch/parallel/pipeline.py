"""Pipeline parallelism over the pp process group — the counterpart of
:mod:`horovod_tpu.parallel.pipeline` for one process per GPU.

The reference runs a GPipe schedule as a ``shard_map`` island manual
over ``pp``: every pp rank holds one stage's slice of the layer-stacked
parameters, a ``lax.scan`` runs ``M + S - 1`` ticks, on each tick every
stage runs its block on its microbatch and ``ppermute``-shifts the
activation one hop down; stage 0 takes a fresh microbatch, the last
stage banks its output, and a masked ``psum`` replicates the bank.
``jax.grad`` reverses the scan and the ppermutes.

Here each pp rank holds its ``L / pp`` layers (:func:`~horovod_tpu_torch.
models.transformer.shard_params`) and runs the same ticks, skipping the
bubble ticks where it has no microbatch (the reference computes them
and masks the result away; the result is the same). Each tick's hop is
one point-to-point exchange, :class:`_Hop`, an autograd function beside
:func:`~horovod_tpu_torch.parallel.tensor_parallel.rotate`: its
backward sends the gradient of what the stage received one hop up and
receives the gradient of what it sent from below. A scalar token chains
a stage's hops, so its backward runs them in reverse tick order, the
order its neighbours run theirs.

:func:`make_pp_train_step` is the transformer's GPipe step (dp and tp,
and ep for MoE, compose with pp); :func:`make_pp_train_step_1f1b` is the
1F1B schedule of :mod:`horovod_tpu_torch.parallel.pipeline_1f1b`.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from horovod_tpu_torch.common.ops_enum import Average, Sum
from horovod_tpu_torch.device import resolve_device
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.parallel.mesh import (check_ported, mesh_axis_size,
                                             pp_group, prepare_groups,
                                             replica_group)
from horovod_tpu_torch.parallel.ring_attention import make_sp_attention
from horovod_tpu_torch.parallel.tensor_parallel import _issue


# ---------------------------------------------------------------------------
# Point-to-point hops along the stages
# ---------------------------------------------------------------------------

def exchange(group, *, send_down=None, recv_up=None, send_up=None,
             recv_down=None) -> None:
    """One tick's hops of this stage, posted together and waited for:
    ``send_down`` to the next stage, ``send_up`` to the previous one,
    and the buffers ``recv_up`` / ``recv_down`` filled from the previous
    / next stage. Counted (and timed) as one ``pp_p2p`` call whose
    bytes are what this rank sends."""
    n, s = collectives.axis_size(group), collectives.axis_rank(group)
    peer = functools.partial(dist.get_global_rank, group)
    ops, sent, any_t = [], 0, None
    for t, op, stage in ((send_down, dist.isend, s + 1),
                         (recv_up, dist.irecv, s - 1),
                         (send_up, dist.isend, s - 1),
                         (recv_down, dist.irecv, s + 1)):
        if t is None:
            continue
        if not 0 <= stage < n:
            raise ValueError(f"stage {s} of {n} has no stage {stage}")
        ops.append(dist.P2POp(op, t, peer(stage), group))
        if op is dist.isend:
            sent += t.numel() * t.element_size()
        any_t = t
    if not ops:
        return

    def run():
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    _issue("pp_p2p", any_t, run, nbytes=sent)


class _Hop(torch.autograd.Function):
    """One GPipe tick on this stage: send ``y`` down (``send``) and
    receive the previous stage's output (``recv``, of ``shape`` and
    ``dtype``); ``token`` passes through, chaining the stage's hops."""

    @staticmethod
    def forward(ctx, y, token, group, send, recv, shape, dtype):
        ctx.group, ctx.send, ctx.recv = group, send, recv
        ctx.y_meta = (y.shape, y.dtype, y.device)
        got = (torch.empty(shape, dtype=dtype, device=token.device) if recv
               else token.new_empty((0,)))
        exchange(group, send_down=y.contiguous() if send else None,
                 recv_up=got if recv else None)
        return got, token.clone()

    @staticmethod
    def backward(ctx, g_got, g_token):
        shape, dtype, device = ctx.y_meta
        g_y = torch.empty(shape, dtype=dtype, device=device) if ctx.send \
            else None
        exchange(ctx.group, send_up=g_got.contiguous() if ctx.recv else None,
                 recv_down=g_y)
        return g_y, g_token, None, None, None, None, None


class _FromLast(torch.autograd.Function):
    """The last stage's ``outs`` on every stage (a broadcast over pp);
    the backward keeps the last stage's own gradient (every stage holds
    the same one) and passes the token a zero."""

    @staticmethod
    def forward(ctx, outs, token, group):
        n = collectives.axis_size(group)
        ctx.last = collectives.axis_rank(group) == n - 1
        return collectives.broadcast(outs, n - 1, group)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g),
                torch.zeros((), device=g.device), None)


class _SumStages(torch.autograd.Function):
    """Sum over the stages forward; identity backward (each stage's own
    term takes the cotangent of the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        return collectives.allreduce(x, Sum, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_stages(group, device) -> None:
    """One collective every stage of ``group`` takes part in, before a
    schedule's hops: NCCL needs the first call on a group that batches
    point-to-point operations to include every rank of it, and a
    schedule's first hops involve two stages only."""
    collectives.allreduce(torch.zeros(1, device=device), Sum, group)


def anchor(device) -> torch.Tensor:
    """The first token of a stage's hop chain: a scalar leaf that
    requires grad, so even a stage whose first hop only receives has
    that hop in its graph."""
    return torch.zeros((), device=device, requires_grad=True)


def gpipe(stage_fn: Callable, stage_params, microbatches, group, *,
          n_micro: int, mb_shape, dtype, device, remat_stage: bool = False):
    """Run this stage's part of the GPipe schedule: ``stage_fn(params,
    x) -> (y, aux)`` on each of its microbatches, the microbatches of
    stage 0 taken from ``microbatches[m]`` (unused elsewhere, may be
    None), the rest received from the previous stage. Returns ``(bank,
    aux, token)``: the last stage's ``n_micro`` outputs (None elsewhere),
    this stage's summed aux, and the last token of its hop chain (a
    zero scalar the caller's objective must include so the hops'
    backward runs)."""
    n, s = collectives.axis_size(group), collectives.axis_rank(group)
    gather_stages(group, device)
    fn = stage_fn
    if remat_stage:
        def fn(p, x):  # noqa: F811 — recomputed whole in the backward
            with set_checkpoint_early_stop(False):
                return checkpoint(stage_fn, p, x, use_reentrant=False)
    token = anchor(device)
    aux = torch.zeros((), dtype=torch.float32, device=device)
    got, bank = None, []
    for t in range(n_micro + n - 1):
        m = t - s
        real = 0 <= m < n_micro
        y = None
        if real:
            y, a = fn(stage_params, microbatches[m] if s == 0 else got)
            aux = aux + a
            if s == n - 1:
                bank.append(y)
        send = real and s < n - 1
        recv = s > 0 and 0 <= t - (s - 1) < n_micro
        if send or recv:
            got, token = _Hop.apply(y if send else token, token, group,
                                    send, recv, tuple(mb_shape), dtype)
    return (bank if s == n - 1 else None), aux, token


def pipeline_apply(stage_fn: Callable, stage_params, microbatches, group, *,
                   remat_stage: bool = False, with_aux: bool = False):
    """Run ``microbatches [M, mb, ...]`` through the stages of the pp
    ``group`` (reference ``pipeline_apply``): ``stage_fn(params, x) ->
    y`` (``(y, aux_scalar)`` with ``with_aux``) preserves ``x``'s shape
    and dtype, and ``stage_params`` is this stage's slice. Returns the
    outputs shaped like ``microbatches``, on every stage (the last
    stage's, broadcast); with ``with_aux`` also the aux summed over
    every real tick and every stage. Differentiable: the backward sends
    each gradient one hop up. Every stage passes the same
    ``microbatches``; only stage 0 reads them."""
    M = microbatches.shape[0]
    base = stage_fn
    if not with_aux:
        def base(p, x):  # noqa: F811 — uniform (y, aux) contract
            return stage_fn(p, x), torch.zeros((), device=x.device)
    bank, aux, token = gpipe(base, stage_params, microbatches, group,
                             n_micro=M, mb_shape=microbatches.shape[1:],
                             dtype=microbatches.dtype,
                             device=microbatches.device,
                             remat_stage=remat_stage)
    outs = (torch.stack(bank) if bank is not None
            else torch.zeros_like(microbatches))
    outs = _FromLast.apply(outs, token, group)
    if with_aux:
        return outs, _SumStages.apply(aux + token, group)
    return outs


# ---------------------------------------------------------------------------
# Transformer integration
# ---------------------------------------------------------------------------

def pp_reshape_layers(params, n_stages: int):
    """``[L, ...]``-stacked layer leaves → ``[S, L/S, ...]`` (the
    reference's stage layout, as its pp steps hold the parameters)."""
    from horovod_tpu_torch.models.transformer import map_params

    def reshape(a):
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(
                f"n_layers={L} not divisible by pp={n_stages}")
        return a.reshape(n_stages, L // n_stages, *a.shape[1:])
    return {**params, "layers": map_params(reshape, params["layers"])}


def pp_param_specs(cfg, n_stages: int):
    """Specs matching :func:`pp_reshape_layers`: the stage dim over
    ``pp``, the rest as in the flat model."""
    from horovod_tpu_torch.models import transformer as tr

    base = tr.param_specs(cfg)
    return {**base, "layers": tr.map_params(lambda s: ("pp", *s),
                                            base["layers"])}


def _pp_stage_attention(cfg, mesh):
    """Check the mesh for a pp step; return the stage attention, which
    is the one ``cfg.sp_attention`` names (``"flash"`` runs the kernel
    in every stage; the reference forces ``"local"`` there, only
    because its partitioner cannot shard a Mosaic call), as
    :func:`~horovod_tpu_torch.models.transformer.run_layers` builds it.
    pp + sp + MoE raises the reference's error; pp with sp or fsdp is
    ROADMAP item 16."""
    sp = mesh_axis_size(mesh, "sp")
    if sp > 1 and cfg.n_experts > 0:
        raise NotImplementedError(
            "pp + sp + MoE is not supported (the per-shard aux "
            "statistic needs its own cross-sp reduction)")
    check_ported(mesh)
    if mesh_axis_size(mesh, "pp") == 1:
        raise ValueError("a pp step needs a mesh with pp > 1")
    return make_sp_attention(mesh, impl=cfg.sp_attention, causal=True)


def _wire_train_step(cfg, mesh, loss_fn, optimizer, device):
    """The tail both pp steps share: ``init_state(generator | params=)``
    broadcasts rank 0's full tree and keeps this stage's shards,
    ``step(state, batch)`` runs ``loss_fn`` (which leaves every leaf's
    gradient on this rank and returns the loss, summed over the
    stages), reduces the gradients over their replica groups
    (:func:`~horovod_tpu_torch.models.transformer.reduce_gradients`),
    applies the optimizer and returns the loss Averaged over dp."""
    from horovod_tpu_torch.binding import broadcast_parameters
    from horovod_tpu_torch.models import transformer as tr

    device = resolve_device(device)
    if mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot train on "
                         f"{device}")
    tr._check_shardable(cfg, mesh)
    prepare_groups(mesh)
    make_opt = tr.default_optimizer if optimizer is None else optimizer
    dpg = replica_group(mesh, "expert")

    def init_state(generator: Optional[torch.Generator] = None, *,
                   params: Optional[dict] = None):
        params = tr._adopt(cfg, device, generator, params)
        broadcast_parameters(params, 0, None)
        params = tr.map_params(lambda p: p.requires_grad_(True),
                               tr.shard_params(params, cfg, mesh))
        return {"params": params, "opt": make_opt(tr.param_leaves(params)),
                "step": 0}

    def step(state, batch):
        opt = state["opt"]
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(state["params"], batch)
        tr.reduce_gradients(state["params"], mesh)
        opt.step()
        state["step"] += 1
        return state, collectives.allreduce(loss, Average, dpg)

    return init_state, step


def _embedded_microbatches(params, inp, cfg, mesh, n_micro):
    """Stage 0's embedded input, split into ``n_micro`` microbatches."""
    from horovod_tpu_torch.models import transformer as tr

    B, T = inp.shape
    x = tr.embed_lookup(params["embed"], inp.long(), cfg.dtype, mesh,
                        full_shape=(cfg.vocab_size, cfg.d_model))
    return x, x.reshape(n_micro, B // n_micro, T, x.shape[-1])


def _check_micro(B: int, n_micro: int) -> None:
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")


def make_pp_train_step(cfg, mesh, n_micro: int, optimizer=None, *,
                       device=None):
    """GPipe training step for the transformer over a mesh with pp > 1
    (composing with dp and tp, and ep for MoE): returns ``(init_state,
    step)`` as :func:`~horovod_tpu_torch.models.transformer.
    make_train_step` does.

    Stage 0 embeds its rows and splits them into ``n_micro``
    microbatches; each stage runs its layers (:func:`gpipe`); the last
    stage applies final_norm and lm_head and the loss; the MoE aux,
    accumulated per microbatch over the real ticks and summed over the
    stages, enters as ``aux / n_micro`` (each microbatch's aux is a
    mean over it). Each stage backpropagates its own share. The
    gradients of embed (first stage) and of the head (last stage) are
    summed over pp, so every stage holds and updates them alike."""
    from horovod_tpu_torch.models import transformer as tr

    _pp_stage_attention(cfg, mesh)
    ppg = pp_group(mesh)
    n, s = collectives.axis_size(ppg), collectives.axis_rank(ppg)

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        inp, tgt = tokens[:, :-1], tokens[:, 1:]
        B, T = inp.shape
        _check_micro(B, n_micro)
        mbs = (_embedded_microbatches(params, inp, cfg, mesh, n_micro)[1]
               if s == 0 else None)
        bank, aux, token = gpipe(
            lambda p, x: tr.run_layers(p, x, cfg, mesh), params["layers"],
            mbs, ppg, n_micro=n_micro, mb_shape=(B // n_micro, T,
                                                 cfg.d_model),
            dtype=cfg.dtype, device=tokens.device)
        share = aux / n_micro + token
        if bank is not None:
            logits = tr.head(params, torch.cat(bank), cfg, mesh)
            share = share + tr.token_nll(logits, tgt, mesh).mean()
        share.backward()
        return collectives.allreduce(share.detach(), Sum, ppg)

    return _wire_train_step(cfg, mesh, loss_fn, optimizer, device)


def make_pp_train_step_1f1b(cfg, mesh, n_micro: int, optimizer=None, *,
                            device=None):
    """1F1B training step for the transformer over a mesh with pp > 1
    (:mod:`horovod_tpu_torch.parallel.pipeline_1f1b`): the same
    composition rules and result as :func:`make_pp_train_step`, with at
    most ``2 · pp`` microbatches in flight on a stage whatever
    ``n_micro`` is. The last stage computes each microbatch's loss as
    ``nll.mean() / n_micro`` and each stage adds its layers' aux over
    ``n_micro``; the embedding's gradient comes back through stage 0's
    input gradients."""
    from horovod_tpu_torch.models import transformer as tr
    from horovod_tpu_torch.parallel.pipeline_1f1b import make_1f1b_loss

    _pp_stage_attention(cfg, mesh)
    ppg = pp_group(mesh)
    n, s = collectives.axis_size(ppg), collectives.axis_rank(ppg)

    def stage_fn(layers, x):
        y, aux = tr.run_layers(layers, x, cfg, mesh)
        return y, aux / n_micro

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        inp, tgt = tokens[:, :-1], tokens[:, 1:]
        B, T = inp.shape
        _check_micro(B, n_micro)
        tgt_mb = tgt.reshape(n_micro, B // n_micro, T)

        def last_fn(lastp, y, m):
            logits = tr.head(lastp, y, cfg, mesh)
            return tr.token_nll(logits, tgt_mb[m], mesh).mean() / n_micro

        if s == 0:
            _, mbs = _embedded_microbatches(params, inp, cfg, mesh, n_micro)
        else:
            mbs = torch.zeros((n_micro, B // n_micro, T, cfg.d_model),
                              dtype=cfg.dtype, device=tokens.device)
        lastp = ({"final_norm": params["final_norm"],
                  "lm_head": params["lm_head"]} if s == n - 1 else None)
        loss = make_1f1b_loss(stage_fn, last_fn, ppg)(
            params["layers"], lastp, mbs)
        loss.backward()
        return loss.detach()

    return _wire_train_step(cfg, mesh, loss_fn, optimizer, device)
