"""Mixture-of-Experts FFN over the ep process group — the counterpart of
:mod:`horovod_tpu.models.moe`.

The reference is GShard's dense dispatch: routing builds one-hot
``dispatch``/``combine`` tensors ``[B, T, E, C]`` and einsums move the
tokens to the ``ep``-sharded expert dim, which GSPMD lowers to
all-to-alls. Here the same routing is kept as indices: each (token,
choice) claim has an expert and a capacity slot (or is dropped past
``C``), the dispatch gathers each slot's one token and the combine
gathers each claim's slot back, so no ``[B, T, K, E, C]`` one-hot is
ever made. A slot holds at most one token, so the dispatch is the
reference's exactly; the combine sums the ``K`` weighted slots of a
token in another order than the einsum (f32 rounding).

On a mesh with ep (and/or tp) > 1 the reference's GSPMD semantics are
written out (:func:`moe_ffn`): every ep rank holds the same rows (the
activations carry no ep in their batch spec), runs its ``E / ep``
experts (``F / tp`` of each on a tp mesh) on every token, and the
combine is a Sum over the tp x ep group. :func:`moe_ffn_island` is the
reference's quantized-dispatch island: rows split over ep, slabs traded
through :func:`~horovod_tpu_torch.ops.quantized.quantized_alltoall`.

Shapes (per layer): tokens ``[B, T, D]``, experts ``E``, per-row
capacity ``C = ceil(k · T · capacity_factor / E)``. Top-k (default 2)
gating with the Switch/GShard load-balancing auxiliary loss.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import threading
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from horovod_tpu_torch.common.ops_enum import Average
from horovod_tpu_torch.ops.quantized import CODECS, quantized_alltoall
from horovod_tpu_torch.parallel.mesh import (axes_group, axis_index,
                                             ep_group, mesh_axis_size)
from horovod_tpu_torch.parallel.tensor_parallel import (_issue, copy_to_tp,
                                                        gather_rows,
                                                        mean_over,
                                                        reduce_from_tp,
                                                        split_rows,
                                                        tp_allreduce)

#: Dispatch-plane values for the HOROVOD_MOE_DISPATCH knob /
#: ``TransformerConfig.moe_dispatch``.
MOE_DISPATCH_MODES = ("gspmd", "island")

#: The expert leaves of a layer's MoE block (sharded over ep); the
#: router is replicated.
EXPERT_KEYS = ("w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01


def capacity(cfg: MoEConfig, seq_len: int) -> int:
    return max(1, math.ceil(cfg.top_k * seq_len * cfg.capacity_factor
                            / cfg.n_experts))


def moe_param_specs(n_layers_leading: bool = True) -> Dict[str, Any]:
    """The reference's partition specs for one MoE block, each leaf a
    tuple of mesh-axis names (or None) per dim: experts over ``ep``,
    matrix dims over ``fsdp``/``tp`` like the dense FFN; a leading
    ``None`` for the stacked ``L`` dim."""
    lead = (None,) if n_layers_leading else ()
    return {
        "router": (*lead, None, None),           # [L?, D, E] replicated
        "w_gate": (*lead, "ep", "fsdp", "tp"),   # [L?, E, D, F]
        "w_up": (*lead, "ep", "fsdp", "tp"),
        "w_down": (*lead, "ep", "tp", "fsdp"),   # [L?, E, F, D]
    }


def moe_param_shapes(n_layers: int, d_model: int, d_ff: int,
                     cfg: MoEConfig) -> Dict[str, Any]:
    L, D, F_, E = n_layers, d_model, d_ff, cfg.n_experts
    return {"router": (L, D, E), "w_gate": (L, E, D, F_),
            "w_up": (L, E, D, F_), "w_down": (L, E, F_, D)}


def init_moe_params(generator: torch.Generator, n_layers: int,
                    d_model: int, d_ff: int, cfg: MoEConfig, dtype,
                    device) -> Dict[str, Any]:
    """The reference's distribution (PyTorch's draws, in the order
    router, w_gate, w_up, w_down): the router in f32 (routing is
    precision-sensitive), the experts ``normal · fan_in^-0.5`` drawn in
    f32 and cast to ``dtype``."""
    shapes = moe_param_shapes(n_layers, d_model, d_ff, cfg)

    def normal(name, fan_in):
        return torch.randn(shapes[name], generator=generator,
                           dtype=torch.float32, device=device) * fan_in ** -0.5

    return {"router": normal("router", d_model),
            "w_gate": normal("w_gate", d_model).to(dtype),
            "w_up": normal("w_up", d_model).to(dtype),
            "w_down": normal("w_down", d_ff).to(dtype)}


@dataclasses.dataclass
class Routing:
    """One batch's routing (:func:`_route`). ``expert``, ``slot`` and
    ``kept`` are ``[B, T, K]``: each (token, choice) claim's expert, its
    capacity slot, and whether the slot is under capacity; ``gates``
    ``[B, T, K]`` are the renormalised gate values. ``probs``, ``top1``
    ``[B, T, E]`` and ``sel``, ``within`` ``[B, T, K, E]`` are the
    reference's tensors of the same names."""
    probs: torch.Tensor
    top1: torch.Tensor
    sel: torch.Tensor
    within: torch.Tensor
    expert: torch.Tensor
    gates: torch.Tensor
    slot: torch.Tensor
    kept: torch.Tensor
    capacity: int

    def dense(self):
        """The reference's one-hot ``(dispatch, combine)`` ``[B, T, E,
        C]`` (f32): for a small batch, to hold the routing against it."""
        B, T, K = self.expert.shape
        E, C = self.probs.shape[-1], self.capacity
        dispatch = self.probs.new_zeros((B, T, E, C))
        combine = self.probs.new_zeros((B, T, E, C))
        b, t, k = torch.nonzero(self.kept, as_tuple=True)
        at = (b, t, self.expert[b, t, k], self.slot[b, t, k])
        dispatch[at] = 1.0
        combine[at] = self.gates[b, t, k].detach()
        return dispatch, combine


def _route(x, router, cfg: MoEConfig, C: int) -> Routing:
    """GShard routing on ``x`` ``[B, T, D]`` (any batch slice): f32
    logits, softmax, top-k with ties to the lower expert (as
    ``lax.top_k``; a stable sort on ``(-p, index)``), gates
    renormalised with the ``1e-9`` floor, and each claim's slot: the
    number of earlier claims on its expert in ``(t, k)`` order within
    its batch row; claims at or past ``C`` are dropped. Per batch row,
    so routing a row block equals the global routing on those rows."""
    B, T, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)                      # [B, T, E]
    order = torch.sort(probs.detach(), dim=-1, descending=True,
                       stable=True).indices
    expert = order[..., :K]                                    # [B, T, K]
    gates = probs.gather(-1, expert)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    sel_i = F.one_hot(expert, E)                               # [B, T, K, E]
    flat = sel_i.reshape(B, T * K, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(B, T, K, E)
    slot = pos.gather(-1, expert[..., None])[..., 0]
    sel = sel_i.float()
    within = (pos < C).float() * sel
    top1 = F.one_hot(expert[..., 0], E).float()
    return Routing(probs, top1, sel, within, expert, gates, slot, slot < C,
                   C)


def _dispatch(h, r: Routing, e0: int, e_loc: int):
    """Slabs ``[e_loc, B, C, D]`` of experts ``[e0, e0 + e_loc)``: each
    slot the row of the token that claimed it (zero if none), gathered
    from ``h`` ``[B, T, D]``; and each claim's flat slab index (the
    zero row past the last slot for a claim dropped or elsewhere)."""
    B, T, D = h.shape
    C = r.capacity
    n = e_loc * B * C
    el = r.expert - e0
    mine = r.kept & (el >= 0) & (el < e_loc)
    b = torch.arange(B, device=h.device)[:, None, None]
    t = torch.arange(T, device=h.device)[None, :, None]
    dest = torch.where(mine, (el * B + b) * C + r.slot, n)
    src = torch.full((n + 1,), B * T, dtype=torch.long, device=h.device)
    src[dest.reshape(-1)] = (b * T + t).expand_as(dest).reshape(-1)
    rows = torch.cat([h.reshape(B * T, D), h.new_zeros((1, D))])
    return rows[src[:n]].view(e_loc, B, C, D), dest


def _combine(xout, gates, dest, dtype):
    """``y[b, t] = Σ_k gate[b, t, k] · xout[slot(b, t, k)]`` in f32 over
    the flat slabs ``xout``, with the gates rounded to ``dtype`` first
    (the reference casts ``combine`` to the activations' dtype)."""
    D = xout.shape[-1]
    slabs = torch.cat([xout.reshape(-1, D), xout.new_zeros((1, D))])
    picked = slabs[dest].float()                               # [B, T, K, D]
    return (gates.to(dtype).float()[..., None] * picked).sum(2)


def _expert_ffn(xin, lp, dtype):
    """SwiGLU over per-expert token slabs ``xin`` ``[E', b, C, D]`` with
    expert weights ``lp`` ``[E', D, F]`` / ``[E', F, D]``: the
    reference's three einsums as batched matmuls, shared by the GSPMD
    path and the island."""
    e, b, c, d = xin.shape
    x2 = xin.reshape(e, b * c, d)
    g = F.silu(torch.bmm(x2, lp["w_gate"]).float())
    u = torch.bmm(x2, lp["w_up"]).float()
    h = (g * u).to(dtype)
    return torch.bmm(h, lp["w_down"]).view(e, b, c, -1)


def _group(mesh, axes):
    """The group over the ``axes`` of ``mesh`` (None where all are 1)."""
    if mesh is None or all(mesh_axis_size(mesh, a) == 1 for a in axes):
        return None
    return axes_group(mesh, axes)


def _partial(mesh, axes):
    """The group over ``axes`` of ``mesh`` whose ranks each hold a part
    of the experts' output, and the counter kind of its collectives."""
    moe = mesh is not None and "ep" in axes and mesh_axis_size(mesh, "ep") > 1
    return _group(mesh, axes), "moe" if moe else "tp"


def _aux(cfg: MoEConfig, r: Routing, group, scale: float):
    """Switch's load-balancing loss ``coef · E · Σ_e f_e · p_e``, with
    ``f`` (the top-1 share of each expert) and ``p`` (its mean
    probability) over the rows of every rank of ``group`` (the ranks
    holding other rows of the batch): Averaged over it, as the
    reference's global-batch means are; ``p``'s backward scaled by
    ``scale`` (:func:`~horovod_tpu_torch.parallel.tensor_parallel.
    mean_over`)."""
    f, p = r.top1.mean((0, 1)), r.probs.mean((0, 1))
    if group is not None:
        with torch.no_grad():
            f = tp_allreduce(f, group, Average, kind="moe")
        p = mean_over(p, group, scale)
    return cfg.aux_loss_coef * cfg.n_experts * torch.sum(f * p)


def moe_ffn(x, lp, cfg: MoEConfig, mesh=None):
    """One MoE FFN block. ``x``: ``[B, T, D]``; ``lp``: this layer's MoE
    leaves (no leading L), on an ep/tp mesh this rank's shards (experts
    ``[e·E/ep, (e+1)·E/ep)``, ``F / tp`` of each). Returns ``(y [B, T,
    D], aux f32)``.

    Every rank routes every token (the ep and tp ranks hold the same
    rows) and runs its experts on their slots; the outputs are summed
    over the tp x ep group. The gradients that are partial on a rank
    (the experts' inputs and the gates) are summed over it; the aux
    path is whole on every rank and is not. The aux term's statistics
    are over the whole batch, every dp rank's rows (whose gradients the
    step Averages over dp). Tokens over capacity are dropped (their
    residual path passes through)."""
    B, T, D = x.shape
    C = capacity(cfg, T)
    group, kind = _partial(mesh, ("tp", "ep"))
    r = _route(x, lp["router"], cfg, C)
    aux = _aux(cfg, r, _group(mesh, ("dp",)), 1.0)
    e_loc = lp["w_gate"].shape[0]
    e0 = 0 if mesh is None else axis_index(mesh, "ep") * e_loc
    xin, dest = _dispatch(copy_to_tp(x, group, kind), r, e0, e_loc)
    xout = _expert_ffn(xin, lp, x.dtype)
    y = _combine(xout, copy_to_tp(r.gates, group, kind), dest, x.dtype)
    return reduce_from_tp(y.to(x.dtype), group, kind), aux


def moe_ffn_island(x, lp, cfg: MoEConfig, mesh, *, codec: str = "int8"):
    """:func:`moe_ffn` with the dispatch and combine hops as explicit
    all-to-alls over ep, both through
    :func:`~horovod_tpu_torch.ops.quantized.quantized_alltoall` with
    ``codec`` (its straight-through backward).

    The rows are split over ep (:func:`~horovod_tpu_torch.parallel.
    tensor_parallel.split_rows`); each rank routes its own rows, packs
    ``[ep, E/ep, b, C, D]`` slabs for every expert, trades them, runs
    its experts on every rank's slabs, trades the outputs back and
    combines; the rows are then gathered back over ep
    (:func:`~horovod_tpu_torch.parallel.tensor_parallel.gather_rows`).
    The aux term is computed from the dp x ep-averaged ``f`` and ``p``
    vectors (the global statistics), not from an average of the ranks'
    aux values. The router's gradient is partial on each rank (its own
    rows) and is summed over ep. Requires ``B % ep == 0`` (``B`` this
    rank's rows) and ``E % ep == 0``."""
    ep = 1 if mesh is None else mesh_axis_size(mesh, "ep")
    if ep <= 1:
        return moe_ffn(x, lp, cfg, mesh)     # no exchange to quantize
    E = cfg.n_experts
    B, T, D = x.shape
    C = capacity(cfg, T)
    if E % ep:
        raise ValueError(
            f"moe_ffn_island: n_experts={E} must divide by the ep axis "
            f"size {ep} (each shard owns E/ep experts)")
    if B % ep:
        raise ValueError(
            f"moe_ffn_island: batch {B} must divide by the ep axis "
            f"size {ep} (token rows are batch-sharded over ep)")
    e_loc = E // ep
    epg = ep_group(mesh)
    tpg, _ = _partial(mesh, ("tp",))
    xl = split_rows(x, epg)
    b_loc = xl.shape[0]
    r = _route(xl, copy_to_tp(lp["router"], epg, "moe"), cfg, C)
    aux = _aux(cfg, r, _group(mesh, ("dp", "ep")), 1.0 / ep)

    xin, dest = _dispatch(copy_to_tp(xl, tpg), r, 0, E)
    hop = functools.partial(quantized_alltoall, group=epg, codec=codec,
                            issue=functools.partial(_issue, "moe_a2a"))
    got = hop(xin.reshape(ep, e_loc, b_loc, C, D))
    got = got.movedim(0, 1).reshape(e_loc, ep * b_loc, C, D)
    xout = _expert_ffn(got, lp, x.dtype)
    back = xout.reshape(e_loc, ep, b_loc, C, D).movedim(1, 0).contiguous()
    back = hop(back).reshape(E, b_loc, C, D)
    y = _combine(back, copy_to_tp(r.gates, tpg), dest, x.dtype)
    y = reduce_from_tp(y.to(x.dtype), tpg)
    return gather_rows(y, epg), aux


def resolve_moe_knobs(dispatch: Optional[str] = None,
                      codec: Optional[str] = None):
    """Resolve the MoE dispatch-plane knobs: explicit config values win,
    ``None`` falls back to ``HOROVOD_MOE_DISPATCH`` (default ``gspmd``)
    and ``HOROVOD_MOE_COMPRESSION`` (default ``int8``). Returns
    ``(dispatch, codec)`` validated."""
    d = dispatch or os.environ.get("HOROVOD_MOE_DISPATCH", "gspmd")
    c = codec or os.environ.get("HOROVOD_MOE_COMPRESSION", "int8")
    if d not in MOE_DISPATCH_MODES:
        raise ValueError(
            f"unknown MoE dispatch mode {d!r}; one of {MOE_DISPATCH_MODES}")
    if c not in CODECS:
        raise ValueError(f"unknown MoE codec {c!r}; one of {CODECS}")
    return d, c


def make_moe_ffn(cfg: MoEConfig, mesh, *, dispatch: Optional[str] = None,
                 codec: Optional[str] = None):
    """The transformer's MoE FFN call, ``fn(x, lp) -> (y, aux)`` (a
    ``functools.partial`` of the function it chose), with
    the reference's routing discipline: ``dispatch="gspmd"``, codec
    ``"none"``, no mesh, or ``ep == 1`` all take :func:`moe_ffn`; only
    ``dispatch="island"`` with a lossy codec builds
    :func:`moe_ffn_island`, and ``E % ep`` raises here, with the mesh in
    hand."""
    d, c = resolve_moe_knobs(dispatch, codec)
    ep = 1 if mesh is None else mesh_axis_size(mesh, "ep")
    if d == "gspmd" or c == "none" or ep <= 1:
        return functools.partial(moe_ffn, cfg=cfg, mesh=mesh)
    if cfg.n_experts % ep:
        raise ValueError(
            f"moe_dispatch='island': n_experts={cfg.n_experts} must "
            f"divide by ep={ep}")
    return functools.partial(moe_ffn_island, cfg=cfg, mesh=mesh, codec=c)


# ---------------------------------------------------------------------------
# Routing telemetry (overflow counter / dropped-token fraction)
# ---------------------------------------------------------------------------

#: Python-plane MoE metric keys (the reference's).
MOE_METRIC_KEYS = (
    "moe_dispatch_overflow_tokens_total",
    "moe_dispatch_dropped_token_frac",
    "moe_dispatch_bytes_saved_pct",
)

_moe_metrics: Dict[str, float] = {}
_moe_metrics_lock = threading.Lock()


@torch.no_grad()
def moe_routing_stats(x, router, cfg: MoEConfig) -> Dict[str, float]:
    """Capacity-overflow telemetry for one batch, from the exact routing
    of :func:`_route`: ``moe_dispatch_overflow_tokens_total``, the
    (token, choice) claims past an expert's capacity, and
    ``moe_dispatch_dropped_token_frac``, that count over the ``B·T·k``
    claims. Feed it to :func:`record_moe_stats`."""
    r = _route(x, router, cfg, capacity(cfg, x.shape[1]))
    claims = float(r.sel.sum())
    overflow = claims - float(r.within.sum())
    return {
        "moe_dispatch_overflow_tokens_total": overflow,
        "moe_dispatch_dropped_token_frac": (
            overflow / claims if claims else 0.0),
    }


def _render_moe_metrics() -> str:
    from horovod_tpu_torch.metrics import NAMESPACE, render_gauges
    with _moe_metrics_lock:
        vals = dict(_moe_metrics)
    return render_gauges(NAMESPACE, vals)


def record_moe_stats(stats: Dict[str, float]) -> None:
    """Fold one batch's telemetry into the exported MoE series:
    ``*_total`` keys accumulate, the rest are last-value gauges. The
    first call registers the ``"moe"`` exporter, so the rows ride
    :func:`horovod_tpu_torch.metrics.metrics_prometheus`."""
    from horovod_tpu_torch.metrics import register_exporter
    with _moe_metrics_lock:
        register = not _moe_metrics
        for k, v in stats.items():
            if k.endswith("_total"):
                _moe_metrics[k] = _moe_metrics.get(k, 0.0) + float(v)
            else:
                _moe_metrics[k] = float(v)
    if register:
        register_exporter("moe", _render_moe_metrics)


def moe_metrics() -> Dict[str, float]:
    """Current values of the recorded MoE series (empty before the
    first :func:`record_moe_stats`)."""
    with _moe_metrics_lock:
        return dict(_moe_metrics)
