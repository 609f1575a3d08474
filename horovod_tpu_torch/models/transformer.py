"""Llama-family decoder LM in PyTorch — the counterpart of
:mod:`horovod_tpu.models.transformer`, on one device, data-parallel over
a process group, fsdp-sharded over a dp x fsdp mesh, or tensor- and
sequence-parallel over a dp x sp x tp mesh.

Parameters are a plain dictionary with the reference's layout: per-layer
leaves stacked on a leading ``n_layers`` dim (``layers["wq"]`` is
``[L, D, H·Dh]``), ``embed [V, D]``, ``lm_head [D, V]``, every matrix
applied as ``x @ W``. :func:`params_from_jax` takes the JAX package's
parameters (as numpy arrays) without transposing anything, so the same
weights run through both packages.

bf16 params/activations, f32 RMSNorm, softmax and loss, interleaved-pair
RoPE, GQA, SwiGLU — with the reference's casts at the same places.
Attention goes through :func:`make_sp_attention`: ``"flash"`` is the
Hopper kernel, ``"local"`` the plain einsum, and the sequence-parallel
impls (the default ``"ring"`` among them) are the plain einsum on one
device, as in the reference, and their ring or all-to-all bodies over
the sp group of a mesh with sp > 1.

On a tp mesh each rank holds its shard of every leaf
(:func:`shard_params`, by :func:`param_specs`): Megatron's column- and
row-parallel layers, written out with the differentiable collectives of
:mod:`horovod_tpu_torch.parallel.tensor_parallel` where GSPMD inserted
them in the reference; the vocab-parallel embedding island
(:func:`embed_lookup`) and loss (:func:`vocab_parallel_nll`) never
gather the table or the logits.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from horovod_tpu_torch.binding import (DistributedOptimizer,
                                       broadcast_parameters)
from horovod_tpu_torch.common.ops_enum import Average, Max, Sum
from horovod_tpu_torch.compression import in_jit_codec, needs_error_feedback
from horovod_tpu_torch.device import resolve_device
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.ops.quantized import (_CAST_WIRE, _INV127,
                                             INT8_BLOCK_ELEMS,
                                             blockwise_int8_decode,
                                             blockwise_int8_encode,
                                             int8_blocks,
                                             quantized_allreduce,
                                             quantized_reduce_scatter)
from horovod_tpu_torch.parallel.mesh import (SHARDING_TODO, axis_index,
                                             data_groups, mesh_axis_size,
                                             replica_group, tp_group,
                                             unported_axes, without_axes)
from horovod_tpu_torch.parallel.ring_attention import make_sp_attention
from horovod_tpu_torch.parallel.tensor_parallel import (copy_to_tp,
                                                        fsdp_allgather,
                                                        reduce_from_tp,
                                                        tp_allreduce)

_MOE_TODO = ("MoE layers (n_experts > 0) are not ported yet (ROADMAP Queue 1 "
             "item 11)")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's config, field for field. Fields that tune XLA or
    the TPU kernel (``flash_block_q/k``, ``scan_unroll``,
    ``remat_prevent_cse``, ``remat_policy``) are kept so configs carry
    over unchanged; the port reads them as stated beside each."""
    vocab_size: int = 32_000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8          # < n_heads → GQA
    d_ff: int = 1376             # SwiGLU hidden
    max_seq: int = 2048
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16  # params/activations; reductions in f32
    remat: bool = True           # torch.utils.checkpoint each layer
    # Every policy is full recompute in the port (the reference's "dots"
    # policies save matmul outputs under jax.checkpoint).
    remat_policy: str = "dots"
    sp_attention: str = "ring"   # "flash" | "local"; "ring" | "ring_flash"
                                 # | "ulysses" run "local" on one device
    # The Hopper kernel picks its own tiles; these are not read.
    flash_block_q: Optional[int] = None
    flash_block_k: Optional[int] = None
    scan_unroll: int = 1          # not read: layers run as a Python loop
    remat_prevent_cse: bool = False  # not read
    # Mixture-of-Experts: n_experts > 0 raises until MoE is ported.
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_dispatch: Optional[str] = None
    moe_compression: Optional[str] = None

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @classmethod
    def llama3_8b(cls, **kw):
        return cls(vocab_size=128_256, d_model=4096, n_layers=32,
                   n_heads=32, n_kv_heads=8, d_ff=14_336, max_seq=8192,
                   **kw)

    @classmethod
    def tiny(cls, **kw):
        base = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                    n_kv_heads=2, d_ff=128, max_seq=128)
        base.update(kw)
        return cls(**base)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
               "w_up", "w_down")
_TOP_KEYS = ("embed", "layers", "final_norm", "lm_head")


def param_shapes(cfg: TransformerConfig) -> Dict[str, Any]:
    """The parameter layout: ``{name: shape}``, layers nested."""
    L, D, H, Hkv, Dh, F_, V = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
                               cfg.vocab_size)
    return {
        "embed": (V, D),
        "layers": {
            "attn_norm": (L, D), "wq": (L, D, H * Dh),
            "wk": (L, D, Hkv * Dh), "wv": (L, D, Hkv * Dh),
            "wo": (L, H * Dh, D), "mlp_norm": (L, D),
            "w_gate": (L, D, F_), "w_up": (L, D, F_), "w_down": (L, F_, D),
        },
        "final_norm": (D,),
        "lm_head": (D, V),
    }


def param_specs(cfg: TransformerConfig) -> Dict[str, Any]:
    """The reference's partition specs (``param_specs``), each leaf a
    tuple of mesh-axis names (or None) per dim: ``tp`` shards heads /
    FFN hidden / vocab, ``fsdp`` the other matrix dim; layer-stacked
    leaves lead with None (:func:`shard_params` applies them)."""
    if cfg.n_experts > 0:
        raise NotImplementedError(_MOE_TODO)
    return {
        "embed": ("tp", "fsdp"),
        "layers": {
            "attn_norm": (None, None), "wq": (None, "fsdp", "tp"),
            "wk": (None, "fsdp", "tp"), "wv": (None, "fsdp", "tp"),
            "wo": (None, "tp", "fsdp"), "mlp_norm": (None, None),
            "w_gate": (None, "fsdp", "tp"), "w_up": (None, "fsdp", "tp"),
            "w_down": (None, "tp", "fsdp"),
        },
        "final_norm": (None,),
        "lm_head": ("fsdp", "tp"),
    }


def _spec_dim(spec, axis: str) -> Optional[int]:
    """Index of the ``axis``-sharded dim of a spec (None where the leaf
    is replicated over ``axis``)."""
    for i, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return i
    return None


def _fsdp_spec_dim(spec) -> Optional[int]:
    """Index of the ``fsdp``-sharded dim of a spec (None for
    fsdp-replicated leaves like the norms)."""
    return _spec_dim(spec, "fsdp")


def tp_shard_dims(cfg: TransformerConfig, tp: int) -> Dict[str, Any]:
    """The tp-sharded dim of every leaf (None where each tp rank holds
    the leaf whole): :func:`param_specs`' ``tp`` dims, except wk/wv when
    ``n_kv_heads % tp`` — then every rank holds them whole and sums
    their gradients over tp (the reference tiles K/V up to the query
    heads there, ``parallel/ring_attention.py:315-324``)."""
    dims = map_params(lambda spec: _spec_dim(spec, "tp"), param_specs(cfg))
    if cfg.n_kv_heads % tp:
        dims["layers"]["wk"] = dims["layers"]["wv"] = None
    return dims


def check_tp(cfg: TransformerConfig, tp: int, sp: int = 1) -> None:
    """Raise unless the tp/sp step can split ``cfg``: heads, FFN hidden
    and vocabulary must divide by tp (``n_kv_heads`` need not), and
    Ulysses needs each rank's heads to divide by sp."""
    bad = {name: n for name, n in (("n_heads", cfg.n_heads),
                                   ("d_ff", cfg.d_ff),
                                   ("vocab_size", cfg.vocab_size))
           if n % tp}
    if bad:
        raise ValueError(f"tp={tp} does not divide {bad}; the tp step "
                         f"shards heads, FFN hidden and vocabulary evenly")
    if cfg.sp_attention == "ulysses" and (cfg.n_heads // tp) % sp:
        raise ValueError(f"ulysses: {cfg.n_heads // tp} heads a tp rank do "
                         f"not split over sp={sp}")


def shard_params(params: Dict[str, Any], cfg: TransformerConfig,
                 mesh) -> Dict[str, Any]:
    """This rank's shard of a full parameter tree (from
    :func:`init_params` or :func:`params_from_jax`) on ``mesh``, by
    :func:`param_specs`: chunk ``t`` of each leaf's tp dim
    (:func:`tp_shard_dims`), then chunk ``f`` of its fsdp dim. A leaf
    with nothing to split is returned as it is; split ones are new,
    detached, contiguous tensors."""
    tp, fsdp = mesh_axis_size(mesh, "tp"), mesh_axis_size(mesh, "fsdp")
    check_tp(cfg, tp, mesh_axis_size(mesh, "sp"))
    t, f = axis_index(mesh, "tp"), axis_index(mesh, "fsdp")
    tdims = param_leaves(tp_shard_dims(cfg, tp))
    fdims = param_leaves(map_params(_fsdp_spec_dim, param_specs(cfg)))
    out = []
    for p, td, fd in zip(param_leaves(params), tdims, fdims):
        piece = p
        if tp > 1 and td is not None:
            piece = piece.detach().chunk(tp, td)[t]
        if fsdp > 1 and fd is not None:
            piece = piece.detach().chunk(fsdp, fd)[f]
        out.append(p if piece is p else piece.clone(
            memory_format=torch.contiguous_format))
    return params_from_leaves(out)


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random parameters with the reference's layout and distribution:
    norms 1, every matrix ``normal · fan_in^-0.5`` drawn in f32 and
    cast to ``cfg.dtype``. ``generator`` lives on ``device`` (which
    defaults to CUDA). The draws are PyTorch's, not JAX's bits."""
    if cfg.n_experts > 0:
        raise NotImplementedError(_MOE_TODO)
    device = resolve_device(device)
    D, F_ = cfg.d_model, cfg.d_ff
    shapes = param_shapes(cfg)

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * fan_in ** -0.5).to(cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    ls = shapes["layers"]
    fan_in = {"wq": D, "wk": D, "wv": D, "wo": cfg.n_heads * cfg.head_dim,
              "w_gate": D, "w_up": D, "w_down": F_}
    layers = {name: (ones(ls[name]) if name.endswith("norm")
                     else dense(ls[name], fan_in[name]))
              for name in _LAYER_KEYS}
    return {
        "embed": dense(shapes["embed"], D),
        "layers": layers,
        "final_norm": ones(shapes["final_norm"]),
        "lm_head": dense(shapes["lm_head"], D),
    }


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16, as JAX exports
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The JAX package's parameter pytree (numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as port parameters on
    ``device``. Same keys, shapes, dtypes and ``x @ W`` orientation;
    nothing is transposed."""
    device = resolve_device(device)
    if "moe" in tree.get("layers", {}):
        raise NotImplementedError(_MOE_TODO)
    if set(tree) != set(_TOP_KEYS) or set(tree["layers"]) != set(_LAYER_KEYS):
        raise ValueError(f"not a dense transformer parameter tree: keys "
                         f"{sorted(tree)}, layers "
                         f"{sorted(tree.get('layers', {}))}")
    return map_params(lambda a: _to_tensor(a, device), tree)


def map_params(fn, params: Dict[str, Any]) -> Dict[str, Any]:
    """A parameter tree of the same layout with ``fn`` applied to every
    leaf."""
    return {
        "embed": fn(params["embed"]),
        "layers": {name: fn(params["layers"][name]) for name in _LAYER_KEYS},
        "final_norm": fn(params["final_norm"]),
        "lm_head": fn(params["lm_head"]),
    }


def param_leaves(params: Dict[str, Any]):
    """Every parameter tensor, in a fixed order."""
    return ([params["embed"]]
            + [params["layers"][name] for name in _LAYER_KEYS]
            + [params["final_norm"], params["lm_head"]])


def params_from_leaves(leaves) -> Dict[str, Any]:
    """The parameter tree of ``leaves`` in :func:`param_leaves`' order."""
    leaves = list(leaves)
    n = len(_LAYER_KEYS)
    return {"embed": leaves[0],
            "layers": dict(zip(_LAYER_KEYS, leaves[1:1 + n])),
            "final_norm": leaves[1 + n], "lm_head": leaves[2 + n]}


def named_param_leaves(params: Dict[str, Any]):
    """``(name, tensor)`` for every parameter, in :func:`param_leaves`'
    order; a layer-stacked leaf is named ``layers.<key>``."""
    names = (["embed"] + [f"layers.{k}" for k in _LAYER_KEYS]
             + ["final_norm", "lm_head"])
    return list(zip(names, param_leaves(params)))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _rmsnorm(x, w, eps):
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * w.float()).to(x.dtype)


def _rope(x, pos, theta):
    """Rotary embedding on interleaved pairs ``(x[..., 0::2],
    x[..., 1::2])``, as the reference rotates them (not the rotate-half
    convention). x: [B, T, H, D]; pos: [T] global positions."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = pos[:, None].float() * inv[None, :]                 # [T, D/2]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(x.shape)
    return y.to(x.dtype)


def decoder_layer(cfg: TransformerConfig, attend, x, lp, pos_offset=0,
                  tp=None):
    """One pre-norm decoder block (attention + dense SwiGLU FFN) on
    ``x`` [B, T, D]; ``lp`` is this layer's param dict (no leading L
    dim). Returns ``(x, aux)``, aux 0 for the dense FFN.

    ``pos_offset`` is the global position of ``x``'s first token (a
    sequence chunk's offset on an sp mesh). With ``tp`` (the tp process
    group) ``lp`` holds this rank's shards: wq/wk/wv and w_gate/w_up
    are column-parallel behind :func:`copy_to_tp`, wo and w_down
    row-parallel before :func:`reduce_from_tp`, so attention runs on
    this rank's ``H / tp`` query heads. Where wk/wv are whole (``Hkv %
    tp``) each rank takes the kv head of each of its query heads, and
    :func:`copy_to_tp` on the weights sums their gradients over tp."""
    if cfg.n_experts > 0:
        raise NotImplementedError(_MOE_TODO)
    Dh = cfg.head_dim
    H, Hkv = lp["wq"].shape[-1] // Dh, lp["wk"].shape[-1] // Dh
    B, T = x.shape[0], x.shape[1]
    pos = torch.arange(T, device=x.device) + pos_offset
    kv_whole = Hkv == cfg.n_kv_heads and H != cfg.n_heads
    wk, wv = ((copy_to_tp(lp["wk"], tp), copy_to_tp(lp["wv"], tp))
              if kv_whole else (lp["wk"], lp["wv"]))

    h = copy_to_tp(_rmsnorm(x, lp["attn_norm"], cfg.norm_eps), tp)
    q = (h @ lp["wq"]).reshape(B, T, H, Dh)
    kk = (h @ wk).reshape(B, T, Hkv, Dh)
    vv = (h @ wv).reshape(B, T, Hkv, Dh)
    q = _rope(q, pos, cfg.rope_theta)
    kk = _rope(kk, pos, cfg.rope_theta)
    if kv_whole:
        # Query head j of this rank is global head t * H + j, which reads
        # kv head (t * H + j) // (n_heads / n_kv_heads).
        t = collectives.axis_rank(tp)
        idx = torch.div(t * H + torch.arange(H, device=x.device),
                        cfg.n_heads // cfg.n_kv_heads, rounding_mode="floor")
        kk, vv, Hkv = kk[:, :, idx], vv[:, :, idx], H
    if Hkv != H and not getattr(attend, "handles_gqa", False):
        rep = H // Hkv
        kk = torch.repeat_interleave(kk, rep, dim=2)
        vv = torch.repeat_interleave(vv, rep, dim=2)
    o = attend(q, kk, vv).reshape(B, T, H * Dh)
    x = x + reduce_from_tp(o @ lp["wo"], tp).to(cfg.dtype)

    h = copy_to_tp(_rmsnorm(x, lp["mlp_norm"], cfg.norm_eps), tp)
    g = F.silu((h @ lp["w_gate"]).float())
    u = (h @ lp["w_up"]).float()
    x = x + reduce_from_tp((g * u).to(cfg.dtype) @ lp["w_down"],
                           tp).to(cfg.dtype)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


REMAT_POLICIES = ("dots", "dots_all", "full")


def check_remat_policy(cfg: TransformerConfig) -> None:
    """Raise for a ``remat_policy`` the reference does not know
    (``horovod_tpu/models/transformer.py::remat_policy_fn``), with its
    message. Every known policy runs as a full recompute here."""
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")


def _replicated_table_lookup(embed, tokens, dtype, codec: str):
    """The table-replication fallback of :func:`embed_lookup` (reference
    ``_replicated_table_lookup``) on a table every rank holds whole, so
    nothing moves; ``codec`` keeps the reference's rounding of the
    table it would have shipped: "bf16"/"fp16" cast the table to the
    wire dtype, "int8" looks the rows up in its blockwise code
    (:mod:`~horovod_tpu_torch.ops.quantized`) and decodes them. As in
    the reference, the int8 rows' gradient reaches the table through
    the block scales only (the rounded codes carry none)."""
    if codec in _CAST_WIRE:
        return embed.to(_CAST_WIRE[codec])[tokens].to(dtype)
    if codec == "int8":
        q, _ = blockwise_int8_encode(embed.detach())
        c = embed.shape[-1]
        pad = int8_blocks(c) * INT8_BLOCK_ELEMS - c
        blocks = F.pad(embed.float(), (0, pad)).unflatten(
            -1, (-1, INT8_BLOCK_ELEMS))
        scales = blocks.abs().amax(dim=-1) * _INV127
        return blockwise_int8_decode(q[tokens], scales[tokens], c).to(dtype)
    return embed.to(dtype)[tokens]


def embed_lookup(embed, tokens, dtype, mesh, compression=None, *,
                 full_shape: Optional[Tuple[int, int]] = None):
    """Vocab-parallel embedding lookup (reference ``embed_lookup``).

    ``embed`` is this rank's piece of the ``full_shape = (V, D)`` table
    as :func:`shard_params` lays it out. Where tp and fsdp divide it,
    that is the tile of rows ``[t·V/tp, (t+1)·V/tp)`` and columns
    ``[f·D/fsdp, (f+1)·D/fsdp)``, and the lookup is the island: gather
    the tokens of every fsdp rank, look up the rows this rank holds (out
    of range tokens give zero rows), Sum over tp
    (:func:`reduce_from_tp`), all-gather the model dim over fsdp and
    keep this rank's tokens. Every collective is activation-sized; the
    table never moves. Where they do not divide, ``embed`` is the whole
    table and the lookup warns and takes :func:`_replicated_table_lookup`
    (with ``compression``'s codec; the island ignores it, as in the
    reference). Without a tp or fsdp axis it is ``embed[tokens]``."""
    tp = 1 if mesh is None else mesh_axis_size(mesh, "tp")
    fsdp = 1 if mesh is None else mesh_axis_size(mesh, "fsdp")
    if tp * fsdp == 1:
        return embed.to(dtype)[tokens]
    if full_shape is None:
        raise ValueError("embed_lookup on a tp/fsdp mesh needs the whole "
                         "table's full_shape=(V, D)")
    V, D = full_shape
    if V % tp or D % fsdp:
        warnings.warn(
            f"embed_lookup: table [{V}, {D}] not divisible by (tp={tp}, "
            f"fsdp={fsdp}); every rank holds it whole. Pad "
            f"vocab_size/d_model to multiples of the mesh axes.")
        if tuple(embed.shape) != (V, D):
            raise ValueError(f"embed_lookup: a table that does not divide "
                             f"is held whole, not {tuple(embed.shape)}")
        return _replicated_table_lookup(embed, tokens, dtype,
                                        in_jit_codec(compression))
    v_loc = V // tp
    if tuple(embed.shape) != (v_loc, D // fsdp):
        raise ValueError(f"embed_lookup: expected this rank's [{v_loc}, "
                         f"{D // fsdp}] tile, got {tuple(embed.shape)}")
    fg = data_groups(mesh)[1]
    toks = tokens if fsdp == 1 else collectives.allgather(tokens, fg)
    idx = toks - axis_index(mesh, "tp") * v_loc
    valid = (idx >= 0) & (idx < v_loc)
    rows = embed.to(dtype)[torch.where(valid, idx, 0)]
    rows = torch.where(valid[..., None], rows, 0)
    rows = fsdp_allgather(reduce_from_tp(rows, tp_group(mesh)), fg, -1)
    if fsdp > 1:
        b = tokens.shape[0]
        f = axis_index(mesh, "fsdp")
        rows = rows[f * b:(f + 1) * b]
    return rows.to(dtype)


def forward_with_aux(params, tokens, cfg: TransformerConfig, mesh=None):
    """tokens ``[B, T]`` integer → (logits ``[B, T, V]``, aux_loss).

    With ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``
    and is recomputed whole in the backward, whatever
    ``cfg.remat_policy`` says. ``mesh`` selects the attention as in the
    reference. On a data-parallel mesh each rank runs its own rows. On
    a tp/sp mesh ``params`` are this rank's shards (:func:`shard_params`)
    and ``tokens`` its rows and sequence chunk (:func:`shard_batch`'s
    inputs); the logits are this rank's ``[B, T / sp, V / tp]`` block."""
    if cfg.remat:
        check_remat_policy(cfg)
    attend = make_sp_attention(mesh, impl=cfg.sp_attention, causal=True)
    tp = None if mesh is None else tp_group(mesh)
    pos_offset = (0 if mesh is None
                  else axis_index(mesh, "sp") * tokens.shape[1])
    layer = functools.partial(decoder_layer, cfg, attend,
                              pos_offset=pos_offset, tp=tp)
    x = embed_lookup(params["embed"], tokens.long(), cfg.dtype, mesh,
                     full_shape=(cfg.vocab_size, cfg.d_model))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    stacked = params["layers"]
    # A layer's recompute must issue every collective of its forward on
    # every rank, so it may not stop early on a tp/sp mesh.
    early_stop = tp is None and not (mesh is not None
                                     and mesh_axis_size(mesh, "sp") > 1)
    for i in range(stacked["wq"].shape[0]):
        lp = {name: w[i] for name, w in stacked.items()}
        if cfg.remat:
            with set_checkpoint_early_stop(early_stop):
                x, a = checkpoint(layer, x, lp, use_reentrant=False)
        else:
            x, a = layer(x, lp)
        aux = aux + a
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return copy_to_tp(x, tp) @ params["lm_head"], aux


def forward(params, tokens, cfg: TransformerConfig, mesh=None):
    """tokens ``[B, T]`` → logits ``[B, T, V]`` (cfg.dtype)."""
    return forward_with_aux(params, tokens, cfg, mesh)[0]


class _VocabParallelNLL(torch.autograd.Function):
    """Cross-entropy of logits split over the vocabulary on tp: a max
    and a sum of ``exp`` all-reduced over tp, the target's logit from
    the rank that holds it (a Sum of masked picks); the backward is
    ``softmax − onehot`` on the local shard, with no collective."""

    @staticmethod
    def forward(ctx, logits, target, group):
        z = logits.float()
        v_loc = z.shape[-1]
        m = tp_allreduce(z.amax(dim=-1), group, Max)
        e = torch.exp(z - m[..., None])
        se = tp_allreduce(e.sum(dim=-1), group, Sum)
        idx = target.long() - collectives.axis_rank(group) * v_loc
        valid = (idx >= 0) & (idx < v_loc)
        idx = torch.where(valid, idx, 0)
        zt = torch.gather(z, -1, idx[..., None])[..., 0]
        zt = tp_allreduce(torch.where(valid, zt, 0.0), group, Sum)
        ctx.save_for_backward(e, se, idx, valid)
        ctx.dtype = logits.dtype
        return m + torch.log(se) - zt

    @staticmethod
    def backward(ctx, g):
        e, se, idx, valid = ctx.saved_tensors
        grad = e / se[..., None]
        grad.scatter_add_(-1, idx[..., None], -valid.float()[..., None])
        grad *= g[..., None]
        return grad.to(ctx.dtype), None, None


def vocab_parallel_nll(logits, target, group):
    """Per-token f32 cross-entropy ``[B, T]`` of this rank's vocabulary
    shard ``logits`` ``[B, T, V / tp]`` (rows ``[t·V/tp, (t+1)·V/tp)``
    on tp rank ``t``) against ``target`` ``[B, T]``: the reference's f32
    ``log_softmax`` over ``P(batch, "sp", "tp")`` logits, with no rank
    holding full-vocabulary logits."""
    return _VocabParallelNLL.apply(logits, target, group)


def lm_loss(params, batch, cfg: TransformerConfig, mesh=None):
    """Next-token cross-entropy (f32 log-softmax, mean over B·T) over
    ``batch["tokens"]`` [B, T+1] plus the aux term; returns a scalar.

    On a tp/sp mesh ``batch["tokens"]`` is this rank's
    :func:`shard_batch` block (its sequence chunk and the token after
    it), so the shift happens before the split, and the loss is this
    rank's mean (the train step Averages it over dp x sp); the loss is
    vocab-parallel (:func:`vocab_parallel_nll`) over tp."""
    tokens = batch["tokens"]
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    logits, aux = forward_with_aux(params, inp, cfg, mesh)
    tp = None if mesh is None else tp_group(mesh)
    if tp is not None:
        return vocab_parallel_nll(logits, tgt, tp).mean() + aux
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None].long())[..., 0]
    return nll.mean() + aux


# ---------------------------------------------------------------------------
# Train step factory
# ---------------------------------------------------------------------------

def default_optimizer(params):
    """AdamW with ``optax.adamw(3e-4, weight_decay=0.01)``'s update:
    b1 0.9, b2 0.999, eps 1e-8 added to the bias-corrected root, decay
    decoupled and applied to every leaf. Its state takes each
    parameter's dtype, as optax's does."""
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


def _dispatch_mesh(mesh, codec: str) -> int:
    """The reference's ``compression=`` dispatcher checks, for every
    mesh: returns the fsdp size. A codec on a mesh with tp/sp/pp/ep > 1
    raises the reference's ValueError; pp/ep > 1 raise
    NotImplementedError (not ported); a codec with no data axis
    raises."""
    model = {a: mesh_axis_size(mesh, a) for a in ("sp", "tp")
             if mesh_axis_size(mesh, a) > 1}
    bad = unported_axes(mesh)
    if (bad or model) and codec != "none":
        raise ValueError(
            f"make_train_step(compression={codec!r}) quantizes the "
            f"data-parallel gradient allreduce and the fsdp gradient "
            f"reduce-scatter; mesh axes {sorted({**model, **bad}.items())} "
            "have no explicit gradient collective to intercept. Use a "
            "dp/fsdp mesh, or compression=None.")
    if bad:
        raise NotImplementedError(f"mesh axes {bad}: {SHARDING_TODO}")
    nfsdp = mesh_axis_size(mesh, "fsdp")
    if "dp" not in tuple(mesh.mesh_dim_names or ()) and nfsdp <= 1:
        raise ValueError(
            f"compression= needs a data axis ('dp', or 'fsdp' > 1); mesh "
            f"has {tuple(mesh.mesh_dim_names or ())}")
    return nfsdp


def make_train_step(cfg: TransformerConfig, device=None, optimizer=None, *,
                    mesh=None, compression=None):
    """Build ``(init_state, step)``.

    ``init_state(generator)`` draws parameters with :func:`init_params`;
    ``init_state(params=...)`` adopts given ones (e.g. from
    :func:`params_from_jax`). ``step(state, batch) -> (state, loss)``
    runs ``lm_loss``, its backward and one optimizer update. The state
    is updated in place (the reference donates it) and returned.

    ``optimizer`` maps the list of parameter tensors to a
    ``torch.optim.Optimizer``; the default is :func:`default_optimizer`.

    With a data-parallel ``mesh`` (:func:`~horovod_tpu_torch.parallel.
    mesh.build_mesh`), each rank runs the step on its own rows of the
    global batch (:func:`shard_batch`): ``init_state`` broadcasts rank
    0's parameters, the optimizer is wrapped in
    :class:`~horovod_tpu_torch.binding.DistributedOptimizer` (every
    gradient Average-reduced before the update, so every rank applies
    the same one), and the returned loss is the Average of the ranks'
    losses, the global mean, as the reference's dp step returns it.

    On a dp x sp x tp mesh ``init_state`` broadcasts rank 0's full tree
    over the world and keeps this rank's shards (:func:`shard_params`);
    each rank runs its rows and sequence chunk (:func:`shard_batch`)
    through the tp layers and the sp attention, gradients are Averaged
    over :func:`~horovod_tpu_torch.parallel.mesh.replica_group` (dp x
    sp; tp shards reduce nothing there), and the loss is the Average of
    the dp x sp ranks' means, the mean over every token (the chunks are
    equal). :func:`gather_params` reassembles the full tree.

    ``compression`` (a ``Compression`` member; None/none = the plain
    step) reduces each gradient leaf through the quantized
    reduce-scatter + all-gather of :mod:`horovod_tpu_torch.ops.
    quantized`; int8 keeps the rank-local error-feedback residuals in
    ``state["ef"]`` (a parameter-layout tree, this rank's own). A mesh
    with ``fsdp > 1`` takes the fsdp step (:func:`_make_fsdp_train_step`)
    with any codec, ``"none"`` included, and composes with tp and sp. A
    codec with tp/sp, or with no data axis, raises; so do pp/ep > 1.
    """
    if cfg.n_experts > 0:
        raise NotImplementedError(_MOE_TODO)
    codec = in_jit_codec(compression)
    if mesh is None and codec != "none":
        raise ValueError("compression= needs a data axis ('dp', or 'fsdp' "
                         "> 1); no mesh was given")
    nfsdp = 1 if mesh is None else _dispatch_mesh(mesh, codec)
    device = resolve_device(device)
    if mesh is not None and mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot train on "
                         f"{device}")
    make_opt = default_optimizer if optimizer is None else optimizer
    if mesh is not None:
        check_tp(cfg, mesh_axis_size(mesh, "tp"), mesh_axis_size(mesh, "sp"))
    if nfsdp > 1:
        return _make_fsdp_train_step(cfg, device, make_opt, mesh,
                                     compression, codec)
    group = None if mesh is None else replica_group(mesh)
    use_ef = needs_error_feedback(compression)

    def init_state(generator: Optional[torch.Generator] = None, *,
                   params: Optional[Dict[str, Any]] = None):
        params = _adopt(cfg, device, generator, params)
        if mesh is not None:
            broadcast_parameters(params, 0, None)
            params = map_params(lambda p: p.requires_grad_(True),
                                shard_params(params, cfg, mesh))
        opt = make_opt(param_leaves(params))
        if mesh is not None:
            opt = DistributedOptimizer(opt, group=group,
                                       compression=compression)
        state = {"params": params, "opt": opt, "step": 0}
        if use_ef:
            state["ef"] = params_from_leaves(opt.ef)
        return state

    def step(state, batch):
        opt = state["opt"]
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(state["params"], batch, cfg, mesh)
        loss.backward()
        opt.step()
        state["step"] += 1
        if use_ef:
            state["ef"] = params_from_leaves(opt.ef)
        loss = loss.detach()
        if mesh is not None:
            loss = collectives.allreduce(loss, Average, group)
        return state, loss

    return init_state, step


def _adopt(cfg, device, generator, params):
    """Draw (``generator``) or adopt (``params``) the full parameter
    tree on ``device``."""
    if (generator is None) == (params is None):
        raise ValueError("init_state takes a generator or params=, "
                         "not both or neither")
    if params is None:
        params = init_params(cfg, generator, device)
    for p in param_leaves(params):
        if p.device != device:
            raise ValueError(f"parameter on {p.device}, train step on "
                             f"{device}")
        p.requires_grad_(True)
    return params


def _make_fsdp_train_step(cfg: TransformerConfig, device, make_opt, mesh,
                          compression, codec: str):
    """The fsdp step: the reference's explicit ZeRO-3 island
    (``_make_fsdp_quantized_train_step``), for every codec.

    * Parameters and optimizer state are this rank's shards
      (:func:`shard_params`: slab ``f`` of each leaf's fsdp dim, within
      its tp shard on a tp mesh); the norms are whole on every rank.
    * The forward all-gathers each sharded leaf over the fsdp group in
      the model dtype (on a tp mesh, into this rank's tp shard) and runs
      the model on the mesh without its fsdp axis (the tp layers and sp
      attention, where those axes are above 1); autograd differentiates
      the gathered leaves on this rank's rows (and sequence chunk).
    * Sharded leaves' gradients are reduced by
      :func:`~horovod_tpu_torch.ops.quantized.quantized_reduce_scatter`
      (Average) over fsdp, the norms' by ``quantized_allreduce`` over
      fsdp; where the replica group (dp, or dp x sp:
      :func:`~horovod_tpu_torch.parallel.mesh.replica_group`) is above
      1, a second ``quantized_allreduce`` (Average) hop runs over it on
      the shard.
    * int8 residuals are kept per hop: ``state["ef"] = {"fsdp": ...,
      "dp": ...}`` (full-shaped for the fsdp hop, shard-shaped for the
      dp hop).
    * The loss is averaged over the replica group, then over fsdp.

    Every fsdp-sharded dim must divide by the fsdp size.
    """
    fg = data_groups(mesh)[1]
    dpg = replica_group(mesh)
    view = without_axes(mesh, "fsdp")
    nfsdp = collectives.axis_size(fg)
    dp_hop = collectives.axis_size(dpg) > 1
    use_ef = needs_error_feedback(compression)
    dims = map_params(_fsdp_spec_dim, param_specs(cfg))
    shapes = param_shapes(cfg)
    bad = [f"{name}{tuple(shape)} dim {d}" for (name, d), shape in zip(
        named_param_leaves(dims), param_leaves(shapes))
        if d is not None and shape[d] % nfsdp]
    if bad:
        raise ValueError(
            f"make_train_step(compression={codec!r}): fsdp={nfsdp} does "
            f"not divide the sharded dim of {bad}; pad the model dims "
            "to multiples of the fsdp axis (the manual island cannot).")
    dim_leaves = param_leaves(dims)

    def init_state(generator: Optional[torch.Generator] = None, *,
                   params: Optional[Dict[str, Any]] = None):
        params = _adopt(cfg, device, generator, params)
        broadcast_parameters(params, 0, None)
        shards = [p.requires_grad_(True) for p in
                  param_leaves(shard_params(params, cfg, mesh))]
        state = {"params": params_from_leaves(shards),
                 "opt": make_opt(shards), "step": 0}
        if use_ef:
            ef = {"fsdp": params_from_leaves(
                [torch.zeros_like(p, dtype=torch.float32)
                 for p in param_leaves(params)])}
            if dp_hop:
                ef["dp"] = params_from_leaves(
                    [torch.zeros_like(s, dtype=torch.float32)
                     for s in shards])
            state["ef"] = ef
        return state

    def step(state, batch):
        shards = param_leaves(state["params"])
        full = [(s.detach() if d is None else collectives.allgather(
            s.detach(), fg, axis=d)).requires_grad_(True)
            for s, d in zip(shards, dim_leaves)]
        loss = lm_loss(params_from_leaves(full), batch, cfg, view)
        grads = torch.autograd.grad(loss, full)
        ef = state.get("ef", {})
        rs_res = (param_leaves(ef["fsdp"]) if use_ef
                  else [None] * len(grads))
        dp_res = (param_leaves(ef["dp"]) if use_ef and dp_hop
                  else [None] * len(grads))
        new_rs, new_dp = [], []
        for s, g, d, r1, r2 in zip(shards, grads, dim_leaves, rs_res,
                                   dp_res):
            if d is None:
                y = quantized_allreduce(g, Average, fg, codec=codec,
                                        residual=r1)
            else:
                y = quantized_reduce_scatter(g, Average, fg, codec=codec,
                                             axis=d, residual=r1)
            if r1 is not None:
                y, nr1 = y
                new_rs.append(nr1)
            if dp_hop:
                y = quantized_allreduce(y, Average, dpg, codec=codec,
                                        residual=r2)
                if r2 is not None:
                    y, nr2 = y
                    new_dp.append(nr2)
            s.grad = y
        state["opt"].step()
        state["opt"].zero_grad(set_to_none=True)
        state["step"] += 1
        if use_ef:
            state["ef"] = {"fsdp": params_from_leaves(new_rs)}
            if dp_hop:
                state["ef"]["dp"] = params_from_leaves(new_dp)
        loss = loss.detach()
        for g in (dpg, fg):
            if g is not None:
                loss = collectives.allreduce(loss, Average, g)
        return state, loss

    return init_state, step


def gather_params(state, cfg: TransformerConfig, mesh) -> Dict[str, Any]:
    """The full parameters of a train step's ``state``: the shards
    all-gathered over the mesh's fsdp group, then over its tp group (the
    tree itself where the mesh shards nothing)."""
    params = state["params"]
    if mesh is None:
        return params
    tp = mesh_axis_size(mesh, "tp")
    for group, dims in (
            (data_groups(mesh)[1], map_params(_fsdp_spec_dim,
                                              param_specs(cfg))),
            (tp_group(mesh), tp_shard_dims(cfg, tp))):
        if group is not None:
            params = params_from_leaves(
                s.detach() if d is None else collectives.allgather(
                    s.detach(), group, axis=d)
                for s, d in zip(param_leaves(params), param_leaves(dims)))
    return params


def shard_batch(tokens, mesh):
    """This rank's block of a global ``[B, T+1]`` token batch on
    ``mesh``: the rank at ``(d, f, s, t)`` takes row block ``d * fsdp +
    f`` of ``dp * fsdp`` equal blocks, as the reference shards the batch
    over ``("dp", "fsdp")``, and, with sp > 1, sequence chunk ``s`` of
    ``sp`` (columns ``[s·T/sp, (s+1)·T/sp]``: the chunk and the token
    after it, so :func:`lm_loss`'s shift gives the chunk's inputs and
    targets); every tp rank takes the same block. ``B`` must divide by
    ``dp * fsdp`` and ``T`` by ``sp``."""
    bad = unported_axes(mesh)
    if bad:
        raise NotImplementedError(f"mesh axes {bad}: {SHARDING_TODO}")
    nf, nsp = mesh_axis_size(mesh, "fsdp"), mesh_axis_size(mesh, "sp")
    n = nf * mesh_axis_size(mesh, "dp")
    r = axis_index(mesh, "dp") * nf + axis_index(mesh, "fsdp")
    if tokens.shape[0] % n:
        raise ValueError(f"global batch of {tokens.shape[0]} rows does not "
                         f"divide over dp x fsdp = {n}")
    rows = tokens.shape[0] // n
    tokens = tokens[r * rows:(r + 1) * rows]
    if nsp == 1:
        return tokens
    t = tokens.shape[1] - 1
    if t % nsp:
        raise ValueError(f"a sequence of {t} tokens does not split over "
                         f"sp = {nsp}")
    s, chunk = axis_index(mesh, "sp"), t // nsp
    return tokens[:, s * chunk:(s + 1) * chunk + 1]
