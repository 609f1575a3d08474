"""Llama-family decoder LM in PyTorch — the counterpart of
:mod:`horovod_tpu.models.transformer`, on one device, data-parallel over
a process group, fsdp-sharded over a dp x fsdp mesh, tensor- and
sequence-parallel over a dp x sp x tp mesh, or expert-parallel over a
dp x tp x ep mesh (the pipeline over pp is
:mod:`horovod_tpu_torch.parallel.pipeline`).

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
the sp group of a mesh with sp > 1. With ``n_experts > 0`` every
layer's FFN is the MoE block of :mod:`horovod_tpu_torch.models.moe`
(``layers["moe"]``), its experts sharded over ep.

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
from horovod_tpu_torch.models import moe as moe_lib
from horovod_tpu_torch.parallel.mesh import (SHARDING_TODO, axis_index,
                                             check_ported,
                                             data_groups, ep_group,
                                             mesh_axis_size, pp_group,
                                             prepare_groups, replica_group,
                                             tp_group, without_axes)
from horovod_tpu_torch.parallel.ring_attention import make_sp_attention
from horovod_tpu_torch.parallel.tensor_parallel import (copy_to_tp,
                                                        fsdp_allgather,
                                                        reduce_from_tp,
                                                        tp_allreduce)

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
    # Mixture-of-Experts: n_experts > 0 replaces the dense SwiGLU FFN with
    # the MoE FFN in every layer (models/moe.py), experts over ep.
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

    @property
    def moe(self) -> Optional[moe_lib.MoEConfig]:
        if self.n_experts <= 0:
            return None
        return moe_lib.MoEConfig(n_experts=self.n_experts,
                                 top_k=self.moe_top_k,
                                 capacity_factor=self.moe_capacity_factor)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

_ATTN_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm")
_FFN_KEYS = ("w_gate", "w_up", "w_down")
#: A dense layer's leaves; an MoE layer has ``_ATTN_KEYS`` and ``"moe"``
#: (the leaves of :func:`~horovod_tpu_torch.models.moe.moe_param_specs`).
_LAYER_KEYS = _ATTN_KEYS + _FFN_KEYS
_MOE_KEYS = ("router",) + moe_lib.EXPERT_KEYS
_TOP_KEYS = ("embed", "layers", "final_norm", "lm_head")
#: The fixed order of every key at every level of a parameter tree.
_ORDER = {k: i for i, k in enumerate(_TOP_KEYS + _ATTN_KEYS + ("moe",)
                                     + _MOE_KEYS)}


def param_shapes(cfg: TransformerConfig) -> Dict[str, Any]:
    """The parameter layout: ``{name: shape}``, layers nested (an MoE
    layer's block under ``layers["moe"]``)."""
    L, D, H, Hkv, Dh, F_, V = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
                               cfg.vocab_size)
    layers = {"attn_norm": (L, D), "wq": (L, D, H * Dh),
              "wk": (L, D, Hkv * Dh), "wv": (L, D, Hkv * Dh),
              "wo": (L, H * Dh, D), "mlp_norm": (L, D)}
    if cfg.moe is not None:
        layers["moe"] = moe_lib.moe_param_shapes(L, D, F_, cfg.moe)
    else:
        layers.update({"w_gate": (L, D, F_), "w_up": (L, D, F_),
                       "w_down": (L, F_, D)})
    return {"embed": (V, D), "layers": layers, "final_norm": (D,),
            "lm_head": (D, V)}


def param_specs(cfg: TransformerConfig) -> Dict[str, Any]:
    """The reference's partition specs (``param_specs``), each leaf a
    tuple of mesh-axis names (or None) per dim: ``tp`` shards heads /
    FFN hidden / vocab, ``fsdp`` the other matrix dim, ``ep`` the
    experts; layer-stacked leaves lead with None (:func:`shard_params`
    applies them, and shards that dim over pp)."""
    layers = {"attn_norm": (None, None), "wq": (None, "fsdp", "tp"),
              "wk": (None, "fsdp", "tp"), "wv": (None, "fsdp", "tp"),
              "wo": (None, "tp", "fsdp"), "mlp_norm": (None, None)}
    if cfg.moe is not None:
        layers["moe"] = moe_lib.moe_param_specs()
    else:
        layers.update({"w_gate": (None, "fsdp", "tp"),
                       "w_up": (None, "fsdp", "tp"),
                       "w_down": (None, "tp", "fsdp")})
    return {"embed": ("tp", "fsdp"), "layers": layers,
            "final_norm": (None,), "lm_head": ("fsdp", "tp")}


def leaf_kind(name: str) -> str:
    """``"expert"``, ``"layer"`` or ``"top"`` for a leaf named as
    :func:`named_param_leaves` names it: the kinds of
    :data:`~horovod_tpu_torch.parallel.mesh.REPLICA_AXES`."""
    if name.startswith("layers.moe.") and name != "layers.moe.router":
        return "expert"
    return "layer" if name.startswith("layers.") else "top"


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


def shard_dims(cfg: TransformerConfig, mesh) -> Dict[str, Any]:
    """``((axis, dim), ...)`` of every leaf on ``mesh``: the dim of the
    leaf each axis above 1 splits (:func:`param_specs`; tp by
    :func:`tp_shard_dims`; pp the stacked layer dim of every layer
    leaf). An axis that leaves the leaf whole is absent."""
    sizes = {a: mesh_axis_size(mesh, a) for a in ("tp", "fsdp", "ep", "pp")}
    tdims = param_leaves(tp_shard_dims(cfg, sizes["tp"]))
    out = []
    for (name, spec), td in zip(named_param_leaves(param_specs(cfg)), tdims):
        dims = {"tp": td, "fsdp": _fsdp_spec_dim(spec),
                "ep": _spec_dim(spec, "ep"),
                "pp": 0 if name.startswith("layers.") else None}
        out.append(tuple((a, d) for a, d in dims.items()
                         if d is not None and sizes[a] > 1))
    return params_from_leaves(out, param_specs(cfg))


def _check_shardable(cfg: TransformerConfig, mesh) -> None:
    """Raise unless ``cfg`` splits over ``mesh``: the compositions not
    ported yet (item 16; MoE with sp or fsdp among them), tp's
    divisibility (:func:`check_tp`), experts over ep, layers over pp."""
    check_ported(mesh)
    bad = {a: mesh_axis_size(mesh, a) for a in ("sp", "fsdp")
           if mesh_axis_size(mesh, a) > 1}
    if cfg.moe is not None and bad:
        raise NotImplementedError(f"MoE with mesh axes {bad}: "
                                  f"{SHARDING_TODO}")
    check_tp(cfg, mesh_axis_size(mesh, "tp"), mesh_axis_size(mesh, "sp"))
    ep, pp = mesh_axis_size(mesh, "ep"), mesh_axis_size(mesh, "pp")
    if cfg.moe is not None and cfg.n_experts % ep:
        raise ValueError(f"n_experts={cfg.n_experts} does not divide over "
                         f"ep={ep}; each ep rank holds E/ep experts")
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by "
                         f"pp={pp}")


def shard_params(params: Dict[str, Any], cfg: TransformerConfig,
                 mesh) -> Dict[str, Any]:
    """This rank's shard of a full parameter tree (from
    :func:`init_params` or :func:`params_from_jax`) on ``mesh``, by
    :func:`shard_dims`: chunk ``t`` of each leaf's tp dim, chunk ``f``
    of its fsdp dim, chunk ``e`` of an expert leaf's expert dim and
    chunk ``p`` (this stage's ``L / pp`` layers) of a layer leaf. A
    leaf with nothing to split is returned as it is; split ones are
    new, detached, contiguous tensors."""
    _check_shardable(cfg, mesh)
    out = []
    for p, dims in zip(param_leaves(params),
                       param_leaves(shard_dims(cfg, mesh))):
        piece = p
        for axis, d in dims:
            piece = piece.detach().chunk(mesh_axis_size(mesh, axis),
                                         d)[axis_index(mesh, axis)]
        out.append(p if piece is p else piece.clone(
            memory_format=torch.contiguous_format))
    return params_from_leaves(out, params)


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random parameters with the reference's layout and distribution:
    norms 1, every matrix ``normal · fan_in^-0.5`` drawn in f32 and
    cast to ``cfg.dtype`` (an MoE router stays f32). ``generator``
    lives on ``device`` (which defaults to CUDA). The draws are
    PyTorch's, not JAX's bits."""
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
    keys = _ATTN_KEYS if cfg.moe is not None else _LAYER_KEYS
    layers = {name: (ones(ls[name]) if name.endswith("norm")
                     else dense(ls[name], fan_in[name]))
              for name in keys}
    if cfg.moe is not None:
        layers["moe"] = moe_lib.init_moe_params(
            generator, cfg.n_layers, D, F_, cfg.moe, cfg.dtype, device)
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
    layers = tree.get("layers", {})
    want = (set(_ATTN_KEYS) | {"moe"} if "moe" in layers
            else set(_LAYER_KEYS))
    if (set(tree) != set(_TOP_KEYS) or set(layers) != want
            or set(layers.get("moe", _MOE_KEYS)) != set(_MOE_KEYS)):
        raise ValueError(f"not a transformer parameter tree: keys "
                         f"{sorted(tree)}, layers {sorted(layers)}")
    return map_params(lambda a: _to_tensor(a, device), tree)


def _keys(tree: Dict[str, Any]):
    """A tree level's keys in the fixed order (other keys after, by
    name: a stage's own parameter trees)."""
    return sorted(tree, key=lambda k: (_ORDER.get(k, len(_ORDER)), k))


def map_params(fn, params: Dict[str, Any]) -> Dict[str, Any]:
    """A parameter tree of the same layout with ``fn`` applied to every
    leaf."""
    return {k: (map_params(fn, params[k]) if isinstance(params[k], dict)
                else fn(params[k])) for k in _keys(params)}


def named_param_leaves(params: Dict[str, Any], prefix=""):
    """``(name, leaf)`` for every parameter, in a fixed order (embed, the
    layer leaves, final_norm, lm_head); a layer-stacked leaf is named
    ``layers.<key>``, an MoE leaf ``layers.moe.<key>``."""
    out = []
    for k in _keys(params):
        v = params[k]
        if isinstance(v, dict):
            out += named_param_leaves(v, f"{prefix}{k}.")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def param_leaves(params: Dict[str, Any]):
    """Every parameter tensor, in :func:`named_param_leaves`' order."""
    return [v for _, v in named_param_leaves(params)]


def params_from_leaves(leaves, like: Dict[str, Any]) -> Dict[str, Any]:
    """The tree of ``leaves`` (in :func:`param_leaves`' order) laid out
    as the parameter tree ``like``."""
    it = iter(leaves)
    return map_params(lambda _: next(it), like)


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
                  tp=None, moe_fn=None):
    """One pre-norm decoder block (attention + SwiGLU FFN or MoE) on
    ``x`` [B, T, D]; ``lp`` is this layer's param dict (no leading L
    dim). Returns ``(x, aux)``: aux 0 for the dense FFN, the
    load-balancing term for MoE. ``moe_fn(h, lp["moe"]) -> (y, aux)``
    is the MoE FFN call (:func:`~horovod_tpu_torch.models.moe.
    make_moe_ffn`'s choice; None: :func:`~horovod_tpu_torch.models.moe.
    moe_ffn` with no mesh).

    ``pos_offset`` is the global position of ``x``'s first token (a
    sequence chunk's offset on an sp mesh). With ``tp`` (the tp process
    group) ``lp`` holds this rank's shards: wq/wk/wv and w_gate/w_up
    are column-parallel behind :func:`copy_to_tp`, wo and w_down
    row-parallel before :func:`reduce_from_tp`, so attention runs on
    this rank's ``H / tp`` query heads. Where wk/wv are whole (``Hkv %
    tp``) each rank takes the kv head of each of its query heads, and
    :func:`copy_to_tp` on the weights sums their gradients over tp."""
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

    if "moe" in lp:
        h = _rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        if moe_fn is None:
            y, aux = moe_lib.moe_ffn(h, lp["moe"], cfg.moe)
        else:
            y, aux = moe_fn(h, lp["moe"])
        return x + y.to(cfg.dtype), aux
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
    a tp/sp/ep mesh ``params`` are this rank's shards
    (:func:`shard_params`) and ``tokens`` its rows and sequence chunk
    (:func:`shard_batch`'s inputs); the logits are this rank's ``[B, T /
    sp, V / tp]`` block."""
    x = embed_lookup(params["embed"], tokens.long(), cfg.dtype, mesh,
                     full_shape=(cfg.vocab_size, cfg.d_model))
    x, aux = run_layers(params["layers"], x, cfg, mesh)
    return head(params, x, cfg, mesh), aux


def layer_fn(cfg: TransformerConfig, mesh, seq_len: int):
    """``layer(x, lp) -> (x, aux)``: :func:`decoder_layer` with
    ``mesh``'s attention, tp group and MoE call, at the position offset
    of this rank's chunk of ``seq_len`` tokens."""
    attend = make_sp_attention(mesh, impl=cfg.sp_attention, causal=True)
    moe_fn = (moe_lib.make_moe_ffn(cfg.moe, mesh, dispatch=cfg.moe_dispatch,
                                   codec=cfg.moe_compression)
              if cfg.moe is not None else None)
    return functools.partial(
        decoder_layer, cfg, attend, tp=None if mesh is None else tp_group(mesh),
        moe_fn=moe_fn,
        pos_offset=0 if mesh is None else axis_index(mesh, "sp") * seq_len)


def _index_layer(stacked, i):
    return {k: (_index_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in stacked.items()}


def run_layers(stacked, x, cfg: TransformerConfig, mesh=None):
    """The layers of ``stacked`` (leaves ``[L, ...]``) on ``x`` in turn,
    each under ``torch.utils.checkpoint`` with ``cfg.remat`` (recomputed
    whole in the backward, whatever ``cfg.remat_policy`` says); returns
    ``(x, summed aux)``."""
    if cfg.remat:
        check_remat_policy(cfg)
    layer = layer_fn(cfg, mesh, x.shape[1])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # A layer's recompute must issue every collective of its forward on
    # every rank, so it may not stop early on a mesh with model axes.
    early_stop = mesh is None or all(
        mesh_axis_size(mesh, a) == 1 for a in ("sp", "tp", "ep"))
    for i in range(stacked["wq"].shape[0]):
        lp = _index_layer(stacked, i)
        if cfg.remat:
            with set_checkpoint_early_stop(early_stop):
                x, a = checkpoint(layer, x, lp, use_reentrant=False)
        else:
            x, a = layer(x, lp)
        aux = aux + a
    return x, aux


def head(params, x, cfg: TransformerConfig, mesh=None):
    """final_norm and lm_head (column-parallel over tp): the logits."""
    tp = None if mesh is None else tp_group(mesh)
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return copy_to_tp(x, tp) @ params["lm_head"]


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
    return token_nll(logits, tgt, mesh).mean() + aux


def token_nll(logits, tgt, mesh=None):
    """Per-token f32 cross-entropy of ``logits`` against ``tgt``:
    vocab-parallel over the tp group of ``mesh``
    (:func:`vocab_parallel_nll`), the plain log-softmax otherwise."""
    tp = None if mesh is None else tp_group(mesh)
    if tp is not None:
        return vocab_parallel_nll(logits, tgt, tp)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, tgt[..., None].long())[..., 0]


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
    raises the reference's ValueError; compositions not ported yet
    raise NotImplementedError (:func:`~horovod_tpu_torch.parallel.mesh.
    check_ported`); a codec with no data axis raises."""
    model = {a: mesh_axis_size(mesh, a) for a in ("pp", "sp", "tp", "ep")
             if mesh_axis_size(mesh, a) > 1}
    if model and codec != "none":
        raise ValueError(
            f"make_train_step(compression={codec!r}) quantizes the "
            f"data-parallel gradient allreduce and the fsdp gradient "
            f"reduce-scatter; mesh axes {sorted(model.items())} "
            "have no explicit gradient collective to intercept. Use a "
            "dp/fsdp mesh, or compression=None.")
    check_ported(mesh)
    if "pp" in model:
        raise ValueError(
            f"a mesh with pp={model['pp']} trains through the pipeline: "
            "use horovod_tpu_torch.parallel.make_pp_train_step (GPipe) "
            "or make_pp_train_step_1f1b")
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
    codec with tp/sp/pp/ep, or with no data axis, raises.

    On a mesh with ep > 1 (with dp and tp; ``cfg.n_experts > 0`` puts
    the MoE block in every layer) each rank holds its ``E / ep``
    experts and every ep rank runs the same rows; each gradient is
    reduced over the ranks that hold the same shard of its leaf
    (:func:`reduce_gradients`), and the loss is the Average over dp. A
    pp mesh trains through :mod:`horovod_tpu_torch.parallel.pipeline`.
    """
    codec = in_jit_codec(compression)
    if mesh is None and codec != "none":
        raise ValueError("compression= needs a data axis ('dp', or 'fsdp' "
                         "> 1); no mesh was given")
    nfsdp = 1 if mesh is None else _dispatch_mesh(mesh, codec)
    if mesh is not None:
        _check_shardable(cfg, mesh)
    device = resolve_device(device)
    if mesh is not None and mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot train on "
                         f"{device}")
    make_opt = default_optimizer if optimizer is None else optimizer
    if nfsdp > 1:
        return _make_fsdp_train_step(cfg, device, make_opt, mesh,
                                     compression, codec)
    if mesh is not None:
        prepare_groups(mesh)
    group = None if mesh is None else replica_group(mesh, "expert")
    by_kind = mesh is not None and mesh_axis_size(mesh, "ep") > 1
    use_ef = needs_error_feedback(compression)

    def init_state(generator: Optional[torch.Generator] = None, *,
                   params: Optional[Dict[str, Any]] = None):
        params = _adopt(cfg, device, generator, params)
        if mesh is not None:
            broadcast_parameters(params, 0, None)
            params = map_params(lambda p: p.requires_grad_(True),
                                shard_params(params, cfg, mesh))
        opt = make_opt(param_leaves(params))
        if mesh is not None and not by_kind:
            opt = DistributedOptimizer(opt, group=group,
                                       compression=compression)
        state = {"params": params, "opt": opt, "step": 0}
        if use_ef:
            state["ef"] = params_from_leaves(opt.ef, params)
        return state

    def step(state, batch):
        opt = state["opt"]
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(state["params"], batch, cfg, mesh)
        loss.backward()
        if by_kind:
            reduce_gradients(state["params"], mesh)
        opt.step()
        state["step"] += 1
        if use_ef:
            state["ef"] = params_from_leaves(opt.ef, state["params"])
        loss = loss.detach()
        if mesh is not None:
            loss = collectives.allreduce(loss, Average, group)
        return state, loss

    return init_state, step


def reduce_gradients(params, mesh) -> None:
    """Reduce the ``.grad`` of every leaf of this rank's ``params`` over
    the ranks that hold the same shard of it
    (:func:`~horovod_tpu_torch.parallel.mesh.replica_group` of its
    :func:`leaf_kind`), one grouped all-reduce a kind: an expert leaf
    over dp, another layer leaf over dp x ep (whose ranks computed it
    alike), embed/final_norm/lm_head over dp x pp x ep. Those are used
    by one stage only (embed by the first, the head by the last), so
    over pp the other stages add zeros: a Sum, scaled by ``pp / size``,
    which is the Average over the other axes. A leaf no gradient
    reached counts as zeros. The reduced values are equal on every rank
    of the group."""
    pp = mesh_axis_size(mesh, "pp")
    kinds = {}
    for name, p in named_param_leaves(params):
        kinds.setdefault(leaf_kind(name), []).append(p)
    for kind, ps in kinds.items():
        group = replica_group(mesh, kind)
        n = collectives.axis_size(group)
        if n == 1:
            continue
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in ps]
        if kind == "top" and pp > 1:
            red = collectives.grouped_allreduce(grads, Sum, group,
                                                postscale_factor=pp / n)
        else:
            red = collectives.grouped_allreduce(grads, Average, group)
        for p, g in zip(ps, red):
            p.grad = g


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
        state = {"params": params_from_leaves(shards, params),
                 "opt": make_opt(shards), "step": 0}
        if use_ef:
            ef = {"fsdp": map_params(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)}
            if dp_hop:
                ef["dp"] = map_params(
                    lambda s: torch.zeros_like(s, dtype=torch.float32),
                    state["params"])
            state["ef"] = ef
        return state

    def step(state, batch):
        shards = param_leaves(state["params"])
        full = [(s.detach() if d is None else collectives.allgather(
            s.detach(), fg, axis=d)).requires_grad_(True)
            for s, d in zip(shards, dim_leaves)]
        loss = lm_loss(params_from_leaves(full, state["params"]), batch,
                       cfg, view)
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
            state["ef"] = {"fsdp": params_from_leaves(new_rs,
                                                      state["params"])}
            if dp_hop:
                state["ef"]["dp"] = params_from_leaves(new_dp,
                                                       state["params"])
        loss = loss.detach()
        for g in (dpg, fg):
            if g is not None:
                loss = collectives.allreduce(loss, Average, g)
        return state, loss

    return init_state, step


def gather_params(state, cfg: TransformerConfig, mesh) -> Dict[str, Any]:
    """The full parameters of a train step's ``state``: every leaf's
    shards all-gathered along the dim each axis splits
    (:func:`shard_dims`), over the fsdp, tp, ep and pp groups in turn
    (the tree itself where the mesh shards nothing)."""
    params = state["params"]
    if mesh is None:
        return params
    groups = {"fsdp": data_groups(mesh)[1], "tp": tp_group(mesh),
              "ep": ep_group(mesh), "pp": pp_group(mesh)}
    out = []
    for p, dims in zip(param_leaves(params),
                       param_leaves(shard_dims(cfg, mesh))):
        p = p.detach()
        for axis, d in dims:
            p = collectives.allgather(p, groups[axis], axis=d)
        out.append(p)
    return params_from_leaves(out, params)


def shard_batch(tokens, mesh):
    """This rank's block of a global ``[B, T+1]`` token batch on
    ``mesh``: the rank at ``(d, f, p, s, t, e)`` takes row block ``d *
    fsdp + f`` of ``dp * fsdp`` equal blocks, as the reference shards
    the batch over ``("dp", "fsdp")``, and, with sp > 1, sequence chunk
    ``s`` of ``sp`` (columns ``[s·T/sp, (s+1)·T/sp]``: the chunk and
    the token after it, so :func:`lm_loss`'s shift gives the chunk's
    inputs and targets); every pp, tp and ep rank takes the same block.
    ``B`` must divide by ``dp * fsdp`` and ``T`` by ``sp``."""
    check_ported(mesh)
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
