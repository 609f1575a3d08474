"""Llama-family decoder LM in PyTorch — the counterpart of
:mod:`horovod_tpu.models.transformer`, on one device or data-parallel
over a process group.

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
device, as in the reference.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch.binding import (DistributedOptimizer,
                                       broadcast_parameters)
from horovod_tpu_torch.common.ops_enum import Average
from horovod_tpu_torch.compression import QUANTIZED_TODO, in_jit_codec
from horovod_tpu_torch.device import resolve_device
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.parallel.mesh import dp_group
from horovod_tpu_torch.parallel.ring_attention import make_sp_attention

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


def decoder_layer(cfg: TransformerConfig, attend, x, lp, pos_offset=0):
    """One pre-norm decoder block (attention + dense SwiGLU FFN) on
    ``x`` [B, T, D]; ``lp`` is this layer's param dict (no leading L
    dim). Returns ``(x, aux)``, aux 0 for the dense FFN."""
    if cfg.n_experts > 0:
        raise NotImplementedError(_MOE_TODO)
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, T = x.shape[0], x.shape[1]
    pos = torch.arange(T, device=x.device) + pos_offset

    h = _rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(B, T, H, Dh)
    kk = (h @ lp["wk"]).reshape(B, T, Hkv, Dh)
    vv = (h @ lp["wv"]).reshape(B, T, Hkv, Dh)
    q = _rope(q, pos, cfg.rope_theta)
    kk = _rope(kk, pos, cfg.rope_theta)
    if Hkv != H and not getattr(attend, "handles_gqa", False):
        rep = H // Hkv
        kk = torch.repeat_interleave(kk, rep, dim=2)
        vv = torch.repeat_interleave(vv, rep, dim=2)
    o = attend(q, kk, vv).reshape(B, T, H * Dh)
    x = x + (o @ lp["wo"]).to(cfg.dtype)

    h = _rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    g = F.silu((h @ lp["w_gate"]).float())
    u = (h @ lp["w_up"]).float()
    x = x + ((g * u).to(cfg.dtype) @ lp["w_down"]).to(cfg.dtype)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward_with_aux(params, tokens, cfg: TransformerConfig, mesh=None):
    """tokens ``[B, T]`` integer → (logits ``[B, T, V]``, aux_loss).

    With ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``
    and is recomputed whole in the backward, whatever
    ``cfg.remat_policy`` says. ``mesh`` (a data-parallel mesh, whose
    ranks each run their own rows) selects the attention as in the
    reference."""
    attend = make_sp_attention(mesh, impl=cfg.sp_attention, causal=True)
    layer = functools.partial(decoder_layer, cfg, attend)
    x = params["embed"].to(cfg.dtype)[tokens.long()]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    stacked = params["layers"]
    for i in range(stacked["wq"].shape[0]):
        lp = {name: w[i] for name, w in stacked.items()}
        if cfg.remat:
            x, a = checkpoint(layer, x, lp, use_reentrant=False)
        else:
            x, a = layer(x, lp)
        aux = aux + a
    x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"], aux


def forward(params, tokens, cfg: TransformerConfig, mesh=None):
    """tokens ``[B, T]`` → logits ``[B, T, V]`` (cfg.dtype)."""
    return forward_with_aux(params, tokens, cfg, mesh)[0]


def lm_loss(params, batch, cfg: TransformerConfig, mesh=None):
    """Next-token cross-entropy (f32 log-softmax, mean over B·T) over
    ``batch["tokens"]`` [B, T+1] plus the aux term; returns a scalar."""
    tokens = batch["tokens"]
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    logits, aux = forward_with_aux(params, inp, cfg, mesh)
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
    :class:`~horovod_tpu_torch.binding.DistributedOptimizer` (one
    grouped Average allreduce of every gradient before the update, so
    every rank applies the same one), and the returned loss is the
    Average of the ranks' losses, the global mean, as the reference's
    dp step returns it. ``compression`` (the quantized gradient path,
    ROADMAP Queue 1 item 8) and mesh axes other than dp (item 9) raise.
    """
    if cfg.n_experts > 0:
        raise NotImplementedError(_MOE_TODO)
    if in_jit_codec(compression) != "none":
        raise NotImplementedError(
            f"make_train_step(compression={in_jit_codec(compression)}): "
            f"{QUANTIZED_TODO}")
    group = None if mesh is None else dp_group(mesh)
    device = resolve_device(device)
    if mesh is not None and mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot train on "
                         f"{device}")
    make_opt = default_optimizer if optimizer is None else optimizer

    def init_state(generator: Optional[torch.Generator] = None, *,
                   params: Optional[Dict[str, Any]] = None):
        if (generator is None) == (params is None):
            raise ValueError("init_state takes a generator or params=, "
                             "not both or neither")
        if params is None:
            params = init_params(cfg, generator, device)
        leaves = param_leaves(params)
        for p in leaves:
            if p.device != device:
                raise ValueError(f"parameter on {p.device}, train step on "
                                 f"{device}")
            p.requires_grad_(True)
        opt = make_opt(leaves)
        if mesh is not None:
            broadcast_parameters(params, 0, group)
            opt = DistributedOptimizer(opt, group=group)
        return {"params": params, "opt": opt, "step": 0}

    def step(state, batch):
        opt = state["opt"]
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(state["params"], batch, cfg, mesh)
        loss.backward()
        opt.step()
        state["step"] += 1
        loss = loss.detach()
        if mesh is not None:
            loss = collectives.allreduce(loss, Average, group)
        return state, loss

    return init_state, step


def shard_batch(tokens, mesh):
    """This rank's rows of a global ``[B, T+1]`` token batch on a
    data-parallel ``mesh``: rank ``r`` of ``dp`` takes rows
    ``[r·B/dp, (r+1)·B/dp)``, as the reference shards the batch over
    ``("dp", "fsdp")``. ``B`` must divide by dp."""
    group = dp_group(mesh)
    dp, r = collectives.axis_size(group), collectives.axis_rank(group)
    if tokens.shape[0] % dp:
        raise ValueError(f"global batch of {tokens.shape[0]} rows does not "
                         f"divide over dp={dp}")
    rows = tokens.shape[0] // dp
    return tokens[r * rows:(r + 1) * rows]
