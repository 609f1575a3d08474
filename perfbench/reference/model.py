"""Plain PyTorch reference of the benchmark's decoder LM, its loss, its
gradients and AdamW: what the timed step has to compute.

It imports ``torch`` and the harness's own helpers: nothing of the
program, nothing of JAX. It takes
the weights and token ids the harness made from the seed (the tree
:mod:`perfbench.weights` lays out) and nothing the program derived
from them. Arithmetic is float32 with TF32 off (:func:`exact_matmuls`).

The model, per layer (pre-norm): RMSNorm; q, k, v projections; rotary
embedding on interleaved pairs ``(x[..., 0::2], x[..., 1::2])`` at
positions ``0..T-1`` (the program's convention; the published
checkpoints' rotate-half layout is the same rotation on a permuted head
dim); causal grouped-query attention, query head ``h`` reading kv head
``h // (H / Hkv)``, scale ``head_dim^-0.5``; the output projection and
the residual; RMSNorm; a SwiGLU FFN ``(silu(h W_g) * (h W_u)) W_d``, or
the MoE block: float32 router logits, softmax over every expert, the
``top_k`` experts of each token (ties to the lower index), their gates
renormalised to sum to 1 (floor 1e-9), and the gate-weighted sum of
those experts' SwiGLU outputs. Every claim is kept: the harness runs
the program at a capacity of the whole row (:func:`check_dropless`).
The load-balancing term is Switch's ``coef · E · Σ_e f_e · p_e`` (``f``
the top-1 share of each expert, with no gradient, ``p`` its mean
probability) over the batch, summed over layers and added to the mean
next-token cross-entropy.

AdamW is torch's (decoupled decay, ``eps`` added to the bias-corrected
root), computed in float32. Its results are stored in each leaf's own
dtype, as the configuration states its parameters and optimizer state:
a bfloat16 norm weight at 1.0 cannot move by a step of 3e-4 (half an
ulp there is 2^-9), in the program or in any implementation of the
configuration, and neither does it here.

:data:`FP8` is the control: the same model computed a precision below
the configuration's bfloat16, float8 e4m3 (one scale a tensor) at every
place the program holds bfloat16 and for every matrix product's
operands, forward and backward (:class:`Precision`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.norms import leaf_norm
from perfbench.weights import to_tree

@contextlib.contextmanager
def exact_matmuls():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def f32_matmul(a, b):
    return torch.matmul(a, b)


def same(x):
    return x


FP8_MAX = 448.0   # largest finite float8 e4m3fn


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude maps to 448), returned in float32."""
    scale = FP8_MAX / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    lead = g.dim() - len(shape)
    if lead:
        g = g.sum(tuple(range(lead)))
    return g


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = round_fp8(a), round_fp8(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = round_fp8(g)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        gb = _sum_to(torch.matmul(qa.transpose(-1, -2), qg), qb.shape)
        return ga, gb


def fp8_matmul(a, b):
    return _Fp8Matmul.apply(a, b)


class _Fp8Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g)


def fp8_round(x):
    """``x`` rounded to float8, and its gradient too."""
    return _Fp8Round.apply(x)


@dataclasses.dataclass(frozen=True)
class Precision:
    """How the reference computes: ``mm`` each matrix product, ``rnd``
    each tensor where the program holds the configuration's dtype (the
    embedding rows, a norm's output, each product's result, q and k
    after the rotation, attention's probabilities and output, the
    residual stream, the SwiGLU hidden product, the MoE gates and output,
    the logits), forward and backward."""
    name: str
    mm: Callable
    rnd: Callable


F32 = Precision("float32", f32_matmul, same)
#: The control: the configuration's bfloat16 places in float8 e4m3.
FP8 = Precision("float8", fp8_matmul, fp8_round)


def check_dropless(spec) -> None:
    """The reference keeps every claim; the program keeps every claim
    when each expert's capacity ``ceil(top_k · T · cf / E)`` is at least
    ``T`` (a token claims an expert once)."""
    if spec.n_experts and spec.capacity_factor * spec.top_k < spec.n_experts:
        raise ValueError(
            f"capacity factor {spec.capacity_factor} drops claims "
            f"(under E / top_k = {spec.n_experts / spec.top_k}); the "
            f"reference is dropless")


def rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, theta):
    """Rotary embedding of ``x`` ``[B, T, H, Dh]`` on interleaved pairs."""
    t, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None, :]
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).flatten(-2)


def attention(q, k, v, prec: Precision):
    """Causal GQA over ``[B, T, H, Dh]`` q and ``[B, T, Hkv, Dh]`` k/v,
    one row of the batch at a time; ``[B, T, H·Dh]``."""
    b, t, h, d = q.shape
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).triu(1)
    rows = []
    for i in range(b):
        qi, ki, vi = (x[i].transpose(0, 1) for x in (q, k, v))  # [H, T, Dh]
        s = prec.mm(qi, ki.transpose(-1, -2)) * d ** -0.5
        p = prec.rnd(torch.softmax(s.masked_fill(mask, float("-inf")),
                                   dim=-1))
        rows.append(prec.mm(p, vi).transpose(0, 1).reshape(t, h * d))
    return prec.rnd(torch.stack(rows))


def linear(x, w, prec: Precision):
    """``x @ w`` over the last dim of ``x``."""
    y = prec.mm(x.reshape(-1, x.shape[-1]), w)
    return prec.rnd(y.reshape(*x.shape[:-1], w.shape[-1]))


def swiglu(h, wg, wu, wd, prec: Precision):
    hidden = prec.rnd(F.silu(linear(h, wg, prec)) * linear(h, wu, prec))
    return linear(hidden, wd, prec)


def moe(h, lp, spec, prec: Precision):
    """The MoE block on ``h`` ``[B, T, D]``: ``(y, aux)``. The router's
    product is float32 at every precision (the configuration keeps the
    router in float32)."""
    b, t, d = h.shape
    x = h.reshape(b * t, d)
    e_n, k_n = spec.n_experts, spec.top_k
    probs = torch.softmax(x @ lp["router"], dim=-1)              # [N, E]
    top = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[:, :k_n]               # [N, K]
    gates = probs.gather(-1, top)
    gates = prec.rnd(gates / gates.sum(-1, keepdim=True).clamp_min(1e-9))
    y = torch.zeros_like(x)
    for e in range(e_n):
        rows, which = torch.nonzero(top == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        out = swiglu(x[rows], lp["w_gate"][e], lp["w_up"][e],
                     lp["w_down"][e], prec)
        y = y.index_add(0, rows, out * gates[rows, which][:, None])
    f = F.one_hot(top[:, 0], e_n).float().mean(0)
    aux = spec.aux_coef * e_n * torch.sum(f * probs.mean(0))
    return prec.rnd(y.reshape(b, t, d)), aux


def layer(spec, prec: Precision, x, lp):
    """One decoder layer on ``x`` ``[B, T, D]``: ``(x, aux)``."""
    b, t, _ = x.shape
    dh, rnd = spec.head_dim, prec.rnd
    h = rnd(rmsnorm(x, lp["attn_norm"], spec.norm_eps))
    q = rnd(rope(linear(h, lp["wq"], prec).reshape(b, t, -1, dh),
                 spec.rope_theta))
    k = rnd(rope(linear(h, lp["wk"], prec).reshape(b, t, -1, dh),
                 spec.rope_theta))
    v = linear(h, lp["wv"], prec).reshape(b, t, -1, dh)
    x = rnd(x + linear(attention(q, k, v, prec), lp["wo"], prec))
    h = rnd(rmsnorm(x, lp["mlp_norm"], spec.norm_eps))
    if "moe" in lp:
        y, aux = moe(h, lp["moe"], spec, prec)
    else:
        y = swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"], prec)
        aux = torch.zeros((), device=x.device)
    return rnd(x + y), aux


def _layer_params(layers, i):
    return {k: (_layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


def loss_fn(params, tokens, spec, prec: Precision = F32):
    """Mean next-token cross-entropy of ``tokens`` ``[B, T+1]`` plus the
    load-balancing terms; each layer recomputed in the backward
    (``checkpoint``), so one layer's activations are live at a time."""
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    x = prec.rnd(params["embed"][inp])
    aux = torch.zeros((), device=x.device)
    for i in range(spec.n_layers):
        x, a = checkpoint(layer, spec, prec, x,
                          _layer_params(params["layers"], i),
                          use_reentrant=False)
        aux = aux + a
    h = prec.rnd(rmsnorm(x, params["final_norm"], spec.norm_eps))
    logits = linear(h, params["lm_head"], prec)
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          tgt.reshape(-1))
    return nll + aux


class AdamW:
    """torch's AdamW (lr 3e-4, betas 0.9/0.999, eps 1e-8, decay 0.01:
    the program's ``default_optimizer``), computed in float32, its
    parameters and moments stored in each leaf's dtype."""

    def __init__(self, stored: List[torch.Tensor], lr=3e-4,
                 betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01):
        self.p = stored
        self.m = [torch.zeros_like(p) for p in stored]
        self.v = [torch.zeros_like(p) for p in stored]
        self.lr, (self.b1, self.b2) = lr, betas
        self.eps, self.wd, self.t = eps, weight_decay, 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = math.sqrt(1 - self.b2 ** self.t)
        for p, m, v, g in zip(self.p, self.m, self.v, grads):
            g = g.float()
            m.copy_(m.float() * self.b1 + g * (1 - self.b1))
            v.copy_(v.float() * self.b2 + g * g * (1 - self.b2))
            denom = v.float().sqrt() / bc2 + self.eps
            new = p.float() * (1 - self.lr * self.wd) \
                - (self.lr / bc1) * m.float() / denom
            p.copy_(new)


def train(named_params, batches, spec, prec: Precision = F32,
          average: Optional[Callable] = None):
    """Train from ``named_params`` (``(name, tensor)`` in the stored
    dtypes; updated in place) on ``batches`` (one ``[B, T+1]`` token
    tensor a step). ``average(loss, grads) -> (loss, grads)``, where
    given, reduces over the data-parallel ranks. Returns the readings
    ``{"loss": [a step], "grad": {leaf: the first step's gradient
    norm}}``; the parameters' change is read by the caller against the
    weights made again."""
    check_dropless(spec)
    names = [n for n, _ in named_params]
    stored = [p for _, p in named_params]
    opt = AdamW(stored)
    out = {"loss": [], "grad": {}}
    with exact_matmuls():
        for i, tokens in enumerate(batches):
            work = [p.detach().float().requires_grad_(True) for p in stored]
            loss = loss_fn(to_tree(zip(names, work)), tokens, spec, prec)
            grads = torch.autograd.grad(loss, work)
            loss = loss.detach()
            del work
            if average is not None:
                loss, grads = average(loss, list(grads))
            out["loss"].append(float(loss))
            if i == 0:
                out["grad"] = {n: leaf_norm(g) for n, g in zip(names, grads)}
            opt.step(list(grads))
            del grads
    return out
