"""Flash attention for the port: a hand-written Hopper kernel for the
forward, the recompute-from-logsumexp backward in PyTorch.

Counterpart of :mod:`horovod_tpu.ops.flash_attention`. The forward is
``csrc/flash_fwd.cu`` (the twin of the Pallas ``_fwd_kernel``), reached
through :func:`flash_fwd_cuda`; its plain PyTorch version
:func:`flash_fwd_reference` runs the same blocked online softmax. A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or
raises — nothing falls back. The backward (``_bwd``, ``_bwd_rows``,
``_bwd_chunked``) was XLA math in the reference and is PyTorch math
here, recomputing the probabilities from the saved logsumexp.

    out = flash_attention(q, k, v, causal=True)   # [B, T, H, D] each
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30

# Keys per block of the plain forward. Any size gives the same values
# to rounding; the kernel picks its own tiles.
_REF_BLOCK_K = 128


def flash_fwd_reference(q, k, v, *, scale: float, causal: bool,
                        out_dtype=None, q_per_kv: int = 1):
    """Plain PyTorch version of the forward kernel.

    q: ``[BH, T, D]``; k/v: ``[BH / q_per_kv, T, D]`` (the [B, H]
    flattening is batch-major, so query head ``bh`` reads kv head
    ``bh // q_per_kv``). Returns ``(out [BH, T, D] in out_dtype or
    q.dtype, lse [BH, T] f32)``.

    The same blocked online softmax as ``_fwd_kernel``: f32 scores,
    finite ``NEG_INF`` masks, running max ``m`` and normaliser ``l``,
    ``safe_l`` for rows with nothing to attend, ``lse = m + log l``.
    Keys are walked in blocks without padding T: a padded key of the
    reference is masked to ``NEG_INF`` and adds exactly zero once a
    row's max is finite, which the first block already makes it (the
    causal diagonal starts at key 0), so leaving it out changes nothing;
    likewise the causal block skip only leaves out blocks that add zero.
    """
    bh, t, d = q.shape
    bkv = k.shape[0]
    out_dtype = q.dtype if out_dtype is None else out_dtype
    qf = q.float().reshape(bkv, q_per_kv, t, d)
    kf, vf = k.float(), v.float()
    acc = torch.zeros_like(qf)
    m = torch.full((bkv, q_per_kv, t, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    q_pos = torch.arange(t, device=q.device)[:, None]
    for k0 in range(0, t, _REF_BLOCK_K):
        kb, vb = kf[:, k0:k0 + _REF_BLOCK_K], vf[:, k0:k0 + _REF_BLOCK_K]
        s = torch.einsum("brqd,bkd->brqk", qf, kb) * scale
        if causal:
            k_pos = torch.arange(k0, k0 + kb.shape[1], device=q.device)
            s = s.masked_fill(k_pos[None, :] > q_pos, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("brqk,bkd->brqd", p, vb)
        m = m_new
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    out = (acc / safe_l).to(out_dtype).reshape(bh, t, d)
    lse = (m + torch.log(safe_l))[..., 0].reshape(bh, t)
    return out, lse


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def kernel_tolerance(dtype, out_dtype, v_absmax: float):
    """How far the kernel's result may lie from
    :func:`flash_fwd_reference` on the same inputs:
    ``(atol, rtol)`` for ``out`` and ``atol`` for ``lse``.

    f32 inputs run f32 arithmetic throughout: only summation order
    differs. bf16 inputs round P to bf16 for the tensor-core P·V
    product (the reference keeps P in f32): each p_j moves by at most
    2^-9 relative while l sums the unrounded p, so ``out`` moves by at
    most ``2^-9 · max|v|``. A bf16 ``out`` may then round to the
    neighbouring bf16 value, one ulp, at most 2^-7 relative."""
    if dtype == torch.float32:
        return 1e-5, 1e-5, 1e-5
    out_dtype = dtype if out_dtype is None else out_dtype
    rtol = 2.0 ** -7 if out_dtype == torch.bfloat16 else 1e-5
    return 2.0 ** -9 * v_absmax + 1e-5, rtol, 1e-4


def _lib():
    from horovod_tpu_torch.ops import _kernels
    lib = _kernels.load("flash_fwd")
    fn = lib.hvd_flash_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_float, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def flash_fwd_cuda(q, k, v, *, scale: float, causal: bool, out_dtype=None,
                   q_per_kv: int = 1):
    """Launch ``csrc/flash_fwd.cu`` on CUDA tensors: same contract as
    :func:`flash_fwd_reference`. Raises on anything the kernel does not
    take (device, dtype, head dim, shape, layout, a bf16 scale <= 0) or
    a launch that fails; never computes the result another way.
    ``flash_fwd_cuda.launches`` counts launches."""
    out_dtype = q.dtype if out_dtype is None else out_dtype
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"flash_fwd_cuda: {name} is on {x.device}; "
                             f"q, k and v must share one CUDA device")
        if x.dtype != q.dtype or x.dtype not in _DTYPE_CODE:
            raise TypeError(f"flash_fwd_cuda: {name} is {x.dtype}; q, k "
                            f"and v must all be float32 or bfloat16")
        if x.dim() != 3 or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_fwd_cuda: {name} must be a "
                             f"contiguous, 16-byte aligned 3-d tensor")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_fwd_cuda: out_dtype {out_dtype} is not "
                        f"float32 or bfloat16")
    bh, t, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_fwd_cuda: head dim {d} is not one of "
                         f"{_HEAD_DIMS}")
    if (q_per_kv < 1 or bh % q_per_kv or bh > 65535
            or k.shape != (bh // q_per_kv, t, d) or v.shape != k.shape):
        raise ValueError(f"flash_fwd_cuda: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"fit q_per_kv={q_per_kv}")
    if q.dtype == torch.bfloat16 and not scale > 0:
        # The bf16 kernel keeps the row max of the unscaled scores.
        raise ValueError(f"flash_fwd_cuda: the bf16 kernel takes scale > 0, "
                         f"not {scale}")
    out = torch.empty((bh, t, d), dtype=out_dtype, device=q.device)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):   # the launch goes to q's card
        rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), lse.data_ptr(), bh, t, d, q_per_kv,
                    float(scale), int(causal), _DTYPE_CODE[q.dtype],
                    _DTYPE_CODE[out_dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd_cuda: kernel launch failed with "
                           f"CUDA error {rc}")
    flash_fwd_cuda.launches += 1
    return out, lse


flash_fwd_cuda.launches = 0


def _fwd(q, k, v, *, scale, causal, out_dtype=None, q_per_kv: int = 1):
    """The forward on the tensors' device: the plain version for CPU
    tensors, the kernel for anything else (which raises off CUDA)."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, scale=scale, causal=causal,
                                   out_dtype=out_dtype, q_per_kv=q_per_kv)
    return flash_fwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                          scale=scale, causal=causal, out_dtype=out_dtype,
                          q_per_kv=q_per_kv)


# Above this query length the backward recompute runs q-chunked: the
# dense form materializes [B·H, Tq, Tk] f32 score/probability tensors
# (O(T²) memory); the chunked form caps live intermediates at
# [B·H, chunk, Tk].
_BWD_CHUNK_T = 4096
_BWD_CHUNK = 1024


def _bwd(scale, causal, residuals, g, g_lse=None, q_per_kv: int = 1):
    """Recompute-based backward from the saved logsumexp (f32 math):
    d lse/d q = (p @ k)·scale and d lse/d k_j = p_j · q · scale carry
    ``g_lse`` when the caller consumed the logsumexp. GQA groups the
    ``q_per_kv`` consecutive query heads of each kv head and sums dk/dv
    over the group. Long sequences take the q-chunked form."""
    if residuals[0].shape[1] > _BWD_CHUNK_T:
        return _bwd_chunked(scale, causal, residuals, g, g_lse, q_per_kv)
    q, k, v, out, lse = residuals
    bkv, t, d = k.shape[0], q.shape[1], q.shape[2]

    def as_grp(x):
        return x.float().reshape(bkv, q_per_kv, t, d)

    gl = (None if g_lse is None
          else g_lse.float().reshape(bkv, q_per_kv, t))
    dq, dk, dv = _bwd_rows(
        as_grp(q), as_grp(g), as_grp(out), lse.reshape(bkv, q_per_kv, t),
        gl, k.float(), v.float(), 0, scale, causal)
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _bwd_rows(qc, doc, outc, lsec, glc, kf, vf, q_pos0, scale, causal):
    """Gradient contributions of one block of query rows (f32 in/out),
    shared by the dense and chunked backwards. ``q_pos0`` is the block's
    first query position, for the causal mask."""
    tk = kf.shape[1]
    s = torch.einsum("brqd,bkd->brqk", qc, kf) * scale
    if causal:
        q_pos = q_pos0 + torch.arange(qc.shape[2], device=qc.device)[:, None]
        k_pos = torch.arange(tk, device=qc.device)[None, :]
        s = s.masked_fill(k_pos > q_pos, NEG_INF)
    p = torch.exp(s - lsec[..., None])           # [bkv, rep, rows, tk]
    # s and dp are dropped as soon as they are used: each is a
    # [bkv, rep, rows, tk] f32 tensor (2.1 GB at T=2048, B·H=128).
    del s

    dv = torch.einsum("brqk,brqd->bkd", p, doc)
    dp = torch.einsum("brqd,bkd->brqk", doc, vf)
    delta = torch.sum(doc * outc, dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    del dp
    dq = torch.einsum("brqk,bkd->brqd", ds, kf)
    dk = torch.einsum("brqk,brqd->bkd", ds, qc)
    if glc is not None:
        dq = dq + (glc[..., None] * torch.einsum("brqk,bkd->brqd", p, kf)
                   * scale)
        dk = dk + torch.einsum("brqk,brqd->bkd", glc[..., None] * p,
                               qc) * scale
    return dq, dk, dv


def _bwd_chunked(scale, causal, residuals, g, g_lse, q_per_kv):
    """:func:`_bwd` with the query axis walked in ``_BWD_CHUNK``-row
    slices, so per-step tensors are [bkv, rep, chunk, tk]. dk/dv
    accumulate in f32 in chunk order; the last slice is simply shorter
    (the reference's zero padding rows add exactly zero)."""
    q, k, v, out, lse = residuals
    bkv, t, d = k.shape[0], q.shape[1], q.shape[2]

    def grp(x):
        return x.reshape(bkv, q_per_kv, t, d)

    qg, dog, outg = grp(q), grp(g), grp(out)
    lseg = lse.reshape(bkv, q_per_kv, t)
    gl = (None if g_lse is None
          else g_lse.float().reshape(bkv, q_per_kv, t))
    kf, vf = k.float(), v.float()
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    dq = torch.empty((bkv, q_per_kv, t, d), dtype=q.dtype, device=q.device)
    for c0 in range(0, t, _BWD_CHUNK):
        sl = slice(c0, c0 + _BWD_CHUNK)
        dq_c, dk_c, dv_c = _bwd_rows(
            qg[:, :, sl].float(), dog[:, :, sl].float(),
            outg[:, :, sl].float(), lseg[:, :, sl],
            None if gl is None else gl[:, :, sl], kf, vf, c0, scale,
            causal)
        dk += dk_c
        dv += dv_c
        dq[:, :, sl] = dq_c.to(q.dtype)
    return dq.reshape(q.shape), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """Twin of the reference's ``_flash`` custom VJP: the kernel
    forward, the recompute backward from the saved logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, q_per_kv):
        out, lse = _fwd(q, k, v, scale=scale, causal=causal,
                        q_per_kv=q_per_kv)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, q_per_kv)
        return out

    @staticmethod
    def backward(ctx, g):
        scale, causal, q_per_kv = ctx.args
        dq, dk, dv = _bwd(scale, causal, ctx.saved_tensors, g,
                          q_per_kv=q_per_kv)
        return dq, dk, dv, None, None, None


class _FlashLse(torch.autograd.Function):
    """Twin of the reference's ``_flash_lse``: differentiable in both
    ``out`` and ``lse``."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, out_dtype, q_per_kv):
        out, lse = _fwd(q, k, v, scale=scale, causal=causal,
                        out_dtype=out_dtype, q_per_kv=q_per_kv)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, q_per_kv)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        scale, causal, q_per_kv = ctx.args
        dq, dk, dv = _bwd(scale, causal, ctx.saved_tensors, g_out, g_lse,
                          q_per_kv=q_per_kv)
        return dq, dk, dv, None, None, None, None


def flash_attention_with_lse(q, k, v, *, causal: bool = False,
                             scale: Optional[float] = None, out_dtype=None):
    """``[BH, T, D]``-layout flash attention returning ``(out, lse)``,
    the building block for blockwise composition (ring attention merges
    per-chunk results by logsumexp weighting). Differentiable in both
    outputs. ``out_dtype=torch.float32`` keeps chunk outputs at merge
    precision."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashLse.apply(q, k, v, float(scale), causal, out_dtype, 1)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """Fused attention over ``[B, T, H, D]`` q with ``[B, T, Hkv, D]``
    k/v, ``H % Hkv == 0``. GQA runs natively: the kernel reads kv head
    ``h // (H / Hkv)`` for query head ``h``, so grouped K/V are never
    copied per query head. Differentiable; the kernel picks its own
    tiles."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, t, h, d = q.shape
    hkv = k.shape[2]
    if h % hkv or v.shape[2] != hkv:
        raise ValueError(
            f"q heads ({h}) must be a multiple of kv heads ({hkv}); "
            f"v has {v.shape[2]}")

    def to_bh(x):
        return x.transpose(1, 2).reshape(b * x.shape[2], t, d)

    out = _Flash.apply(to_bh(q), to_bh(k), to_bh(v), float(scale), causal,
                       h // hkv)
    return out.reshape(b, h, t, d).transpose(1, 2)
