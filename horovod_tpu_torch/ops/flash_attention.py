"""Flash attention for the port: hand-written Hopper kernels for the
forward and the backward.

Counterpart of :mod:`horovod_tpu.ops.flash_attention`. The forward is
``csrc/flash_fwd.cu`` (the twin of the Pallas ``_fwd_kernel``), reached
through :func:`flash_fwd_cuda`; its plain PyTorch version
:func:`flash_fwd_reference` runs the same blocked online softmax. The
backward is ``csrc/flash_bwd.cu``, reached through
:func:`flash_bwd_cuda`; its plain version is ``_bwd`` (``_bwd_rows``,
``_bwd_chunked``), XLA math in the reference and PyTorch math here,
recomputing the probabilities from the saved logsumexp. A CPU tensor
takes the plain versions; a CUDA tensor launches the kernels or raises
— nothing falls back.

    out = flash_attention(q, k, v, causal=True)   # [B, T, H, D] each
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from horovod_tpu_torch.metrics import span

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


def _fwd_lib():
    from horovod_tpu_torch.ops import _kernels
    lib = _kernels.load("flash_fwd")
    fn = lib.hvd_flash_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_float, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check_layout(fn, q, k, v, q_per_kv):
    """The q, k, v checks both kernels' wrappers make: float32 or
    bfloat16 alike, contiguous 16-byte aligned 3-d tensors of a head dim
    the kernels take, k/v of ``q_per_kv``-fold fewer heads."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype or x.dtype not in _DTYPE_CODE:
            raise TypeError(f"{fn}: {name} is {x.dtype}; q, k "
                            f"and v must all be float32 or bfloat16")
        if x.dim() != 3 or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be a "
                             f"contiguous, 16-byte aligned 3-d tensor")
    bh, t, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {d} is not one of "
                         f"{_HEAD_DIMS}")
    if (q_per_kv < 1 or bh % q_per_kv or bh > 65535
            or k.shape != (bh // q_per_kv, t, d) or v.shape != k.shape):
        raise ValueError(f"{fn}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"fit q_per_kv={q_per_kv}")


def _check_device(fn, **tensors):
    """Every tensor given (None skipped) on the first one's CUDA
    device."""
    first = next(iter(tensors.values())).device
    for name, x in tensors.items():
        if x is not None and (x.device.type != "cuda" or x.device != first):
            raise ValueError(f"{fn}: {name} is on {x.device}; the kernel "
                             f"takes tensors on one CUDA device")


def flash_fwd_cuda(q, k, v, *, scale: float, causal: bool, out_dtype=None,
                   q_per_kv: int = 1):
    """Launch ``csrc/flash_fwd.cu`` on CUDA tensors: same contract as
    :func:`flash_fwd_reference`. Raises on anything the kernel does not
    take (device, dtype, head dim, shape, layout, a bf16 scale <= 0) or
    a launch that fails; never computes the result another way.
    ``flash_fwd_cuda.launches`` counts launches."""
    out_dtype = q.dtype if out_dtype is None else out_dtype
    _check_layout("flash_fwd_cuda", q, k, v, q_per_kv)
    _check_device("flash_fwd_cuda", q=q, k=k, v=v)
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_fwd_cuda: out_dtype {out_dtype} is not "
                        f"float32 or bfloat16")
    bh, t, d = q.shape
    if q.dtype == torch.bfloat16 and not scale > 0:
        # The bf16 kernel keeps the row max of the unscaled scores.
        raise ValueError(f"flash_fwd_cuda: the bf16 kernel takes scale > 0, "
                         f"not {scale}")
    out = torch.empty((bh, t, d), dtype=out_dtype, device=q.device)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):   # the launch goes to q's card
        rc = _fwd_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
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


def bwd_kernel_tolerance(residuals, g, g_lse=None, *, scale: float,
                         causal: bool, q_per_kv: int = 1):
    """How far the backward kernel's ``(dq, dk, dv)`` may lie from
    ``_bwd``'s on the same inputs: elementwise ``atol`` tensors for the
    three, and one ``rtol`` (``|kernel - plain| <= atol + rtol·|plain|``).

    bf16 inputs: the kernel rounds P to bf16 as the operand of
    dV = Pᵀ·dO, and dS = P∘(dP − δ) as the operand of dQ = dS·K·scale
    and dK = dSᵀ·Q·scale (``_bwd`` keeps both f32). Each rounding moves
    a term by at most 2^-9 of itself, so dV moves by at most
    2^-9·Pᵀ|dO| and dQ, dK by at most 2^-9·|dS|·|K|·scale and
    2^-9·|dS|ᵀ·|Q|·scale; ``atol`` takes 2^-7 of those sums, four times
    the worst case. dS itself carries the f32 error of dP = dO·Vᵀ and
    δ = rowsum(dO∘out), summed in another order than ``_bwd``'s (at
    most D·2^-24 of their absolute terms, which is all of dS where dP
    and δ cancel, as on a causal row's first key): ``atol`` adds
    2^-16·N·|K|·scale and 2^-16·Nᵀ·|Q|·scale, N = P∘(|dO|·|V|ᵀ +
    rowsum(|dO|∘|out|)). An f32 dO beside bf16 inputs is rounded to
    bf16 for dV and dP: dV moves by another 2^-9·Pᵀ|dO| (inside the
    2^-7) and dP by 2^-9 of its terms, so N's factor becomes 2^-7. Both
    sides round their result to bf16 once and may land one ulp apart:
    ``rtol`` 2^-7.

    f32 inputs run f32 arithmetic throughout (exp2 for exp, another
    summation order): 2^-16 on every sum, ``rtol`` 1e-5."""
    f32 = residuals[0].dtype == torch.float32
    eps_ops = 2.0 ** -16 if f32 else 2.0 ** -7
    eps_dp = 2.0 ** -7 if not f32 and g.dtype == torch.float32 \
        else 2.0 ** -16
    mags = _bwd_magnitudes(scale, causal, residuals, g, g_lse, q_per_kv,
                           eps_ops, eps_dp)
    return [m + 1e-6 for m in mags], 1e-5 if f32 else 2.0 ** -7


def _bwd_magnitudes(scale, causal, residuals, g, g_lse, q_per_kv, eps_ops,
                    eps_dp):
    """:func:`bwd_kernel_tolerance`'s sums for dq, dk and dv (f32, in
    their layouts): ``M·|K|·scale``, ``Mᵀ·|Q|·scale`` and
    ``eps_ops·Pᵀ·|dO|``, with ``M = eps_ops·|dS| + eps_dp·N``; the query
    axis walked in ``_BWD_CHUNK`` rows, as ``_bwd_chunked``."""
    q, k, v, out, lse = residuals
    bkv, t, d = k.shape[0], q.shape[1], q.shape[2]

    def grp(x):
        return x.float().reshape(bkv, q_per_kv, t, d)

    qg, dog, outg = grp(q), grp(g), grp(out)
    lseg = lse.float().reshape(bkv, q_per_kv, t)
    kf, vf = k.float(), v.float()
    mq = torch.empty_like(qg)
    mk, mv = torch.zeros_like(kf), torch.zeros_like(vf)
    for c0 in range(0, t, _BWD_CHUNK):
        sl = slice(c0, c0 + _BWD_CHUNK)
        dos, outs = dog[:, :, sl], outg[:, :, sl]
        s = torch.einsum("brqd,bkd->brqk", qg[:, :, sl], kf) * scale
        if causal:
            q_pos = c0 + torch.arange(s.shape[2], device=q.device)[:, None]
            k_pos = torch.arange(t, device=q.device)[None, :]
            s = s.masked_fill(k_pos > q_pos, NEG_INF)
        p = torch.exp(s - lseg[:, :, sl, None])
        del s
        delta = torch.sum(dos * outs, dim=-1)
        if g_lse is not None:
            delta = delta - g_lse.float().reshape(bkv, q_per_kv, t)[:, :, sl]
        ds = p * (torch.einsum("brqd,bkd->brqk", dos, vf) - delta[..., None])
        noise = torch.einsum("brqd,bkd->brqk", dos.abs(), vf.abs()) \
            + torch.sum(dos.abs() * outs.abs(), dim=-1)[..., None]
        m = eps_ops * ds.abs() + eps_dp * p * noise
        del ds, noise
        mq[:, :, sl] = torch.einsum("brqk,bkd->brqd", m, kf.abs()) * scale
        mk += torch.einsum("brqk,brqd->bkd", m, qg[:, :, sl].abs()) * scale
        mv += eps_ops * torch.einsum("brqk,brqd->bkd", p, dos.abs())
    return mq.reshape(q.shape), mk, mv


def _bwd_lib():
    from horovod_tpu_torch.ops import _kernels
    fn = _kernels.load("flash_bwd").hvd_flash_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 13 + [i] * 5 + [ctypes.c_float] + [i] * 4 + [p]
        fn.restype = ctypes.c_int
    return fn


def flash_bwd_cuda(q, k, v, out, lse, g, g_lse=None, *, scale: float,
                   causal: bool, q_per_kv: int = 1):
    """Launch ``csrc/flash_bwd.cu`` on CUDA tensors: the gradients
    ``(dq, dk, dv)`` of ``_bwd`` (in the inputs' dtype) from the
    forward's ``out`` and ``lse``, the output's cotangent ``g`` and,
    where the caller consumed the logsumexp, its cotangent ``g_lse``
    (``[BH, T]`` f32). q: ``[BH, T, D]``; k/v: ``[BH / q_per_kv, T, D]``;
    ``out`` and ``g`` ``[BH, T, D]`` in float32 or bfloat16. Raises on
    anything the kernel does not take (dtype, head dim, shape, layout,
    device) before building it, or on a launch that fails; never
    computes the result another way. ``flash_bwd_cuda.launches`` counts
    launches."""
    fn = "flash_bwd_cuda"
    _check_layout(fn, q, k, v, q_per_kv)
    bh, t, d = q.shape
    for name, x, dtypes, shape in (
            ("out", out, _DTYPE_CODE, (bh, t, d)),
            ("g", g, _DTYPE_CODE, (bh, t, d)),
            ("lse", lse, (torch.float32,), (bh, t)),
            ("g_lse", g_lse, (torch.float32,), (bh, t))):
        if x is None:
            continue
        if x.dtype not in dtypes:
            raise TypeError(f"{fn}: {name} is {x.dtype}, not one of "
                            f"{tuple(dtypes)}")
        if (tuple(x.shape) != shape or not x.is_contiguous()
                or x.data_ptr() % 16):
            raise ValueError(f"{fn}: {name} must be a contiguous, 16-byte "
                             f"aligned tensor of shape {shape}, not "
                             f"{tuple(x.shape)}")
    _check_device(fn, q=q, k=k, v=v, out=out, g=g, lse=lse, g_lse=g_lse)
    tpad = -(-t // 128) * 128
    rows = torch.empty((2, bh, tpad), dtype=torch.float32, device=q.device)
    # The tensor cores take dO in the inputs' bf16.
    g16 = (torch.empty((bh, t, d), dtype=torch.bfloat16, device=q.device)
           if q.dtype == torch.bfloat16 and g.dtype == torch.float32
           else None)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):   # the launch goes to q's card
        rc = _bwd_lib()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            g.data_ptr(), None if g_lse is None else g_lse.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            rows[0].data_ptr(), rows[1].data_ptr(),
            None if g16 is None else g16.data_ptr(), bh, t, tpad, d,
            q_per_kv, float(scale), int(causal), _DTYPE_CODE[q.dtype],
            _DTYPE_CODE[out.dtype], _DTYPE_CODE[g.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error "
                           f"{rc}")
    flash_bwd_cuda.launches += 1
    return dq, dk, dv


flash_bwd_cuda.launches = 0


def _backward(scale, causal, residuals, g, g_lse=None, q_per_kv: int = 1):
    """The backward on the tensors' device: the plain ``_bwd`` for CPU
    tensors, the kernel for anything else (which raises off CUDA)."""
    if residuals[0].device.type == "cpu":
        return _bwd(scale, causal, residuals, g, g_lse, q_per_kv)
    q, k, v, out, lse = residuals
    return flash_bwd_cuda(
        q, k, v, out, lse, g.contiguous(),
        None if g_lse is None else g_lse.float().contiguous(),
        scale=scale, causal=causal, q_per_kv=q_per_kv)


# Above this query length the plain backward recompute runs q-chunked:
# the dense form materializes [B·H, Tq, Tk] f32 score/probability tensors
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
    forward, the kernel backward from the saved logsumexp."""

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
        dq, dk, dv = _backward(scale, causal, ctx.saved_tensors, g,
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
        dq, dk, dv = _backward(scale, causal, ctx.saved_tensors, g_out,
                               g_lse, q_per_kv=q_per_kv)
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
    with span("hvd:attention"):
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
