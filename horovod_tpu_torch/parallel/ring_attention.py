"""Attention selection and sequence parallelism for the port's model, the
counterpart of :mod:`horovod_tpu.parallel.ring_attention`.

:func:`make_sp_attention` builds the ``"flash"`` kernel path, the plain
``"local"`` einsum path, or, on a mesh whose ``sp`` axis is above 1, one
of the sequence-parallel bodies over the sp process group:

* :func:`ring_self_attention` — K/V chunks rotate around the ring while
  each rank accumulates its queries' online softmax in plain torch ops;
* :func:`ring_flash_attention` — the same ring with the flash kernel
  (``csrc/flash_fwd.cu``) on each chunk, whose ``(out, lse)`` pairs are
  merged by a running logsumexp (:func:`attend_and_merge`);
* :func:`ulysses_attention` — all-to-all from sequence shards to head
  shards, plain attention over the whole sequence, and back.

With no mesh, or sp == 1, the sequence-parallel impls reduce to
``local_attention``, as in the reference.

The reference runs these bodies inside ``shard_map`` on global arrays;
here each rank calls them on its own chunk: ``[batch, seq / sp, heads,
head_dim]`` for q/k/v, chunk ``s`` of a contiguous sequence on sp rank
``s``. Every rank makes the same rotations in the same order, forward
and backward; the ring skips the reference's last rotation, whose
result the reference never reads.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.parallel.mesh import mesh_axis_size
from horovod_tpu_torch.parallel.tensor_parallel import (all_to_all, keep,
                                                        rotate)

_NEG_BIG = -1e30  # finite "-inf", as in the reference


def local_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """Plain attention over ``[B, T, H, D]`` (equal q and kv heads):
    f32 scores and softmax, P cast to v's dtype for the P·V product
    with f32 accumulation, the result in q's dtype — as the reference's
    ``preferred_element_type=f32`` einsums compute it."""
    B, T, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((T, k.shape[1]), dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, _NEG_BIG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def _block_attend(q, k, v, o, l, m, *, scale, mask):
    """One online-softmax accumulation step over a K/V block (reference
    ``_block_attend``). q: [B, Tq, H, D]; k/v: [B, Tk, H, D]; o: [B, Tq,
    H, D] f32; l, m: [B, H, Tq] f32 running normaliser and max; mask:
    [Tq, Tk] bool (True = attend) or None."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, _NEG_BIG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o * corr.transpose(1, 2)[..., None] + pv
    return o, l, m_new


def ring_self_attention(q, k, v, *, group, causal: bool = True,
                        scale: Optional[float] = None):
    """Ring attention on this rank's chunk (reference
    ``ring_self_attention``): ``q``/``k``/``v`` ``[B, T_local, H, D]``,
    chunk ``r`` of the sequence on rank ``r`` of the sp ``group``.
    Step ``i`` attends the local queries to chunk ``(r + i) % sp``, its
    causal mask ``qpos >= kpos`` keyed off the chunks' global offsets,
    then K/V (stacked, one transfer) rotate one hop (shift -1: receive
    the next-higher rank's chunk). Returns ``[B, T_local, H, D]`` in
    ``q.dtype``."""
    B, T, H, D = q.shape
    sp, my = collectives.axis_size(group), collectives.axis_rank(group)
    if scale is None:
        scale = D ** -0.5
    o = torch.zeros((B, T, H, D), dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, T), _NEG_BIG, dtype=torch.float32,
                   device=q.device)
    ar = torch.arange(T, device=q.device)
    qpos = my * T + ar
    kv = torch.stack([k, v])
    for i in range(sp):
        src = (my + i) % sp
        mask = (qpos[:, None] >= (src * T + ar)[None, :]) if causal else None
        o, l, m = _block_attend(q, kv[0], kv[1], o, l, m, scale=scale,
                                mask=mask)
        if i < sp - 1:
            kv = rotate(kv, group, -1)
    out = o / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def chunk_case(src: int, my: int, causal: bool) -> str:
    """What the local queries of chunk ``my`` do with keys of chunk
    ``src``: ``"full"`` (an earlier chunk, or any chunk without the
    causal mask), ``"diag"`` (the own chunk, causal) or ``"skip"`` (a
    later chunk: nothing to attend)."""
    if not causal or src < my:
        return "full"
    return "diag" if src == my else "skip"


def ring_carry(qb):
    """The merge's starting ``(o, m, l)`` for queries ``qb`` ``[BH, T,
    D]``: nothing attended yet."""
    bh, t, d = qb.shape
    return (torch.zeros((bh, t, d), dtype=torch.float32, device=qb.device),
            torch.full((bh, t), _NEG_BIG, dtype=torch.float32,
                       device=qb.device),
            torch.zeros((bh, t), dtype=torch.float32, device=qb.device))


def attend_and_merge(qb, kb, vb, carry, *, case: str, scale: float):
    """One ring step of :func:`ring_flash_attention`: the flash kernel on
    the local queries ``qb`` and one K/V chunk (``[BH, T, D]`` each,
    q_per_kv 1; ``causal=False`` for a ``"full"`` chunk, ``True`` for
    the ``"diag"`` one; a ``"skip"`` chunk is not attended), its f32
    ``(out, lse)`` merged into the running ``carry = (o, m, l)``: ``m``
    the running max of the chunks' logsumexps, ``o = Σ out_i·exp(lse_i
    − m)``, ``l = Σ exp(lse_i − m)``, all f32. Differentiable, through
    ``lse`` too."""
    if case == "skip":
        return carry
    from horovod_tpu_torch.ops.flash_attention import flash_attention_with_lse
    o, m, l = carry
    out_b, lse_b = flash_attention_with_lse(
        qb, kb, vb, causal=case == "diag", scale=scale,
        out_dtype=torch.float32)
    m_new = torch.maximum(m, lse_b)
    w_old = torch.exp(m - m_new)
    w_new = torch.exp(lse_b - m_new)
    o = o * w_old[..., None] + out_b * w_new[..., None]
    l = l * w_old + w_new
    return o, m_new, l


def merged_result(carry):
    """``(out, lse)`` of a merge: ``o / l`` (``l`` held at 1e-30 or
    above, as the reference) and ``m + log l``, f32."""
    o, m, l = carry
    l = torch.clamp_min(l, 1e-30)
    return o / l[..., None], m + torch.log(l)


def ring_flash_attention(q, k, v, *, group, causal: bool = True,
                         scale: Optional[float] = None):
    """Ring attention with the flash kernel per chunk (reference
    ``ring_flash_attention``) on this rank's chunk ``[B, T_local, H,
    D]`` (K/V with q's heads). K/V are laid out ``[B·H, T, D]`` once
    and rotate in that layout; each step's case is a host-side branch
    on the ranks (:func:`chunk_case`), so a causal ring launches the
    kernel ``r + 1`` times on rank ``r``; a skipped chunk's K/V stay in
    the graph (:func:`~horovod_tpu_torch.parallel.tensor_parallel.
    keep`) so every rank's backward makes the same rotations. Returns
    ``[B, T_local, H, D]`` in ``q.dtype``."""
    B, T, H, D = q.shape
    sp, my = collectives.axis_size(group), collectives.axis_rank(group)
    if scale is None:
        scale = D ** -0.5

    def to_bh(x):
        return x.transpose(1, 2).reshape(B * H, T, D)

    qb = to_bh(q)
    kv = torch.stack([to_bh(k), to_bh(v)])
    carry = ring_carry(qb)
    for i in range(sp):
        case = chunk_case((my + i) % sp, my, causal)
        carry = attend_and_merge(qb, kv[0], kv[1], carry, case=case,
                                 scale=scale)
        if case == "skip":
            carry = (keep(carry[0], kv),) + carry[1:]
        if i < sp - 1:
            kv = rotate(kv, group, -1)
    out = merged_result(carry)[0]
    return out.reshape(B, H, T, D).transpose(1, 2).to(q.dtype)


def ulysses_attention(q, k, v, *, group, causal: bool = True,
                      scale: Optional[float] = None):
    """DeepSpeed-Ulysses sequence parallelism (reference
    ``ulysses_attention``): q/k/v ``[B, T_local, H, D]`` (equal heads,
    ``H % sp == 0``) go, stacked, through one all-to-all to ``[B, T,
    H / sp, D]``, attend with :func:`local_attention` over the whole
    sequence, and the output comes back by a second all-to-all."""
    sp = collectives.axis_size(group)
    if q.shape[2] % sp:
        raise ValueError(f"ulysses_attention: {q.shape[2]} heads do not "
                         f"split over sp={sp}")
    if sp == 1:
        return local_attention(q, k, v, causal=causal, scale=scale)
    qkv = all_to_all(torch.stack([q, k, v]), group, split_axis=3,
                     concat_axis=2)
    oh = local_attention(qkv[0], qkv[1], qkv[2], causal=causal, scale=scale)
    return all_to_all(oh, group, split_axis=1, concat_axis=2)


_BODIES = {"ring": ring_self_attention, "ring_flash": ring_flash_attention,
           "ulysses": ulysses_attention}


def make_sp_attention(mesh=None, *, axis_name: str = "sp",
                      impl: str = "ring", causal: bool = True):
    """Build ``attend(q, k, v)`` for the model layer.

    ``impl="flash"`` is the Hopper kernel (:func:`flash_attention`,
    GQA-native, so ``attend.handles_gqa`` is set); ``impl="local"`` is
    :func:`local_attention`, and so is every sequence-parallel impl
    while the ``axis_name`` axis is 1 (``mesh=None`` or a mesh without
    sequence parallelism: the reference's fallback). On a mesh whose
    ``axis_name`` axis is above 1, ``"ring"``, ``"ring_flash"`` and
    ``"ulysses"`` run their bodies over that axis' group on each rank's
    sequence chunk; ``"flash"`` raises, as in the reference (the kernel
    is the sp=1 path; ``"ring_flash"`` puts it in the ring), and so does
    ``"local"``, which would attend within the chunk only."""
    sp = 1 if mesh is None else mesh_axis_size(mesh, axis_name)
    if impl not in ("flash", "local", *_BODIES):
        raise ValueError(f"unknown SP attention impl {impl!r}")
    if impl == "flash":
        if sp > 1:
            raise NotImplementedError(
                "impl='flash' is the sp=1 kernel; use impl='ring_flash' "
                "for sequence parallelism with the flash kernel")
        from horovod_tpu_torch.ops.flash_attention import flash_attention
        fa = functools.partial(flash_attention, causal=causal)
        fa.handles_gqa = True
        return fa
    if sp == 1:
        return functools.partial(local_attention, causal=causal)
    if impl == "local":
        raise NotImplementedError(
            f"impl='local' attends within one rank's chunk; with "
            f"{axis_name}={sp} use 'ring', 'ring_flash' or 'ulysses'")
    return functools.partial(_BODIES[impl], group=mesh.get_group(axis_name),
                             causal=causal)


def sequence_sharded_attention(q, k, v, mesh, *, axis_name: str = "sp",
                               impl: str = "ring", causal: bool = True):
    """One-shot form of :func:`make_sp_attention` on this rank's chunks."""
    return make_sp_attention(mesh, axis_name=axis_name, impl=impl,
                             causal=causal)(q, k, v)
