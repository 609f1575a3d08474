"""Quantized process-group collectives, the counterpart of
:mod:`horovod_tpu.ops.quantized` (EQuARX, arXiv:2506.17615).

The reference traces its codecs and collectives into the XLA program
under ``shard_map``; here each process holds its shard and the hops are
``torch.distributed`` calls over a process group (``group=None`` is the
world): NCCL on CUDA tensors, gloo on CPU tensors.

Codecs, with the reference's arithmetic:

* **bf16 / fp16**: cast the wire representation down, fold in f32.
* **int8**: blockwise-scaled; each :data:`INT8_BLOCK_ELEMS`-element
  block carries an f32 scale ``absmax * float32(1/127)``, values are
  multiplied by the block's inverse scale (a true division,
  ``1/scale``, 0 for an all-zero block), rounded half to even
  (``torch.round``) and clamped to ``[-127, 127]``; decode only
  multiplies by the scale. Pad lanes are zeros and never change a
  block's absmax.

The allreduce is the reduce-scatter + all-gather decomposition with
both hops narrow:

1. quantize the local value, blockwise per destination shard;
2. ``all_to_all_single`` of the narrow bytes (int8 rows carry their f32
   scales in the same buffer: ``[scales | q]`` a row), then a
   fixed-order f32 fold over the peers (row 0 + row 1 + ...). For
   bf16/fp16 the hop may instead be one ``reduce_scatter_tensor`` in
   the wire dtype (``native_hop``, the default, as the reference's on
   a backend that reduces narrow operands);
3. requantize the reduced shard;
4. ``all_gather_into_tensor`` of the narrow bytes, then decode.

Error feedback (int8, or any codec when a residual is passed): the
rank-local residual is added before quantization and the call returns
the new one, in sum space: hop 1's encode error on every row, plus
hop 2's requantize error on the row this rank owns.

Where the int8 arithmetic meets a decode, the reference's compiled
program fuses it: XLA contracts the fold of decoded rows into
``acc = fma(q_i, scale_i, acc)`` and each encode error ``v - q * scale``
into one fused multiply-subtract. The port computes both the same way,
each product exact in f64 and each sum rounded once to f32
(:func:`_decode_fold`, :func:`_encode_error`), so it rounds as the
reference does on every backend.

:data:`counters` counts the collective calls this module issues and the
bytes of their send buffers on this rank.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.common.ops_enum import Average, ReduceOp, Sum

# Elements per int8 quantization block, pinned to the native plane's
# kInt8BlockElems (native/include/hvd/codec.h) by the tests.
INT8_BLOCK_ELEMS = 256

#: Codec names (the ``in_jit_codec`` values compression.py maps to).
CODECS = ("none", "bf16", "fp16", "int8")

_CAST_WIRE = {"bf16": torch.bfloat16, "fp16": torch.float16}

# float32(1/127), exactly representable, so the product rounds once.
_INV127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))

#: ``calls``: collectives issued; ``wire_bytes``: their send-buffer
#: bytes on this rank. Reset them to 0 around a region to count it.
counters = {"calls": 0, "wire_bytes": 0}


def reset_counters() -> None:
    counters["calls"] = counters["wire_bytes"] = 0


def _count(send: torch.Tensor) -> None:
    counters["calls"] += 1
    counters["wire_bytes"] += send.numel() * send.element_size()


# ---------------------------------------------------------------------------
# Blockwise int8 codec
# ---------------------------------------------------------------------------

def int8_blocks(n: int) -> int:
    """Ceil-div block count for ``n`` elements (codec.h Int8Blocks)."""
    return -(-n // INT8_BLOCK_ELEMS)


def _int8_encode_into(x, q_out, s_out) -> None:
    """Encode ``x`` [..., C] into ``q_out`` int8 [..., NB*B] and
    ``s_out`` f32 [..., NB] (views may be strided)."""
    x = x.float()
    c = x.shape[-1]
    nb = int8_blocks(c)
    pad = nb * INT8_BLOCK_ELEMS - c
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    v = x.reshape(x.shape[:-1] + (nb, INT8_BLOCK_ELEMS))
    scales = v.abs().amax(dim=-1).mul_(_INV127)
    inv = torch.where(scales > 0, torch.reciprocal(scales),
                      torch.zeros((), dtype=torch.float32, device=x.device))
    t = v * inv.unsqueeze(-1)
    torch.round(t, out=t)
    t.clamp_(-127, 127)
    q_out.copy_(t.reshape(q_out.shape))
    s_out.copy_(scales)


def blockwise_int8_encode(x):
    """Quantize ``x`` [..., C] blockwise along the last dim.

    Returns ``(q, scales)``: ``q`` int8 [..., NB*B] (C zero-padded to
    whole blocks; pad lanes quantize to 0), ``scales`` f32 [..., NB]
    with ``absmax * float32(1/127)`` per block (0 for an all-zero
    block)."""
    nb = int8_blocks(x.shape[-1])
    lead = tuple(x.shape[:-1])
    q = torch.empty(lead + (nb * INT8_BLOCK_ELEMS,), dtype=torch.int8,
                    device=x.device)
    s = torch.empty(lead + (nb,), dtype=torch.float32, device=x.device)
    _int8_encode_into(x, q, s)
    return q, s


def blockwise_int8_decode(q, scales, c: int):
    """Dequantize ``(q, scales)`` to f32 [..., c]: ``q * scale``, never
    a division."""
    nb = scales.shape[-1]
    v = q.float().reshape(q.shape[:-1] + (nb, INT8_BLOCK_ELEMS))
    out = (v * scales.unsqueeze(-1)).reshape(q.shape)
    return out[..., :c]


# Blocks per f64 chunk of the fused decode arithmetic (bounds its
# temporaries to a few hundred MB on the largest leaves).
_CHUNK_BLOCKS = 1 << 16


def _chunks(nb: int, c: int):
    for lo in range(0, nb, _CHUNK_BLOCKS):
        hi = min(nb, lo + _CHUNK_BLOCKS)
        yield lo, hi, lo * INT8_BLOCK_ELEMS, min(c, hi * INT8_BLOCK_ELEMS)


def _products(q, s, lo, hi, c_hi):
    """``q * scale`` of blocks ``[lo, hi)`` of rows ``q`` [R, NB*B],
    ``s`` [R, NB], exactly, in f64, truncated at element ``c_hi``."""
    e0 = lo * INT8_BLOCK_ELEMS
    qq = q[..., e0:hi * INT8_BLOCK_ELEMS].double().unflatten(
        -1, (hi - lo, INT8_BLOCK_ELEMS))
    return (qq * s[..., lo:hi].double().unsqueeze(-1)).flatten(-2)[
        ..., :c_hi - e0]


def _decode_fold(q, s, c: int):
    """The rows' decoded sum in rank order, each term fused into the
    running f32 sum: ``acc = fma(q_i, scale_i, acc)`` from 0 (the
    reference's compiled decode + fold). [c] f32."""
    # fma(q_0, scale_0, 0) is the f32 product: the plain decode.
    y = blockwise_int8_decode(q[0], s[0], c)
    for i in range(1, q.shape[0]):
        for lo, hi, e0, e1 in _chunks(s.shape[-1], c):
            y[e0:e1] = (y[e0:e1].double()
                        + _products(q[i], s[i], lo, hi, e1)).float()
    return y


def _encode_error(v, q, s):
    """``v - q * scale`` rounded once (a fused multiply-subtract): the
    encode error of rows ``v`` [R, c] that encoded to ``(q, s)``."""
    c = v.shape[-1]
    e = torch.empty_like(v, dtype=torch.float32)
    for lo, hi, e0, e1 in _chunks(s.shape[-1], c):
        e[..., e0:e1] = (v[..., e0:e1].double()
                         - _products(q, s, lo, hi, e1)).float()
    return e


def _packed_width(c: int) -> int:
    nb = int8_blocks(c)
    return 4 * nb + nb * INT8_BLOCK_ELEMS


def _unpack(buf, c: int):
    """``(q, scales)`` views of a packed ``[..., scales | q]`` uint8
    buffer of rows of ``c`` elements."""
    nb = int8_blocks(c)
    return buf[..., 4 * nb:].view(torch.int8), buf[..., :4 * nb].view(
        torch.float32)


def _pack(x):
    """Encode ``x`` [..., C] into one packed uint8 buffer per row:
    ``[NB f32 scales | NB*B int8]``, the send buffer of a hop."""
    c = x.shape[-1]
    buf = torch.empty(tuple(x.shape[:-1]) + (_packed_width(c),),
                      dtype=torch.uint8, device=x.device)
    q, s = _unpack(buf, c)
    _int8_encode_into(x, q, s)
    return buf


# ---------------------------------------------------------------------------
# Checks and hops
# ---------------------------------------------------------------------------

def _check_codec(codec: str) -> None:
    if codec not in CODECS:
        raise ValueError(f"unknown in-jit codec {codec!r}; one of {CODECS}")


def _check_group(group, fn_name: str) -> None:
    """A tuple or list of groups is the reference's tuple axis: the
    quantized hops address one group."""
    if isinstance(group, (tuple, list)):
        raise ValueError(
            f"{fn_name} reduces over a single process group; got "
            f"{group!r}. Reduce group-by-group (sequential single-group "
            "hops are the supported spelling for multi-axis meshes).")


def _check_float(x, what: str = "gradients") -> None:
    if not x.is_floating_point():
        raise TypeError(f"cannot quantize dtype {x.dtype}; compression "
                        f"applies to float {what}")


def _alltoall(send, group):
    recv = torch.empty_like(send)
    _count(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv


def _allgather_rows(send, p: int, group):
    """``[p, *send.shape]``: every rank's ``send``, in rank order."""
    out = send.new_empty((p * send.numel(),))
    _count(send)
    dist.all_gather_into_tensor(out, send.contiguous().reshape(-1),
                                group=group)
    return out.view((p,) + tuple(send.shape))


def _reduce_scatter(send, group):
    """Sum ``send`` [p, m] over the group in its own dtype; this rank's
    row comes back."""
    out = send.new_empty((send[0].numel(),))
    _count(send)
    dist.reduce_scatter_tensor(out, send.contiguous().reshape(-1),
                               op=dist.ReduceOp.SUM, group=group)
    return out.view(tuple(send.shape[1:]))


def _fold(rows):
    """Fixed-order f32 fold of ``rows`` [p, m]: row 0 + row 1 + ..."""
    y = rows[0].clone()
    for i in range(1, rows.shape[0]):
        y += rows[i]
    return y


def _inv(p: int) -> float:
    return float(torch.tensor(1.0 / p, dtype=torch.float32))


def _scatter_hop(rows, group, codec: str, native_hop, want_error: bool):
    """Hop 1: ``rows`` [p, m] f32, row r for rank r → this rank's f32
    sum over the group and, with ``want_error``, the rows' encode error
    (None for ``"none"``)."""
    c = rows.shape[-1]
    if codec == "none":
        return _fold(_alltoall(rows.contiguous(), group)), None
    if codec == "int8":
        send = _pack(rows)
        y = _decode_fold(*_unpack(_alltoall(send, group), c), c)
        return y, (_encode_error(rows, *_unpack(send, c)) if want_error
                   else None)
    w1 = rows.to(_CAST_WIRE[codec])
    if native_hop is None or native_hop:
        y = _reduce_scatter(w1, group).float()
    else:
        y = _fold(_alltoall(w1, group).float())
    return y, (rows - w1.float() if want_error else None)


# ---------------------------------------------------------------------------
# The quantized collectives
# ---------------------------------------------------------------------------

def quantized_allreduce(x, op: ReduceOp = Average, group=None, *,
                        codec: str, residual: Optional[torch.Tensor] = None,
                        native_hop: Optional[bool] = None):
    """Allreduce ``x`` over ``group`` with narrow bytes on both hops.

    ``codec`` is one of :data:`CODECS`; ``"none"`` is a plain
    ``all_reduce`` (Average divides by the group size). ``residual``
    (f32, ``x``-shaped) is this rank's error-feedback buffer: the value
    quantized is ``x + residual`` and the call returns
    ``(reduced, new_residual)``; without it only ``reduced`` returns.
    ``native_hop`` (bf16/fp16; None means on) reduces hop 1 with one
    ``reduce_scatter_tensor`` in the wire dtype; off, it is
    ``all_to_all`` plus the f32 fold. Only Sum/Average compress.
    """
    _check_codec(codec)
    if codec == "none":
        if op not in (Sum, Average):
            raise ValueError("quantized_allreduce supports Sum/Average")
        y = x.clone()
        _count(y)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        if op == Average:
            y = y / dist.get_world_size(group)
        return (y, residual) if residual is not None else y
    if op not in (Sum, Average):
        raise ValueError(
            f"compression={codec!r} supports op=Sum/Average only, got {op!r}")
    _check_group(group, "quantized_allreduce")
    _check_float(x)

    p, me = dist.get_world_size(group), dist.get_rank(group)
    n = x.numel()
    xf = x.float().reshape(-1)
    if residual is not None:
        xf = xf + residual.float().reshape(-1)
    n_per = -(-n // p)                     # elements per scattered shard
    if n_per * p != n:
        xf = torch.nn.functional.pad(xf, (0, n_per * p - n))
    v = xf.reshape(p, n_per)               # row r -> shard owned by rank r

    ef = residual is not None
    y, e1 = _scatter_hop(v, group, codec, native_hop, ef)
    if codec == "int8":
        send2 = _pack(y.unsqueeze(0))[0]
        z = blockwise_int8_decode(*_unpack(_allgather_rows(send2, p, group),
                                           n_per), n_per)
        e2 = _encode_error(y, *_unpack(send2, n_per)) if ef else None
    else:
        w2 = y.to(_CAST_WIRE[codec])
        z = _allgather_rows(w2, p, group).float()
        e2 = y - w2.float()

    if op == Average:
        z = z * _inv(p)
    out = z.reshape(-1)[:n].reshape(x.shape).to(x.dtype)
    if not ef:
        return out
    e1[me] += e2
    return out, e1.reshape(-1)[:n].reshape(x.shape)


def quantized_reduce_scatter(x, op: ReduceOp = Sum, group=None, *,
                             codec: str, axis: int = 0,
                             residual: Optional[torch.Tensor] = None,
                             native_hop: Optional[bool] = None):
    """Reduce-scatter ``x`` over ``group`` with the hop's bytes narrowed
    by ``codec``: hop 1 of :func:`quantized_allreduce` on the
    contiguous slabs of ``x``'s dim ``axis``, which must divide by the
    group size. This rank gets its slab (``x.shape`` with that dim
    divided). ``"none"`` folds the exact f32 values. ``residual`` (f32,
    ``x``-shaped) is this rank's EF buffer for the one encode point;
    with it the call returns ``(shard, new_residual)``."""
    _check_codec(codec)
    _check_group(group, "quantized_reduce_scatter")
    if op not in (Sum, Average):
        raise ValueError(
            f"quantized_reduce_scatter supports op=Sum/Average, got {op!r}")
    if codec != "none":
        _check_float(x)
    p = dist.get_world_size(group)
    axis = axis % x.dim()
    if x.shape[axis] % p:
        raise ValueError(
            f"quantized_reduce_scatter: dim {axis} of shape "
            f"{tuple(x.shape)} does not divide by the group size {p}")
    moved = x.movedim(axis, 0)
    rows = moved.float().reshape(p, -1)
    if residual is not None and codec != "none":
        rows = rows + residual.float().movedim(axis, 0).reshape(p, -1)
    shard_shape = (moved.shape[0] // p,) + tuple(moved.shape[1:])

    y, e1 = _scatter_hop(rows, group, codec, native_hop,
                         residual is not None)
    if op == Average:
        y = y * _inv(p)
    shard = y.reshape(shard_shape).movedim(0, axis).to(x.dtype).contiguous()
    if residual is None:
        return shard
    if e1 is None:                   # codec "none": nothing dropped
        return shard, residual
    return shard, e1.reshape(moved.shape).movedim(0, axis).contiguous()


def quantized_allgather(x, group=None, *, codec: str, axis: int = 0):
    """All-gather ``x`` along ``axis`` (every rank's piece in rank
    order) with the wire bytes narrowed by ``codec``. int8 ships
    blockwise ``[scales | q]`` rows of ``x`` moved to put ``axis`` last
    and dequantizes after the hop. ``"none"`` is the exact gather."""
    _check_codec(codec)
    if codec != "none":
        _check_group(group, "quantized_allgather")
        _check_float(x, "tensors")
    p = dist.get_world_size(group)
    moved = x.movedim(axis, -1)
    c = moved.shape[-1]
    if codec == "none":
        g = _allgather_rows(moved, p, group)
    elif codec in _CAST_WIRE:
        g = _allgather_rows(moved.to(_CAST_WIRE[codec]), p, group).to(x.dtype)
    else:
        g = blockwise_int8_decode(
            *_unpack(_allgather_rows(_pack(moved), p, group), c), c)
    out = g.movedim(0, -2).reshape(tuple(moved.shape[:-1]) + (p * c,))
    return out.movedim(-1, axis).to(x.dtype).contiguous()


def _alltoall_value(x, group, codec: str):
    """Forward value of the quantized alltoall: each destination slab
    ``x[d]`` is flattened and encoded as one blockwise payload, the
    narrow bytes ride ``all_to_all_single``, and the received slabs
    decode back to ``x.dtype``."""
    if codec == "none":
        return _alltoall(x.contiguous(), group)
    if codec in _CAST_WIRE:
        return _alltoall(x.to(_CAST_WIRE[codec]).contiguous(),
                         group).to(x.dtype)
    rows = x.float().reshape(x.shape[0], -1)
    c = rows.shape[-1]
    q, s = _unpack(_alltoall(_pack(rows), group), c)
    return blockwise_int8_decode(q, s, c).reshape(x.shape).to(x.dtype)


class _QuantizedAlltoall(torch.autograd.Function):
    """The tiled alltoall is its own transpose: the cotangent rides the
    same exchange, narrowed by ``bwd_codec`` (straight-through: the
    forward's rounding never enters the backward)."""

    @staticmethod
    def forward(ctx, x, group, codec, bwd_codec, issue):
        ctx.group, ctx.bwd_codec, ctx.issue = group, bwd_codec, issue
        return issue(x, lambda: _alltoall_value(x, group, codec))

    @staticmethod
    def backward(ctx, g):
        return (ctx.issue(g, lambda: _alltoall_value(g, ctx.group,
                                                     ctx.bwd_codec)),
                None, None, None, None)


def _run(x, fn):
    return fn()


def quantized_alltoall(x, group=None, *, codec: str,
                       bwd_codec: Optional[str] = None, issue=None):
    """Alltoall ``x`` over ``group`` with the wire narrowed by ``codec``
    (the MoE dispatch/combine hop). ``x``'s leading dim must equal the
    group size; slab ``x[d]`` goes to rank ``d`` and the result's slab
    ``[s]`` came from rank ``s``. Differentiable: the backward ships the
    cotangent the reverse way with ``bwd_codec`` (default ``codec``).
    ``"none"`` both ways is the exact alltoall. ``issue(payload, fn)``,
    where given, runs each exchange ``fn()`` (forward and backward), so
    a caller can count and time them."""
    _check_codec(codec)
    bwd = codec if bwd_codec is None else bwd_codec
    _check_codec(bwd)
    if codec != "none" or bwd != "none":
        _check_group(group, "quantized_alltoall")
        p = dist.get_world_size(group)
        if x.shape[0] != p:
            raise ValueError(
                f"quantized_alltoall: leading dim {x.shape[0]} must equal "
                f"the group size {p} (one slab per peer)")
        _check_float(x, "activations")
    return _QuantizedAlltoall.apply(x, group, codec, bwd, issue or _run)


def alltoall_wire_bytes(shape, codec: str, *, elem_bytes: int = 4) -> int:
    """Bytes one :func:`quantized_alltoall` of a ``shape``-shaped
    payload of ``elem_bytes``-byte elements puts on the wire (all P
    slabs, scales included)."""
    _check_codec(codec)
    n = math.prod(shape)
    if codec == "none":
        return n * elem_bytes
    if codec in _CAST_WIRE:
        return n * 2
    per_slab = math.prod(shape[1:])
    nb = int8_blocks(per_slab)
    return shape[0] * nb * (INT8_BLOCK_ELEMS + 4)
