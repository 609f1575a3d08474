"""The serving programs over the paged KV cache — the counterpart of
:mod:`horovod_tpu.serve.decode`, as plain functions on tensors.

:func:`make_serve_fns` builds five programs for one model config, block
geometry and device:

* ``prefill`` — one whole prompt (padded to a length bucket) through the
  model: write its K/V pages into the sequence's blocks and return the
  first generated token from the last real position's logits. Its
  attention is the Hopper flash kernel
  (:func:`horovod_tpu_torch.ops.flash_attention.flash_attention`, causal
  and GQA-native), one launch a layer.
* ``prefill_resume`` — one prompt *chunk* at a block-aligned ``offset``,
  attending over every page of the sequence (a mapped prefix or earlier
  chunks) under the global-position causal mask: prefix-cache hits pay
  only for their suffix, and long prompts stream in between decode
  steps.
* ``decode`` — one step of the running batch (padded to a batch bucket):
  append each sequence's newest K/V at its position through its block
  table, attend over its gathered pages, emit the next token.
* ``verify`` — the speculative chunk step: ``decode``'s page addressing
  over a chunk of tokens a sequence.
* ``inject`` — scatter handed-off pages into the pool.

The programs write the pool **in place** (``index_copy_`` / indexed
assignment into the ``[L, ...]`` tensors the caller passes, returned
unchanged), as the reference's donated caches are rewritten: no call
copies the pool. Out-of-range slots are routed to the null block
exactly where the reference routes them; an out-of-range index is a
device-side assert on CUDA, not a clamp.

Numerics follow the reference: the model's own ``_rmsnorm`` and
``embed_lookup``, unfused q/k/v/gate/up projections, the paged
attention's scores as f32 products of the pages and queries in the
model dtype, masked to ``_NEG_BIG``, an f32 softmax, the probabilities
cast to the page dtype for the P·V product with f32 accumulation, and
the result cast back. Served decode is therefore row-independent: a
request decodes to the same tokens whatever batch it shares.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from horovod_tpu_torch.device import resolve_device
from horovod_tpu_torch.models import moe as moe_lib
from horovod_tpu_torch.models.transformer import (_index_layer, _rmsnorm,
                                                  embed_lookup)
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.serve.kv_cache import NULL_BLOCK

_NEG_BIG = -1e30  # the finite "-inf" of ring_attention


def _rope_tables(pos, d, theta):
    """``(cos, sin)`` [B, T, 1, d/2] of the rotary angles at ``pos``
    [B, T]: the same for every layer, so a program computes them once."""
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=pos.device) / d))
    ang = pos[..., None].float() * inv                      # [B, T, D/2]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def _apply_rope(x, cos, sin):
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def _rope_at(x, pos, theta):
    """Rotary embedding at explicit per-(batch, seq) positions, on
    interleaved even/odd pairs stacked back (the reference's ``_rope_at``,
    not the training ``_rope``'s shared position vector): in a decode
    batch every row is at its own length.

    ``x``: [B, T, H, D]; ``pos``: [B, T] integer."""
    return _apply_rope(x, *_rope_tables(pos, x.shape[-1], theta))


def _qkv(cfg, lp, x, rope):
    """Pre-norm, the q/k/v projections and rope (``rope`` is
    :func:`_rope_tables` at the tokens' positions), as ``decoder_layer``
    computes them. k/v keep Hkv heads: the cache holds post-rope K/V
    before any GQA repeat."""
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, T = x.shape[0], x.shape[1]
    h = _rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(B, T, H, Dh)
    k = (h @ lp["wk"]).reshape(B, T, Hkv, Dh)
    v = (h @ lp["wv"]).reshape(B, T, Hkv, Dh)
    return _apply_rope(q, *rope), _apply_rope(k, *rope), v


def _ffn(cfg, lp, x):
    """The post-attention FFN block, ``decoder_layer``'s math. An MoE
    config takes :func:`~horovod_tpu_torch.models.moe.moe_ffn`; its aux
    loss is routing telemetry at serve time and is dropped."""
    h = _rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    if cfg.moe is not None:
        y, _aux = moe_lib.moe_ffn(h, lp["moe"], cfg.moe)
        return x + y.to(cfg.dtype)
    g = F.silu((h @ lp["w_gate"]).float())
    u = (h @ lp["w_up"]).float()
    return x + ((g * u).to(cfg.dtype) @ lp["w_down"]).to(cfg.dtype)


def _paged_attention(q, kp, vp, mask, scale):
    """Attention of ``q`` [B, C, H, Dh] over gathered pages ``kp``/``vp``
    [B, S, Hkv, Dh] under ``mask`` [B, C, S] (True = visible), in the
    reference's dtype path. Query head ``h`` reads kv head ``h // (H /
    Hkv)`` (the reference's ``jnp.repeat``), by grouping the query heads
    instead of copying the pages."""
    B, C, H, Dh = q.shape
    Hkv = kp.shape[2]
    kp, vp = kp.to(q.dtype), vp.to(q.dtype)
    qg = q.float().reshape(B, C, Hkv, H // Hkv, Dh)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kp.float()) * scale
    s = s.masked_fill(~mask[:, None, None], _NEG_BIG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p.to(vp.dtype).float(),
                     vp.float())
    return o.reshape(B, C, H, Dh).to(q.dtype)


class ServeFns(NamedTuple):
    """The five programs, in the reference's order."""
    prefill: object
    prefill_resume: object
    decode: object
    inject: object
    verify: object


def make_serve_fns(cfg, *, block_size: int, table_width: int, device=None,
                   compression=None) -> ServeFns:
    """Build ``(prefill, prefill_resume, decode, inject, verify)`` for
    ``cfg`` on ``device`` (the current CUDA device by default; the CPU
    only when asked for). ``table_width`` is the block-table row length
    (blocks a sequence, worst case). ``compression`` is passed to
    ``embed_lookup``, which reads it only on a mesh.

    Every program takes the pool tensors ``kc``/``vc`` ``[L, n_blocks,
    block_size, Hkv, Dh]``, writes them in place and returns them with
    its result; integer arguments may be tensors, numpy arrays or
    Python ints. Memoized on the arguments, as the reference's jit
    closures are."""
    device = resolve_device(device)
    return _cached_serve_fns(cfg, block_size, table_width, device,
                             compression)


@functools.lru_cache(maxsize=64)
def _cached_serve_fns(cfg, block_size: int, table_width: int, device,
                      compression=None) -> ServeFns:
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L = cfg.n_layers
    bs, W = block_size, table_width
    S = W * bs
    scale = Dh ** -0.5

    def ints(x):
        return torch.as_tensor(x, device=device).long()

    def embed(params, tokens):
        return embed_lookup(params["embed"], tokens, cfg.dtype, None,
                            compression)

    def layers(params):
        return [_index_layer(params["layers"], i) for i in range(L)]

    def head(params, x):
        x = _rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return (x @ params["lm_head"]).float()

    def write_tokens(pool, phys, new):
        # Token-granularity write into one layer's pool: ``phys`` are
        # flat (block · block_size + offset) rows. Rows routed to the
        # null block may repeat; whichever lands is never read.
        pool.view(-1, Hkv, Dh).index_copy_(0, phys, new.to(pool.dtype))

    def pages(pool, tables):
        # [B, W] tables -> this layer's pages as [B, S, Hkv, Dh].
        return pool[tables].reshape(tables.shape[0], S, Hkv, Dh)

    @torch.no_grad()
    def prefill(params, kc, vc, tokens, length, block_table):
        """tokens [Tp] (bucket-padded), length (real prompt length),
        block_table [W]. Returns (kc, vc, first_token)."""
        tokens, table = ints(tokens), ints(block_table)
        Tp = tokens.shape[0]
        n_blk = Tp // bs
        assert n_blk <= W, (
            f"prompt bucket {Tp} needs {n_blk} blocks > table width {W}")
        x = embed(params, tokens[None])                      # [1, Tp, D]
        pos = torch.arange(Tp, device=device)[None]
        rope = _rope_tables(pos, Dh, cfg.rope_theta)
        blks = table[:n_blk]
        for l, lp in enumerate(layers(params)):
            q, k, v = _qkv(cfg, lp, x, rope)
            # The padded prompt is block-aligned, so the write is
            # blockwise. Bucket blocks past the allocation are null
            # (repeated) entries of the table: garbage written there is
            # never read (attention masks by length).
            kc[l].index_copy_(0, blks, k[0].reshape(n_blk, bs, Hkv, Dh)
                              .to(kc.dtype))
            vc[l].index_copy_(0, blks, v[0].reshape(n_blk, bs, Hkv, Dh)
                              .to(vc.dtype))
            # Causal over the padded prompt: rows past `length` are
            # garbage, and only row length - 1 is read.
            o = flash_attention(q, k, v, causal=True)
            x = x + (o.reshape(1, Tp, H * Dh) @ lp["wo"]).to(cfg.dtype)
            x = _ffn(cfg, lp, x)
        logits = head(params, x[0, int(length) - 1])
        return kc, vc, torch.argmax(logits).to(torch.int32)

    @torch.no_grad()
    def prefill_resume(params, kc, vc, tokens, offset, length,
                       block_table):
        """One prefill chunk at block-aligned token ``offset``: tokens
        [Tc] (bucket-padded), length (real tokens in the chunk),
        block_table [W]. Queries attend over every page of the table
        (the prefix, written by whoever computed it, and this chunk's
        own pages, written first) under the global-position causal
        mask. Returns (kc, vc, tok): the argmax at the chunk's last
        real position, the first generated token if this chunk ends the
        prompt."""
        tokens, table = ints(tokens), ints(block_table)
        offset = int(offset)
        Tc = tokens.shape[0]
        n_blk = Tc // bs
        x = embed(params, tokens[None])                      # [1, Tc, D]
        pos = offset + torch.arange(Tc, device=device)[None]  # [1, Tc]
        rope = _rope_tables(pos, Dh, cfg.rope_theta)
        # Chunk rows whose slot falls past the table (the bucket padding
        # of a last chunk at a high offset) go to the null block; a
        # clamp would overwrite the sequence's real pages instead.
        slot = offset // bs + torch.arange(n_blk, device=device)
        blks = torch.where(slot < W, table[slot.clamp(max=W - 1)],
                           NULL_BLOCK)
        mask = (torch.arange(S, device=device)[None, :]
                <= pos[0][:, None])[None]                    # [1, Tc, S]
        for l, lp in enumerate(layers(params)):
            q, k, v = _qkv(cfg, lp, x, rope)
            kc[l].index_copy_(0, blks, k[0].reshape(n_blk, bs, Hkv, Dh)
                              .to(kc.dtype))
            vc[l].index_copy_(0, blks, v[0].reshape(n_blk, bs, Hkv, Dh)
                              .to(vc.dtype))
            o = _paged_attention(q, pages(kc[l], table[None]),
                                 pages(vc[l], table[None]), mask, scale)
            x = x + (o.reshape(1, Tc, H * Dh) @ lp["wo"]).to(cfg.dtype)
            x = _ffn(cfg, lp, x)
        logits = head(params, x[0, int(length) - 1])
        return kc, vc, torch.argmax(logits).to(torch.int32)

    def write_slots(pos, tables):
        # Flat pool rows of the tokens at positions ``pos`` [B, C]
        # through ``tables`` [B, W]. Positions past the table (a draft's
        # proposals near a sequence's cap) go to the null block; a
        # clamped slot would overwrite the sequence's last real block.
        slot = pos // bs
        blk = torch.gather(tables, 1, slot.clamp(max=W - 1))
        blk = torch.where(slot < W, blk, NULL_BLOCK)
        return (blk * bs + pos % bs).reshape(-1)

    @torch.no_grad()
    def decode(params, kc, vc, tokens, positions, block_tables):
        """One continuous-batching step: tokens [B] (each sequence's
        last token), positions [B] (its cache length, where the token's
        K/V lands), block_tables [B, W]. Padded slots carry token 0,
        position 0 and an all-null table: they touch only the null
        block and the engine discards their outputs. Returns (kc, vc,
        next_tokens [B])."""
        tokens, positions = ints(tokens), ints(positions)
        tables = ints(block_tables)
        B = tokens.shape[0]
        x = embed(params, tokens[:, None])                   # [B, 1, D]
        pos = positions[:, None]
        rope = _rope_tables(pos, Dh, cfg.rope_theta)
        phys = write_slots(pos, tables)
        mask = (torch.arange(S, device=device)[None]
                <= positions[:, None])[:, None]              # [B, 1, S]
        for l, lp in enumerate(layers(params)):
            q, k, v = _qkv(cfg, lp, x, rope)
            write_tokens(kc[l], phys, k[:, 0])
            write_tokens(vc[l], phys, v[:, 0])
            o = _paged_attention(q, pages(kc[l], tables),
                                 pages(vc[l], tables), mask, scale)
            x = x + (o.reshape(B, 1, H * Dh) @ lp["wo"]).to(cfg.dtype)
            x = _ffn(cfg, lp, x)
        logits = head(params, x[:, 0])
        return kc, vc, torch.argmax(logits, dim=-1).to(torch.int32)

    @torch.no_grad()
    def verify(params, kc, vc, tokens, positions, block_tables):
        """The speculative verify step: tokens [B, C] (a sequence's
        ``[last_token, d1..d_{C-1}]``), positions [B] (its cache length,
        where the chunk's first K/V lands), block_tables [B, W].
        ``prefill_resume``'s math batched over sequences with
        ``decode``'s token-granularity addressing (chunks start
        mid-block), so the argmax at chunk position j is what a decode
        step would emit after ``tokens[:, :j+1]``. Chunk positions past
        the table and padded rows go to the null block. Returns (kc,
        vc, out [B, C])."""
        tokens, positions = ints(tokens), ints(positions)
        tables = ints(block_tables)
        B, C = tokens.shape
        x = embed(params, tokens)                            # [B, C, D]
        pos = positions[:, None] + torch.arange(C, device=device)[None]
        rope = _rope_tables(pos, Dh, cfg.rope_theta)
        phys = write_slots(pos, tables)
        mask = (torch.arange(S, device=device)[None, None, :]
                <= pos[:, :, None])                          # [B, C, S]
        for l, lp in enumerate(layers(params)):
            q, k, v = _qkv(cfg, lp, x, rope)
            write_tokens(kc[l], phys, k.reshape(-1, Hkv, Dh))
            write_tokens(vc[l], phys, v.reshape(-1, Hkv, Dh))
            o = _paged_attention(q, pages(kc[l], tables),
                                 pages(vc[l], tables), mask, scale)
            x = x + (o.reshape(B, C, H * Dh) @ lp["wo"]).to(cfg.dtype)
            x = _ffn(cfg, lp, x)
        logits = head(params, x)                             # [B, C, V]
        return kc, vc, torch.argmax(logits, dim=-1).to(torch.int32)

    @torch.no_grad()
    def inject(kc, vc, blocks, k_pages, v_pages):
        """Scatter handed-off pages into the pool: blocks [n] (real
        target blocks first, then null padding whose zero pages land on
        the never-read null block), k/v_pages [L, n, bs, Hkv, Dh] on any
        device. Writes O(pages), never the whole pool."""
        idx = ints(blocks)
        kc[:, idx] = torch.as_tensor(k_pages).to(device=device,
                                                 dtype=kc.dtype)
        vc[:, idx] = torch.as_tensor(v_pages).to(device=device,
                                                 dtype=vc.dtype)
        return kc, vc

    return ServeFns(prefill, prefill_resume, decode, inject, verify)
