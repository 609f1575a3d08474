"""Paged KV-cache management for continuous-batching inference — the
counterpart of :mod:`horovod_tpu.serve.kv_cache`.

The cache is a pool of fixed-size **blocks** (vLLM's PagedAttention
layout): two tensors shaped ``[L, n_blocks, block_size, Hkv, Dh]`` on
one device, plus a host-side :class:`BlockAllocator` handing out block
ids. Each sequence owns a *block table* (a row of physical block ids);
the decode programs gather K/V pages through the table and write new
pages into the pool in place, so batch membership can change every
iteration without copying the pool.

Block 0 is the **null block**: padded batch slots and writes past a
sequence's table are routed there, so the scatters need no branch; its
contents are never read (attention masks by sequence length).

Blocks are **refcounted and content-addressed**: a full block can be
published under a chained content hash (``block_hash(parent, tokens)``)
and later requests whose prompts share that whole-block prefix map the
cached block into their table instead of recomputing its K/V (prefix
caching). A block whose refcount drops to zero keeps its contents in an
LRU pool and is evicted only when a fresh allocation finds the plain
free list empty. The hashes are the reference's bytes, so the two
packages index the same prompts under the same keys.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import struct
from typing import Any, Dict, List, Optional, Tuple

import torch

from horovod_tpu_torch.device import resolve_device

NULL_BLOCK = 0

#: The ROADMAP item that ports serving on a mesh.
MESH_TODO = ("serving on a mesh (tp/ep-sharded params and KV pool, "
             "ServeConfig.compression on the mesh) is ROADMAP item 17 "
             "and not ported yet")


def block_hash(parent: bytes, tokens) -> bytes:
    """Chained content hash of one full block: blake2b-128 over the
    parent hash (``b""`` for the first block) and the block's tokens as
    little-endian int64, so equal hashes imply an equal whole-token
    prefix, not just an equal block."""
    toks = [int(t) for t in tokens]
    m = hashlib.blake2b(parent, digest_size=16)
    m.update(struct.pack(f"<{len(toks)}q", *toks))
    return m.digest()


def hash_chain(prompt, block_size: int) -> List[bytes]:
    """Chained content hash per full prompt block (the partial tail
    block stays private and unhashed); entry ``i`` summarizes the whole
    prefix through block ``i``. The engine publishes and looks up
    against this chain, and a router placing requests by cache affinity
    must hash identically."""
    chain, h = [], b""
    for i in range(len(prompt) // block_size):
        h = block_hash(h, prompt[i * block_size:(i + 1) * block_size])
        chain.append(h)
    return chain


class OutOfBlocks(RuntimeError):
    """Raised by :meth:`BlockAllocator.alloc` when the pool cannot
    serve the request — the engine's admission backpressure signal."""


class BlockAllocator:
    """Host-side refcounted free list over the device block pool.

    Three disjoint states partition the non-null blocks:

    * **live** — refcount >= 1 (``alloc`` hands out refcount-1 blocks;
      :meth:`acquire_cached` revives or shares them). Counted by
      ``n_used``.
    * **cached** — refcount 0 but content-addressed: parked in an LRU
      pool, still indexed by hash, revivable for free.
    * **free** — refcount 0, no retained content.

    ``n_free`` counts free + cached (both are allocatable); ``alloc``
    drains the plain free list first (LIFO, so allocation order is
    deterministic) and only then evicts the least-recently-used cached
    blocks (``evictions`` counts those). Only refcount-0 blocks enter
    the LRU pool, so eviction never touches a referenced block.
    """

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2:
            raise ValueError(
                f"need at least 2 blocks (1 usable + null), got {n_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        # Block 0 is the null sink — never handed out.
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._refs: Dict[int, int] = {}          # live block -> refcount
        # Refcount-0 cached blocks in LRU order (oldest first, evicted
        # first); the value is the block's content hash.
        self._lru: "collections.OrderedDict[int, bytes]" = \
            collections.OrderedDict()
        self._hash_of_block: Dict[int, bytes] = {}
        self._block_of_hash: Dict[bytes, int] = {}
        self._high_water = 0
        # Block-granularity prefix-cache counters (the engine keeps the
        # token-granularity hit rate in ServeMetrics).
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.evictions = 0

    @property
    def n_free(self) -> int:
        """Allocatable blocks: truly free + cached (refcount 0)."""
        return len(self._free) + len(self._lru)

    @property
    def n_used(self) -> int:
        return len(self._refs)

    @property
    def n_cached(self) -> int:
        """Refcount-0 blocks still holding indexed content."""
        return len(self._lru)

    @property
    def high_water(self) -> int:
        """Peak concurrent blocks in use."""
        return self._high_water

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    def blocks_for_tokens(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` cache entries."""
        return -(-max(n_tokens, 0) // self.block_size)

    def can_alloc(self, n: int) -> bool:
        return n <= self.n_free

    def alloc(self, n: int) -> List[int]:
        if n > self.n_free:
            raise OutOfBlocks(
                f"requested {n} KV blocks, {self.n_free} free "
                f"({len(self._lru)} of them cached; pool "
                f"{self.n_blocks - 1} x {self.block_size} tokens)")
        out: List[int] = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:
                # Allocation pressure: forget the least-recently-used
                # cached block (refcount 0 by construction).
                b, h = self._lru.popitem(last=False)
                del self._hash_of_block[b]
                del self._block_of_hash[h]
                self.evictions += 1
            self._refs[b] = 1
            out.append(b)
        self._high_water = max(self._high_water, len(self._refs))
        return out

    def peek(self, h: bytes) -> Optional[int]:
        """Non-mutating lookup: the block published under ``h`` (live
        or cached), or None. No refcount, no hit/miss count, no LRU
        reordering — admission sizes its reservation with it, so a
        backpressure retry loop does not inflate the cache statistics."""
        return self._block_of_hash.get(h)

    def acquire_cached(self, h: bytes) -> Optional[int]:
        """Prefix-cache lookup: if a block is published under ``h``,
        take a reference on it (reviving it from the LRU pool if it was
        refcount 0) and return its id; else record a miss and return
        None."""
        b = self._block_of_hash.get(h)
        if b is None:
            self.prefix_misses += 1
            return None
        if b in self._lru:
            del self._lru[b]
            self._refs[b] = 1
            self._high_water = max(self._high_water, len(self._refs))
        else:
            self._refs[b] += 1
        self.prefix_hits += 1
        return b

    def register(self, block: int, h: bytes) -> bool:
        """Publish a live, full, immutable ``block`` under content hash
        ``h``. Returns False (no-op) if ``h`` is already published: two
        sequences that prefilled the same prefix each keep their block,
        the first registration wins and the other stays anonymous."""
        if block not in self._refs:
            raise ValueError(
                f"registering block {block} with no live reference")
        if h in self._block_of_hash:
            return False
        if block in self._hash_of_block:
            raise ValueError(f"block {block} already registered")
        self._hash_of_block[block] = h
        self._block_of_hash[h] = block
        return True

    def verify_integrity(self) -> None:
        """Full-pool invariant check: live / cached / free partition the
        non-null blocks exactly, refcounts are positive, the content
        index is a bijection, and every cached block is indexed.
        Raises ``AssertionError`` on any violation."""
        live, cached, free = (set(self._refs), set(self._lru),
                              set(self._free))
        assert len(self._free) == len(free), "duplicate free-list entry"
        assert not (live & cached) and not (live & free) \
            and not (cached & free), "block in two states"
        assert live | cached | free == set(range(1, self.n_blocks)), \
            "live/cached/free do not partition the pool"
        assert all(r > 0 for r in self._refs.values()), \
            "zero/negative refcount held as live"
        assert len(self._block_of_hash) == len(self._hash_of_block), \
            "content index out of sync"
        for b, h in self._hash_of_block.items():
            assert self._block_of_hash[h] == b, "index not a bijection"
        for b in cached:
            assert b in self._hash_of_block, "anonymous block in LRU"

    def free(self, blocks: List[int]) -> None:
        """Drop one reference per listed block. A block whose refcount
        reaches 0 parks in the LRU cache pool if it was registered,
        else returns to the plain free list. Every id is checked before
        anything changes, so the pool is untouched on error."""
        seen = set()
        for b in blocks:
            if not 0 < b < self.n_blocks:
                raise ValueError(f"freeing invalid block id {b}")
            if b not in self._refs or b in seen:
                raise ValueError(f"double free of block {b}")
            seen.add(b)
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b]:
                continue
            del self._refs[b]
            h = self._hash_of_block.get(b)
            if h is None:
                self._free.append(b)
            else:
                self._lru[b] = h        # most recently released last


@dataclasses.dataclass
class KVCache:
    """Device-side paged cache: one K and one V tensor, layer-stacked on
    the leading dim as the parameters are. The serve programs write them
    in place; the tensors are never replaced."""

    k: Any  # [L, n_blocks, block_size, Hkv, Dh]
    v: Any  # [L, n_blocks, block_size, Hkv, Dh]
    block_size: int
    n_blocks: int

    @property
    def max_blocks_per_seq(self) -> int:
        return self.n_blocks


def init_kv_cache(cfg, n_blocks: int, block_size: int,
                  mesh: Optional[Any] = None, dtype: Optional[Any] = None,
                  *, device=None) -> KVCache:
    """Allocate the zeroed block pool on ``device`` (the current CUDA
    device by default; the CPU only when asked for). ``dtype`` defaults
    to the model's. A mesh (a tp-sharded pool) raises: ROADMAP item 17."""
    if mesh is not None:
        raise NotImplementedError(f"init_kv_cache(mesh=...): {MESH_TODO}")
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   block_size=block_size, n_blocks=n_blocks)


def pick_bucket(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket >= n (buckets ascending). The buckets fix the
    padded prompt and batch shapes the programs compute with."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")


def page_chunks(n_pages: int, chunk_pages: int) -> List[Tuple[int, int]]:
    """Block-aligned ``[start, stop)`` ranges covering ``n_pages`` KV
    pages in ``chunk_pages``-sized pieces (the last one ragged): the
    chunking shared by a chunked inject and whatever streams it."""
    if n_pages < 0:
        raise ValueError(f"n_pages {n_pages} < 0")
    if chunk_pages < 1:
        raise ValueError(f"chunk_pages {chunk_pages} < 1")
    return [(lo, min(lo + chunk_pages, n_pages))
            for lo in range(0, n_pages, chunk_pages)]
