"""Planning of direct KV-page migration — the counterpart of
:mod:`horovod_tpu.serve.migrate`.

The fleet moves a sequence's KV pages on a prefill handoff, a migrating
drain or a recovery. Relayed, the pages go source -> router -> target,
two traversals; direct, the source worker streams them to the target's
bulk listener. This module is the planning half of the direct plane:

* **The knob.** ``HOROVOD_FLEET_DIRECT_MIGRATION``: ``auto`` dials
  worker to worker and falls back to relayed when the dial fails;
  ``off`` is the relayed path, byte for byte. The router reads it once
  per fleet (:func:`direct_migration_mode`).
* **The cost twin.** :func:`migration_cost_us` is a two-term closed
  form over the measured alpha-beta model ``hvd.topology()`` publishes,
  mirrored term for term by the native ``hvd_migration_cost_us``
  (``native/src/topology.cc``), so router tests can score placements
  without a controller.
* **The plan.** :func:`plan_migration` sweeps a power-of-two chunk menu
  through the cost model and returns the argmin.

A replica's instance (``"0"``, ``"1"``, ...) maps onto a topology rank
with :func:`replica_rank`. With no model every cost is 0 and placement
is the plain least-load pick.
"""

from __future__ import annotations

import dataclasses
import math
import os
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.parallel.mesh import axis_index, tp_group
from horovod_tpu_torch.serve.kv_cache import pool_kv_heads

#: The sane-env knob: ``auto`` (default) dials the direct channel and
#: falls back to relayed on a failed dial; ``off`` forces the relayed
#: path byte-for-byte.
DIRECT_MIGRATION_ENV = "HOROVOD_FLEET_DIRECT_MIGRATION"

#: Python mirror of ``kSpanOverheadUs`` (native/src/topology.cc): the
#: fixed per-span bookkeeping cost the schedule interpreter charges on
#: top of alpha. A migration chunk pays it twice (send + ack).
SPAN_OVERHEAD_US = 0.2


#: The direct-migration exposition families, each under the
#: ``serve_fleet_`` prefix; the histogram renders pooled tails as
#: ``serve_fleet_p{50,99}_migration_ms``.
MIGRATION_METRIC_KEYS = (
    "serve_fleet_direct_migrations_total",
    "serve_fleet_migration_bytes_total",
    "serve_fleet_migration_ms",
    "serve_fleet_migration_link_cost_us",
)

_warned_bad_mode = False


def direct_migration_mode() -> str:
    """``"auto"`` or ``"off"`` from :data:`DIRECT_MIGRATION_ENV`.
    Lenient parse in the sane-env tradition: the off-ish spellings
    (``off``/``0``/``false``/``no``/``relayed``) disable, anything
    else (including unset) is ``auto`` — with a warn-once on garbage
    so a typo degrades loudly, not silently."""
    global _warned_bad_mode
    raw = os.environ.get(DIRECT_MIGRATION_ENV, "auto").strip().lower()
    if raw in ("off", "0", "false", "no", "relayed"):
        return "off"
    if raw not in ("auto", "on", "1", "true", "yes", "direct", ""):
        if not _warned_bad_mode:
            _warned_bad_mode = True
            warnings.warn(
                f"{DIRECT_MIGRATION_ENV}={raw!r} is not auto/off; "
                "treating as auto", stacklevel=2)
    return "auto"


def fleet_topology() -> Optional[Dict[str, Any]]:
    """The measured alpha-beta model for migration scoring, or
    ``None`` when no model exists. This is the ONE seam the router
    reads topology through — tests monkeypatch it with a synthetic
    model, and it swallows the not-initialized case (router fleets in
    the tests run without ``hvd.init()``; every topology export is
    controller-gated)."""
    try:
        from horovod_tpu_torch import api
        return api.topology()
    except Exception:
        return None


def replica_rank(instance: str, n_ranks: int) -> int:
    """Map a router replica instance id onto a topology rank. Instance
    ids are the router's decimal join counter; fleets larger than the
    probed ring wrap (two replicas sharing a rank share its links,
    which is exactly the single-host reality)."""
    digits = "".join(c for c in instance if c.isdigit())
    return (int(digits) % n_ranks) if digits and n_ranks > 0 else 0


def link_cost_us(model: Optional[Dict[str, Any]], src: int, dst: int,
                 n_bytes: int) -> float:
    """One-shot alpha-beta cost of moving ``n_bytes`` src → dst under
    ``model`` (0 when loopback or no model). The single-span verdict —
    :func:`migration_cost_us` is the chunked generalization."""
    if model is None or src == dst:
        return 0.0
    alpha = model["alpha_us"][src][dst]
    beta = model["beta_us_per_byte"][src][dst]
    return alpha + beta * n_bytes


def migration_cost_us(model: Optional[Dict[str, Any]], src: int,
                      dst: int, n_bytes: int, n_chunks: int) -> float:
    """Cost verdict for streaming ``n_bytes`` src → dst in
    ``n_chunks`` pipelined chunks. Mirrored EXACTLY (same terms, same
    order) by the native ``hvd_migration_cost_us`` — change one,
    change both (``tests/test_torch_migrate.py`` holds the pair).

    Terms: every chunk pays launch + ack latency plus twice the span
    bookkeeping overhead; the full payload crosses the wire once; and
    the LAST chunk's inject cannot overlap anything, modeled as one
    chunk's worth of extra beta. More chunks buy overlap (smaller
    tail term) at the price of per-chunk latency — an interior
    minimum, which is the whole point of scheduling the transfer."""
    if n_chunks < 1:
        raise ValueError(f"n_chunks {n_chunks} < 1")
    if model is None or src == dst:
        return 0.0
    alpha_fwd = model["alpha_us"][src][dst]
    alpha_ack = model["alpha_us"][dst][src]
    beta = model["beta_us_per_byte"][src][dst]
    per_chunk = alpha_fwd + alpha_ack + 2.0 * SPAN_OVERHEAD_US
    return (n_chunks * per_chunk + n_bytes * beta
            + (n_bytes / n_chunks) * beta)


def codec_wire_ratio(codec) -> float:
    """Wire-bytes ratio of the span codec on an f32 pool: the cast
    codecs (bf16/fp16) halve every page, ``None`` ships raw. Accepts
    the same spellings ``rpc.span_codec_id`` does (name string,
    ``None``, or a ``hvd.Compression`` member)."""
    if codec is None:
        return 1.0
    wire = getattr(codec, "wire_codec", None)
    if wire is not None:
        return 0.5 if int(wire) in (1, 2) else 1.0
    return 0.5 if str(codec) in ("bf16", "fp16") else 1.0


def page_nbytes(model_cfg, block_size: int, mesh=None) -> int:
    """Raw bytes of one K+V page pair under ``model_cfg`` — the
    per-block unit the migration planner converts block counts into
    wire bytes with. The pool holds the model's dtype: a bf16 page is
    half an f32 one. On a ``mesh`` it is this rank's page: the KV heads
    the rank's pool holds (:func:`~horovod_tpu_torch.serve.kv_cache.
    pool_kv_heads`)."""
    try:
        itemsize = torch.empty((), dtype=model_cfg.dtype).element_size()
    except Exception:
        itemsize = 4
    return int(2 * model_cfg.n_layers * block_size
               * pool_kv_heads(model_cfg, mesh) * model_cfg.head_dim
               * itemsize)


def kv_head_slice(model_cfg, mesh=None) -> slice:
    """The KV heads of this rank's pool among a whole page's
    ``n_kv_heads``: the tp coordinate's run of
    :func:`~horovod_tpu_torch.serve.kv_cache.pool_kv_heads`, or every
    head where the pool holds them all."""
    n = pool_kv_heads(model_cfg, mesh)
    if n == model_cfg.n_kv_heads:
        return slice(None)
    t = axis_index(mesh, "tp")
    return slice(t * n, (t + 1) * n)


def broadcast_pages(h, group, device):
    """Handoff ``h`` with the pages of the first rank of ``group`` on
    every rank of it: K and V stacked into one tensor on ``device``, one
    broadcast (the other ranks' ``h`` need only the pages' shape and
    dtype). ``h`` itself where ``group`` is None."""
    if group is None:
        return h
    shape = (2,) + tuple(h.k_pages.shape)
    if dist.get_rank(group) == 0:
        buf = torch.stack([h.k_pages, h.v_pages]).to(device)
    else:
        buf = torch.empty(shape, dtype=h.k_pages.dtype, device=device)
    dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
    return dataclasses.replace(h, k_pages=buf[0], v_pages=buf[1])


def slice_pages(h, model_cfg, mesh=None):
    """Handoff ``h`` of whole pages (every KV head: a worker's) cut to
    this rank's pool on ``mesh`` (:func:`kv_head_slice`), bitwise."""
    s = kv_head_slice(model_cfg, mesh)
    return dataclasses.replace(
        h, k_pages=h.k_pages[:, :, :, s].contiguous(),
        v_pages=h.v_pages[:, :, :, s].contiguous())


def gather_pages(h, model_cfg, mesh, device):
    """Handoff ``h`` of this rank's KV heads (a mesh replica's export)
    made whole: the tp ranks' heads all-gathered in tp order (one
    all-gather of K and V stacked, on ``device``). ``h`` itself where
    the pool holds every head. Every rank of the tp axis calls it."""
    if kv_head_slice(model_cfg, mesh) == slice(None):
        return h
    buf = torch.stack([h.k_pages, h.v_pages]).to(device)
    full = collectives.allgather(buf, tp_group(mesh), axis=4)
    return dataclasses.replace(h, k_pages=full[0], v_pages=full[1])


def chunk_menu(n_pages: int) -> List[int]:
    """Candidate chunk sizes (in pages) the planner sweeps: powers of
    two up to the page count, plus the monolithic transfer."""
    if n_pages < 1:
        return [1]
    menu = []
    c = 1
    while c < n_pages:
        menu.append(c)
        c *= 2
    menu.append(n_pages)
    return menu


def plan_migration(n_pages: int, page_bytes: int, *,
                   src: int, dst: int,
                   codec: Optional[str] = None,
                   model: Optional[Dict[str, Any]] = None,
                   ) -> Dict[str, Any]:
    """Pick the chunk schedule for one candidate migration: sweep
    :func:`chunk_menu` through :func:`migration_cost_us` over the wire
    byte count (codec applied) and return the argmin::

        {"chunk_pages", "n_chunks", "cost_us", "wire_bytes"}

    No model (or loopback) → ONE monolithic chunk with cost 0: with
    no evidence that per-chunk latency is cheap, blind chunking only
    multiplies the target's per-chunk inject dispatches (measured to
    dominate small moves), so an unprobed fleet streams each sequence
    whole — exactly the relayed path's granularity — and placement
    degrades to pure least-load."""
    n_pages = max(int(n_pages), 1)
    wire_bytes = int(math.ceil(n_pages * page_bytes
                               * codec_wire_ratio(codec)))
    if model is None or src == dst:
        return {"chunk_pages": n_pages, "n_chunks": 1,
                "cost_us": 0.0, "wire_bytes": wire_bytes}
    best: Optional[Tuple[float, int, int]] = None
    for chunk in chunk_menu(n_pages):
        n_chunks = -(-n_pages // chunk)
        cost = migration_cost_us(model, src, dst, wire_bytes, n_chunks)
        if best is None or cost < best[0]:
            best = (cost, chunk, n_chunks)
    cost, chunk, n_chunks = best
    return {"chunk_pages": chunk, "n_chunks": n_chunks,
            "cost_us": cost, "wire_bytes": wire_bytes}
