"""Continuous-batching inference engine — the counterpart of
:mod:`horovod_tpu.serve.engine`, on one device or over a tp/ep mesh.

Scheduling is **iteration-level** (Orca / vLLM): every
:meth:`ServeEngine.step` retires the sequences that finished on the
previous iteration, expires queued requests past their deadline, admits
new requests into the running batch, runs their prefill (in chunks when
``prefill_chunk`` is set), then runs ONE decode iteration for everything
active. New requests join mid-flight and finished ones leave at once.

Admission control is two-layered: **queue backpressure** (:meth:`submit`
raises :class:`QueueFull`, a 503, once ``max_queue`` requests wait) and
**KV backpressure** (a request is admitted only when the block pool can
reserve its worst case, prompt + max_new_tokens, so a running sequence
never runs out of blocks mid-decode).

Two throughput levers sit on the paged layout: **prefix caching**
(admission maps every leading whole prompt block already in the content
index into the new sequence's table; only the rest is prefilled; full
prompt blocks are published back after they are written) and **chunked
prefill** (a long suffix streams in block-aligned chunks across steps,
interleaved with decode).

Deadlines are absolute engine-clock times by which a request must be
admitted; a stale request gets a structured rejection (``reason``, its
``deadline_class`` and a ``retry_after_s`` estimate from the queue depth
and the recent retirement rate). The clock is injectable for tests.

The handoff and migration surface moves a sequence's K/V pages, as
host copies, from one engine to another: :meth:`export_prefilled`
(a prefill-only request, ``submit(prefill_only=True)``),
:meth:`export_running` (a sequence mid-decode) and
:meth:`inject_prefilled` / :meth:`inject_begin` / :meth:`inject_chunk`
/ :meth:`inject_commit` / :meth:`inject_abort` on the receiving side.

Determinism: FIFO admission, stable batch slots and greedy argmax — the
same submissions always give the same tokens.

On a mesh (``mesh=``, one process a card, each with its own engine)
every rank submits the same requests in the same order and steps in
lockstep: the programs' collectives need every rank of the mesh to call
the same program on the same shapes. Every host decision is a function
of the submissions, the tokens (equal on every rank) and the clock, so
each step reads the clock once and takes mesh rank 0's reading
(:meth:`ServeEngine._now`, or the reading a mesh router hands
:meth:`ServeEngine.step`); deadlines therefore expire alike on every
rank. A submit and a completed prefill stamp the request with mesh rank
0's reading too (:func:`lockstep_now`), so every rank returns the same
:class:`RequestResult`. A dp axis holds replicas that serve the same
stream, as GSPMD replicates the reference's unsharded batch.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch.profiler import record_function

from horovod_tpu_torch.device import resolve_device
from horovod_tpu_torch.models.transformer import (_check_shardable,
                                                  named_param_leaves,
                                                  param_leaves, param_shapes,
                                                  shard_dims)
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.parallel.mesh import AXES, axes_group, mesh_axis_size
from horovod_tpu_torch.serve import decode as decode_lib
from horovod_tpu_torch.serve.kv_cache import (BlockAllocator, hash_chain,
                                              init_kv_cache, pick_bucket)
from horovod_tpu_torch.serve.metrics import ServeMetrics


class QueueFull(RuntimeError):
    """Admission-queue backpressure: shed load upstream. Carries the
    structured-rejection fields, so a caller can tell its client when to
    retry."""
    http_status = 503

    def __init__(self, msg: str, *, reason: str = "queue_full",
                 queue_depth: int = 0,
                 retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.reason = reason
        self.queue_depth = queue_depth
        self.retry_after_s = retry_after_s


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs (the model's shape lives in ``TransformerConfig``)."""

    max_batch: int = 8           # decode batch slots
    max_queue: int = 64          # admission queue depth (then 503)
    block_size: int = 16         # KV tokens per block
    n_blocks: Optional[int] = None   # pool size; default = worst case
    max_prompt: int = 512        # longest admissible prompt
    max_new_tokens: int = 128    # per-request generation cap
    eos_id: Optional[int] = None
    # Shape buckets (None = powers-of-two menus): they fix the padded
    # prompt and batch shapes the programs compute with.
    batch_buckets: Optional[tuple] = None
    prefill_buckets: Optional[tuple] = None
    # "continuous": iteration-level admission. "static": admit only
    # into an empty batch — the classical loop, the benchmark baseline.
    scheduling: str = "continuous"
    cache_dtype: Any = None      # default: the model's dtype
    # Map whole-block prompt prefixes out of the content-addressed block
    # cache instead of recomputing them.
    prefix_caching: bool = True
    # Max prefill tokens per engine step (block-aligned); None = every
    # admitted request's whole suffix prefills in its admission step.
    prefill_chunk: Optional[int] = None
    # Passed to the programs' embedding lookup, which reads it only on
    # a mesh whose tp does not divide the vocabulary.
    compression: Any = None
    # Speculative decoding (serve/speculative.py): `draft` is a
    # speculative.DraftConfig, `spec_k` the tokens the draft proposes a
    # round, all verified in one target step. Both set or neither.
    draft: Any = None
    spec_k: int = 0


@dataclasses.dataclass
class RequestResult:
    rid: int
    status: str                  # "ok" | "expired" | "shed"
    http_status: int             # 200 | 503
    tokens: List[int]
    n_prompt: int
    submitted_at: float
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    # Structured rejection (status != "ok"): the reason, the request's
    # deadline class and how long the client should back off.
    reason: Optional[str] = None
    deadline_class: int = 0
    retry_after_s: Optional[float] = None

    @property
    def first_token_latency_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at


@dataclasses.dataclass
class _Queued:
    rid: int
    prompt: List[int]
    max_new: int
    deadline: Optional[float]
    submitted_at: float
    chain: List[bytes]           # content-hash chain, hashed once at
    #                              submit (not per admission retry)
    deadline_class: int = 0
    prefill_only: bool = False   # park for handoff instead of decoding
    trace: int = 0               # trace id (0 = unsampled)


@dataclasses.dataclass
class _Seq:
    rid: int
    prompt: List[int]
    max_new: int
    blocks: List[int]            # refs held: shared prefix + private
    table: torch.Tensor          # [table_width] int32 physical block ids
    n_cached: int                # tokens currently in the KV cache
    generated: List[int]
    submitted_at: float
    chain: List[bytes]           # one hash per full prompt block
    #                              (empty: caching off)
    registered: int              # prompt blocks published (or mapped
    #                              from the cache) so far
    first_token_at: Optional[float] = None
    last_prefill_tok: int = 0    # argmax at the newest chunk's last real
    #                              position: the first generated token
    #                              once prefill completes
    deadline_class: int = 0
    prefill_only: bool = False
    trace: int = 0

    @property
    def last_token(self) -> int:
        return self.generated[-1]

    def finished(self, eos_id: Optional[int]) -> bool:
        return (len(self.generated) >= self.max_new
                or (eos_id is not None and self.last_token == eos_id))


@dataclasses.dataclass
class PrefillHandoff:
    """A sequence packaged for another engine: its K/V pages as host
    (CPU) copies and the request state needed to go on decoding there.
    The pages are bitwise copies and the decode math depends on
    positions only, so a handed-off sequence decodes to the tokens it
    would have produced in place.

    :meth:`ServeEngine.export_prefilled` (a completed prefill:
    ``n_cached`` is the prompt length, ``generated`` the one token the
    prefill emitted) and :meth:`ServeEngine.export_running` (a sequence
    mid-decode) both produce it; :meth:`ServeEngine.inject_prefilled`
    consumes either."""

    prompt: List[int]
    max_new: int
    generated: List[int]         # tokens emitted so far (>= 1)
    submitted_at: float
    first_token_at: float
    deadline_class: int
    chain: List[bytes]           # content-hash chain (may be empty)
    k_pages: Any                 # [L, n_pages, bs, Hkv, Dh], on the CPU
    v_pages: Any                 # (on a mesh, this rank's KV heads)
    block_size: int
    n_cached: int                # tokens covered by the pages
    trace_id: int = 0

    @property
    def n_pages(self) -> int:
        return int(self.k_pages.shape[1])


class RetireEma:
    """Inter-retirement interval EMA: the drain-rate signal behind every
    ``retry_after_s`` estimate (0.8/0.2 smoothing, seeded by the first
    observation)."""

    def __init__(self):
        self.value = 0.0
        self._last: Optional[float] = None

    def observe(self, now: float) -> None:
        if self._last is not None:
            dt = max(now - self._last, 0.0)
            self.value = (0.8 * self.value + 0.2 * dt
                          if self.value else dt)
        self._last = now

    def retry_after(self, queue_depth: int) -> float:
        """Requests ahead times the recent inter-retirement interval;
        0.0 before any retirement."""
        return round(queue_depth * self.value, 6)


def validate_request(serve_cfg: ServeConfig, model_cfg, n_pool_blocks: int,
                     prompt: List[int], max_new: int,
                     deadline_class: int) -> None:
    """Admission validation, shared by the engine and anything that
    accepts requests before an engine sees them."""
    if not prompt:
        raise ValueError("empty prompt")
    if len(prompt) > serve_cfg.max_prompt:
        raise ValueError(
            f"prompt length {len(prompt)} > max_prompt "
            f"{serve_cfg.max_prompt}")
    if not 1 <= max_new <= serve_cfg.max_new_tokens:
        raise ValueError(
            f"max_new_tokens {max_new} outside [1, "
            f"{serve_cfg.max_new_tokens}]")
    if len(prompt) + max_new > model_cfg.max_seq:
        raise ValueError(
            f"prompt+max_new {len(prompt) + max_new} > model max_seq "
            f"{model_cfg.max_seq}")
    if deadline_class < 0:
        raise ValueError(f"deadline_class {deadline_class} < 0")
    need = -(-(len(prompt) + max_new) // serve_cfg.block_size)
    if need > n_pool_blocks - 1:
        # The worst case exceeds the whole pool: admission could never
        # succeed and FIFO would starve every request behind it.
        raise ValueError(
            f"request needs {need} KV blocks worst-case but the pool "
            f"holds {n_pool_blocks - 1}; raise n_blocks or lower "
            "max_new_tokens")


def _pow2_menu(lo: int, hi: int) -> tuple:
    out = []
    b = lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(out)


#: The mesh axes serving shards over; dp holds replicas.
SERVE_AXES = ("dp", "tp", "ep")


def check_serve_mesh(model_cfg, mesh, device) -> None:
    """Raise unless ``model_cfg`` serves on ``mesh`` from ``device``:
    the mesh's device type is the engine's, its axes other than dp, tp
    and ep are 1, and the model splits over it (heads and FFN hidden
    over tp, experts over ep; a vocabulary tp does not divide is held
    whole)."""
    if mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot serve on "
                         f"{device}")
    bad = {a: mesh_axis_size(mesh, a) for a in AXES
           if a not in SERVE_AXES and mesh_axis_size(mesh, a) > 1}
    if bad:
        raise ValueError(f"serving shards over tp and ep (dp holds "
                         f"replicas); mesh axes {bad} must be 1")
    _check_shardable(model_cfg, mesh, serving=True)


def check_shards(model_cfg, params, mesh) -> None:
    """Raise unless ``params`` has the shapes of this rank's shards on
    ``mesh`` (:func:`~horovod_tpu_torch.models.transformer.
    shard_params` with ``serving=True``)."""
    for (name, p), shape, dims in zip(
            named_param_leaves(params),
            param_leaves(param_shapes(model_cfg)),
            param_leaves(shard_dims(model_cfg, mesh))):
        want = list(shape)
        for axis, d in dims:
            want[d] //= mesh_axis_size(mesh, axis)
        if list(p.shape) != want:
            raise ValueError(
                f"parameter {name} is {tuple(p.shape)}, not this rank's "
                f"shard {tuple(want)} on the mesh: pass shard_params("
                f"params, cfg, mesh, serving=True)")


def lockstep_now(clock, group=None, device=None) -> float:
    """A reading of ``clock``: this process's, or with ``group`` (the
    group a mesh steps in lockstep over) the reading of the group's
    first rank, broadcast as one f64 on ``device``. Every rank of the
    group calls it alike (a collective), and then expires, stamps and
    times alike."""
    now = clock()
    if group is None:
        return now
    t = torch.tensor([now], dtype=torch.float64, device=device)
    return collectives.broadcast(t, 0, group).item()


def _ints(values, n: int) -> torch.Tensor:
    """``values`` in an int32 row of length ``n``, zero-padded."""
    out = torch.zeros(n, dtype=torch.int32)
    out[:len(values)] = torch.tensor(values, dtype=torch.int32)
    return out


class ServeEngine:
    def __init__(self, model_cfg, params, serve_cfg: Optional[ServeConfig]
                 = None, mesh: Optional[Any] = None,
                 clock=time.perf_counter,
                 instance: Optional[str] = None, device=None):
        cfg = serve_cfg or ServeConfig()
        if cfg.scheduling not in ("continuous", "static"):
            raise ValueError(f"unknown scheduling {cfg.scheduling!r}")
        if (cfg.draft is None) != (cfg.spec_k == 0) or cfg.spec_k < 0:
            raise ValueError(
                f"draft= and spec_k= go together (draft="
                f"{'set' if cfg.draft is not None else None}, spec_k="
                f"{cfg.spec_k}): set both for speculative decoding, "
                "neither for plain decode")
        self.device = resolve_device(device)
        for leaf in param_leaves(params):
            if leaf.device != self.device:
                raise ValueError(
                    f"ServeEngine on {self.device}: a parameter lies on "
                    f"{leaf.device}; move the parameters to the engine's "
                    "device first")
        # The group every rank of the mesh steps in lockstep over (None
        # for one process): the clock is read once a step, from its
        # first rank.
        self._lockstep = None
        if mesh is not None:
            check_serve_mesh(model_cfg, mesh, self.device)
            check_shards(model_cfg, params, mesh)
            group = axes_group(mesh, AXES)
            if collectives.axis_size(group) > 1:
                self._lockstep = group
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.mesh = mesh
        self._params = params
        self._clock = clock

        bs = cfg.block_size
        # Prompt buckets are whole blocks (prefill writes pages).
        max_prompt_padded = -(-cfg.max_prompt // bs) * bs
        self._prefill_buckets = cfg.prefill_buckets or _pow2_menu(
            bs, max_prompt_padded)
        self._batch_buckets = cfg.batch_buckets or _pow2_menu(
            1, cfg.max_batch)
        self._table_width = -(-(max_prompt_padded + cfg.max_new_tokens) // bs)
        # Fail at construction, not mid-step after blocks are reserved:
        # every admissible request must fit a bucket, and every bucket's
        # pages must fit the block table.
        if any(b % bs for b in self._prefill_buckets):
            raise ValueError(
                f"prefill_buckets {self._prefill_buckets} must be "
                f"multiples of block_size {bs}")
        if max(self._prefill_buckets) // bs > self._table_width:
            raise ValueError(
                f"largest prefill bucket {max(self._prefill_buckets)} "
                f"needs {max(self._prefill_buckets) // bs} blocks but "
                f"the block table holds {self._table_width}")
        pick_bucket(cfg.max_prompt, self._prefill_buckets)
        pick_bucket(cfg.max_batch, self._batch_buckets)
        if cfg.prefill_chunk is not None:
            # Chunks start block-aligned (the resume program's page
            # writes are blockwise) and fit a bucket.
            if cfg.prefill_chunk < bs or cfg.prefill_chunk % bs:
                raise ValueError(
                    f"prefill_chunk {cfg.prefill_chunk} must be a "
                    f"positive multiple of block_size {bs}")
            pick_bucket(cfg.prefill_chunk, self._prefill_buckets)

        # Inject pad widths, in blocks: the prefill buckets plus the
        # whole table (a migrated running sequence may carry prompt and
        # generated pages beyond the largest prompt bucket).
        self._inject_widths = tuple(sorted(
            {b // bs for b in self._prefill_buckets}
            | {self._table_width}))

        n_blocks = cfg.n_blocks
        if n_blocks is None:
            # Worst case: every batch slot holds a maximal sequence
            # (+1 for the null block).
            n_blocks = cfg.max_batch * self._table_width + 1
        self.allocator = BlockAllocator(n_blocks, bs)
        self.cache = init_kv_cache(model_cfg, n_blocks, bs, mesh=mesh,
                                   dtype=cfg.cache_dtype, device=self.device)
        (self._prefill_fn, self._resume_fn, self._decode_fn,
         self._inject_fn, self._verify_fn) = decode_lib.make_serve_fns(
             model_cfg, mesh, block_size=bs, table_width=self._table_width,
             device=self.device, compression=cfg.compression)

        self.metrics = ServeMetrics(clock=clock, instance=instance)
        self.metrics.attach_allocator(self.allocator)
        self._queue: collections.deque[_Queued] = collections.deque()
        self._active: List[_Seq] = []
        # Admitted sequences whose prefill has not completed: they hold
        # their reservation and a batch slot, and join the decode batch
        # once prefill finishes.
        self._prefilling: List[_Seq] = []
        # prefill_only sequences whose prefill completed, parked with
        # their prompt blocks until exported (not counted in `pending`).
        self._handoff: Dict[int, _Seq] = {}
        self._results: Dict[int, RequestResult] = {}
        self._rids = itertools.count()
        # Staged (chunked) injects in flight: token -> {meta, blocks,
        # n_pages, cursor}; invisible to admission and decode until
        # commit, and an abort returns the reservation.
        self._inject_staging: Dict[int, Dict[str, Any]] = {}
        self._inject_tokens = itertools.count()
        self._retire_ema = RetireEma()
        # The speculative side-car: draft params, its own KV pool and
        # the propose/verify/accept round that replaces _decode_once.
        self._spec = None
        if cfg.draft is not None:
            from horovod_tpu_torch.serve.speculative import SpecDecoder
            self._spec = SpecDecoder(self)

    # -- submission --------------------------------------------------

    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               deadline: Optional[float] = None,
               deadline_class: int = 0,
               prefill_only: bool = False,
               chain: Optional[List[bytes]] = None,
               trace_id: int = 0) -> int:
        """Enqueue a request; returns its id. Raises :class:`QueueFull`
        when the admission queue is full and ``ValueError`` on shapes
        the engine can never serve. ``deadline_class`` rides
        rejections; ``prefill_only`` parks the sequence for
        :meth:`export_prefilled` instead of decoding it here; ``chain``
        is the prompt's precomputed hash chain (trusted: it must equal
        ``hash_chain(prompt, block_size)``); ``trace_id`` (0 =
        unsampled) tags this request's prefill and decode spans."""
        prompt = [int(t) for t in prompt]
        max_new = (self.cfg.max_new_tokens if max_new_tokens is None
                   else max_new_tokens)
        validate_request(self.cfg, self.model_cfg,
                         self.allocator.n_blocks, prompt, max_new,
                         deadline_class)
        if len(self._queue) >= self.cfg.max_queue:
            self.metrics.record_rejected()
            raise QueueFull(
                f"admission queue full ({self.cfg.max_queue} waiting)",
                queue_depth=len(self._queue),
                retry_after_s=self._retry_after())
        rid = next(self._rids)
        chain = ((hash_chain(prompt, self.cfg.block_size)
                  if chain is None else chain)
                 if self.cfg.prefix_caching else [])
        self._queue.append(_Queued(rid, prompt, max_new, deadline,
                                   self._now(), chain,
                                   deadline_class=deadline_class,
                                   prefill_only=prefill_only,
                                   trace=trace_id))
        self.metrics.record_submitted()
        self.metrics.record_queue_depth(len(self._queue))
        return rid

    # -- results -----------------------------------------------------

    @property
    def pending(self) -> bool:
        return bool(self._queue or self._prefilling or self._active)

    def result(self, rid: int) -> Optional[RequestResult]:
        return self._results.get(rid)

    @property
    def results(self) -> Dict[int, RequestResult]:
        return dict(self._results)

    # -- fleet hooks (host-side reads; nothing here steps the engine or
    #    touches the device) -----------------------------------------

    def _retry_after(self) -> float:
        return self._retire_ema.retry_after(len(self._queue))

    def admission_snapshot(self) -> Dict[str, float]:
        """Occupancy, free KV blocks and queue depth: host-side counter
        reads a router can poll without stepping the engine."""
        n_run = len(self._active) + len(self._prefilling)
        return {
            "queue_depth": len(self._queue),
            "queue_slots_free": self.cfg.max_queue - len(self._queue),
            "running": n_run,
            "batch_slots_free": self.cfg.max_batch - n_run,
            "occupancy": n_run / self.cfg.max_batch,
            "kv_blocks_free": self.allocator.n_free,
            "kv_blocks_used": self.allocator.n_used,
            "handoff_parked": len(self._handoff),
            "retry_after_s": self._retry_after(),
        }

    def cached_chain_len(self, chain: Sequence[bytes]) -> int:
        """Leading blocks of ``chain`` this engine's content index holds
        (live or cached): the prefix-affinity signal. Non-mutating
        (``peek``)."""
        n = 0
        for h in chain:
            if self.allocator.peek(h) is None:
                break
            n += 1
        return n

    def withdraw(self, rid: int) -> bool:
        """Remove a still-queued (never admitted) request, without a
        result. False if ``rid`` is unknown, admitted or resolved."""
        for i, req in enumerate(self._queue):
            if req.rid == rid:
                del self._queue[i]
                self.metrics.record_withdrawn()
                self.metrics.record_queue_depth(len(self._queue))
                return True
        return False

    # -- the scheduler iteration ------------------------------------

    def _now(self) -> float:
        """A clock reading to step on or stamp a result with: this
        engine's clock, or on a mesh the first rank's, broadcast (one
        f64 a read), so that deadlines expire alike on every rank, the
        ranks call the same programs and every result carries the same
        times."""
        return lockstep_now(self._clock, self._lockstep, self.device)

    def step(self, now: Optional[float] = None) -> None:
        """One iteration: retire → expire → admit → prefill chunk(s)
        → decode. ``now`` is a clock reading the caller already holds
        (a router on a mesh passes mesh rank 0's), taken instead of
        :meth:`_now`'s."""
        now = self._now() if now is None else now
        self._retire_finished(now)
        self._expire_queued(now)
        self._admit(now)
        self._advance_prefills()
        self._decode_once()
        self.metrics.record_queue_depth(len(self._queue))

    def run_until_idle(self, max_steps: int = 1_000_000) -> None:
        for _ in range(max_steps):
            if not self.pending:
                return
            self.step()
        raise RuntimeError(f"engine still busy after {max_steps} steps")

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: Optional[int] = None) -> List[List[int]]:
        """Serve ``prompts`` to completion and return their generated
        token lists in order."""
        rids = [self.submit(p, max_new_tokens) for p in prompts]
        self.run_until_idle()
        return [self._results[r].tokens for r in rids]

    # -- internals ---------------------------------------------------

    def _finish(self, seq: _Seq, now: float) -> None:
        self.allocator.free(seq.blocks)
        if self._spec is not None:
            self._spec.drop(seq.rid)
        self._results[seq.rid] = RequestResult(
            rid=seq.rid, status="ok", http_status=200,
            tokens=list(seq.generated), n_prompt=len(seq.prompt),
            submitted_at=seq.submitted_at,
            first_token_at=seq.first_token_at, finished_at=now,
            deadline_class=seq.deadline_class)
        self._retire_ema.observe(now)
        self.metrics.record_finished()

    def _retire_finished(self, now: float) -> None:
        still = []
        for seq in self._active:
            if seq.finished(self.cfg.eos_id):
                self._finish(seq, now)
            else:
                still.append(seq)
        self._active = still

    def _expire_queued(self, now: float) -> None:
        keep: collections.deque[_Queued] = collections.deque()
        for req in self._queue:
            if req.deadline is not None and now > req.deadline:
                self._results[req.rid] = RequestResult(
                    rid=req.rid, status="expired", http_status=503,
                    tokens=[], n_prompt=len(req.prompt),
                    submitted_at=req.submitted_at, finished_at=now,
                    reason="deadline_expired",
                    deadline_class=req.deadline_class,
                    retry_after_s=self._retry_after())
                self.metrics.record_expired()
            else:
                keep.append(req)
        self._queue = keep

    def _admit(self, now: float) -> None:
        batch_was_empty = not self._active and not self._prefilling
        while (self._queue and
               len(self._active) + len(self._prefilling)
               < self.cfg.max_batch):
            if self.cfg.scheduling == "static" and not batch_was_empty:
                # The baseline scheduler waits for the whole batch to
                # drain before admitting again.
                return
            req = self._queue[0]
            plen = len(req.prompt)
            # A prefill-only sequence never decodes here, so it reserves
            # no max_new tail.
            need = self.allocator.blocks_for_tokens(
                plen if req.prefill_only else plen + req.max_new)
            # Walk the chain against the content index: every leading
            # whole block already cached maps into this sequence's
            # table. Capped at plen-1 tokens: the last prompt token must
            # run through the model (its logits are the first generated
            # token). The walk only peeks, so a blocked request's
            # retries do not inflate the hit counters or reorder the LRU.
            matchable = req.chain[:(plen - 1) // self.cfg.block_size]
            n_match, n_revive = 0, 0
            for h in matchable:
                b = self.allocator.peek(h)
                if b is None:
                    break
                n_match += 1
                if self.allocator.refcount(b) == 0:
                    # Reviving a refcount-0 cached block uses a unit of
                    # n_free, as a fresh allocation does.
                    n_revive += 1
            if not self.allocator.can_alloc(need - n_match + n_revive):
                return       # KV backpressure; FIFO, no overtaking
            self._queue.popleft()
            # Commit: nothing changed since the peek, so the same blocks
            # resolve, and hits count once, for a real admission.
            matched: List[int] = []
            for h in matchable:
                b = self.allocator.acquire_cached(h)
                if b is None:
                    break
                matched.append(b)
            assert len(matched) == n_match
            blocks = matched + self.allocator.alloc(need - n_match)
            n_hit = len(matched) * self.cfg.block_size
            self.metrics.record_prefix_lookup(n_hit, plen - n_hit)
            self._prefilling.append(_Seq(
                rid=req.rid, prompt=req.prompt, max_new=req.max_new,
                blocks=blocks, table=_ints(blocks, self._table_width),
                n_cached=n_hit, generated=[],
                submitted_at=req.submitted_at, chain=req.chain,
                registered=len(matched),
                deadline_class=req.deadline_class,
                prefill_only=req.prefill_only, trace=req.trace))

    def _advance_prefills(self) -> None:
        """Run prefill chunks FIFO across admitted sequences, bounded
        per step by ``prefill_chunk`` tokens (at least one chunk, so
        progress is guaranteed). With ``prefill_chunk=None`` every
        waiting suffix completes this step."""
        budget = self.cfg.prefill_chunk
        spent = 0
        while self._prefilling and (budget is None or spent < budget):
            seq = self._prefilling[0]
            self._extend_prefix_match(seq)
            remaining = len(seq.prompt) - seq.n_cached
            if budget is None:
                chunk = remaining
            else:
                # Cap by the unspent budget; a non-final chunk ends
                # block-aligned (the next chunk's pages start there).
                chunk = min(remaining, budget - spent)
                if chunk < remaining:
                    chunk -= chunk % self.cfg.block_size
                    if chunk == 0:
                        break
            spent += self._run_prefill_chunk(seq, chunk)
            if seq.n_cached >= len(seq.prompt):
                self._prefilling.pop(0)
                self._complete_prefill(seq)

    def _extend_prefix_match(self, seq: _Seq) -> None:
        """Retry the cache walk just before prefilling: same-step
        siblings admitted earlier have published their prefix by now.
        Safe while the cursor sits on a block boundary with every block
        up to it published or mapped: the swapped slots hold no K/V
        yet, and the displaced private blocks return to the pool."""
        if (not self.cfg.prefix_caching
                or seq.n_cached != seq.registered * self.cfg.block_size):
            return
        plen = len(seq.prompt)
        extended = 0
        for i in range(seq.registered,
                       (plen - 1) // self.cfg.block_size):
            # peek first: a cold prompt would otherwise log one miss per
            # chunk boundary.
            if self.allocator.peek(seq.chain[i]) is None:
                break
            b = self.allocator.acquire_cached(seq.chain[i])
            if b is None:
                break
            self.allocator.free([seq.blocks[i]])
            seq.blocks[i] = b
            seq.table[i] = b
            seq.n_cached += self.cfg.block_size
            seq.registered += 1
            extended += self.cfg.block_size
        if extended:
            self.metrics.record_prefix_extend(extended)

    def _run_prefill_chunk(self, seq: _Seq, chunk: int) -> int:
        plen = len(seq.prompt)
        offset = seq.n_cached
        toks = _ints(seq.prompt[offset:offset + chunk],
                     pick_bucket(chunk, self._prefill_buckets))
        t0 = self._clock()
        with record_function("serve:prefill"):
            if offset == 0 and chunk == plen:
                # A whole cold prompt: the monolithic program, whose
                # attention is the flash kernel over the prompt alone.
                kc, vc, tok = self._prefill_fn(
                    self._params, self.cache.k, self.cache.v, toks,
                    plen, seq.table)
            else:
                kc, vc, tok = self._resume_fn(
                    self._params, self.cache.k, self.cache.v, toks,
                    offset, chunk, seq.table)
            tok = int(tok)  # host sync: the step is done when this is
        dur = self._clock() - t0
        self.cache.k, self.cache.v = kc, vc
        seq.n_cached = offset + chunk
        seq.last_prefill_tok = tok
        self.metrics.record_prefill(t0, dur, chunk, offset=offset,
                                    trace=seq.trace)
        if self.cfg.prefix_caching:
            # Publish the prompt blocks this chunk filled; a hash
            # already published keeps this copy anonymous.
            n_full = seq.n_cached // self.cfg.block_size
            for i in range(seq.registered, n_full):
                self.allocator.register(seq.blocks[i], seq.chain[i])
            seq.registered = max(seq.registered, n_full)
        return chunk

    def _complete_prefill(self, seq: _Seq) -> None:
        now = self._now()
        seq.generated.append(seq.last_prefill_tok)
        seq.first_token_at = now
        self.metrics.record_first_token(now - seq.submitted_at)
        if seq.finished(self.cfg.eos_id):
            # One-token requests (or an immediate eos) finish here, even
            # prefill-only ones: nothing is left to hand off.
            self._finish(seq, now)
        elif seq.prefill_only:
            self._handoff[seq.rid] = seq
        else:
            self._active.append(seq)

    # -- prefill/decode disaggregation (KV handoff) ------------------

    def handoff_ready(self) -> List[int]:
        """rids of prefill-only sequences parked for
        :meth:`export_prefilled`."""
        return list(self._handoff)

    def export_prefilled(self, rid: int) -> PrefillHandoff:
        """Pop a parked prefill-only sequence: copy its K/V pages off
        this pool, free its blocks, and return the package another
        engine feeds to :meth:`inject_prefilled`."""
        return self._export_seq(self._handoff.pop(rid))

    def _export_seq(self, seq: _Seq) -> PrefillHandoff:
        """Package ``seq``: bitwise copies of every block its cached
        tokens touch (the partial tail block rides whole; its bytes
        past ``n_cached`` are never attended to), then free the local
        reservation."""
        n_blk = self.allocator.blocks_for_tokens(seq.n_cached)
        idx = torch.tensor(seq.blocks[:n_blk], dtype=torch.long,
                           device=self.device)
        k_pages = self.cache.k[:, idx].cpu()
        v_pages = self.cache.v[:, idx].cpu()
        self.allocator.free(seq.blocks)
        if self._spec is not None:
            self._spec.drop(seq.rid)
        self.metrics.record_handoff_out()
        return PrefillHandoff(
            prompt=list(seq.prompt), max_new=seq.max_new,
            generated=list(seq.generated),
            submitted_at=seq.submitted_at,
            first_token_at=seq.first_token_at,
            deadline_class=seq.deadline_class, chain=list(seq.chain),
            k_pages=k_pages, v_pages=v_pages,
            block_size=self.cfg.block_size, n_cached=seq.n_cached,
            trace_id=seq.trace)

    def running_exportable(self) -> List[int]:
        """rids of decoding sequences a drain could migrate now: active,
        prefill complete and not finished (a finished one must retire
        here)."""
        return [s.rid for s in self._active
                if not s.finished(self.cfg.eos_id)]

    def export_running(self, rid: int) -> PrefillHandoff:
        """Pop a sequence mid-decode and package it for
        :meth:`inject_prefilled` on another engine: its prompt and
        generated-token K/V move bitwise."""
        for i, seq in enumerate(self._active):
            if seq.rid == rid:
                break
        else:
            raise KeyError(f"no running sequence {rid}")
        if seq.finished(self.cfg.eos_id):
            raise ValueError(
                f"sequence {rid} already finished — retire it here "
                "instead of migrating it")
        del self._active[i]
        return self._export_seq(seq)

    def inject_prefilled(self, h: PrefillHandoff) -> int:
        """Admit a handed-off sequence straight into the decode batch:
        reserve its worst-case blocks, scatter its pages into this pool
        and decode on from its last token. Raises :class:`QueueFull` (no
        batch slot) or ``OutOfBlocks``. The one-chunk case of
        :meth:`inject_begin` / :meth:`inject_chunk` /
        :meth:`inject_commit`."""
        token = self.inject_begin({
            "prompt": h.prompt, "max_new": h.max_new,
            "generated": h.generated, "submitted_at": h.submitted_at,
            "first_token_at": h.first_token_at,
            "deadline_class": h.deadline_class, "chain": h.chain,
            "block_size": h.block_size, "n_cached": h.n_cached,
            "n_pages": h.n_pages, "trace_id": h.trace_id})
        try:
            self.inject_chunk(token, h.k_pages, h.v_pages)
        except BaseException:
            self.inject_abort(token)
            raise
        return self.inject_commit(token)

    def inject_begin(self, meta: Dict[str, Any]) -> int:
        """First leg of a staged inject: validate the manifest (what
        :meth:`inject_prefilled` checks, pages excluded) and reserve the
        sequence's worst-case blocks. Returns a staging token for
        :meth:`inject_chunk` / :meth:`inject_commit` /
        :meth:`inject_abort`; until commit the sequence is invisible to
        decode, admission and results."""
        if meta["block_size"] != self.cfg.block_size:
            raise ValueError(
                f"handoff block_size {meta['block_size']} != engine "
                f"block_size {self.cfg.block_size} — engines must "
                "share geometry for pages to map block-for-block")
        plen = len(meta["prompt"])
        n_cached = int(meta["n_cached"])
        if not (plen <= n_cached <= plen + meta["max_new"]
                and meta["generated"]
                and n_cached == plen + len(meta["generated"]) - 1):
            raise ValueError(
                f"inconsistent handoff: n_cached={n_cached} "
                f"prompt={plen} generated={len(meta['generated'])}")
        n_page = int(meta["n_pages"])
        if n_page != self.allocator.blocks_for_tokens(n_cached):
            raise ValueError(
                f"handoff carries {n_page} pages but n_cached="
                f"{n_cached} needs "
                f"{self.allocator.blocks_for_tokens(n_cached)}")
        if len(self._active) + len(self._prefilling) >= self.cfg.max_batch:
            raise QueueFull("no batch slot for handoff",
                            reason="no_batch_slot",
                            retry_after_s=self._retry_after())
        need = self.allocator.blocks_for_tokens(plen + meta["max_new"])
        blocks = self.allocator.alloc(need)
        token = next(self._inject_tokens)
        self._inject_staging[token] = {
            "meta": meta, "blocks": blocks, "n_pages": n_page,
            "cursor": 0}
        return token

    def inject_chunk(self, token: int, k_pages, v_pages) -> int:
        """Scatter one run of pages (``[cursor, cursor + chunk)`` in
        manifest order) into the reserved blocks, in place: O(carried
        pages), never a whole-pool copy. The chunk is padded to a width
        of the inject menu with zero pages aimed at the null block.
        Chunks target disjoint blocks, so the committed pool is the
        same however the pages were chunked. Returns pages remaining."""
        st = self._inject_staging[token]
        k_pages = torch.as_tensor(k_pages)
        v_pages = torch.as_tensor(v_pages)
        if k_pages.shape[2:] != self.cache.k.shape[2:]:
            raise ValueError(
                f"inject pages of {tuple(k_pages.shape[2:])} (block, KV "
                f"heads, head dim) into a pool of "
                f"{tuple(self.cache.k.shape[2:])}: on a mesh, engines "
                "hand over the pages of the same tp rank")
        cn = int(k_pages.shape[1])
        if cn < 1 or st["cursor"] + cn > st["n_pages"]:
            raise ValueError(
                f"inject chunk of {cn} pages at cursor {st['cursor']} "
                f"overruns the {st['n_pages']}-page manifest")
        width = pick_bucket(cn, self._inject_widths)
        idx = _ints(st["blocks"][st["cursor"]:st["cursor"] + cn], width)
        if cn < width:
            pad = (0, 0) * (k_pages.dim() - 2) + (0, width - cn)
            k_pages = torch.nn.functional.pad(k_pages, pad)
            v_pages = torch.nn.functional.pad(v_pages, pad)
        self.cache.k, self.cache.v = self._inject_fn(
            self.cache.k, self.cache.v, idx, k_pages, v_pages)
        st["cursor"] += cn
        return st["n_pages"] - st["cursor"]

    def inject_commit(self, token: int) -> int:
        """Every manifest page landed: put the sequence in the decode
        batch and return its rid. Registration, metrics and batch
        membership all happen here."""
        st = self._inject_staging[token]
        if st["cursor"] != st["n_pages"]:
            raise ValueError(
                f"inject commit with {st['cursor']}/{st['n_pages']} "
                "pages streamed")
        del self._inject_staging[token]
        meta, blocks = st["meta"], st["blocks"]
        rid = next(self._rids)
        seq = _Seq(
            rid=rid, prompt=list(meta["prompt"]),
            max_new=meta["max_new"], blocks=blocks,
            table=_ints(blocks, self._table_width),
            n_cached=int(meta["n_cached"]),
            generated=list(meta["generated"]),
            submitted_at=meta["submitted_at"],
            chain=list(meta["chain"]), registered=0,
            deadline_class=meta["deadline_class"],
            trace=int(meta.get("trace_id", 0)))
        seq.first_token_at = meta["first_token_at"]
        if self.cfg.prefix_caching:
            # Publish the injected prompt blocks locally; a hash already
            # published keeps this copy anonymous.
            for i, ch in enumerate(meta["chain"]):
                self.allocator.register(blocks[i], ch)
            seq.registered = len(meta["chain"])
        self._active.append(seq)
        self.metrics.record_handoff_in()
        return rid

    def inject_abort(self, token: int) -> None:
        """Discard a staged inject: the reservation returns to the pool;
        pages already scattered stay as never-read garbage on freed
        blocks. Idempotent per token."""
        st = self._inject_staging.pop(token, None)
        if st is not None:
            self.allocator.free(st["blocks"])

    def _decode_once(self) -> None:
        if not self._active:
            return
        if self._spec is not None:
            # A speculative round: draft proposals, one target verify,
            # greedy acceptance with cursor-only rollback.
            self._spec.round()
            return
        n = len(self._active)
        bucket = pick_bucket(n, self._batch_buckets)
        tokens = _ints([s.last_token for s in self._active], bucket)
        positions = _ints([s.n_cached for s in self._active], bucket)
        tables = torch.zeros((bucket, self._table_width), dtype=torch.int32)
        for i, seq in enumerate(self._active):
            tables[i] = seq.table
        t0 = self._clock()
        with record_function("serve:decode"):
            kc, vc, out = self._decode_fn(
                self._params, self.cache.k, self.cache.v, tokens,
                positions, tables)
            out = out.tolist()  # host sync
        dur = self._clock() - t0
        self.cache.k, self.cache.v = kc, vc
        for i, seq in enumerate(self._active):
            seq.n_cached += 1
            seq.generated.append(out[i])
        self.metrics.record_decode(
            t0, dur, n, self.cfg.max_batch,
            traces=[s.trace for s in self._active if s.trace])
