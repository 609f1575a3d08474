"""The serving fleet: an admission router over replicas of the engine —
the counterpart of :mod:`horovod_tpu.serve.router`.

One :class:`~horovod_tpu_torch.serve.engine.ServeEngine` is one replica;
heavy traffic from many users needs a fleet. The router owns fleet-level
admission and placement, and its replicas stay plain engines (in this
process) or worker processes behind the RPC plane
(:class:`~horovod_tpu_torch.serve.rpc.RemoteReplica`), driven by the
same code:

* **Cache-affinity placement.** At submit the router hashes the prompt's
  block chain once (:func:`~horovod_tpu_torch.serve.kv_cache.
  hash_chain`) and at placement walks each candidate's content index
  (``cached_chain_len``, a peek): the longest chain wins, and no match
  or a tie falls back to the least-occupied replica. A bounded
  *placed-chain* index remembers where each chain entry was last
  routed, so a burst of one tenant's requests follows its first one
  before anything is prefilled. Random and round-robin placements are
  the benchmark's baselines.
* **Prefill/decode pools.** With ``RouterConfig.n_prefill > 0`` the
  leading replicas only prefill, and each finished prefill's KV pages
  move to a decode replica (``export_prefilled`` ->
  ``inject_prefilled``, or streamed worker to worker by the direct
  plane, :mod:`~horovod_tpu_torch.serve.migrate`). The pages move
  bitwise, so the streams are those of one replica.
* **Shedding by deadline class.** On a full router queue an arrival
  evicts the newest queued request of a strictly worse class, which
  resolves to a structured ``"shed"`` result; otherwise the arrival is
  refused with :class:`FleetSaturated`.
* **Elastic membership and failover.** Replicas join and drain
  (``add_replica``, ``remove_replica``, which can move running
  sequences out); a worker that dies has its uncollected requests
  requeued at the front of the queue, and each resolves exactly once.
  Remote step RPCs fan out, so the workers compute their iterations
  concurrently, while replies apply in fleet order.
* **Multi-model groups** (``add_model``): placement, handoffs, drains
  and failover stay inside a request's model group.
* **Telemetry.** :class:`FleetMetrics` renders fleet rollups under
  ``serve_fleet_``, and ``export_fleet_trace`` writes the router's and
  every replica's spans for
  :mod:`~horovod_tpu_torch.serve.trace_merge`.

Everything is deterministic for a fixed seed: FIFO placement, ties
broken by replica id, and the random baseline drawn from the config's
seed.

**On a mesh** (``mesh=``, one process a card) the rule of
``ServeEngine(mesh=)`` holds one level up: every rank of the mesh runs
the same router over its own shards (``shard_params(serving=True)``),
submits the same requests in the same order and steps in lockstep, and
every replica is a ``ServeEngine(mesh=)`` over the same mesh, as the
reference shards every replica over its one mesh. Every decision is a
function of the submissions, the tokens (equal on every rank) and mesh
rank 0's readings: each clock read is rank 0's, broadcast as one f64
over the mesh (the engines take the step's reading and do not broadcast
again), and the topology model a page move is scored on is rank 0's,
broadcast once a step. A handoff moves each rank's KV heads into the
same rank's pool of the target replica. Rank 0 writes the router's
trace file, and every rank its replicas' under its own rank's name.

Worker replicas stay meshless beside a mesh fleet, as in the reference,
and a worker speaks one connection, so mesh rank 0 alone holds it: rank
0 passes the worker's handle where every other rank passes an
``rpc.MirrorHandle()``, and each of those ranks runs a mirror of the
replica whose every call returns rank 0's outcome, broadcast as one
object a call (:class:`~horovod_tpu_torch.serve.rpc.LockstepConn`): the
reply, or the failure every rank then raises alike, so a worker's
death requeues alike on every rank. A worker's pages carry every KV
head: a handoff from a worker goes to every rank as one broadcast of
rank 0's pages, of which each rank injects its heads; one to a worker
gathers the tp ranks' heads into whole pages, which rank 0 sends. Such a
move counts the whole pages (what crosses the worker's wire). Rank 0
alone writes a worker's trace file.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.device import resolve_device
from horovod_tpu_torch.functions import broadcast_object
from horovod_tpu_torch.models.transformer import param_leaves
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.parallel.mesh import AXES, axes_group
from horovod_tpu_torch.serve import migrate as migrate_mod
from horovod_tpu_torch.serve.engine import (
    QueueFull, RequestResult, RetireEma, ServeConfig, ServeEngine,
    check_serve_mesh, lockstep_now, validate_request,
)
from horovod_tpu_torch.serve.kv_cache import hash_chain
from horovod_tpu_torch.serve.metrics import MAX_SAMPLES, percentile
from horovod_tpu_torch.serve.rpc import (RemoteReplica, RpcConnectionError,
                                         lockstep_handle, span_codec_id)
from horovod_tpu_torch.serve.trace import RouterTrace, mint_trace_id

#: The topology model not yet read this step (a mesh router reads it
#: once a step).
_UNREAD = object()

#: Bound on the router's placed-chain hint index (16-byte hashes ->
#: ~3 MB at the cap); beyond it the oldest routing hints fall off.
#: Stale hints are harmless — the live per-replica index walk is the
#: ground truth, the hint only pre-groups same-prefix bursts.
CHAIN_INDEX_CAP = 65536


def _advance_membership(reason: int, rank: int = -1) -> None:
    """Tick the process-global membership plane: the
    serving fleet's replica churn rides the same epoch
    ``hvd.membership()`` reports for training, so one monotone number
    fences both planes. Safe from any thread — the plane's fences gate
    background-owned state internally. ``rank`` names the affected
    member when there is one (a dead replica's numeric instance): the
    native plane records it in the ``peer_death`` flight event, so a
    post-mortem flight dump says WHO died, not just that someone
    did."""
    basics.get_lib().hvd_membership_advance(reason, rank)


def _record_flap(identity: str) -> None:
    """Record a replica death in the decay blacklist under its fleet
    identity (same flap model the elastic driver uses for hosts)."""
    basics.get_lib().hvd_blacklist_record(
        identity.encode(), time.monotonic())


class FleetSaturated(QueueFull):
    """Router-level shed: the fleet queue is full and nothing queued
    is lower-class than the arrival. Carries ``reason`` /
    ``deadline_class`` / ``retry_after_s`` like every structured
    rejection in the serve tier."""

    def __init__(self, msg: str, *, deadline_class: int,
                 queue_depth: int, retry_after_s: Optional[float]):
        super().__init__(msg, reason="shed_low_class",
                         queue_depth=queue_depth,
                         retry_after_s=retry_after_s)
        self.deadline_class = deadline_class


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Fleet knobs (per-replica knobs live in ``ServeConfig``)."""

    n_replicas: int = 2
    # Leading replicas become a prefill-only pool, the rest decode-only
    # (KV handoff between them). 0 = unified: every replica prefills
    # AND decodes, no handoff.
    n_prefill: int = 0
    # Router-held (not yet placed) request cap; beyond it the shedding
    # policy decides who loses, by deadline class.
    max_queue: int = 256
    # "affinity" (cache-aware, the point of this module) with
    # least-occupancy fallback; "least" = occupancy only;
    # "random" / "round_robin" = benchmark baselines.
    placement: str = "affinity"
    seed: int = 0                # drives the random-placement baseline
    # -- cross-process fleet knobs -----------------------------------
    # Seconds between liveness heartbeats to a remote replica the step
    # loop would not otherwise talk to. 0 = every step (freshest
    # metrics cache; fine on loopback), raise it on real networks.
    heartbeat_every: float = 0.0
    # Wire codec for K/V pages on RPC handoffs: None | "bf16" | "fp16"
    # (the wire cast codecs; bf16 halves migration bytes with the
    # bitwise-pinned decode). Lossy for f32 pools — streams stay
    # deterministic but are the bf16-rounded ones; leave None when the
    # cross-process fleet must be bitwise the in-process one.
    handoff_compression: Optional[str] = None
    # SO_RCVTIMEO/SO_SNDTIMEO on worker connections: a worker that
    # stops answering for this long is declared dead (requeue +
    # failover). Generous default — the first step against a fresh
    # worker builds its kernel and warms its programs. Beside a mesh,
    # keep it under the mesh group's collective timeout: the other
    # ranks wait in a broadcast while rank 0 waits on the worker.
    rpc_timeout: float = 300.0
    # Direct worker<->worker page migration (serve/migrate.py): "env" defers to HOROVOD_FLEET_DIRECT_MIGRATION
    # (auto|off), or force it per-fleet — "off" is the relayed
    # export->router->inject path byte-for-byte; "auto" dials the
    # bulk channel and falls back to relayed when the dial fails.
    direct_migration: str = "env"

    def __post_init__(self):
        if self.n_replicas < 1:
            raise ValueError(f"n_replicas {self.n_replicas} < 1")
        if not 0 <= self.n_prefill < self.n_replicas:
            raise ValueError(
                f"n_prefill {self.n_prefill} must leave at least one "
                f"decode replica out of {self.n_replicas}")
        if self.placement not in ("affinity", "least", "random",
                                  "round_robin"):
            raise ValueError(f"unknown placement {self.placement!r}")
        if self.heartbeat_every < 0:
            raise ValueError(
                f"heartbeat_every {self.heartbeat_every} < 0")
        if self.direct_migration not in ("env", "auto", "off"):
            raise ValueError(
                f"unknown direct_migration {self.direct_migration!r} "
                "(want env, auto, or off)")
        # Fail on garbage at config time, not mid-handoff.
        span_codec_id(self.handoff_compression)


#: The model id of the constructor-registered group: a single-model
#: fleet never has to spell a model id anywhere.
DEFAULT_MODEL = "default"


@dataclasses.dataclass
class _Pending:
    """Router-side copy of a request: enough to (re)place it on any
    same-model replica — this is what makes replica drain lossless
    AND model-correct (a requeued request re-places only within its
    model group)."""

    rid: int
    prompt: List[int]
    max_new: int
    deadline: Optional[float]
    deadline_class: int
    submitted_at: float
    chain: List[bytes]
    model: str = DEFAULT_MODEL
    trace: int = 0               # distributed trace id (0 = unsampled)


@dataclasses.dataclass
class _ModelGroup:
    """One registered model: its configs, params (None for all-remote
    groups), pool split, and the worker params-from-seed contract.
    Replicas of different groups are ordinary fleet members — only
    placement, handoff, drain and the last-replica guard key on the
    group."""

    model_cfg: Any
    params: Any
    serve_cfg: ServeConfig
    n_prefill: int = 0
    worker_seed: int = 0


@dataclasses.dataclass
class _Replica:
    instance: str
    role: str                    # "unified" | "prefill" | "decode"
    engine: Any                  # ServeEngine | rpc.RemoteReplica
    model: str = DEFAULT_MODEL   # the _ModelGroup this replica serves
    draining: bool = False
    remote: bool = False         # engine lives in a worker process
    migrate: bool = False        # drain moves RUNNING decodes out too
    # engine rid -> router rid, for every request placed here whose
    # result has not been collected yet.
    outstanding: Dict[int, int] = dataclasses.field(default_factory=dict)


class FleetMetrics:
    """Fleet-level rollup over the replicas' ``ServeMetrics``:
    summed counters, pooled latency tails (per-replica p99s don't
    average into a fleet p99 — the samples do), token-weighted fleet
    hit rate, and the router's own counters (placements by kind,
    sheds by class, handoffs). Registers on the shared exposition
    under ``serve_fleet_`` so one scrape covers every replica AND the
    rollup."""

    #: Same single-instance-collision fix as ``ServeMetrics``: two
    #: live fleets in one process must not emit identical unlabeled
    #: ``serve_fleet_*`` samples into one scrape.
    _fleet_ids = itertools.count()

    #: Lifetime counters a reaped replica's history folds into (its
    #: ServeMetrics object dies with it; without absorption a drain
    #: would silently shrink fleet totals and break the submitted ==
    #: finished+expired+rejected balance). Point-in-time gauges
    #: (kv_blocks_*) and rates are deliberately NOT absorbed — a dead
    #: pool holds nothing.
    ABSORBED = ("tokens_generated", "requests_submitted",
                "requests_finished", "requests_expired",
                "requests_rejected", "prefix_hit_tokens",
                "prefix_prefill_tokens", "spec_proposed_total",
                "spec_accepted_total")

    def __init__(self, router: "ServeRouter"):
        import weakref

        self._router = weakref.ref(router)
        self.fleet = str(next(self._fleet_ids))
        self.placed_affinity = 0     # placements won by a chain match
        self.placed_fallback = 0     # no match: occupancy/baseline pick
        self.shed_total = 0
        self.shed_by_class: Dict[int, int] = {}
        self.expired_total = 0
        self.handoffs = 0
        # Cross-process fleet health:
        self.heartbeats = 0          # liveness/metrics probes sent
        self.worker_deaths = 0       # replicas declared dead (RPC fail)
        self.requeued_total = 0      # requests requeued off dead/failed
        #                              replicas (each still resolves
        #                              exactly once)
        self.migrations = 0          # RUNNING decodes moved by a drain
        # Direct-migration plane (the exported names are listed in
        # serve/migrate.py MIGRATION_METRIC_KEYS):
        self.direct_migrations_total = 0   # page moves over the
        #                                    worker<->worker channel
        self.migration_bytes_total = 0     # wire bytes moved by the
        #                                    page-move plane, any path
        self.migration_link_cost_us = 0.0  # last decision's alpha-beta
        #                                    cost verdict (gauge)
        self.migration_ms: List[float] = []   # per-move wall samples
        #                                       (pooled-tail histogram)
        self._retired: Dict[str, float] = {}   # absorbed counters
        # ...and the same counters bucketed by model group, feeding
        # the per-model rollup series (label model=...).
        self._retired_models: Dict[str, Dict[str, float]] = {}
        # Absorbed latency samples (same MAX_SAMPLES cap as the live
        # series): without them the fleet p99 would silently IMPROVE
        # after draining whichever replica served the slow tenant.
        self._retired_samples: Dict[str, List[float]] = {
            "first_token_s": [], "per_token_s": []}
        from horovod_tpu_torch.metrics import register_exporter_weak
        register_exporter_weak(f"serve_fleet_{id(self)}", self,
                               "prometheus")

    def absorb(self, metrics, model: str = "default") -> None:
        """Fold a reaped replica's final ``ServeMetrics`` into the
        rollup — lifetime counters (fleet-wide AND under its model
        group) plus its latency samples (capped) — so fleet totals and
        tails survive membership churn."""
        snap = metrics.snapshot()
        by_model = self._retired_models.setdefault(model, {})
        for key in self.ABSORBED:
            self._retired[key] = (self._retired.get(key, 0)
                                  + snap.get(key, 0))
            by_model[key] = by_model.get(key, 0) + snap.get(key, 0)
        for series, kept in self._retired_samples.items():
            room = MAX_SAMPLES - len(kept)
            if room > 0:
                kept.extend(getattr(metrics, series)[:room])

    def record_placed(self, match_len: int) -> None:
        if match_len > 0:
            self.placed_affinity += 1
        else:
            self.placed_fallback += 1

    def record_shed(self, deadline_class: int) -> None:
        self.shed_total += 1
        self.shed_by_class[deadline_class] = (
            self.shed_by_class.get(deadline_class, 0) + 1)

    def record_migration_ms(self, ms: float) -> None:
        if len(self.migration_ms) < MAX_SAMPLES:
            self.migration_ms.append(float(ms))

    def snapshot(self) -> Dict[str, float]:
        router = self._router()
        if router is None:
            return {}
        reps = router._replicas
        snaps = [r.engine.metrics.snapshot() for r in reps]
        out: Dict[str, float] = {
            "replicas": len(reps),
            "queue_depth": len(router._queue),
            "placed_affinity": self.placed_affinity,
            "placed_fallback": self.placed_fallback,
            "shed_total": self.shed_total,
            "expired_total": self.expired_total,
            "handoffs": self.handoffs,
            "heartbeats": self.heartbeats,
            "worker_deaths": self.worker_deaths,
            "requeued_total": self.requeued_total,
            "migrations": self.migrations,
            "direct_migrations_total": self.direct_migrations_total,
            "migration_bytes_total": self.migration_bytes_total,
            "migration_link_cost_us": self.migration_link_cost_us,
        }
        # Page-move wall-time tails: pooled samples like every other
        # fleet histogram (a quantile of the union, not an average of
        # per-path quantiles).
        for q in (50, 99):
            v = percentile(self.migration_ms, q)
            out[f"p{q}_migration_ms"] = (None if v is None
                                         else round(v, 3))
        for c, n in sorted(self.shed_by_class.items()):
            out[f"shed_class_{c}"] = n
        for key in self.ABSORBED + ("kv_blocks_in_use",
                                    "kv_blocks_cached"):
            out[key] = (sum(s.get(key, 0) for s in snaps)
                        + self._retired.get(key, 0))
        rates = [s["tokens_per_sec"] for s in snaps]
        out["tokens_per_sec"] = round(sum(rates), 2)
        occ = [s["batch_occupancy"] for s in snaps]
        out["batch_occupancy"] = (round(sum(occ) / len(occ), 4)
                                  if occ else 0.0)
        looked = out["prefix_hit_tokens"] + out["prefix_prefill_tokens"]
        out["prefix_cache_hit_rate"] = (
            round(out["prefix_hit_tokens"] / looked, 4)
            if looked else 0.0)
        out["spec_accept_rate"] = (
            round(out["spec_accepted_total"]
                  / out["spec_proposed_total"], 4)
            if out["spec_proposed_total"] else 0.0)
        # Pooled tails: the fleet p99 is a quantile of the union of
        # every replica's samples (live + absorbed-from-reaped), not
        # an average of replica p99s.
        for series, label in (("first_token_s", "first_token_ms"),
                              ("per_token_s", "per_token_ms")):
            pooled = [x for r in reps
                      for x in getattr(r.engine.metrics, series)]
            pooled += self._retired_samples[series]
            for q in (50, 99):
                v = percentile(pooled, q)
                out[f"p{q}_{label}"] = (None if v is None
                                        else round(v * 1e3, 3))
        return out

    def snapshot_by_model(self) -> Dict[str, Dict[str, float]]:
        """Per-model-group rollups: live replicas of each group summed
        with the group's absorbed (reaped-replica) counters, plus the
        group's queue depth and accept rate. The fleet-wide snapshot
        stays the authoritative total; these slices answer "which
        model is the traffic/accept-rate/backlog on?"."""
        router = self._router()
        if router is None:
            return {}
        out: Dict[str, Dict[str, float]] = {}
        for model in sorted(router._models):
            reps = [r for r in router._replicas if r.model == model]
            snaps = [r.engine.metrics.snapshot() for r in reps]
            retired = self._retired_models.get(model, {})
            d: Dict[str, float] = {
                "replicas": len(reps),
                "queue_depth": sum(1 for q in router._queue
                                   if q.model == model),
            }
            for key in self.ABSORBED:
                d[key] = (sum(s.get(key, 0) for s in snaps)
                          + retired.get(key, 0))
            d["tokens_per_sec"] = round(
                sum(s["tokens_per_sec"] for s in snaps), 2)
            d["spec_accept_rate"] = (
                round(d["spec_accepted_total"]
                      / d["spec_proposed_total"], 4)
                if d["spec_proposed_total"] else 0.0)
            out[model] = d
        return out

    def prometheus(self) -> str:
        """Fleet-wide rollup under ``{fleet=...}`` plus one per-model
        slice under ``{fleet=..., model=...}`` — same families,
        different label sets (the exposition assembler dedupes the
        per-family TYPE lines, so the one-TYPE-line-per-family pin
        holds)."""
        from horovod_tpu_torch.metrics import render_gauges
        parts = [render_gauges("serve_fleet", self.snapshot(),
                               labels={"fleet": self.fleet})]
        for model, snap in self.snapshot_by_model().items():
            parts.append(render_gauges(
                "serve_fleet", snap,
                labels={"fleet": self.fleet, "model": model}))
        return "".join(parts)


class ServeRouter:
    """N engine replicas behind one admission front door.

    In-process replicas share the model config, params, mesh and engine
    geometry — so they share one set of programs (``make_serve_fns``
    memoizes on the geometry) and adding a replica costs a KV pool.

    On a mesh every rank of the mesh constructs the same router over
    this rank's shards (``shard_params(params, cfg, mesh,
    serving=True)``), calls the same methods with the same arguments in
    the same order (``submit``, ``step``, ``add_replica``,
    ``remove_replica``, ``export_fleet_trace`` ...) and so steps every
    replica in lockstep, as one ``ServeEngine(mesh=)`` a process does;
    a rank that submits something else hangs the mesh. Deadlines are
    read on mesh rank 0's clock (:meth:`now`). Beside the mesh
    replicas, worker replicas take mesh rank 0's handles there and an
    ``rpc.MirrorHandle()`` for each on every other rank.
    """

    def __init__(self, model_cfg, params,
                 router_cfg: Optional[RouterConfig] = None,
                 serve_cfg: Optional[ServeConfig] = None,
                 mesh: Optional[Any] = None, clock=time.perf_counter,
                 workers: Optional[Sequence[Any]] = None,
                 worker_seed: int = 0, device=None):
        """``workers`` lifts the fleet across processes: a sequence of
        ``rpc.WorkerHandle`` (from ``rpc.spawn_worker`` /
        ``rpc.connect_worker``), one per replica — each is configured
        with this fleet's model/serve geometry and builds its params
        as ``init_params(model_cfg, a generator on the worker's device
        seeded with worker_seed)``, so ``params`` here must equal that
        (pass ``params=None`` for an all-remote fleet; it is only used
        to build in-process engines). With ``workers=None`` every
        replica is in-process. In-process engines run on ``device``
        (default: the device of ``params``). ``mesh`` (a tp/ep/dp
        mesh, as ``ServeEngine(mesh=)`` takes) shards every in-process
        replica over it; ``params`` are then this rank's shards, and
        mesh rank 0 passes the ``workers`` handles where every other
        rank passes ``rpc.MirrorHandle()`` for each (the group's
        collective timeout must exceed ``RouterConfig.rpc_timeout``: the
        other ranks wait on rank 0's calls). A ``None`` in ``workers``
        is an in-process replica."""
        self.cfg = router_cfg or RouterConfig()
        self._model_cfg = model_cfg
        self._params = params
        self._serve_cfg = serve_cfg or ServeConfig()
        self._device = (device if device is not None or params is None
                        else param_leaves(params)[0].device)
        self._worker_seed = worker_seed
        # The mesh every in-process replica is sharded over, and the
        # group its ranks step the router in lockstep over (None for
        # one process): each clock read is rank 0's, broadcast.
        self._mesh = mesh
        self._lockstep = None
        self._topo = _UNREAD
        if mesh is not None:
            self._device = resolve_device(self._device)
            check_serve_mesh(model_cfg, mesh, self._device)
            group = axes_group(mesh, AXES)
            if collectives.axis_size(group) > 1:
                self._lockstep = group
        self._raw_clock = clock
        self._clock = (clock if self._lockstep is None
                       else functools.partial(lockstep_now, clock,
                                              self._lockstep, self._device))
        # Registered model groups; the constructor args define the
        # DEFAULT_MODEL group, add_model() registers more (draft/target
        # pairs, A/B fleets, per-tenant models as ordinary members).
        self._models: Dict[str, _ModelGroup] = {
            DEFAULT_MODEL: _ModelGroup(
                model_cfg, params, self._serve_cfg,
                n_prefill=self.cfg.n_prefill, worker_seed=worker_seed)}
        self._rng = np.random.RandomState(self.cfg.seed)
        self._rr = 0                 # round_robin cursor
        self._replicas: List[_Replica] = []
        self._next_instance = itertools.count()
        self._queue: collections.deque[_Pending] = collections.deque()
        self._requests: Dict[int, _Pending] = {}   # every unresolved rid
        # (model, chain entry) -> instance it was last routed to
        # (insertion-ordered for FIFO eviction at CHAIN_INDEX_CAP; the
        # model in the key stops identical token prefixes under
        # different models from aliasing each other's routing hints).
        self._placed_chains: "collections.OrderedDict[Tuple[str, bytes], str]" = \
            collections.OrderedDict()
        self._results: Dict[int, RequestResult] = {}
        self._rids = itertools.count()
        self._retire_ema = RetireEma()
        self.metrics = FleetMetrics(self)
        # Distributed tracing: the router's half of every sampled
        # request's timeline. Ids are minted at submit (salted by
        # cfg.seed — deterministic across seeded reruns) and ride the
        # RPC frame header to workers.
        self.trace = RouterTrace(clock=self._clock)
        # "env" resolves the sane-env knob ONCE at fleet construction
        # (a fleet never flips mid-life); "auto"/"off" force it.
        self._direct_mode = (migrate_mod.direct_migration_mode()
                             if self.cfg.direct_migration == "env"
                             else self.cfg.direct_migration)
        # Manifest epochs: every direct-migration attempt carries a
        # fresh one, so a stale partial stream can never replay into
        # a target (the worker refuses repeated epochs).
        self._migration_epochs = itertools.count(1)
        #: (rid, replica instance, chain-match length, link cost in
        #: us) per placement decision, in decision order — the
        #: determinism probe the property test replays. Queue
        #: placements carry cost 0.0 (no source pool to move from);
        #: page-move target picks log match -1 with the decision's
        #: alpha-beta cost verdict. Capped like every other unbounded
        #: series.
        self.placement_log: List[Tuple[int, str, int, float]] = []
        workers = list(workers or [])
        if workers and len(workers) != self.cfg.n_replicas:
            raise ValueError(
                f"{len(workers)} workers for n_replicas="
                f"{self.cfg.n_replicas}; pass one handle per replica")
        for i in range(self.cfg.n_replicas):
            role = ("prefill" if i < self.cfg.n_prefill else
                    "decode" if self.cfg.n_prefill else "unified")
            self._add_replica(role, worker=workers[i] if workers
                              else None)

    # -- the mesh's lockstep ------------------------------------------

    def now(self) -> float:
        """The router's clock: on a mesh, rank 0's reading (a
        collective: every rank calls it alike). Deadlines passed to
        :meth:`submit` are on this clock."""
        return self._clock()

    def _topology(self) -> Optional[Dict[str, Any]]:
        """The measured topology model page moves are scored on: this
        process's, or on a mesh rank 0's, broadcast once a step, so
        per-rank noise cannot split a tie differently on two ranks."""
        if self._lockstep is None:
            return migrate_mod.fleet_topology()
        if self._topo is _UNREAD:
            mine = (migrate_mod.fleet_topology()
                    if dist.get_rank(self._lockstep) == 0 else None)
            self._topo = broadcast_object(mine, 0, self._lockstep)
        return self._topo

    # -- membership --------------------------------------------------

    def _add_replica(self, role: str, worker: Any = None,
                     model: str = DEFAULT_MODEL) -> _Replica:
        group = self._models[model]
        inst = str(next(self._next_instance))
        # Router-facing id (`inst`) is per-router and deterministic —
        # placement logs compare bit-for-bit across seeded runs. The
        # EXPOSITION label prefixes the process-unique fleet id: two
        # live fleets must not emit colliding serve_*{instance="0"}
        # samples into one scrape.
        label = f"{self.metrics.fleet}.{inst}"
        if worker is not None:
            if self._lockstep is not None:
                # Rank 0's connection, mirrored on every other rank.
                worker = lockstep_handle(worker, self._lockstep)
            worker.conn.codec = span_codec_id(self.cfg.handoff_compression)
            worker.conn.set_timeout(self.cfg.rpc_timeout)
            eng = RemoteReplica(worker, group.model_cfg,
                                group.serve_cfg,
                                seed=group.worker_seed, instance=label,
                                clock=self._clock, trace=self.trace)
        else:
            if group.params is None:
                raise ValueError(
                    "params=None: cannot build an in-process replica "
                    "(pass params, or a worker handle per replica)")
            # On a mesh the engine keeps this rank's own clock for its
            # metrics and takes the router's broadcast reading each
            # step (``step(now)``).
            eng = ServeEngine(group.model_cfg, group.params,
                              group.serve_cfg, mesh=self._mesh,
                              clock=self._raw_clock, instance=label,
                              device=self._device)
        rep = _Replica(instance=inst, role=role, engine=eng,
                       model=model, remote=worker is not None)
        self._replicas.append(rep)
        _advance_membership(basics.MEMBER_JOIN)
        return rep

    def add_model(self, model: str, model_cfg, params=None,
                  serve_cfg: Optional[ServeConfig] = None, *,
                  n_replicas: int = 1, n_prefill: int = 0,
                  workers: Optional[Sequence[Any]] = None,
                  worker_seed: int = 0) -> List[str]:
        """Register a model group and join its replicas; returns their
        instance ids. Replicas of the new group are ordinary fleet
        members — same placement, drain, shedding, and failover code —
        but requests reach them only via ``submit(..., model=...)``,
        handoffs/migrations stay inside the group, and the per-group
        ``n_prefill`` splits ITS replicas into prefill/decode pools
        independently of the default group's split. This is what makes
        draft/target pairs, A/B fleets, and per-tenant models plain
        members of one fleet. ``workers`` (one handle per replica)
        lifts the group cross-process exactly like the constructor's —
        workers rebuild THIS group's engine via ``configure``."""
        if model in self._models:
            raise ValueError(f"model {model!r} already registered")
        if n_replicas < 1:
            raise ValueError(f"n_replicas {n_replicas} < 1")
        if not 0 <= n_prefill < n_replicas:
            raise ValueError(
                f"n_prefill {n_prefill} must leave at least one decode "
                f"replica out of {n_replicas}")
        workers = list(workers or [])
        if workers and len(workers) != n_replicas:
            raise ValueError(
                f"{len(workers)} workers for n_replicas={n_replicas}; "
                "pass one handle per replica")
        if params is None and not workers:
            raise ValueError(
                "params=None: cannot build in-process replicas for "
                f"model {model!r} (pass params, or a worker handle "
                "per replica)")
        self._models[model] = _ModelGroup(
            model_cfg, params, serve_cfg or ServeConfig(),
            n_prefill=n_prefill, worker_seed=worker_seed)
        out = []
        try:
            for i in range(n_replicas):
                role = ("prefill" if i < n_prefill else
                        "decode" if n_prefill else "unified")
                out.append(self._add_replica(
                    role, worker=workers[i] if workers else None,
                    model=model).instance)
        except Exception:
            # Roll the half-registered group back: a failed worker
            # configure must not leave a zombie model id that can
            # neither be completed nor re-registered.
            self._replicas = [r for r in self._replicas
                              if r.instance not in out]
            del self._models[model]
            raise
        return out

    def add_replica(self, role: Optional[str] = None,
                    model: str = DEFAULT_MODEL) -> str:
        """Join a fresh in-process replica (elastic scale-up); returns
        its instance id. Default role matches the model group's shape:
        "decode" for a split group, "unified" otherwise."""
        return self._join(role, None, model)

    def add_remote_replica(self, worker: Any,
                           role: Optional[str] = None,
                           model: str = DEFAULT_MODEL) -> str:
        """Join a serve-worker process (``rpc.spawn_worker`` /
        ``rpc.connect_worker`` handle) as a replica — the elastic
        scale-up path of the cross-process fleet."""
        return self._join(role, worker, model)

    def _join(self, role: Optional[str], worker: Any,
              model: str = DEFAULT_MODEL) -> str:
        group = self._models.get(model)
        if group is None:
            raise ValueError(f"unknown model {model!r}; registered: "
                             f"{sorted(self._models)}")
        if role is None:
            role = "decode" if group.n_prefill else "unified"
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(f"unknown role {role!r}")
        return self._add_replica(role, worker=worker,
                                 model=model).instance

    def remove_replica(self, instance: str,
                       migrate_running: bool = False) -> None:
        """Drain a replica out of the fleet: its queued (never
        admitted) requests are withdrawn and requeued at the router
        in original submission order. In-flight sequences either keep
        decoding here until done (the default) or — with
        ``migrate_running=True`` — are exported mid-decode and
        injected into same-model peers with capacity (bitwise page
        moves, same tokens), so a drain completes in O(one step)
        instead of O(longest decode). The replica reaps out once
        empty; a remote replica's worker process is then shut down.

        Guard: refuses to remove the last non-draining replica of a
        needed role *within its model group* when (a) no other group
        has live replicas — an empty fleet serves nothing — or (b)
        the group still has work (router-queued requests for that
        model, or this replica's own in-flight work, which a drain
        with no same-model survivor could never re-place). A workless
        secondary group CAN drain to zero — that is how a model is
        decommissioned."""
        rep = self._replica(instance)
        group = self._models[rep.model]
        peers = [r for r in self._replicas
                 if r is not rep and not r.draining
                 and r.model == rep.model]
        other_groups = any(r.model != rep.model and not r.draining
                           for r in self._replicas)
        needed = (("prefill", "decode") if group.n_prefill
                  else ("unified",))
        for role in needed:
            if rep.role == role and not any(p.role == role
                                            for p in peers):
                queued = any(q.model == rep.model for q in self._queue)
                # Work anywhere in the GROUP blocks the drain, not
                # just this replica's: a peer prefill replica's parked
                # sequence needs a same-model decode target that would
                # never exist again after removing the last one.
                group_work = any(r.outstanding for r in self._replicas
                                 if r.model == rep.model)
                if not other_groups or queued or group_work:
                    raise ValueError(
                        f"cannot remove replica {instance}: last "
                        f"non-draining {role!r} replica for model "
                        f"{rep.model!r}"
                        + (" with queued work" if queued or group_work
                           else " in the fleet"))
        rep.draining = True
        rep.migrate = migrate_running
        # Successful withdrawals stay in `outstanding` until the loop
        # completes: if a later RPC finds the worker dead,
        # _handle_dead requeues EVERYTHING still mapped there — the
        # already-withdrawn included (they can never produce a result
        # on the dead worker), in one correctly-ordered batch. Deleting
        # eagerly would strand those requests in _requests with no
        # queue entry and no owner.
        withdrawn = []
        for erid, rid in list(rep.outstanding.items()):
            ok = self._guard(rep, lambda e=erid: rep.engine.withdraw(e))
            if rep not in self._replicas:
                return   # died mid-drain: _handle_dead requeued it all
            if ok:
                withdrawn.append((erid, rid))
        for erid, _rid in withdrawn:
            del rep.outstanding[erid]
        # Front of the router queue, original submit order preserved:
        # drained work overtakes nothing and loses nothing.
        for req in sorted((self._requests[rid] for _, rid in withdrawn),
                          key=lambda r: r.rid, reverse=True):
            self._queue.appendleft(req)

    def _replica(self, instance: str) -> _Replica:
        for rep in self._replicas:
            if rep.instance == instance:
                return rep
        raise KeyError(f"no replica {instance!r}")

    # -- liveness / failover (cross-process fleet) -------------------

    def _guard(self, rep: _Replica, fn):
        """Run one engine interaction; a transport failure (the
        dead-worker signal) turns into :meth:`_handle_dead` and a
        ``None`` return instead of unwinding the step loop. In-process
        engines never raise it, so this is free for them."""
        try:
            return fn()
        except RpcConnectionError:
            self._handle_dead(rep)
            return None

    def _handle_dead(self, rep: _Replica) -> None:
        """A replica's worker is gone. Every request placed there
        whose result was never collected goes back to the FRONT of the
        router queue in original submission order — it re-places on a
        survivor and resolves exactly once (results already collected
        stay collected; the dead worker can no longer deliver
        anything). The replica's last-heartbeat metrics fold into the
        fleet rollup like any reaped replica's."""
        if rep not in self._replicas:
            return
        self._replicas.remove(rep)
        # The numeric instance rides into the native peer_death flight
        # event — a post-mortem dump names WHO died.
        try:
            dead_rank = int(rep.instance)
        except ValueError:
            dead_rank = -1
        _advance_membership(basics.MEMBER_DEAD_PEER, rank=dead_rank)
        _record_flap(f"replica:{self.metrics.fleet}.{rep.instance}")
        getattr(rep.engine, "mark_dead", lambda: None)()
        requeue = [rid for rid in rep.outstanding.values()
                   if rid in self._requests]
        for rid in sorted(requeue, reverse=True):
            self._queue.appendleft(self._requests[rid])
            req = self._requests[rid]
            self.trace.instant("router:requeue", trace=req.trace,
                               rid=rid, from_instance=rep.instance)
        self.metrics.worker_deaths += 1
        self.metrics.requeued_total += len(requeue)
        self.metrics.absorb(rep.engine.metrics, rep.model)
        # Flight trail: one requeue record per orphaned request
        # (a0 = router rid, a1 = dead instance), then — when the
        # operator asked for post-mortems — dump the ring. The native
        # peer_death record from _advance_membership is already in it.
        from horovod_tpu_torch.metrics import flight_dump, flight_record
        for rid in requeue:
            flight_record(basics.FLIGHT_REQUEUE, rid, dead_rank)
        if os.environ.get("HOROVOD_FLIGHT_DIR"):
            flight_dump()

    def _heartbeat_sweep(self, now: float) -> None:
        """Probe remote replicas the step loop will not otherwise talk
        to this iteration (idle ones — a busy replica's ``step`` RPC
        is its heartbeat): liveness, plus the metrics/admission cache
        behind the cross-process fleet scrape. ``heartbeat_every``
        throttles it for real networks; the 0 default keeps every
        step's cache fresh."""
        for rep in list(self._replicas):
            if not rep.remote:
                continue
            if rep.engine.pending:
                continue   # its step() RPC this iteration is the beat
            if now - rep.engine.last_beat < self.cfg.heartbeat_every:
                continue
            self._guard(rep, rep.engine.heartbeat)
            if rep in self._replicas:
                self.metrics.heartbeats += 1

    @property
    def replicas(self) -> List[str]:
        return [r.instance for r in self._replicas]

    @property
    def membership_epoch(self) -> int:
        """The process-global membership epoch after this fleet's
        churn (``hvd.membership().epoch``): joins, drains-to-reap, and
        worker deaths each tick it, alongside any training-plane
        changes in the same process. Monotone — the chaos harness
        asserts exactly that."""
        return int(basics.get_lib().hvd_membership_epoch())

    @property
    def engines(self) -> List[ServeEngine]:
        """The replica engines, fleet order (read-only introspection:
        benchmarks pool latency samples across them)."""
        return [r.engine for r in self._replicas]

    # -- submission / shedding ---------------------------------------

    def _retry_after(self) -> float:
        return self._retire_ema.retry_after(len(self._queue))

    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               deadline: Optional[float] = None,
               deadline_class: int = 0,
               model: str = DEFAULT_MODEL) -> int:
        """Fleet admission. Validates against the target model group's
        engine limits, then queues for placement (which only ever
        considers that group's replicas — a request can never land on
        a wrong-model replica, pinned by the router property test).
        On a full router queue the shedding policy runs fleet-wide:
        the newest queued request of a strictly lower class (higher
        number) is shed — resolved to a structured ``"shed"`` result —
        to make room; if none exists, raises
        :class:`FleetSaturated`."""
        prompt = list(prompt)
        group = self._models.get(model)
        if group is None:
            raise ValueError(f"unknown model {model!r}; registered: "
                             f"{sorted(self._models)}")
        cfg = group.serve_cfg
        max_new = (cfg.max_new_tokens if max_new_tokens is None
                   else max_new_tokens)
        # The ENGINE's validation helper, verbatim: anything an engine
        # would reject must reject HERE, not explode out of a later
        # step() at placement time (all replicas of a group share one
        # geometry, so any group engine's pool answers for the group).
        # Draining replicas don't count as live: accepting a request
        # against a group mid-drain-to-zero would queue it forever
        # once the drainer reaps (placement filters draining too).
        mine = [r for r in self._replicas
                if r.model == model and not r.draining]
        if not mine:
            # Every worker died and nothing joined: be explicit
            # instead of IndexError-ing out of validation.
            raise QueueFull(
                f"no live replicas for model {model!r}",
                reason="no_replicas",
                queue_depth=len(self._queue),
                retry_after_s=None)
        validate_request(cfg, group.model_cfg,
                         mine[0].engine.allocator.n_blocks,
                         prompt, max_new, deadline_class)
        if len(self._queue) >= self.cfg.max_queue:
            victim = self._shed_candidate(deadline_class)
            if victim is None:
                self.metrics.record_shed(deadline_class)
                raise FleetSaturated(
                    f"fleet queue full ({self.cfg.max_queue}) and "
                    f"nothing queued is lower-class than "
                    f"{deadline_class}",
                    deadline_class=deadline_class,
                    queue_depth=len(self._queue),
                    retry_after_s=self._retry_after())
            self._shed(victim)
        rid = next(self._rids)
        # Hashed ONCE here, reused by placement scoring, the burst
        # hint, and engine admission (passed through). With the engine
        # tier's caching off there is nothing to be affine TO — no
        # index to walk, no reuse to win — so skip the hashing and let
        # affinity degrade to least-load instead of pinning every
        # same-prefix tenant onto one hot replica for zero benefit.
        chain = (hash_chain(prompt, cfg.block_size)
                 if cfg.prefix_caching else [])
        now = self._clock()
        trace = mint_trace_id(rid, salt=self.cfg.seed)
        req = _Pending(
            rid=rid, prompt=prompt, max_new=max_new, deadline=deadline,
            deadline_class=deadline_class, submitted_at=now,
            chain=chain, model=model, trace=trace)
        self._requests[rid] = req
        self._queue.append(req)
        if trace:
            self.trace.instant("router:submit", t=now, trace=trace,
                               rid=rid, n_prompt=len(prompt),
                               model=model)
        return rid

    def _shed_candidate(self, incoming_class: int) -> Optional[int]:
        """Queue index of the request to shed for an arrival of
        ``incoming_class``: the newest of the *worst* (highest) class,
        and only if strictly worse than the arrival — FIFO favors the
        already-queued at equal class."""
        if not self._queue:
            return None
        worst = max(range(len(self._queue)),
                    key=lambda i: (self._queue[i].deadline_class, i))
        if self._queue[worst].deadline_class <= incoming_class:
            return None
        return worst

    def _shed(self, idx: int) -> None:
        req = self._queue[idx]
        del self._queue[idx]
        del self._requests[req.rid]
        self._results[req.rid] = RequestResult(
            rid=req.rid, status="shed", http_status=503, tokens=[],
            n_prompt=len(req.prompt), submitted_at=req.submitted_at,
            finished_at=self._clock(), reason="shed_low_class",
            deadline_class=req.deadline_class,
            retry_after_s=self._retry_after())
        self.metrics.record_shed(req.deadline_class)

    # -- results -----------------------------------------------------

    def result(self, rid: int) -> Optional[RequestResult]:
        return self._results.get(rid)

    @property
    def results(self) -> Dict[int, RequestResult]:
        return dict(self._results)

    @property
    def pending(self) -> bool:
        return bool(self._queue
                    or any(r.outstanding for r in self._replicas))

    # -- placement ---------------------------------------------------

    def _candidates(
            self, pool_role: Tuple[str, ...], model: str,
    ) -> List[Tuple[_Replica, Dict[str, float]]]:
        """(replica, admission snapshot) pairs eligible for a new
        placement: right MODEL group, right pool, not draining,
        engine-queue room. Model is filtered before anything else —
        capacity pressure in one group can never spill a request onto
        another group's replicas. The affinity invariant — never route
        to a replica without capacity — is enforced here, before any
        cache walk happens; each replica is snapshotted ONCE per
        placement decision and the snapshot rides along for the load
        tie-breaks (it cannot change between filter and pick within
        one decision)."""
        out = []
        for r in list(self._replicas):
            if (r.model != model or r.role not in pool_role
                    or r.draining):
                continue
            snap = self._guard(r, r.engine.admission_snapshot)
            if snap is not None and snap["queue_slots_free"] > 0:
                out.append((r, snap))
        return out

    @staticmethod
    def _load(snap: Dict[str, float]) -> int:
        """Placement-fallback occupancy signal: everything admitted
        or waiting on the snapshotted replica."""
        return int(snap["queue_depth"] + snap["running"]
                   + snap["handoff_parked"])

    def _pick(self, req: _Pending,
              cands: List[Tuple[_Replica, Dict[str, float]]],
              ) -> Tuple[_Replica, int]:
        """Choose among capacity-checked candidates; returns (replica,
        chain_match_len). Deterministic for a fixed seed: ties break
        on load then list order, and the random baseline draws from
        the config-seeded RNG."""
        if self.cfg.placement == "random":
            return cands[int(self._rng.randint(len(cands)))][0], 0
        if self.cfg.placement == "round_robin":
            rep = cands[self._rr % len(cands)][0]
            self._rr += 1
            return rep, 0
        if self.cfg.placement == "affinity":
            scored = [(self._chain_score(r, req.chain), r, s)
                      for r, s in cands]
            best = max(n for n, _, _ in scored)
            if best > 0:
                hot = [(r, s) for n, r, s in scored if n == best]
                return min(hot, key=lambda t: self._load(t[1]))[0], best
        return min(cands, key=lambda t: self._load(t[1]))[0], 0

    def _chain_score(self, rep: _Replica, chain: List[bytes]) -> int:
        """Affinity score of ``rep`` for a prompt chain: the longer of
        the replica's LIVE content-index walk (blocks actually held)
        and the leading run of chain entries last ROUTED there (the
        burst hint — a same-prefix sibling placed moments ago whose
        prefill hasn't published yet). Hint keys carry the model id,
        so identical prefixes under different models never alias."""
        live = self._guard(
            rep, lambda: rep.engine.cached_chain_len(chain))
        if live is None:
            # Died mid-walk: score 0; the placement pass discovers the
            # death at submit (or the replica-count check) and
            # restarts against the survivors.
            return 0
        hint = 0
        for h in chain:
            if self._placed_chains.get((rep.model, h)) != rep.instance:
                break
            hint += 1
        return max(live, hint)

    def _record_chain(self, rep: _Replica, chain: List[bytes]) -> None:
        for h in chain:
            key = (rep.model, h)
            if key in self._placed_chains:
                self._placed_chains.move_to_end(key)
            self._placed_chains[key] = rep.instance
        while len(self._placed_chains) > CHAIN_INDEX_CAP:
            self._placed_chains.popitem(last=False)

    def _place_queued(self) -> None:
        """FIFO placement (no overtaking — same tail-predictability
        contract as engine admission): place in queue order until a
        MODEL's requests find no candidate, then skip that model's
        remaining requests this step and keep placing other models' —
        FIFO holds within each model group, but one saturated (or
        replica-less) group never head-of-line-blocks the rest of the
        fleet. Pool roles come from the request's group (each group
        splits prefill/decode independently); candidates are always
        same-model."""
        # Snapshot scan, one rid-filtered rebuild per pass: a worker
        # death inside a _guard call requeues its work at the queue
        # FRONT mid-scan, so positional indexing could place one
        # request and delete a different one — and per-placement
        # deque.remove would make a deep queue O(n^2). A death
        # RESTARTS the pass from the (mutated) front, so per-model
        # FIFO holds even across failovers: the requeued-at-front work
        # and the request whose pick died both go before anything
        # younger.
        while True:
            stuck: set = set()    # models with no candidate this pass
            placed: set = set()   # rids placed this pass
            n_reps = len(self._replicas)
            died = False
            for req in list(self._queue):
                if req.model in stuck:
                    continue
                group = self._models[req.model]
                pool = (("prefill",) if group.n_prefill
                        else ("unified",))
                cands = self._candidates(pool, req.model)
                if len(self._replicas) != n_reps:
                    # A death detected inside the candidate probes (or
                    # the affinity walk) requeued work at the front —
                    # restart so it is not overtaken by this pass's
                    # stale snapshot.
                    died = True
                    break
                if not cands:
                    stuck.add(req.model)
                    continue
                rep, match = self._pick(req, cands)
                t_place = self._clock()
                erid = self._guard(rep, lambda: rep.engine.submit(
                    req.prompt, req.max_new, deadline=req.deadline,
                    deadline_class=req.deadline_class,
                    prefill_only=(rep.role == "prefill"),
                    chain=req.chain, trace_id=req.trace))
                if erid is None:
                    died = True
                    break
                if req.trace:
                    # Queue wait closes at placement: submit -> the
                    # instant the request left the router queue.
                    self.trace.span(
                        "router:queue_wait", req.submitted_at,
                        t_place - req.submitted_at, trace=req.trace,
                        rid=req.rid, instance=rep.instance,
                        match=match)
                placed.add(req.rid)
                rep.outstanding[erid] = req.rid
                if self.cfg.placement == "affinity":
                    # Only the affinity scorer ever reads the hint
                    # index; the baselines skip the OrderedDict churn.
                    self._record_chain(rep, req.chain)
                self.metrics.record_placed(match)
                if len(self.placement_log) < MAX_SAMPLES:
                    self.placement_log.append(
                        (req.rid, rep.instance, match, 0.0))
            if placed:
                # A death mid-pass UN-places work: _handle_dead
                # requeued every rid the dead replica owned — including
                # ones placed earlier in THIS pass (the queue then
                # holds the same _Pending twice: stale position +
                # requeued front). Keep anything no longer owned by a
                # live replica, deduped to its front (requeued)
                # occurrence so requeue-at-front order survives.
                owned = {rid for r in self._replicas
                         for rid in r.outstanding.values()}
                placed &= owned
                seen: set = set()
                newq: collections.deque = collections.deque()
                for q in self._queue:
                    if q.rid in placed or q.rid in seen:
                        continue
                    seen.add(q.rid)
                    newq.append(q)
                self._queue = newq
            if not died:
                return

    # -- handoff (prefill pool -> decode pool) -----------------------

    def _collect_handoffs(self) -> None:
        for rep in list(self._replicas):
            if rep.role != "prefill":
                continue
            ready = self._guard(rep, rep.engine.handoff_ready)
            if ready is None:
                continue   # died; _handle_dead requeued its work
            for erid in ready:
                rid = rep.outstanding[erid]
                req = self._requests[rid]
                need = rep.engine.allocator.blocks_for_tokens(
                    len(req.prompt) + req.max_new)
                target = self._pick_capacity(("decode",), need,
                                             exclude=rep,
                                             model=rep.model,
                                             source=rep)
                if target is None:
                    # No decode capacity this step; the sequence stays
                    # parked (blocks held at the prefill replica) and
                    # is retried next step — never dropped.
                    continue
                if not self._move_seq(rep, erid, rid, target,
                                      "prefilled", need):
                    if rep not in self._replicas:
                        break   # source died; its work is requeued
                    continue
                self.metrics.handoffs += 1

    def _migrate_draining(self) -> None:
        """The migrating half of ``remove_replica(migrate_running=
        True)``: export RUNNING sequences off draining replicas and
        inject them into same-pool peers with capacity (a bitwise page
        move — the tokens that follow are exactly the ones the donor
        would have produced). A sequence with no target this step
        keeps decoding on the drainer and retries next step — never
        dropped, never duplicated."""
        for rep in list(self._replicas):
            if not (rep.draining and rep.migrate):
                continue
            running = self._guard(rep, rep.engine.running_exportable)
            if running is None:
                continue
            pool = (("decode",)
                    if self._models[rep.model].n_prefill
                    else ("unified",))
            for erid in running:
                rid = rep.outstanding.get(erid)
                if rid is None:
                    continue   # e.g. injected seq finishing this step
                req = self._requests[rid]
                need = rep.engine.allocator.blocks_for_tokens(
                    len(req.prompt) + req.max_new)
                target = self._pick_capacity(pool, need, exclude=rep,
                                             model=rep.model,
                                             source=rep)
                if target is None:
                    continue
                if not self._move_seq(rep, erid, rid, target,
                                      "running", need):
                    if rep not in self._replicas:
                        break
                    continue
                self.metrics.migrations += 1

    def _migration_plan(self, src: _Replica, target: _Replica,
                        need_blocks: int) -> Dict[str, Any]:
        """Chunk-schedule verdict for moving ``need_blocks`` worth of
        pages src -> target: the Python cost twin over the measured
        alpha-beta model (mirrored by the native
        ``hvd_migration_cost_us``). No model (the tests' fleets, single
        hosts) degrades to the default chunking with cost 0."""
        topo = self._topology()
        n_ranks = int(topo["np"]) if topo else 0
        return migrate_mod.plan_migration(
            need_blocks, self._page_nbytes(src, target),
            src=migrate_mod.replica_rank(src.instance, n_ranks),
            dst=migrate_mod.replica_rank(target.instance, n_ranks),
            codec=self.cfg.handoff_compression, model=topo)

    def _page_nbytes(self, src: _Replica, dst: _Replica) -> int:
        """Bytes of one K+V page pair a move from ``src`` to ``dst``
        counts: a rank's KV heads between two replicas of this mesh, a
        whole page where a worker is an end (what crosses its wire), so
        that every rank counts the same bytes."""
        mesh = None if src.remote or dst.remote else self._mesh
        return migrate_mod.page_nbytes(self._models[src.model].model_cfg,
                                       src.engine.allocator.block_size,
                                       mesh=mesh)

    def _note_migration(self, rid: int, target: _Replica,
                        cost_us: float, wire_bytes: int,
                        ms: float) -> None:
        m = self.metrics
        m.migration_bytes_total += int(wire_bytes)
        m.record_migration_ms(ms)
        m.migration_link_cost_us = round(float(cost_us), 3)
        if len(self.placement_log) < MAX_SAMPLES:
            # match -1 marks a page-move target pick (vs a queue
            # placement); the cost column is the decision's verdict.
            self.placement_log.append(
                (rid, target.instance, -1, round(float(cost_us), 3)))

    def _move_seq(self, src: _Replica, erid: int, rid: int,
                  target: _Replica, kind: str,
                  need_blocks: int) -> bool:
        """Move sequence ``erid`` (``kind`` = "prefilled" | "running")
        off ``src`` and into ``target``.

        With the direct plane on and both ends remote, the router
        sends ONE control frame (``migrate_to``) and the source
        streams the pages point-to-point to the target's bulk
        listener, chunked per the topology plan — the bytes never
        visit this process. A failed dial falls back to the relayed
        export->inject below, byte-compatible.

        Failure semantics keep exactly-once on every path: an export
        that dies takes the whole source down (its outstanding work —
        this rid included — requeues); a stream or inject that dies
        AFTER the export freed the source pages requeues THIS request
        explicitly at the queue front (its pages died in flight; it
        re-prefills from scratch on a survivor), while the target
        discards its partial pages by staging-abort."""
        t0 = self._clock()
        plan = self._migration_plan(src, target, need_blocks)
        if (self._direct_mode == "auto" and src.remote and target.remote
                and src is not target
                and getattr(target.engine, "peer_port", 0)):
            ret = self._guard(src, lambda: src.engine.migrate_direct(
                erid, kind, target.engine.peer_host,
                target.engine.peer_port, plan["chunk_pages"],
                next(self._migration_epochs)))
            if ret is None:
                return False     # source died: _handle_dead requeued
            status = ret.get("status")
            if status == "ok":
                del src.outstanding[erid]
                target.outstanding[int(ret["erid"])] = rid
                target.engine.note_remote_inject()
                self.metrics.direct_migrations_total += 1
                self._note_migration(
                    rid, target, cost_us=plan["cost_us"],
                    wire_bytes=int(ret.get("wire_bytes") or 0),
                    ms=float(ret.get("ms") or 0.0))
                self._trace_handoff(rid, src, target, kind, t0)
                return True
            if status != "dial_failed":
                # Exported, then the stream died mid-transfer: pages
                # are gone on both sides (target staging aborted on
                # disconnect). Queue front, exactly-once.
                del src.outstanding[erid]
                self._queue.appendleft(self._requests[rid])
                self.metrics.requeued_total += 1
                return False
            # dial_failed: the sequence never left the source — fall
            # through to the relayed path.
        h = self._guard(src,
                        lambda: getattr(src.engine,
                                        f"export_{kind}")(erid))
        if h is None:
            return False
        del src.outstanding[erid]
        # Between a worker (every KV head) and a mesh replica (this
        # rank's): rank 0's pages from the worker go to every rank and
        # each injects its heads; the other way the tp ranks' heads are
        # gathered into whole pages for rank 0 to send.
        wire = h
        if self._mesh is not None and src.remote and not target.remote:
            wire = migrate_mod.broadcast_pages(h, self._lockstep,
                                               self._device)
            h = migrate_mod.slice_pages(
                wire, self._models[src.model].model_cfg, self._mesh)
        elif self._mesh is not None and target.remote and not src.remote:
            h = wire = migrate_mod.gather_pages(
                h, self._models[src.model].model_cfg, self._mesh,
                self._device)
        new_erid = self._guard(target,
                               lambda: target.engine.inject_prefilled(h))
        if new_erid is None:
            self._queue.appendleft(self._requests[rid])
            self.metrics.requeued_total += 1
            return False
        target.outstanding[new_erid] = rid
        # Relayed accounting: the pages crossed the router, raw (span
        # codec applies per hop on remote ends; nbytes here is the
        # router-held copy — one traversal's worth for parity with
        # the direct counter; whole pages where a worker is an end).
        self._note_migration(
            rid, target, cost_us=plan["cost_us"],
            wire_bytes=int(
                wire.k_pages.numel() * wire.k_pages.element_size()
                + wire.v_pages.numel() * wire.v_pages.element_size()),
            ms=(self._clock() - t0) * 1e3)
        self._trace_handoff(rid, src, target, kind, t0)
        return True

    def _trace_handoff(self, rid: int, src: _Replica,
                       target: _Replica, kind: str, t0: float) -> None:
        req = self._requests.get(rid)
        if req is None or not req.trace:
            return
        self.trace.span("router:handoff", t0, self._clock() - t0,
                        trace=req.trace, rid=rid, kind=kind,
                        src=src.instance, dst=target.instance)

    def _pick_capacity(self, pool_role: Tuple[str, ...],
                       need_blocks: int,
                       exclude: Optional[_Replica] = None,
                       model: str = DEFAULT_MODEL,
                       source: Optional[_Replica] = None,
                       ) -> Optional[_Replica]:
        """Cheapest-link, then least-loaded same-MODEL replica in
        ``pool_role`` with a batch slot AND ``need_blocks`` of KV
        headroom — the handoff/migration target filter
        (admission-queue room is irrelevant: an injected sequence
        bypasses the queue). With a measured topology model and a
        ``source``, candidates are scored by the alpha-beta cost of
        moving the pages over their link first (a drain on a
        multi-host fleet prefers the cheap link); without a model —
        the tests' fleets, single hosts — every cost is 0 and the pick is
        the historical pure least-load. Pages only ever move between
        replicas of one model group: a KV page is meaningless under
        another model's weights."""
        topo = self._topology() if source is not None else None
        n_ranks = int(topo["np"]) if topo else 0
        src_rank = (migrate_mod.replica_rank(source.instance, n_ranks)
                    if source is not None else 0)
        cands = []
        for r in list(self._replicas):
            if (r.model != model or r.role not in pool_role
                    or r.draining or r is exclude):
                continue
            snap = self._guard(r, r.engine.admission_snapshot)
            if (snap is not None and snap["batch_slots_free"] > 0
                    and r.engine.allocator.can_alloc(need_blocks)):
                xfer_bytes = 0 if topo is None else int(
                    need_blocks * self._page_nbytes(source, r)
                    * migrate_mod.codec_wire_ratio(
                        self.cfg.handoff_compression))
                cost = migrate_mod.link_cost_us(
                    topo, src_rank,
                    migrate_mod.replica_rank(r.instance, n_ranks),
                    xfer_bytes)
                cands.append((r, snap, cost))
        if not cands:
            return None
        return min(cands, key=lambda t: (round(t[2], 3),
                                         self._load(t[1])))[0]

    # -- the fleet iteration -----------------------------------------

    def step(self) -> None:
        """One fleet iteration: heartbeat idle remote replicas
        (liveness + the cross-process metrics cache), expire
        router-queued deadlines, move completed prefills to the decode
        pool, migrate RUNNING work off migrating drains, place queued
        requests, step every busy replica, collect results, reap
        drained replicas. A worker that died since the last step is
        detected at its first RPC this step and its uncollected work
        requeues at the front — nothing is dropped, nothing resolves
        twice. On a mesh the step's clock reading (rank 0's) is the
        one every engine steps on."""
        now = self._clock()
        self._topo = _UNREAD
        self._heartbeat_sweep(now)
        self._expire_queued(now)
        self._collect_handoffs()
        self._migrate_draining()
        self._place_queued()
        self._step_replicas(now if self._mesh is not None else None)
        self._collect_results()
        self._reap_drained()

    def _step_replicas(self, now: Optional[float] = None) -> None:
        """Step every busy replica. Remote replicas' step RPCs FAN
        OUT: the request frame goes to every busy worker first
        (``step_begin``), in-process replicas step while the workers
        compute, then the replies are collected — and applied — in
        fleet order (``step_finish``). N workers therefore run their
        iterations concurrently instead of serially per router step
        (the measured loopback RPC tax was ~0.8x serial), while reply
        application order stays the deterministic fleet order — never
        network arrival order — so placement logs and results remain
        seed-deterministic. A worker that died is detected at its send
        OR its reply; either way ``_handle_dead`` requeues its work
        exactly once. ``now`` (on a mesh) is the reading in-process
        engines step on instead of reading their own clocks."""
        started: List[_Replica] = []
        try:
            # Remote begins FIRST (all of them), in-process steps
            # second: the workers compute while the local engines run,
            # instead of a leading local replica's full decode step
            # delaying every worker's request frame.
            for rep in list(self._replicas):
                if (rep in self._replicas and rep.remote
                        and rep.engine.pending):
                    if self._guard(rep,
                                   rep.engine.step_begin) is not None:
                        started.append(rep)
            for rep in list(self._replicas):
                if (rep in self._replicas and not rep.remote
                        and rep.engine.pending):
                    self._guard(rep, lambda e=rep.engine: e.step(now))
            while started:
                rep = started.pop(0)
                if rep in self._replicas:
                    self._guard(rep, rep.engine.step_finish)
        except BaseException:
            # A non-transport failure mid-fan-out (_guard only absorbs
            # connection errors — e.g. a worker engine exception
            # re-raised natively): the replicas still in `started`
            # have an uncollected step reply on a STRICT
            # request/response connection. Drain those replies
            # best-effort before unwinding, or the next RPC on each
            # would read a stale step beat as its own reply.
            for rep in started:
                if rep in self._replicas:
                    try:
                        rep.engine.step_finish()
                    except Exception:
                        pass
            raise

    def _expire_queued(self, now: float) -> None:
        keep: collections.deque[_Pending] = collections.deque()
        for req in self._queue:
            if req.deadline is not None and now > req.deadline:
                del self._requests[req.rid]
                self._results[req.rid] = RequestResult(
                    rid=req.rid, status="expired", http_status=503,
                    tokens=[], n_prompt=len(req.prompt),
                    submitted_at=req.submitted_at, finished_at=now,
                    reason="deadline_expired",
                    deadline_class=req.deadline_class,
                    retry_after_s=self._retry_after())
                self.metrics.expired_total += 1
            else:
                keep.append(req)
        self._queue = keep

    def _collect_results(self) -> None:
        for rep in self._replicas:
            done = []
            for erid, rid in rep.outstanding.items():
                res = rep.engine.result(erid)
                if res is None:
                    continue
                # Rebind to the router's rid space; everything else
                # (tokens, latencies, structured-rejection fields)
                # passes through untouched.
                req = self._requests[rid]
                self._results[rid] = dataclasses.replace(res, rid=rid)
                del self._requests[rid]
                done.append(erid)
                if req.trace:
                    # End-to-end on the router clock: submit to the
                    # step the result came home. The critical-path
                    # breakdown in `trace_merge` decomposes exactly
                    # this span.
                    t_end = self._clock()
                    self.trace.span(
                        "router:e2e", req.submitted_at,
                        t_end - req.submitted_at, trace=req.trace,
                        rid=rid, status=res.status,
                        instance=rep.instance)
                # Only REAL retirements feed the drain-rate EMA (the
                # engine's own EMA observes only _finish): a deadline
                # storm of back-to-back expirations would otherwise
                # collapse retry_after_s toward 0 exactly when the
                # fleet is saturated and serving nothing.
                if res.status == "ok" and res.finished_at is not None:
                    self._retire_ema.observe(res.finished_at)
            for erid in done:
                del rep.outstanding[erid]

    def _reap_drained(self) -> None:
        for r in list(self._replicas):
            if not (r.draining and not r.outstanding
                    and not r.engine.pending):
                continue
            parked = self._guard(r, r.engine.handoff_ready)
            if r not in self._replicas or parked:
                continue   # died (handled) or still holding handoffs
            # Fold the dying replica's lifetime counters and latency
            # samples into the rollup — fleet totals and tails must
            # survive membership churn — then, for a worker process,
            # shut it down (the drain owns the worker's lifecycle).
            self.metrics.absorb(r.engine.metrics, r.model)
            self._replicas.remove(r)
            _advance_membership(basics.MEMBER_SHRINK)
            if r.remote:
                r.engine.shutdown()

    def run_until_idle(self, max_steps: int = 1_000_000) -> None:
        for _ in range(max_steps):
            if not self.pending:
                return
            self.step()
        raise RuntimeError(f"fleet still busy after {max_steps} steps")

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: Optional[int] = None) -> List[List[int]]:
        """Convenience batch API, mirroring ``ServeEngine.generate``:
        serve ``prompts`` across the fleet and return their token
        streams in submission order."""
        rids = [self.submit(p, max_new_tokens) for p in prompts]
        self.run_until_idle()
        return [self._results[r].tokens for r in rids]

    def export_fleet_trace(self, dir_path: str) -> List[str]:
        """Write the whole fleet's trace files into ``dir_path``:
        ``router.json`` (this router's spans + timebase anchor) and
        one ``replica-<instance>.json`` per live replica, each
        carrying its own anchor and — for remote replicas — the
        router's RTT-estimated clock offset. ``trace_merge merge``
        over the directory produces the single-timebase Perfetto
        view. Returns the paths written. Remote replicas with no
        offset sample yet get one forced heartbeat first (a fleet
        that never idled may never have swept them). On a mesh
        (every rank calls it alike) mesh rank 0 writes ``router.json``
        and each worker's file, and each rank its in-process
        replicas' spans as ``replica-<instance>-rank<global
        rank>.json``, so no file is written twice."""
        import json as _json
        os.makedirs(dir_path, exist_ok=True)
        paths = []
        # Every rank reads the anchor: on a mesh the clock read is a
        # collective.
        meta = self.trace.metadata(fleet=self.metrics.fleet)
        suffix = ""
        if self._mesh is not None:
            suffix = f"-rank{dist.get_rank()}"
        root = self._lockstep is None or dist.get_rank(self._lockstep) == 0
        if root:
            p = os.path.join(dir_path, "router.json")
            self.trace.export(p, metadata=meta)
            paths.append(p)
        for rep in list(self._replicas):
            p = os.path.join(dir_path,
                             f"replica-{rep.instance}{suffix}.json")
            if rep.remote:
                if rep.engine.clock_rtt == float("inf"):
                    self._guard(rep, rep.engine.heartbeat)
                    if rep not in self._replicas:
                        continue   # died on the forced beat
                # Every rank makes the call (a mirror's is a
                # collective); the one worker's file is rank 0's.
                d = self._guard(rep, rep.engine.export_trace)
                if d is None or not root:
                    continue
                p = os.path.join(dir_path, f"replica-{rep.instance}.json")
                with open(p, "w") as f:
                    _json.dump({"traceEvents": d["events"],
                                "displayTimeUnit": "ms",
                                "metadata": d["meta"]}, f)
            else:
                rep.engine.metrics.export_chrome_trace(
                    p, instance=rep.instance, clock_offset=0.0)
            paths.append(p)
        return paths

    def close(self) -> None:
        """Release remote replicas without drain semantics: best-
        effort shutdown RPC to every worker, connections closed.
        In-process replicas need no teardown. Idempotent; the
        cross-process bench/tests call it between cold fleets."""
        for rep in self._replicas:
            if rep.remote:
                rep.engine.shutdown()
