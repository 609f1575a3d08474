"""Serving metrics: throughput, latency tails and scheduler health — the
counterpart of :mod:`horovod_tpu.serve.metrics`.

Surfaces:

* :meth:`ServeMetrics.snapshot` — counters and percentiles as a flat
  dict (what the serve benchmarks report).
* :meth:`ServeMetrics.prometheus` — the snapshot as Prometheus text
  through the port's one exposition helper
  (:func:`horovod_tpu_torch.metrics.render_gauges`), registered with
  :func:`horovod_tpu_torch.metrics.metrics_prometheus`'s exporters.
* :meth:`ServeMetrics.export_chrome_trace` — per-step spans in the
  chrome-tracing JSON format. The engine also runs each step under
  ``torch.profiler.record_function`` with the same names
  (``serve:prefill``, ``serve:decode``, ``serve:spec_draft``,
  ``serve:spec_verify``), so a torch profiler trace shows the phases.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Dict, List, Optional

from horovod_tpu_torch.metrics import register_exporter_weak, render_gauges

#: Keep at most this many latency samples per series (drop-newest); a
#: long-running engine must not grow without bound.
MAX_SAMPLES = 100_000


def percentile(samples: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 100]); None on no samples."""
    if not samples:
        return None
    xs = sorted(samples)
    idx = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[idx]


#: Process-wide default for the per-engine ``instance`` label, so the
#: series of several engines in one process stay apart in one scrape.
_instance_ids = itertools.count()


class ServeMetrics:
    def __init__(self, clock=time.perf_counter,
                 instance: Optional[str] = None):
        self._clock = clock
        self._allocator = None
        self._alloc_base = (0, 0, 0)
        self.instance = (str(next(_instance_ids)) if instance is None
                         else str(instance))
        self.reset()
        # Weakly bound: an abandoned engine's series vanish with it.
        register_exporter_weak(f"serve_{id(self)}", self, "prometheus")

    def reset(self) -> None:
        self.started_at = self._clock()
        self.tokens_generated = 0
        self.requests_submitted = 0
        self.requests_finished = 0
        self.requests_expired = 0
        self.requests_rejected = 0
        self.handoffs_in = 0
        self.handoffs_out = 0
        self.prefill_steps = 0
        self.decode_steps = 0
        self.queue_depth = 0
        self.max_queue_depth = 0
        self._occupancy_sum = 0.0
        # Token-granularity prefix-cache accounting (the block counters
        # live on the attached BlockAllocator).
        self.prefix_hit_tokens = 0
        self.prefix_prefill_tokens = 0
        # Speculative decoding: proposal / acceptance tallies and the
        # per-round draft / verify wall-time series.
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_draft_s: List[float] = []
        self.spec_verify_s: List[float] = []
        self.first_token_s: List[float] = []
        self.per_token_s: List[float] = []
        self._events: List[dict] = []
        # The allocator's counters are lifetime totals: baseline them so
        # snapshots cover the same window as every other counter here.
        if self._allocator is not None:
            a = self._allocator
            self._alloc_base = (a.prefix_hits, a.prefix_misses,
                                a.evictions)

    def attach_allocator(self, allocator) -> None:
        """Let snapshots and the trace read the block pool's gauges and
        prefix counters."""
        self._allocator = allocator
        self._alloc_base = (allocator.prefix_hits,
                            allocator.prefix_misses,
                            allocator.evictions)

    # -- recording ---------------------------------------------------

    def _span(self, name: str, t0: float, dur: float, **args) -> None:
        # chrome-tracing "complete" event; ts/dur in microseconds.
        if len(self._events) >= MAX_SAMPLES:
            return
        ts = round((t0 - self.started_at) * 1e6, 1)
        self._events.append({
            "name": name, "ph": "X", "pid": 0, "tid": 0,
            "ts": ts, "dur": round(dur * 1e6, 1), "args": args})
        if (self._allocator is not None
                and len(self._events) < MAX_SAMPLES):
            # Pool occupancy as a counter track beside the spans.
            self._events.append({
                "name": "kv_blocks", "ph": "C", "pid": 0, "tid": 0,
                "ts": ts, "args": {"in_use": self._allocator.n_used,
                                   "cached": self._allocator.n_cached}})

    def record_queue_depth(self, depth: int) -> None:
        self.queue_depth = depth
        self.max_queue_depth = max(self.max_queue_depth, depth)

    def _pool_gauges(self) -> dict:
        a = self._allocator
        if a is None:
            return {}
        return {"blocks_in_use": a.n_used, "blocks_cached": a.n_cached}

    def record_prefill(self, t0: float, dur_s: float, n_tokens: int,
                       offset: int = 0, trace: int = 0) -> None:
        """One prefill chunk of ``n_tokens`` starting at token
        ``offset``; ``trace`` is the request's trace id (0 = unsampled,
        left out of the span)."""
        self.prefill_steps += 1
        extra = {"trace": trace} if trace else {}
        self._span("serve:prefill", t0, dur_s, n_tokens=n_tokens,
                   offset=offset, **extra, **self._pool_gauges())

    def record_prefix_lookup(self, hit_tokens: int,
                             suffix_tokens: int) -> None:
        """One admission's cache outcome: ``hit_tokens`` prompt tokens
        mapped from the prefix cache, ``suffix_tokens`` left to
        prefill."""
        self.prefix_hit_tokens += hit_tokens
        self.prefix_prefill_tokens += suffix_tokens

    def record_prefix_extend(self, tokens: int) -> None:
        """Tokens turned from pending prefill into cache hits by the
        engine's second cache walk at prefill time."""
        self.prefix_hit_tokens += tokens
        self.prefix_prefill_tokens -= tokens

    def record_decode(self, t0: float, dur_s: float, n_active: int,
                      max_batch: int, traces=None) -> None:
        self.decode_steps += 1
        self.tokens_generated += n_active
        self._occupancy_sum += n_active / max_batch
        if len(self.per_token_s) < MAX_SAMPLES:
            # Every active sequence advanced one token this step, so the
            # step's wall time is the per-token latency sample.
            self.per_token_s.append(dur_s)
        extra = {"traces": list(traces)} if traces else {}
        self._span("serve:decode", t0, dur_s, n_active=n_active,
                   **extra, **self._pool_gauges())

    def record_spec_round(self, t0: float, draft_dur_s: float,
                          verify_dur_s: float, n_active: int,
                          max_batch: int, *, proposed: int,
                          accepted: int, emitted: int,
                          traces=None) -> None:
        """One speculative iteration: the draft's decode steps (one
        span) and the target's verify step, with the round's tallies.
        It feeds the throughput and occupancy series a decode step
        feeds; its per-token sample is the round's wall time over the
        tokens each sequence got."""
        self.spec_rounds += 1
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        self.tokens_generated += emitted
        self._occupancy_sum += n_active / max_batch
        dur = draft_dur_s + verify_dur_s
        if emitted and len(self.per_token_s) < MAX_SAMPLES:
            self.per_token_s.append(dur * n_active / emitted)
        if len(self.spec_draft_s) < MAX_SAMPLES:
            self.spec_draft_s.append(draft_dur_s)
        if len(self.spec_verify_s) < MAX_SAMPLES:
            self.spec_verify_s.append(verify_dur_s)
        extra = {"traces": list(traces)} if traces else {}
        self._span("serve:spec_draft", t0, draft_dur_s,
                   n_active=n_active, proposed=proposed, **extra)
        self._span("serve:spec_verify", t0 + draft_dur_s, verify_dur_s,
                   accepted=accepted, emitted=emitted, **extra,
                   **self._pool_gauges())

    def record_first_token(self, latency_s: float) -> None:
        # The first token comes out of the prefill, not a decode step.
        self.tokens_generated += 1
        if len(self.first_token_s) < MAX_SAMPLES:
            self.first_token_s.append(latency_s)

    def record_submitted(self) -> None:
        self.requests_submitted += 1

    def record_withdrawn(self) -> None:
        """A queued request taken back by ``ServeEngine.withdraw``: it
        leaves without a result and is counted again wherever it is
        submitted next."""
        self.requests_submitted -= 1

    def record_finished(self) -> None:
        self.requests_finished += 1

    def record_expired(self) -> None:
        self.requests_expired += 1

    def record_rejected(self) -> None:
        self.requests_rejected += 1

    def record_handoff_out(self) -> None:
        """A sequence left this engine (``export_prefilled`` or
        ``export_running``)."""
        self.handoffs_out += 1

    def record_handoff_in(self) -> None:
        """A handed-off sequence arrived to decode here."""
        self.handoffs_in += 1

    # -- export ------------------------------------------------------

    def snapshot(self) -> Dict[str, float]:
        elapsed = max(self._clock() - self.started_at, 1e-9)

        def ms(x):
            return None if x is None else round(x * 1e3, 3)

        # A speculative round occupies the batch slots as a decode step
        # does, so both count in the occupancy's denominator.
        occ_steps = self.decode_steps + self.spec_rounds
        occ = self._occupancy_sum / occ_steps if occ_steps else 0.0
        looked_up = self.prefix_hit_tokens + self.prefix_prefill_tokens
        out = {
            "elapsed_s": round(elapsed, 3),
            "tokens_generated": self.tokens_generated,
            "tokens_per_sec": round(self.tokens_generated / elapsed, 2),
            "requests_submitted": self.requests_submitted,
            "requests_finished": self.requests_finished,
            "requests_expired": self.requests_expired,
            "requests_rejected": self.requests_rejected,
            "handoffs_in": self.handoffs_in,
            "handoffs_out": self.handoffs_out,
            "prefill_steps": self.prefill_steps,
            "decode_steps": self.decode_steps,
            "queue_depth": self.queue_depth,
            "max_queue_depth": self.max_queue_depth,
            "batch_occupancy": round(occ, 4),
            "prefix_cache_hit_rate": (
                round(self.prefix_hit_tokens / looked_up, 4)
                if looked_up else 0.0),
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_prefill_tokens": self.prefix_prefill_tokens,
            "p50_first_token_ms": ms(percentile(self.first_token_s, 50)),
            "p99_first_token_ms": ms(percentile(self.first_token_s, 99)),
            "p50_per_token_ms": ms(percentile(self.per_token_s, 50)),
            "p99_per_token_ms": ms(percentile(self.per_token_s, 99)),
            # Zeros on a plain engine, so rollups over mixed engines sum
            # without key checks. The accept rate is accepted draft
            # tokens over proposed ones.
            "spec_rounds": self.spec_rounds,
            "spec_proposed_total": self.spec_proposed,
            "spec_accepted_total": self.spec_accepted,
            "spec_accept_rate": (
                round(self.spec_accepted / self.spec_proposed, 4)
                if self.spec_proposed else 0.0),
            "p50_spec_draft_ms": ms(percentile(self.spec_draft_s, 50)),
            "p99_spec_draft_ms": ms(percentile(self.spec_draft_s, 99)),
            "p50_spec_verify_ms": ms(percentile(self.spec_verify_s, 50)),
            "p99_spec_verify_ms": ms(percentile(self.spec_verify_s, 99)),
        }
        if self._allocator is not None:
            a = self._allocator
            hits0, misses0, evict0 = self._alloc_base
            out.update({
                # Counters are deltas since reset(); the high-water
                # gauge covers the engine's lifetime.
                "kv_blocks_in_use": a.n_used,
                "kv_blocks_cached": a.n_cached,
                "kv_blocks_high_water": a.high_water,
                "prefix_block_hits": a.prefix_hits - hits0,
                "prefix_block_misses": a.prefix_misses - misses0,
                "prefix_block_evictions": a.evictions - evict0,
            })
        return out

    def prometheus(self) -> str:
        """This snapshot as Prometheus text under the ``serve_`` prefix,
        every sample labelled with this engine's ``instance``."""
        return render_gauges("serve", self.snapshot(),
                             labels={"instance": self.instance})

    def trace_metadata(self, **extra) -> dict:
        """Timebase anchor for :meth:`export_chrome_trace`: span ``ts``
        values are microseconds since ``started_at`` on this engine's
        clock, and ``(clock_now, wall_now)`` maps them onto wall time."""
        md = {
            "kind": "engine",
            "instance": self.instance,
            "pid": os.getpid(),
            "started_at": self.started_at,
            "clock_now": self._clock(),
            "wall_now": time.time(),
        }
        md.update(extra)
        return md

    def export_chrome_trace(self, path: str, **extra) -> None:
        """Write the recorded step spans as a chrome-tracing file, with
        the :meth:`trace_metadata` anchor."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self._events,
                       "displayTimeUnit": "ms",
                       "metadata": self.trace_metadata(**extra)}, f)
