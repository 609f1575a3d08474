"""Request-scoped tracing for serving — the counterpart of
:mod:`horovod_tpu.serve.trace`.

* **Trace ids.** :func:`mint_trace_id` gives one 64-bit id per request:
  FNV-1a over ``(salt, rid)``, deterministic for a fixed salt, never 0
  (id 0 means "unsampled" everywhere). The engine tags its
  prefill/decode spans with it (``ServeEngine.submit(trace_id=...)``).
* **Sampling.** ``HOROVOD_TRACE_SAMPLE`` is the fraction of requests to
  trace, in [0, 1] (default 1: everything). The decision is
  deterministic by the id's hash, so a replayed run traces the same
  requests; an unsampled request pays only the test.
* **One timebase.** :class:`RouterTrace` records a router's half of a
  request's life on its own clock, and every export carries a
  ``(clock_now, wall_now)`` anchor pair in its metadata, as
  ``ServeMetrics.export_chrome_trace`` does, so spans of several
  processes can be mapped onto one wall clock.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from typing import Any, Dict, List, Optional

#: The sampling knob: fraction of requests to trace, default 1.0
#: (everything); 0 disables minting.
TRACE_SAMPLE_ENV = "HOROVOD_TRACE_SAMPLE"

#: Span cap, the same drop-newest policy as ``ServeMetrics`` events.
MAX_TRACE_EVENTS = 100_000

_warned_bad_sample = False


def trace_sample_rate() -> float:
    """:data:`TRACE_SAMPLE_ENV` as a fraction in [0, 1]: unset or empty
    is 1.0; a value that is not a number warns once and traces
    everything (a typo must not silently turn tracing off); numbers are
    clamped into range."""
    global _warned_bad_sample
    raw = os.environ.get(TRACE_SAMPLE_ENV, "").strip()
    if not raw:
        return 1.0
    try:
        val = float(raw)
    except ValueError:
        if not _warned_bad_sample:
            _warned_bad_sample = True
            warnings.warn(
                f"{TRACE_SAMPLE_ENV}={raw!r} is not a number; tracing "
                "every request (the default)", stacklevel=2)
        return 1.0
    return min(max(val, 0.0), 1.0)


def _fnv1a64(*parts: int) -> int:
    """FNV-1a over each part's 8 little-endian bytes, in order."""
    h = 0xcbf29ce484222325
    for p in parts:
        v = p & 0xFFFFFFFFFFFFFFFF
        for _ in range(8):
            h ^= v & 0xFF
            h = (h * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
            v >>= 8
    return h


def mint_trace_id(rid: int, salt: int = 0,
                  sample: Optional[float] = None) -> int:
    """Trace id for request ``rid``: FNV-1a over (salt, rid), never 0
    (0 = unsampled). ``sample`` overrides the environment's rate."""
    rate = trace_sample_rate() if sample is None else sample
    if rate <= 0.0:
        return 0
    h = _fnv1a64(salt, rid)
    if rate < 1.0 and (h % 1_000_000) >= int(rate * 1_000_000):
        return 0
    return h or 1


class RouterTrace:
    """Chrome-event recorder for a router's half of a request's life
    (submit, queue wait, placement, handoffs, the end-to-end span). All
    timestamps are on the router's clock: ``ts`` in microseconds since
    construction, as ``ServeMetrics`` spans are; :meth:`export` writes
    the anchor pair that maps them onto wall time."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self.started_at = clock()
        self._events: List[dict] = []

    def _ts(self, t: float) -> float:
        return round((t - self.started_at) * 1e6, 1)

    def span(self, name: str, t0: float, dur_s: float,
             trace: int = 0, **args: Any) -> None:
        if len(self._events) >= MAX_TRACE_EVENTS:
            return
        if trace:
            args["trace"] = trace
        self._events.append({
            "name": name, "ph": "X", "pid": 0, "tid": 0,
            "ts": self._ts(t0), "dur": round(dur_s * 1e6, 1),
            "args": args})

    def instant(self, name: str, t: Optional[float] = None,
                trace: int = 0, **args: Any) -> None:
        if len(self._events) >= MAX_TRACE_EVENTS:
            return
        if trace:
            args["trace"] = trace
        self._events.append({
            "name": name, "ph": "i", "s": "t", "pid": 0, "tid": 0,
            "ts": self._ts(self._clock() if t is None else t),
            "args": args})

    @property
    def events(self) -> List[dict]:
        return self._events

    def metadata(self, **extra: Any) -> Dict[str, Any]:
        """The ``(clock_now, wall_now)`` anchor and whatever the caller
        adds (kind, instance, offsets)."""
        md = {
            "kind": "router",
            "pid": os.getpid(),
            "started_at": self.started_at,
            "clock_now": self._clock(),
            "wall_now": time.time(),
            "clock_offset": 0.0,
        }
        md.update(extra)
        return md

    def export(self, path: str, metadata: Optional[Dict[str, Any]] = None,
               **extra: Any) -> None:
        """Write the spans and an anchor: ``metadata`` as read
        beforehand, or :meth:`metadata` of ``extra`` now."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self._events,
                       "displayTimeUnit": "ms",
                       "metadata": (self.metadata(**extra)
                                    if metadata is None else metadata)}, f)
