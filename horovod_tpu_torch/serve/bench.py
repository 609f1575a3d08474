"""Serving benchmarks: scheduling, prefix caching, chunked prefill,
speculative decoding and the tracing tax — the counterpart of
:mod:`horovod_tpu.serve.bench` on one device.

* **continuous vs static batching** on a mixed-length trace: both
  schedulers run the same programs over the same pool geometry; the
  ratio isolates the scheduling win. The same trace through a chunked
  engine reports its per-token tail beside the monolithic run's.
* **prefix caching** on a shared-system-prompt trace: cache on vs off.
* **speculative decoding** with the draft/target pair of
  :func:`~horovod_tpu_torch.serve.speculative.make_draft_target_params`.
* **the tracing tax**: trace-id tagging on vs off on one engine, and
  the flight recorder's full-ring dump.

Each returns the reference's keys; an engine serves on one device, so
the ``*_per_chip`` keys are per GPU. Run directly (``--device cpu`` for
the plain path):

    python -m horovod_tpu_torch.serve.bench

The fleet tier (``run_router_benchmark``) waits for ROADMAP item 14.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import List, Tuple

import numpy as np
import torch

from horovod_tpu_torch.device import resolve_device
from horovod_tpu_torch.serve.metrics import percentile


def make_trace(n_requests: int = 40, *, seed: int = 0,
               min_prompt: int = 4, max_prompt: int = 32,
               min_new: int = 8, max_new: int = 64,
               vocab: int = 256) -> List[Tuple[List[int], int]]:
    """Deterministic mixed-length request trace:
    ``[(prompt_tokens, max_new_tokens), ...]`` (numpy's ``RandomState``
    draws, so the reference makes the same trace from the same seed)."""
    rng = np.random.RandomState(seed)
    # Callers shrink max_* freely; the lower bounds follow.
    min_prompt = min(min_prompt, max_prompt)
    min_new = min(min_new, max_new)
    trace = []
    for _ in range(n_requests):
        plen = int(rng.randint(min_prompt, max_prompt + 1))
        nnew = int(rng.randint(min_new, max_new + 1))
        prompt = rng.randint(1, vocab, size=plen).astype(np.int32).tolist()
        trace.append((prompt, nnew))
    return trace


def make_shared_prefix_trace(n_requests: int = 32, *, seed: int = 0,
                             prefix_len: int = 64, min_suffix: int = 4,
                             max_suffix: int = 12, min_new: int = 4,
                             max_new: int = 8, vocab: int = 256,
                             ) -> List[Tuple[List[int], int]]:
    """Every request shares one ``prefix_len``-token system prompt and
    appends a short unique suffix: the regime where block-level prefix
    reuse pays."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(1, vocab, size=prefix_len).astype(np.int32).tolist()
    trace = []
    for _ in range(n_requests):
        slen = int(rng.randint(min_suffix, max_suffix + 1))
        nnew = int(rng.randint(min_new, max_new + 1))
        suffix = rng.randint(1, vocab, size=slen).astype(np.int32).tolist()
        trace.append((prefix + suffix, nnew))
    return trace


def make_multi_tenant_trace(n_requests: int = 48, *, seed: int = 0,
                            n_tenants: int = 8, prefix_len: int = 32,
                            min_suffix: int = 2, max_suffix: int = 8,
                            min_new: int = 2, max_new: int = 4,
                            vocab: int = 256,
                            ) -> List[Tuple[List[int], int]]:
    """``n_tenants`` distinct system prompts, requests interleaved
    across tenants."""
    rng = np.random.RandomState(seed)
    prefixes = [rng.randint(1, vocab, size=prefix_len).astype(
        np.int32).tolist() for _ in range(n_tenants)]
    trace = []
    for _ in range(n_requests):
        t = int(rng.randint(n_tenants))
        slen = int(rng.randint(min_suffix, max_suffix + 1))
        nnew = int(rng.randint(min_new, max_new + 1))
        suffix = rng.randint(1, vocab, size=slen).astype(np.int32).tolist()
        trace.append((prefixes[t] + suffix, nnew))
    return trace


def _run_trace(engine, trace) -> dict:
    """Submit the whole trace up front (a closed-loop burst) and serve
    it to completion; returns the engine's metrics snapshot and the
    wall-clock throughput. ``_tokens`` carries the decoded streams in
    submission order (callers pop it before emitting JSON)."""
    t0 = time.perf_counter()
    engine.metrics.reset()
    rids = [engine.submit(p, n) for p, n in trace]
    engine.run_until_idle()
    dt = time.perf_counter() - t0
    streams = [engine.result(r).tokens for r in rids]
    total = sum(len(s) for s in streams)
    snap = engine.metrics.snapshot()
    snap["wall_s"] = round(dt, 3)
    snap["tokens_total"] = total
    snap["tokens_per_sec_wall"] = round(total / dt, 2)
    snap["_tokens"] = streams
    snap["_per_token_s"] = list(engine.metrics.per_token_s)
    return snap


def _interleaved_passes(engines, trace, repeats: int, warmup: bool) -> dict:
    """Warm every engine on the trace (and any prefix cache), then run
    the measured passes interleaved round-robin across arms, so drift on
    a shared host spreads evenly over them. Returns ``{label: [pass
    snapshots]}``."""
    if warmup:
        for engine in engines.values():
            _run_trace(engine, trace)
    passes = {label: [] for label in engines}
    for _ in range(max(repeats, 1)):
        for label, engine in engines.items():
            passes[label].append(_run_trace(engine, trace))
    return passes


def _best_pass(snaps) -> dict:
    return dict(max(snaps, key=lambda s: s["tokens_per_sec_wall"]))


def _model(model_cfg, default_cfg, device):
    """``(cfg, params)``: params from seed 0 on ``device``."""
    from horovod_tpu_torch.models.transformer import init_params

    cfg = default_cfg if model_cfg is None else model_cfg
    return cfg, init_params(cfg, torch.Generator(device).manual_seed(0),
                            device=device)


def _tiny(**kw):
    from horovod_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig.tiny(dtype=torch.float32, remat=False, **kw)


def run_serving_benchmark(n_requests: int = 40, *, seed: int = 0,
                          model_cfg=None, max_batch: int = 8,
                          block_size: int = 8, warmup: bool = True,
                          repeats: int = 3, prefill_chunk: int = 16,
                          device=None) -> dict:
    """Continuous vs static batching (and chunked prefill) on the same
    mixed-length trace: throughput from each arm's best of ``repeats``
    interleaved passes, latency tails over the pooled samples of all of
    an arm's passes (per-token) or their least-interfered pass
    (first-token). Prefix caching is off in every arm: the measured
    passes replay the warm-up's prompts."""
    from horovod_tpu_torch.serve.engine import ServeConfig, ServeEngine

    device = resolve_device(device)
    model_cfg, params = _model(model_cfg, _tiny(), device)
    trace = make_trace(n_requests, seed=seed)
    max_prompt = max(len(p) for p, _ in trace)
    max_new = max(n for _, n in trace)

    engines = {}
    for label, overrides in (
            ("continuous", {}),
            ("static", {"scheduling": "static"}),
            ("chunked", {"prefill_chunk": prefill_chunk})):
        cfg = ServeConfig(
            max_batch=max_batch, max_queue=max(len(trace), 8),
            block_size=block_size, max_prompt=max_prompt,
            max_new_tokens=max_new, prefix_caching=False, **overrides)
        engines[label] = ServeEngine(model_cfg, params, cfg, device=device)
    passes = _interleaved_passes(engines, trace, repeats, warmup)
    snaps = {label: _best_pass(ps) for label, ps in passes.items()}
    for label, ps in passes.items():
        pooled = [x for s in ps for x in s["_per_token_s"]]
        for q in (50, 99):
            v = percentile(pooled, q)
            snaps[label][f"p{q}_per_token_ms"] = (
                None if v is None else round(v * 1e3, 3))
        for k in ("p50_first_token_ms", "p99_first_token_ms"):
            vals = [s[k] for s in ps if s[k] is not None]
            snaps[label][k] = min(vals) if vals else None

    cont, stat, chk = snaps["continuous"], snaps["static"], snaps["chunked"]
    ratio = (cont["tokens_per_sec_wall"] / stat["tokens_per_sec_wall"]
             if stat["tokens_per_sec_wall"] else None)
    return {
        "serve_tokens_per_sec_per_chip": cont["tokens_per_sec_wall"],
        "serve_static_tokens_per_sec_per_chip": stat["tokens_per_sec_wall"],
        "serve_continuous_over_static":
            None if ratio is None else round(ratio, 3),
        "serve_p50_first_token_ms": cont["p50_first_token_ms"],
        "serve_p99_first_token_ms": cont["p99_first_token_ms"],
        "serve_p50_per_token_ms": cont["p50_per_token_ms"],
        "serve_p99_per_token_ms": cont["p99_per_token_ms"],
        "serve_batch_occupancy": cont["batch_occupancy"],
        "serve_static_batch_occupancy": stat["batch_occupancy"],
        "serve_decode_steps": cont["decode_steps"],
        "serve_static_decode_steps": stat["decode_steps"],
        "serve_chunked_tokens_per_sec_per_chip": chk["tokens_per_sec_wall"],
        "serve_chunked_p50_per_token_ms": chk["p50_per_token_ms"],
        "serve_chunked_p99_per_token_ms": chk["p99_per_token_ms"],
        "serve_chunked_p99_first_token_ms": chk["p99_first_token_ms"],
        "serve_chunked_tokens_identical":
            chk["_tokens"] == cont["_tokens"],
    }


def run_prefix_benchmark(n_requests: int = 32, *, seed: int = 0,
                         model_cfg=None, max_batch: int = 8,
                         block_size: int = 8, prefix_len: int = 64,
                         warmup: bool = True, repeats: int = 3,
                         device=None) -> dict:
    """The prefix cache on vs off on the shared-system-prompt trace,
    best of ``repeats`` interleaved passes each, with short decodes (the
    claim is about prompt work). The pool holds the worst-case live
    reservation plus room for the cached prefix and one tail block a
    request, so the cache is not evicted under a full wave."""
    from horovod_tpu_torch.serve.engine import ServeConfig, ServeEngine

    device = resolve_device(device)
    model_cfg, params = _model(model_cfg, _tiny(
        d_model=256, d_ff=1024, n_layers=2, n_heads=8, n_kv_heads=4),
        device)
    trace = make_shared_prefix_trace(n_requests, seed=seed,
                                     prefix_len=prefix_len,
                                     min_new=2, max_new=4)
    max_prompt = max(len(p) for p, _ in trace)
    max_new = max(n for _, n in trace)
    blocks_per_seq = -(-(-(-max_prompt // block_size) * block_size
                         + max_new) // block_size)
    n_blocks = (max_batch * blocks_per_seq
                + prefix_len // block_size + n_requests + 1)

    engines = {}
    for label, caching in (("cache", True), ("nocache", False)):
        cfg = ServeConfig(
            max_batch=max_batch, max_queue=max(len(trace), 8),
            block_size=block_size, max_prompt=max_prompt,
            max_new_tokens=max_new, n_blocks=n_blocks,
            prefix_caching=caching)
        engines[label] = ServeEngine(model_cfg, params, cfg, device=device)
    # The warm-up fills the cache-on arm's index, so the measured passes
    # time serving with a warm cache.
    passes = _interleaved_passes(engines, trace, repeats, warmup)
    snaps = {label: _best_pass(ps) for label, ps in passes.items()}

    hit, miss = snaps["cache"], snaps["nocache"]
    speedup = (hit["tokens_per_sec_wall"] / miss["tokens_per_sec_wall"]
               if miss["tokens_per_sec_wall"] else None)
    return {
        "serve_prefix_tokens_per_sec_per_chip": hit["tokens_per_sec_wall"],
        "serve_prefix_nocache_tokens_per_sec_per_chip":
            miss["tokens_per_sec_wall"],
        "serve_prefix_cache_speedup":
            None if speedup is None else round(speedup, 3),
        "serve_prefix_cache_hit_rate": hit["prefix_cache_hit_rate"],
        "serve_prefix_p99_first_token_ms": hit["p99_first_token_ms"],
        "serve_prefix_nocache_p99_first_token_ms":
            miss["p99_first_token_ms"],
        "serve_prefix_block_evictions": hit["prefix_block_evictions"],
        "serve_prefix_kv_high_water": hit["kv_blocks_high_water"],
        "serve_prefix_tokens_identical": hit["_tokens"] == miss["_tokens"],
    }


def run_spec_benchmark(n_requests: int = 24, *, seed: int = 0,
                       draft_cfg=None, target_layers: int = 8,
                       spec_k: int = 4, max_batch: int = 4,
                       block_size: int = 8, warmup: bool = True,
                       repeats: int = 3, device=None) -> dict:
    """Speculative vs plain decode on a decode-heavy multi-tenant trace,
    with the idealized pair (a ``target_layers``-deep target whose extra
    layers add nothing: accept rate 1.0 by construction), so the ratio
    shows what reading the weights once per ``spec_k`` tokens buys.
    Throughput takes the best pass, first-token tails the least
    interfered, the accept rate pools the passes' counts."""
    from horovod_tpu_torch.serve.engine import ServeConfig, ServeEngine
    from horovod_tpu_torch.serve.speculative import (
        DraftConfig, make_draft_target_params)

    device = resolve_device(device)
    if draft_cfg is None:
        draft_cfg = _tiny(d_model=512, d_ff=2048, n_layers=1, n_heads=8,
                          n_kv_heads=4)
    target_cfg, target_params = make_draft_target_params(
        draft_cfg, n_layers=target_layers, seed=0, device=device)
    trace = make_multi_tenant_trace(n_requests, seed=seed, min_new=6,
                                    max_new=12)
    max_prompt = max(len(p) for p, _ in trace)
    max_new = max(n for _, n in trace)
    base = dict(max_batch=max_batch, max_queue=max(len(trace), 8),
                block_size=block_size, max_prompt=max_prompt,
                max_new_tokens=max_new)
    engines = {
        "plain": ServeEngine(target_cfg, target_params,
                             ServeConfig(**base), device=device),
        "spec": ServeEngine(target_cfg, target_params, ServeConfig(
            **base, draft=DraftConfig(draft_cfg, seed=0),
            spec_k=spec_k), device=device),
    }
    passes = _interleaved_passes(engines, trace, repeats, warmup)
    snaps = {label: _best_pass(ps) for label, ps in passes.items()}
    for label, ps in passes.items():
        vals = [s["p99_first_token_ms"] for s in ps
                if s["p99_first_token_ms"] is not None]
        snaps[label]["p99_first_token_ms"] = min(vals) if vals else None
    proposed = sum(s["spec_proposed_total"] for s in passes["spec"])
    accepted = sum(s["spec_accepted_total"] for s in passes["spec"])
    ref = snaps["plain"]["_tokens"]
    identical = all(s["_tokens"] == ref
                    for ps in passes.values() for s in ps)
    plain_tps = snaps["plain"]["tokens_per_sec_wall"]
    spec_tps = snaps["spec"]["tokens_per_sec_wall"]
    return {
        "serve_spec_tokens_per_sec": spec_tps,
        "serve_spec_plain_tokens_per_sec": plain_tps,
        "serve_spec_over_plain": (round(spec_tps / plain_tps, 3)
                                  if plain_tps else None),
        "serve_spec_accept_rate": (round(accepted / proposed, 4)
                                   if proposed else 0.0),
        "serve_spec_p99_first_token_ms":
            snaps["spec"]["p99_first_token_ms"],
        "serve_spec_plain_p99_first_token_ms":
            snaps["plain"]["p99_first_token_ms"],
        "serve_spec_verify_rounds_count": snaps["spec"]["spec_rounds"],
        "serve_spec_tokens_identical": identical,
    }


def run_trace_overhead_benchmark(n_requests: int = 32, *, seed: int = 0,
                                 model_cfg=None, max_batch: int = 8,
                                 block_size: int = 8, warmup: bool = True,
                                 repeats: int = 4, device=None) -> dict:
    """Two keys:

    * ``serve_trace_overhead_pct`` — the throughput tax of trace-id
      tagging (every submit minted, every span carrying ids) against
      the same workload untagged, on ONE engine; the arm order flips
      every round and the medians compare, so warm-up drift cancels.
    * ``flight_dump_ms`` — one full-ring (4096-slot) dump of the port's
      native flight recorder, best of 5.
    """
    import os
    import tempfile

    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.metrics import (flight_clear, flight_dump,
                                           flight_record)
    from horovod_tpu_torch.serve.engine import ServeConfig, ServeEngine
    from horovod_tpu_torch.serve.trace import mint_trace_id

    device = resolve_device(device)
    model_cfg, params = _model(model_cfg, _tiny(), device)
    trace = make_trace(n_requests, seed=seed)
    max_prompt = max(len(p) for p, _ in trace)
    max_new = max(n for _, n in trace)
    cfg = ServeConfig(max_batch=max_batch, max_queue=max(len(trace), 8),
                      block_size=block_size, max_prompt=max_prompt,
                      max_new_tokens=max_new, prefix_caching=False)
    engine = ServeEngine(model_cfg, params, cfg, device=device)

    def _pass(label):
        t0 = time.perf_counter()
        engine.metrics.reset()
        rids = []
        for i, (p, n) in enumerate(trace):
            tid = (mint_trace_id(i, salt=seed, sample=1.0)
                   if label == "traced" else 0)
            rids.append(engine.submit(p, n, trace_id=tid))
        engine.run_until_idle()
        dt = time.perf_counter() - t0
        total = sum(len(engine.result(r).tokens) for r in rids)
        return total / dt

    if warmup:
        for label in ("plain", "traced"):
            _pass(label)
    tps = {"traced": [], "plain": []}
    for r in range(max(repeats, 1)):
        order = ("plain", "traced") if r % 2 == 0 else ("traced", "plain")
        for label in order:
            tps[label].append(_pass(label))
    med_on = statistics.median(tps["traced"])
    med_off = statistics.median(tps["plain"])
    overhead = (med_off / med_on - 1.0) * 100.0 if med_on else None

    # Full-ring dump: pad the ring to capacity, then time the render
    # the fatal-signal handler runs.
    flight_clear()
    for i in range(4096):
        flight_record(basics.FLIGHT_REQUEUE, i, 0)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "flight-bench.txt")
        dump_s = []
        for _ in range(5):
            t0 = time.perf_counter()
            ok = flight_dump(path)
            dump_s.append(time.perf_counter() - t0)
            if not ok:
                raise RuntimeError("flight_dump wrote nothing")
    flight_clear()
    return {
        "serve_trace_overhead_pct":
            None if overhead is None else round(overhead, 2),
        "flight_dump_ms": round(min(dump_s) * 1e3, 3),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain path (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = run_serving_benchmark(device=device)
    out.update(run_prefix_benchmark(device=device))
    out.update(run_spec_benchmark(device=device))
    out.update(run_trace_overhead_benchmark(device=device))
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
