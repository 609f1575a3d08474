"""The port's serving engine (``horovod_tpu_torch.serve``) against the
JAX package's, on the CPU, f32, ``TransformerConfig.tiny`` with JAX's
parameters from ``PRNGKey(0)`` loaded through ``params_from_jax``:

- ``_rope_at`` (rtol 1e-6), ``block_hash``/``hash_chain`` (equal bytes)
  and the allocator: one randomized sequence of alloc / register /
  acquire / free replayed through both, block ids, refcounts, states
  and eviction counts equal after every op;
- each of the five programs (``prefill``, ``prefill_resume``,
  ``decode``, ``verify``, ``inject``) on the same pools, tokens,
  offsets and block tables, chosen to hit every guard that routes a
  write to the null block: a bucket block past the allocation, a chunk
  whose bucket runs past the table, a decode slot past the table, an
  all-null padded row, a verify chunk that starts mid-block and runs
  past the table. Each case writes the null block at most once per
  row of it (or with equal values), so the whole pools compare, null
  block included: within 1e-5, and the tokens are equal;
- whole-engine greedy streams against the JAX ``ServeEngine``, token
  for token, on ``make_trace`` through continuous, static and chunked
  (``prefill_chunk`` 16) scheduling, on ``make_shared_prefix_trace``
  with the prefix cache on and off (hit counts equal too), and on the
  tiny MoE config (one JAX run per trace, module fixtures);
- the reference's own identities on the port (``tests/test_serve.py``):
  served decode equal to single-request decode and to the full-context
  ``forward`` greedy, the prefix-cache and chunked parity, the handoff
  round trip and the mid-decode export, eos, queue-full, deadlines,
  withdraw, KV backpressure, the bucket validation, the metrics;
- the serve bench functions at tiny sizes: the reference's keys (minus
  the fleet tiers) and ``horovod_tpu_torch.bench.run_serve``.

Speculative decoding is ``tests/test_torch_serve_spec.py``.
"""

import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import TransformerConfig as JaxConfig
from horovod_tpu.models import init_transformer
from horovod_tpu.serve import ServeConfig as JaxServeConfig
from horovod_tpu.serve import ServeEngine as JaxServeEngine
from horovod_tpu.serve import bench as jax_bench
from horovod_tpu.serve import decode as jax_decode
from horovod_tpu.serve import kv_cache as jax_kv

from horovod_tpu_torch import serve
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.serve import bench as tbench
from horovod_tpu_torch.serve import decode as tdecode
from horovod_tpu_torch.serve import kv_cache as tkv

#: One geometry for every engine of the module (the reference's
#: ``_PFX_KW``): JAX compiles one program set for it.
KW = dict(max_batch=4, block_size=4, max_prompt=24, max_new_tokens=6,
          batch_buckets=(4,), prefill_buckets=(4, 8, 16, 24))


def _cfgs(**kw):
    return (JaxConfig.tiny(dtype=jnp.float32, remat=False, **kw),
            ttr.TransformerConfig.tiny(dtype=torch.float32, remat=False,
                                       **kw))


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, port params)."""
    jcfg, tcfg = _cfgs()
    jp = init_transformer(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, ttr.params_from_jax(
        jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def moe_model():
    """The reference's tiny MoE (8 experts, top-2, one layer; capacity
    factor 4 so capacity never binds)."""
    jcfg, tcfg = _cfgs(n_layers=1, n_experts=8, moe_capacity_factor=4.0)
    jp = init_transformer(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, ttr.params_from_jax(
        jax.tree.map(np.asarray, jp), device="cpu")


def _engine(model, clock=None, **kw):
    _, _, tcfg, tp = model
    opts = dict(max_batch=4, block_size=8, max_prompt=16, max_new_tokens=8)
    opts.update(kw)
    return serve.ServeEngine(tcfg, tp, serve.ServeConfig(**opts),
                             clock=clock or FakeClock(), device="cpu")


def _jax_engine(model, **kw):
    jcfg, jp, _, _ = model
    return JaxServeEngine(jcfg, jp, JaxServeConfig(**kw),
                          clock=FakeClock())


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ---------------------------------------------------------------------------
# Rope, hashes, allocator
# ---------------------------------------------------------------------------

def test_rope_at_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 4, 16).astype(np.float32)
    pos = rng.randint(0, 4000, size=(3, 5)).astype(np.int32)
    want = np.asarray(jax_decode._rope_at(jnp.asarray(x), jnp.asarray(pos),
                                          500_000.0))
    got = tdecode._rope_at(torch.from_numpy(x), torch.from_numpy(pos),
                           500_000.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_block_hash_and_chain_match_jax():
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, 128256, size=37).tolist()
    assert tkv.block_hash(b"", prompt[:8]) == jax_kv.block_hash(
        b"", prompt[:8])
    assert tkv.block_hash(b"\x01" * 16, [2**40, -3]) == jax_kv.block_hash(
        b"\x01" * 16, [2**40, -3])
    for bs in (1, 4, 16):
        assert tkv.hash_chain(prompt, bs) == jax_kv.hash_chain(prompt, bs)
    assert tkv.hash_chain(prompt[:3], 4) == []


def _alloc_state(a):
    return (sorted(a._refs.items()), list(a._lru.items()), list(a._free),
            a.n_free, a.n_used, a.n_cached, a.high_water, a.prefix_hits,
            a.prefix_misses, a.evictions)


def test_allocator_replay_matches_jax():
    """One randomized op sequence (seeded) through both allocators: the
    blocks handed out, refcounts, LRU order, free list and counters
    agree after every op, as do the errors raised."""
    rng = np.random.RandomState(1234)
    a, b = tkv.BlockAllocator(17, 4), jax_kv.BlockAllocator(17, 4)
    hashes = [tkv.block_hash(b"", [i]) for i in range(12)]
    for _ in range(1500):
        op = rng.randint(5)
        if op == 0:
            n = int(rng.randint(1, 6))
            if b.can_alloc(n):
                assert a.alloc(n) == b.alloc(n)
            else:
                with pytest.raises(tkv.OutOfBlocks):
                    a.alloc(n)
                with pytest.raises(jax_kv.OutOfBlocks):
                    b.alloc(n)
        elif op == 1 and b._refs:
            blk = int(rng.choice(sorted(b._refs)))
            h = hashes[rng.randint(len(hashes))]
            try:
                want = b.register(blk, h)
            except ValueError:
                with pytest.raises(ValueError):
                    a.register(blk, h)
            else:
                assert a.register(blk, h) == want
        elif op == 2:
            h = hashes[rng.randint(len(hashes))]
            assert a.peek(h) == b.peek(h)
            assert a.acquire_cached(h) == b.acquire_cached(h)
        elif op in (3, 4) and b._refs:
            blk = int(rng.choice(sorted(b._refs)))
            a.free([blk])
            b.free([blk])
        assert _alloc_state(a) == _alloc_state(b)
        a.verify_integrity()
    assert a.evictions > 0 and a.prefix_hits > 0 and a.prefix_misses > 0
    with pytest.raises(ValueError, match="invalid block"):
        a.free([0])


def test_pick_bucket_and_page_chunks():
    assert serve.pick_bucket(4, (4, 8, 16)) == 4
    assert serve.pick_bucket(9, (4, 8, 16)) == 16
    with pytest.raises(ValueError):
        serve.pick_bucket(17, (4, 8, 16))
    for n, c in ((0, 3), (7, 3), (9, 3), (5, 8)):
        assert tkv.page_chunks(n, c) == jax_kv.page_chunks(n, c)
    with pytest.raises(ValueError):
        tkv.page_chunks(3, 0)


# ---------------------------------------------------------------------------
# The five programs
# ---------------------------------------------------------------------------

BS, W, NB = 4, 5, 16      # block size, table width, pool blocks


def _pools(cfg, seed):
    rng = np.random.RandomState(seed)
    shape = (cfg.n_layers, NB, BS, cfg.n_kv_heads, cfg.head_dim)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _both(model, name, args, seed=3):
    """Run program ``name`` on JAX and on the port from the same pools;
    returns ((jax k, v, out), (port k, v, out)) as numpy."""
    jcfg, jp, tcfg, tp = model
    k0, v0 = _pools(tcfg, seed)
    jfns = dict(zip(("prefill", "prefill_resume", "decode", "inject",
                     "verify"), jax_decode.make_serve_fns(
                         jcfg, None, block_size=BS, table_width=W)))
    tfns = tdecode.make_serve_fns(tcfg, block_size=BS, table_width=W,
                                  device="cpu")._asdict()
    kt, vt = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    if name == "inject":
        jk, jv = jfns[name](jnp.asarray(k0), jnp.asarray(v0), *args)
        tk, tv = tfns[name](kt, vt, *[torch.as_tensor(a) for a in args])
        assert tk is kt and tv is vt              # written in place
        return (np.asarray(jk), np.asarray(jv), None), (
            tk.numpy(), tv.numpy(), None)
    jk, jv, jo = jfns[name](jp, jnp.asarray(k0), jnp.asarray(v0), *args)
    tk, tv, to = tfns[name](tp, kt, vt, *args)
    assert tk is kt and tv is vt                  # written in place
    return (np.asarray(jk), np.asarray(jv), np.asarray(jo)), (
        tk.numpy(), tv.numpy(), to.numpy())


def _check(j, t, k0_changed=True):
    np.testing.assert_allclose(t[0], j[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t[1], j[1], rtol=1e-5, atol=1e-5)
    if j[2] is not None:
        np.testing.assert_array_equal(t[2], j[2])


def test_prefill_matches_jax_with_a_bucket_block_past_the_allocation(model):
    """A 7-token prompt in the 8 bucket with one allocated block: the
    bucket's second block is the table's null entry."""
    toks = np.zeros(8, np.int32)
    toks[:7] = [5, 17, 200, 3, 9, 77, 1]
    table = np.array([6, 0, 0, 0, 0], np.int32)
    j, t = _both(model, "prefill", (toks, np.int32(7), table))
    _check(j, t)


def test_prefill_matches_jax_on_a_full_table(model):
    toks = np.arange(1, 21, dtype=np.int32) * 11
    table = np.array([3, 9, 1, 14, 7], np.int32)
    j, t = _both(model, "prefill", (toks, np.int32(20), table))
    _check(j, t)


@pytest.mark.parametrize("offset,length,bucket", [
    (4, 7, 8),      # after one prefix block; pads within the table
    (8, 3, 16),     # a chunk whose bucket runs one block past the table
    (0, 5, 8),      # a cold first chunk
])
def test_prefill_resume_matches_jax(model, offset, length, bucket):
    toks = np.zeros(bucket, np.int32)
    toks[:length] = np.arange(length) * 7 + 2
    table = np.array([2, 11, 5, 8, 13], np.int32)
    j, t = _both(model, "prefill_resume",
                 (toks, np.int32(offset), np.int32(length), table))
    _check(j, t)


def test_decode_matches_jax_at_every_guard(model):
    """Four rows: mid-table, a slot past the table (position 21 of a
    20-token table: its write goes to the null block's row 1), a
    sequence at its last slot, and an all-null padded row (token 0,
    position 0)."""
    tokens = np.array([9, 4, 250, 0], np.int32)
    positions = np.array([6, 21, 19, 0], np.int32)
    tables = np.array([[1, 2, 0, 0, 0],
                       [3, 4, 5, 6, 7],
                       [8, 9, 10, 11, 12],
                       [0, 0, 0, 0, 0]], np.int32)
    j, t = _both(model, "decode", (tokens, positions, tables))
    _check(j, t)


def test_verify_matches_jax_mid_block_and_past_the_table(model):
    """Chunks of 3: one starting mid-block, one starting at 18 of a
    20-token table (its third token goes to the null block), and an
    all-null padded row."""
    tokens = np.array([[5, 6, 7], [100, 101, 102], [0, 0, 0]], np.int32)
    positions = np.array([5, 18, 0], np.int32)
    tables = np.array([[1, 2, 3, 0, 0],
                       [4, 5, 6, 7, 8],
                       [0, 0, 0, 0, 0]], np.int32)
    j, t = _both(model, "verify", (tokens, positions, tables))
    _check(j, t)


def test_inject_matches_jax_with_null_padding(model):
    _, _, tcfg, _ = model
    rng = np.random.RandomState(5)
    pages = (tcfg.n_layers, 4, BS, tcfg.n_kv_heads, tcfg.head_dim)
    kp, vp = (rng.randn(*pages).astype(np.float32) for _ in range(2))
    kp[:, 3] = vp[:, 3] = 0          # the padding page
    blocks = np.array([12, 3, 7, 0], np.int32)
    j, t = _both(model, "inject", (blocks, kp, vp))
    _check(j, t)


def test_programs_are_memoized(model):
    _, _, tcfg, _ = model
    a = tdecode.make_serve_fns(tcfg, block_size=BS, table_width=W,
                               device="cpu")
    assert tdecode.make_serve_fns(tcfg, block_size=BS, table_width=W,
                                  device="cpu") is a
    assert tdecode.make_serve_fns(tcfg, block_size=BS, table_width=W + 1,
                                  device="cpu") is not a


# ---------------------------------------------------------------------------
# Whole-engine streams against the JAX engine
# ---------------------------------------------------------------------------

MIX = jax_bench.make_trace(10, seed=0, min_prompt=2, max_prompt=24,
                           min_new=1, max_new=6)
PREFIX = jax_bench.make_shared_prefix_trace(8, seed=0, prefix_len=12,
                                            min_suffix=2, max_suffix=8,
                                            min_new=2, max_new=6)


def _serve(engine, trace):
    rids = [engine.submit(p, n) for p, n in trace]
    engine.run_until_idle()
    return [list(engine.result(r).tokens) for r in rids]


def test_traces_are_the_reference_traces():
    assert tbench.make_trace(10, seed=0, min_prompt=2, max_prompt=24,
                             min_new=1, max_new=6) == MIX
    assert tbench.make_shared_prefix_trace(
        8, seed=0, prefix_len=12, min_suffix=2, max_suffix=8, min_new=2,
        max_new=6) == PREFIX
    assert tbench.make_multi_tenant_trace(9, seed=3) == \
        jax_bench.make_multi_tenant_trace(9, seed=3)


@pytest.fixture(scope="module")
def jax_streams(model):
    """The JAX engine's streams on MIX (three schedulers) and PREFIX
    (cache on and off), with the cache-on run's hit counters."""
    out = {}
    for label, kw in (("continuous", {}), ("static",
                                            {"scheduling": "static"}),
                      ("chunked", {"prefill_chunk": 16})):
        out[label] = _serve(_jax_engine(model, **KW, prefix_caching=False,
                                        **kw), MIX)
    for label, caching in (("cache", True), ("nocache", False)):
        eng = _jax_engine(model, **KW, prefix_caching=caching)
        out[label] = _serve(eng, PREFIX)
        out[label + "_hits"] = (eng.allocator.prefix_hits,
                                eng.metrics.prefix_hit_tokens)
    return out


@pytest.mark.parametrize("label,kw", [
    ("continuous", {}),
    ("static", {"scheduling": "static"}),
    ("chunked", {"prefill_chunk": 16}),
])
def test_scheduler_streams_equal_jax(model, jax_streams, label, kw):
    eng = _engine(model, **KW, prefix_caching=False, **kw)
    assert _serve(eng, MIX) == jax_streams[label]
    assert eng.allocator.n_used == 0


@pytest.mark.parametrize("caching", [True, False])
def test_prefix_trace_streams_equal_jax(model, jax_streams, caching):
    label = "cache" if caching else "nocache"
    eng = _engine(model, **KW, prefix_caching=caching)
    assert _serve(eng, PREFIX) == jax_streams[label]
    assert (eng.allocator.prefix_hits,
            eng.metrics.prefix_hit_tokens) == jax_streams[label + "_hits"]
    if caching:
        assert eng.allocator.prefix_hits > 0


def test_moe_streams_equal_jax(moe_model):
    trace = MIX[:6]
    want = _serve(_jax_engine(moe_model, **KW), trace)
    assert _serve(_engine(moe_model, **KW), trace) == want


# ---------------------------------------------------------------------------
# The reference's identities, on the port
# ---------------------------------------------------------------------------

def _prompts(n, rng_seed=0, lo=3, hi=14):
    rng = np.random.RandomState(rng_seed)
    return [rng.randint(1, 256, size=int(rng.randint(lo, hi))).tolist()
            for _ in range(n)]


def _shared_prefix_prompts(n=5, prefix_len=12, rng_seed=21):
    rng = np.random.RandomState(rng_seed)
    prefix = rng.randint(1, 256, size=prefix_len).tolist()
    return [prefix + rng.randint(1, 256,
                                 size=int(rng.randint(2, 6))).tolist()
            for _ in range(n)]


def test_served_decode_equals_single_request_decode(model):
    prompts = _prompts(6, rng_seed=3)
    served = _engine(model, batch_buckets=(4,)).generate(prompts, 5)
    solo_engine = _engine(model, batch_buckets=(4,))
    assert served == [solo_engine.generate([p], 5)[0] for p in prompts]


@pytest.mark.parametrize("moe", [False, True])
def test_served_decode_matches_full_forward(model, moe_model, moe):
    """The paged incremental decode emits the full-context ``forward``'s
    greedy argmax at every step (the port's own forward; one forward a
    prompt reads every generated position, teacher-forced)."""
    m = moe_model if moe else model
    _, _, tcfg, tp = m
    prompts = _prompts(3, rng_seed=7)
    outs = _engine(m).generate(prompts, 4)
    for p, got in zip(prompts, outs):
        toks = torch.tensor([p + got[:-1]])
        logits = ttr.forward(tp, toks, dataclasses.replace(
            tcfg, sp_attention="local"))[0]
        want = logits[len(p) - 1:].float().argmax(-1).tolist()
        assert got == want


def test_prefix_cache_and_chunked_parity(model):
    prompts = _shared_prefix_prompts(6)
    ref = _engine(model, **KW, prefix_caching=False).generate(prompts, 5)
    assert _engine(model, **KW).generate(prompts, 5) == ref
    assert _engine(model, **KW, prefill_chunk=4).generate(prompts, 5) == ref
    assert _engine(model, **KW, prefix_caching=False,
                   prefill_chunk=4).generate(prompts, 5) == ref


def test_prefix_cache_maps_shared_blocks(model):
    prompts = _shared_prefix_prompts()
    eng = _engine(model, **KW)
    eng.generate(prompts, 4)
    a = eng.allocator
    assert a.prefix_hits >= 3 * (len(prompts) - 1)
    assert eng.metrics.snapshot()["prefix_cache_hit_rate"] > 0.5
    assert a.n_used == 0 and a.n_cached > 0
    before = a.prefix_hits
    eng.generate([prompts[0]], 4)
    assert a.prefix_hits >= before + 3


def test_prefill_handoff_round_trip(model):
    prompts = _shared_prefix_prompts(3)
    ref = _engine(model, **KW).generate(prompts, 5)
    pre, dec = _engine(model, **KW), _engine(model, **KW)
    rids = [pre.submit(p, 5, prefill_only=True) for p in prompts]
    while len(pre.handoff_ready()) < len(prompts):
        pre.step()
    bft = pre.allocator.blocks_for_tokens
    assert pre.allocator.n_used == 3 + sum(bft(len(p)) - 3 for p in prompts)
    moved = {}
    for rid in rids:
        h = pre.export_prefilled(rid)
        assert len(h.generated) == 1 and h.k_pages.device.type == "cpu"
        moved[rid] = dec.inject_prefilled(h)
    assert pre.allocator.n_used == 0
    assert (pre.metrics.handoffs_out, dec.metrics.handoffs_in) == (3, 3)
    dec.run_until_idle()
    assert [dec.result(moved[r]).tokens for r in rids] == ref
    assert dec.allocator.n_used == 0
    before = dec.allocator.prefix_hits
    dec.generate([prompts[0]], 5)
    assert dec.allocator.prefix_hits > before


def test_export_running_mid_decode(model):
    prompts = _shared_prefix_prompts(3)
    ref = _engine(model, **KW).generate(prompts, 5)
    a, b = _engine(model, **KW), _engine(model, **KW)
    rids = [a.submit(p, 5) for p in prompts]
    a.step()
    a.step()
    assert set(a.running_exportable()) == set(rids)
    moved = {}
    for rid in rids:
        h = a.export_running(rid)
        assert h.n_cached == len(h.prompt) + len(h.generated) - 1
        moved[rid] = b.inject_prefilled(h)
    assert a.allocator.n_used == 0 and not a.pending
    b.run_until_idle()
    assert [b.result(moved[r]).tokens for r in rids] == ref
    with pytest.raises(KeyError):
        a.export_running(99999)


def test_chunked_inject_equals_one_shot(model):
    """A handoff streamed in page chunks (``page_chunks``) leaves the
    pool as the one-shot inject does, and an aborted stage returns its
    reservation."""
    prompts = _shared_prefix_prompts(1, prefix_len=16)
    pre = _engine(model, **KW)
    rid = pre.submit(prompts[0], 5, prefill_only=True)
    while not pre.handoff_ready():
        pre.step()
    h = pre.export_prefilled(rid)
    one, many = _engine(model, **KW), _engine(model, **KW)
    one.inject_prefilled(h)
    meta = {"prompt": h.prompt, "max_new": h.max_new,
            "generated": h.generated, "submitted_at": h.submitted_at,
            "first_token_at": h.first_token_at,
            "deadline_class": h.deadline_class, "chain": h.chain,
            "block_size": h.block_size, "n_cached": h.n_cached,
            "n_pages": h.n_pages}
    token = many.inject_begin(meta)
    for lo, hi in tkv.page_chunks(h.n_pages, 2):
        many.inject_chunk(token, h.k_pages[:, lo:hi], h.v_pages[:, lo:hi])
    many.inject_commit(token)
    assert torch.equal(one.cache.k, many.cache.k)
    assert torch.equal(one.cache.v, many.cache.v)
    one.run_until_idle()
    many.run_until_idle()
    assert one.results[0].tokens == many.results[0].tokens
    abort = many.inject_begin(meta)
    assert many.allocator.n_used > 0
    many.inject_abort(abort)
    many.inject_abort(abort)
    assert many.allocator.n_used == 0


def test_submit_validation_and_bucket_menus(model):
    eng = _engine(model)
    for call in (lambda: eng.submit([]),
                 lambda: eng.submit([1] * 17),
                 lambda: eng.submit([1, 2], max_new_tokens=9),
                 lambda: eng.submit([1, 2], max_new_tokens=0)):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(ValueError, match="KV blocks"):
        _engine(model, n_blocks=2, max_prompt=8).submit([1] * 8, 8)
    for kw in ({"prefill_buckets": (8,)}, {"batch_buckets": (2,)},
               {"prefill_buckets": (12, 16)}):
        with pytest.raises(ValueError):
            _engine(model, **kw)
    with pytest.raises(ValueError, match="block table"):
        _engine(model, prefill_buckets=(64,))
    with pytest.raises(ValueError, match="prefill_chunk"):
        _engine(model, prefill_chunk=6)


def test_queue_full_is_a_structured_503(model):
    eng = _engine(model, max_queue=2)
    eng.submit([1, 2, 3])
    eng.submit([4, 5])
    with pytest.raises(serve.QueueFull) as ei:
        eng.submit([6])
    assert ei.value.http_status == 503 and ei.value.reason == "queue_full"
    assert ei.value.queue_depth == 2 and ei.value.retry_after_s is not None
    assert eng.metrics.requests_rejected == 1


def test_deadline_expiry(model):
    clock = FakeClock()
    eng = _engine(model, clock=clock)
    stale = eng.submit([1, 2, 3], 2, deadline=clock() + 1.0,
                       deadline_class=2)
    fresh = eng.submit([4, 5, 6], 2, deadline=clock() + 60.0)
    clock.advance(5.0)
    eng.run_until_idle()
    r = eng.result(stale)
    assert (r.status, r.http_status, r.tokens, r.reason,
            r.deadline_class) == ("expired", 503, [], "deadline_expired", 2)
    assert eng.result(fresh).status == "ok"
    assert eng.metrics.requests_expired == 1 and eng.allocator.n_used == 0


def test_withdraw_and_admission_snapshot(model):
    eng = _engine(model, max_batch=1, n_blocks=16)
    s0 = eng.admission_snapshot()
    assert (s0["queue_depth"], s0["running"], s0["kv_blocks_free"]) == (
        0, 0, 15)
    a = eng.submit([1, 2, 3], 2)
    b = eng.submit([4, 5, 6], 2)
    eng.step()
    assert eng.admission_snapshot()["running"] == 1
    assert not eng.withdraw(a) and eng.withdraw(b) and not eng.withdraw(b)
    eng.run_until_idle()
    assert eng.result(a).status == "ok" and eng.result(b) is None
    assert eng.metrics.requests_submitted == 1
    assert eng.cached_chain_len(serve.hash_chain([1, 2, 3] * 4, 8)) == 0


def test_kv_backpressure_and_mid_batch_retirement(model):
    eng = _engine(model, n_blocks=4, max_prompt=8)
    a = eng.submit([1, 2, 3, 4, 5], 8)
    b = eng.submit([6, 7, 8, 9, 10], 8)
    eng.step()
    assert eng.metrics.queue_depth == 1
    eng.run_until_idle()
    assert len(eng.result(a).tokens) == len(eng.result(b).tokens) == 8
    eng = _engine(model)
    short = eng.submit([1, 2, 3], 2)
    long = eng.submit([4, 5, 6], 8)
    used = []
    while eng.pending:
        eng.step()
        used.append(eng.allocator.n_used)
    assert len(eng.result(short).tokens) == 2
    assert len(eng.result(long).tokens) == 8
    assert used[-1] == 0 and 0 < min(u for u in used if u) < max(used)


def test_eos_stops_at_the_first_eos(model):
    probe = _engine(model).generate([[1, 2, 3]], 8)[0]
    eos = probe[2]
    out = _engine(model, eos_id=eos).generate([[1, 2, 3]], 8)[0]
    assert out == probe[:probe.index(eos) + 1] and len(out) < len(probe)


def test_chunked_prefill_interleaves_with_decode(model):
    eng = _engine(model, **KW, prefill_chunk=4, prefix_caching=False)
    short = eng.submit([1, 2, 3], 6)
    eng.step()
    long_rid = eng.submit(list(range(1, 21)), 2)
    eng.step()
    before = eng.metrics.decode_steps
    steps = 0
    while eng._prefilling:
        assert all(s.rid != long_rid for s in eng._active)
        eng.step()
        steps += 1
    assert steps >= 4 and eng.metrics.decode_steps - before >= 3
    eng.run_until_idle()
    assert len(eng.result(long_rid).tokens) == 2
    assert len(eng.result(short).tokens) == 6


def test_metrics_snapshot_trace_and_exposition(model, tmp_path):
    from horovod_tpu_torch.metrics import metrics_prometheus

    eng = _engine(model)
    eng.generate(_prompts(3, rng_seed=5), 3)
    snap = eng.metrics.snapshot()
    assert snap["requests_finished"] == 3 and snap["tokens_generated"] == 9
    assert snap["prefill_steps"] == 3 and snap["decode_steps"] > 0
    assert snap["kv_blocks_high_water"] == eng.allocator.high_water > 0
    path = tmp_path / "serve_trace.json"
    eng.metrics.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    assert {"serve:prefill", "serve:decode"} <= {
        e["name"] for e in data["traceEvents"]}
    assert data["metadata"]["kind"] == "engine"
    inst = re.escape(eng.metrics.instance)
    assert re.search(r'^serve_tokens_generated\{instance="%s"\} 9$' % inst,
                     metrics_prometheus(), re.M)


def test_trace_ids_match_jax():
    from horovod_tpu.serve import trace as jax_trace
    from horovod_tpu_torch.serve import trace as ttrace

    for rid, salt in ((0, 0), (7, 3), (2**40, 2**63 + 5)):
        assert ttrace.mint_trace_id(rid, salt, sample=1.0) == \
            jax_trace.mint_trace_id(rid, salt, sample=1.0)
        assert ttrace.mint_trace_id(rid, salt, sample=0.5) == \
            jax_trace.mint_trace_id(rid, salt, sample=0.5)
    assert ttrace.mint_trace_id(3, sample=0.0) == 0


def test_engine_tags_spans_with_trace_ids(model):
    from horovod_tpu_torch.serve.trace import mint_trace_id

    eng = _engine(model)
    tid = mint_trace_id(1, sample=1.0)
    eng.submit([1, 2, 3], 2, trace_id=tid)
    eng.run_until_idle()
    ev = [e for e in eng.metrics._events if e["ph"] == "X"]
    assert ev[0]["args"]["trace"] == tid
    assert ev[1]["args"]["traces"] == [tid]


# ---------------------------------------------------------------------------
# The serve bench
# ---------------------------------------------------------------------------

SERVE_KEYS = {
    "serve_tokens_per_sec_per_chip", "serve_static_tokens_per_sec_per_chip",
    "serve_continuous_over_static", "serve_p50_first_token_ms",
    "serve_p99_first_token_ms", "serve_p50_per_token_ms",
    "serve_p99_per_token_ms", "serve_batch_occupancy",
    "serve_static_batch_occupancy", "serve_decode_steps",
    "serve_static_decode_steps", "serve_chunked_tokens_per_sec_per_chip",
    "serve_chunked_p50_per_token_ms", "serve_chunked_p99_per_token_ms",
    "serve_chunked_p99_first_token_ms", "serve_chunked_tokens_identical"}
PREFIX_KEYS = {
    "serve_prefix_tokens_per_sec_per_chip",
    "serve_prefix_nocache_tokens_per_sec_per_chip",
    "serve_prefix_cache_speedup", "serve_prefix_cache_hit_rate",
    "serve_prefix_p99_first_token_ms",
    "serve_prefix_nocache_p99_first_token_ms",
    "serve_prefix_block_evictions", "serve_prefix_kv_high_water",
    "serve_prefix_tokens_identical"}
SPEC_KEYS = {
    "serve_spec_tokens_per_sec", "serve_spec_plain_tokens_per_sec",
    "serve_spec_over_plain", "serve_spec_accept_rate",
    "serve_spec_p99_first_token_ms", "serve_spec_plain_p99_first_token_ms",
    "serve_spec_verify_rounds_count", "serve_spec_tokens_identical"}


def test_serve_bench_functions_give_the_reference_keys():
    small = ttr.TransformerConfig.tiny(dtype=torch.float32, remat=False,
                                       n_layers=1)
    kw = dict(warmup=False, repeats=1, device="cpu")
    out = tbench.run_serving_benchmark(6, model_cfg=small, **kw)
    assert set(out) == SERVE_KEYS
    assert out["serve_chunked_tokens_identical"] is True
    assert out["serve_decode_steps"] <= out["serve_static_decode_steps"]
    out = tbench.run_prefix_benchmark(6, model_cfg=small, prefix_len=16,
                                      **kw)
    assert set(out) == PREFIX_KEYS
    assert out["serve_prefix_tokens_identical"] is True
    assert out["serve_prefix_cache_hit_rate"] > 0.5
    out = tbench.run_spec_benchmark(
        4, draft_cfg=small, target_layers=2, spec_k=3, **kw)
    assert set(out) == SPEC_KEYS
    assert out["serve_spec_accept_rate"] == 1.0
    assert out["serve_spec_tokens_identical"] is True


def test_bench_run_serve_folds_every_tier():
    from horovod_tpu_torch import bench

    small = ttr.TransformerConfig.tiny(dtype=torch.float32, remat=False,
                                       n_layers=2)
    seen = []
    out = bench.run_serve("cpu", small, n_requests=4, spec_requests=3,
                          trace_requests=3, repeats=1, draft_layers=1,
                          target_layers=2, emit=seen.append)
    assert set(out) == (SERVE_KEYS | PREFIX_KEYS | SPEC_KEYS
                        | {"serve_trace_overhead_pct", "flight_dump_ms"})
    assert len(seen) == 4 and out["flight_dump_ms"] > 0
    assert not any(k.startswith(("serve_router_", "serve_migration_"))
                   for k in out)
    assert bench.CFG_SERVE == ttr.TransformerConfig.llama3_8b(
        sp_attention="flash", remat=False)
