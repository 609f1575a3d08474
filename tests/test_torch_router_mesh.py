"""The port's fleet router on a mesh (``ServeRouter(mesh=...)``: every
rank of the mesh runs the same router over its shards, submits the same
requests and steps in lockstep on mesh rank 0's clock) against the JAX
package's ``ServeRouter(mesh=build_mesh(dp=-1, ...))`` on the 8 CPU
devices of ``tests/conftest.py``, on gloo worlds of 2 and 4 CPU
processes, f32, ``TransformerConfig.tiny`` with JAX's parameters from
``PRNGKey(0)`` through ``params_from_jax`` and ``shard_params(serving=
True)``, the geometry of ``tests/test_router.py``. Every case holds the
tokens and the placement log equal on every rank and equal to JAX's:

- (a) tp=2, unified, affinity and round-robin placement;
- (b) dp=2 x tp=2, a split fleet (``n_prefill=1``) with chunked prefill:
  every request handed off as the rank's KV heads;
- (c) the tiny MoE on ep=4;
- (d) a speculative fleet on tp=2, the draft JAX's seed 1;
- (e) the port of ``tests/test_router.py::_drive_property_run`` (seed 7)
  on tp=2: joins, drains, ``remove_replica`` and shedding, every request
  resolved exactly once;
- (f) clocks skewed by 50 s per rank, with deadlines, shedding and a
  one-token request: the same requests expire and are shed on every rank
  (rank 0's clock), every ``RequestResult`` field is equal on every rank,
  and the world does not hang;
- (g) ``fleet_topology`` a different model on each rank: page moves go
  where rank 0's model sends them;
- (h) ``export_fleet_trace`` on tp=2: rank 0 writes ``router.json``,
  each rank its replicas' files under its rank, no file twice, and
  ``trace_merge merge`` reads the directory onto one timebase.

Worker replicas beside a mesh fleet are held in
``tests/test_torch_router_mesh_workers.py``.

Workers run this file as a script (``--worker``) and load torch, numpy
and the port only.
"""

import concurrent.futures
import dataclasses
import os
import pickle
import sys
import types

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))

from test_torch_collectives import run_world  # noqa: E402

#: The reference's router geometry (``tests/test_router.py::_KW``).
KW = dict(max_batch=4, block_size=4, max_prompt=24, max_new_tokens=6,
          batch_buckets=(4,), prefill_buckets=(4, 8, 16, 24))
SPEC_K = 3
#: The models: TransformerConfig.tiny overrides and JAX's seed.
MODELS = {"dense": ({}, 0), "draft": ({}, 1),
          "moe": (dict(n_layers=1, n_experts=8, moe_capacity_factor=4.0), 0)}
#: Clocks of the skew case: rank r reads 100 + SKEW * r.
SKEW = 50.0
#: The cases each world runs, with the mesh axes of the port's world and
#: of JAX's mesh over the 8 CPU devices (dp=-1 takes the rest).
CASES = {
    "a_affinity": (2, {"tp": 2}, {"tp": 2}),
    "a_round_robin": (2, {"tp": 2}, {"tp": 2}),
    "b_split_chunked": (4, {"dp": 2, "tp": 2}, {"tp": 2}),
    "c_moe": (4, {"ep": 4}, {"ep": 4}),
    "d_spec": (2, {"tp": 2}, {"tp": 2}),
    "e_property": (2, {"tp": 2}, {"tp": 2}),
    "f_skew": (2, {"tp": 2}, {"tp": 2}),
    "g_topology": (2, {"tp": 2}, {"tp": 2}),
}


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _tenant_prompts(n_per_tenant=3, n_tenants=2, prefix_len=12,
                    rng_seed=21):
    rng = np.random.RandomState(rng_seed)
    prefixes = [rng.randint(1, 256, size=prefix_len).tolist()
                for _ in range(n_tenants)]
    out = []
    for _ in range(n_per_tenant):
        for p in prefixes:
            out.append(p + rng.randint(
                1, 256, size=int(rng.randint(2, 6))).tolist())
    return out


def _res(r):
    """The comparable part of a result (times are each clock's own)."""
    return None if r is None else (r.status, r.http_status, r.reason,
                                   r.deadline_class, tuple(r.tokens),
                                   r.retry_after_s is not None)


_SNAP = ("replicas", "queue_depth", "placed_affinity", "placed_fallback",
         "shed_total", "expired_total", "handoffs", "migrations",
         "tokens_generated", "requests_submitted", "requests_finished",
         "requests_expired", "requests_rejected", "prefix_hit_tokens",
         "prefix_prefill_tokens", "prefix_cache_hit_rate",
         "kv_blocks_in_use", "kv_blocks_cached")


def _snap(router):
    s = router.metrics.snapshot()
    return {k: s.get(k) for k in _SNAP} | {
        k: v for k, v in s.items() if k.startswith("shed_class_")}


def _toy_model(np_, cheap, expensive, src=0):
    alpha = [[0.0] * np_ for _ in range(np_)]
    for d in range(np_):
        if d != src:
            alpha[src][d] = expensive
    alpha[src][cheap] = 1.0
    return {"np": np_, "alpha_us": alpha,
            "beta_us_per_byte": [[0.0] * np_ for _ in range(np_)]}


# ---------------------------------------------------------------------------
# The scenarios, run through both packages (``ns`` is a package's router
# pieces on its mesh)
# ---------------------------------------------------------------------------

def _trace_run(ns, placement, n_prefill=0, chunk=None):
    prompts = _tenant_prompts(n_per_tenant=4, n_tenants=3)
    router = ns.router(n_replicas=2, n_prefill=n_prefill,
                       placement=placement, seed=5,
                       serve_kw={"prefill_chunk": chunk} if chunk else None)
    streams = router.generate(prompts, 4)
    out = (streams, list(router.placement_log), _snap(router))
    if ns.port and n_prefill:
        # The bytes the handoffs moved on this rank (the port's only:
        # JAX's router moves whole pages).
        out += (router.metrics.migration_bytes_total,)
    return out


def _spec_run(ns):
    prompts = _tenant_prompts(n_per_tenant=3, n_tenants=2)
    router = ns.router(n_replicas=2, serve_kw={
        "draft": ns.DraftConfig(ns.cfg, seed=1), "spec_k": SPEC_K})
    ns.fix_draft(router)
    streams = router.generate(prompts, 4)
    rounds = sum(e.metrics.snapshot()["spec_rounds"] for e in router.engines)
    return streams, list(router.placement_log), _snap(router), rounds > 0


def _property_run(ns, seed):
    """``tests/test_router.py::_drive_property_run``: random submit /
    step / join / leave across two model groups."""
    rng = np.random.RandomState(seed)
    clock = FakeClock()
    router = ns.router(clock=clock, n_replicas=2, max_queue=6,
                       serve_kw={"max_batch": 2, "max_queue": 3})
    router.add_model("b", ns.cfg, ns.params, n_replicas=1,
                     serve_cfg=ns.ServeConfig(**{**KW, "max_batch": 2,
                                                 "max_queue": 3}))
    inst_model = {i: router._replica(i).model for i in router.replicas}
    prefixes = [rng.randint(1, 256, size=8).tolist() for _ in range(3)]
    submitted, saturated = {}, 0
    for _ in range(60):
        op = rng.randint(4)
        model = "b" if rng.randint(2) else "default"
        if op == 0:
            p = (prefixes[int(rng.randint(3))]
                 + rng.randint(1, 256, size=int(rng.randint(1, 5))).tolist())
            cls = int(rng.randint(3))
            try:
                submitted[router.submit(p, int(rng.randint(1, 4)),
                                        deadline_class=cls,
                                        model=model)] = model
            except ns.FleetSaturated:
                saturated += 1
        elif op == 1:
            clock.advance(0.01)
            router.step()
        elif op == 2 and len(router.replicas) < 5:
            inst_model[router.add_replica(model=model)] = model
        elif op == 3:
            live = [i for i in router.replicas
                    if not router._replica(i).draining]
            if len(live) > 1:
                victim = live[int(rng.randint(len(live)))]
                vm = router._replica(victim).model
                if sum(1 for i in live
                       if router._replica(i).model == vm) > 1:
                    try:
                        router.remove_replica(victim)
                    except ValueError:
                        pass
    router.run_until_idle()
    results = {rid: (m, _res(router.result(rid)))
               for rid, m in submitted.items()}
    depths = [e.metrics.max_queue_depth for e in router.engines]
    return (list(router.placement_log), results, saturated, depths,
            inst_model, _snap(router))


#: The skew case's submissions: (deadline on rank 0's clock, class).
SKEW_PLAN = ((None, 0), (103.5, 1), (None, 2), (100.5, 0), (None, 2),
             (101.5, 1), (102.5, 0), (None, 0))
#: The skew case's one-token request (its first token finishes it), by
#: its index in ``SKEW_PLAN``.
SKEW_ONE_TOKEN = 7


def _skew_run(ns, clock):
    """Eight requests at once on a router queue of 4 over two replicas of
    max batch 1: arrivals shed the newest of a worse class (one is
    refused), one deadline expires in the router's queue and one in an
    engine's; the last asks for one token. The clock advances by 1
    before each step. The port's run also returns every result's
    fields."""
    router = ns.router(clock=clock, n_replicas=2, max_queue=4,
                       serve_kw={"max_batch": 1, "max_queue": 2})
    prompts = _tenant_prompts(n_per_tenant=4, n_tenants=2)
    rids, refused = [], 0
    for i, (p, (deadline, cls)) in enumerate(zip(prompts, SKEW_PLAN)):
        try:
            rids.append(router.submit(p, 1 if i == SKEW_ONE_TOKEN else 4,
                                      deadline=deadline,
                                      deadline_class=cls))
        except ns.FleetSaturated:
            refused += 1
    steps = 0
    while router.pending and steps < 60:
        clock.advance(1.0)
        router.step()
        steps += 1
    out = ([(r, _res(router.result(r))) for r in rids], refused,
           list(router.placement_log), steps, _snap(router))
    if ns.port:
        out += ([dataclasses.astuple(router.result(r)) for r in rids],)
    return out


def _link_cost_drain(ns, model):
    """``tests/test_torch_router.py``'s drain scored by link cost, on the
    topology ``model`` this process reads."""
    saved = ns.mig.fleet_topology
    ns.mig.fleet_topology = lambda: model
    try:
        router = ns.router(n_replicas=3)
        r0 = router._replicas[0]
        need = r0.engine.allocator.blocks_for_tokens(8)
        picks = [router._pick_capacity(("unified",), need, exclude=r0,
                                       source=r0).instance]
        prompts = _tenant_prompts(n_per_tenant=2)
        rids = [router.submit(p, 4) for p in prompts]
        router.step()
        router.remove_replica(r0.instance, migrate_running=True)
        router.run_until_idle()
    finally:
        ns.mig.fleet_topology = saved
    return (picks, list(router.placement_log),
            [_res(router.result(r)) for r in rids])


def _scenario(name, ns, rank=0):
    if name in ("a_affinity", "a_round_robin"):
        return _trace_run(ns, name[2:])
    if name == "b_split_chunked":
        return _trace_run(ns, "affinity", n_prefill=1, chunk=4)
    if name == "c_moe":
        return _trace_run(ns, "affinity")
    if name == "d_spec":
        return _spec_run(ns)
    if name == "e_property":
        return _property_run(ns, 7)
    if name == "f_skew":
        return _skew_run(ns, FakeClock(100.0 + SKEW * rank))
    if name == "g_topology":
        # Rank 0's model makes replica 2 the cheap target; every other
        # rank's, replica 1.
        return _link_cost_drain(ns, _toy_model(3, cheap=2 if rank == 0
                                               else 1, expensive=5e6))
    raise KeyError(name)


# ---------------------------------------------------------------------------
# The port (worker side)
# ---------------------------------------------------------------------------

def _port_ns(d, name, axes):
    import torch

    from horovod_tpu_torch import serve
    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.parallel.mesh import build_mesh
    from horovod_tpu_torch.serve import migrate

    mesh = build_mesh(**axes)
    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32, remat=False,
                                     **MODELS[name][0])
    shards = ttr.shard_params(ttr.params_from_jax(d[name], device="cpu"),
                              cfg, mesh, serving=True)

    def router(clock=None, serve_kw=None, **rkw):
        return serve.ServeRouter(
            cfg, shards, serve.RouterConfig(**rkw),
            serve.ServeConfig(**{**KW, **(serve_kw or {})}), mesh=mesh,
            clock=clock or FakeClock(), device="cpu")

    def fix_draft(r):
        # JAX's seed-1 draft, as this rank's shards.
        draft = ttr.shard_params(ttr.params_from_jax(d["draft"],
                                                     device="cpu"),
                                 cfg, mesh, serving=True)
        for e in r.engines:
            e._spec._params = draft

    return types.SimpleNamespace(
        cfg=cfg, params=shards, mesh=mesh, mig=migrate, router=router,
        ServeConfig=serve.ServeConfig, FleetSaturated=serve.FleetSaturated,
        DraftConfig=serve.DraftConfig, fix_draft=fix_draft, port=True)


def _trace_export(d, tmp):
    """(h): an affinity trace on tp=2 with real clocks, exported into
    ``tmp/fleet_trace``; returns this rank's paths."""
    import time

    ns = _port_ns(d, "dense", {"tp": 2})
    router = ns.router(clock=time.perf_counter, n_replicas=2)
    router.generate(_tenant_prompts(n_per_tenant=3, n_tenants=2), 4)
    return [os.path.relpath(p, tmp) for p in
            router.export_fleet_trace(os.path.join(tmp, "fleet_trace"))]


def _worker(store, out, data):
    import torch.distributed as dist

    from horovod_tpu_torch.parallel.mesh import init_process_group

    with open(data, "rb") as f:
        d = pickle.load(f)
    init_process_group("cpu", init_method=f"file://{store}", timeout=120)
    n, rank = dist.get_world_size(), dist.get_rank()
    res = {}
    for case, (world, axes, _) in CASES.items():
        if world != n:
            continue
        model = {"c_moe": "moe"}.get(case, "dense")
        res[case] = _scenario(case, _port_ns(d, model, axes), rank)
    if n == 2:
        res["h_trace"] = _trace_export(d, os.path.dirname(store))
    with open(out, "wb") as f:
        pickle.dump(res, f)
    # Every rank's results are written: end without the interpreter's
    # teardown, in which a gloo world's threads once aborted one rank of
    # four ("terminate called without an active exception") after its
    # peers had exited, in a loaded run of the whole suite.
    dist.barrier()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


# ---------------------------------------------------------------------------
# The JAX side
# ---------------------------------------------------------------------------

def _jax_ns(name, axes):
    import jax
    import jax.numpy as jnp

    from horovod_tpu import serve
    from horovod_tpu.models import TransformerConfig, init_transformer
    from horovod_tpu.parallel import build_mesh
    from horovod_tpu.serve import migrate
    from horovod_tpu.serve.speculative import DraftConfig

    kw, seed = MODELS[name]
    cfg = TransformerConfig.tiny(dtype=jnp.float32, remat=False, **kw)
    params = init_transformer(cfg, jax.random.PRNGKey(seed))
    mesh = build_mesh(dp=-1, **axes)

    def router(clock=None, serve_kw=None, **rkw):
        return serve.ServeRouter(
            cfg, params, serve.RouterConfig(**rkw),
            serve.ServeConfig(**{**KW, **(serve_kw or {})}), mesh=mesh,
            clock=clock or FakeClock())

    return types.SimpleNamespace(
        cfg=cfg, params=params, mig=migrate, router=router,
        ServeConfig=serve.ServeConfig, FleetSaturated=serve.FleetSaturated,
        DraftConfig=DraftConfig, fix_draft=lambda r: None, port=False)


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("router_mesh"))
    data = os.path.join(tmp, "data.pkl")
    with open(data, "wb") as f:
        pickle.dump({name: _jax_params(name) for name in MODELS}, f)
    script = os.path.abspath(__file__)
    for n in (2, 4):
        os.makedirs(os.path.join(tmp, f"w{n}"))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        worlds = {n: pool.submit(run_world, n, os.path.join(tmp, f"w{n}"),
                                 script, (data,))
                  for n in (2, 4)}
        out = {n: f.result() for n, f in worlds.items()}
    out["tmp"] = tmp
    return out


def _jax_params(name):
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import TransformerConfig, init_transformer

    kw, seed = MODELS[name]
    cfg = TransformerConfig.tiny(dtype=jnp.float32, remat=False, **kw)
    return jax.tree.map(np.asarray,
                        init_transformer(cfg, jax.random.PRNGKey(seed)))


def _same_on_every_rank(ranks, key):
    got = [r[key] for r in ranks]
    assert all(g == got[0] for g in got), (key, got)
    return got[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_fleet_matches_jax_on_every_rank(port_results, case):
    world, _, jax_axes = CASES[case]
    got = _same_on_every_rank(port_results[world], case)
    model = {"c_moe": "moe"}.get(case, "dense")
    want = _scenario(case, _jax_ns(model, jax_axes), 0)
    assert got[:len(want)] == want


def test_split_fleet_hands_off_every_request(port_results):
    import torch

    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.serve import migrate

    streams, log, snap, nbytes = _same_on_every_rank(port_results[4],
                                                     "b_split_chunked")
    assert len(streams) == 12 and all(streams)
    assert snap["handoffs"] == 12
    assert [m for _, _, m, _ in log].count(-1) == 12
    # Each rank moved its KV heads: half of every page at tp=2.
    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32, remat=False)
    bs = KW["block_size"]
    pages = sum(-(-len(p) // bs) for p in _tenant_prompts(4, 3))
    assert nbytes == pages * migrate.page_nbytes(cfg, bs) // 2


def test_spec_fleet_runs_rounds(port_results):
    *_, ran = _same_on_every_rank(port_results[2], "d_spec")
    assert ran


def test_property_run_resolves_each_request_once(port_results):
    log, results, _, depths, inst_model, snap = _same_on_every_rank(
        port_results[2], "e_property")
    assert results and {m for m, _ in results.values()} == {"default", "b"}
    for m, r in results.values():
        assert r[0] in ("ok", "shed")
        assert (len(r[4]) >= 1) == (r[0] == "ok")
    for rid, inst, _m, _c in log:
        assert inst_model[inst] == results[rid][0]
    assert all(dq <= 3 for dq in depths)
    assert snap["requests_finished"] == sum(
        1 for _, r in results.values() if r[0] == "ok")


def test_skewed_clocks_expire_and_shed_alike(port_results):
    # Every field of every result, times included, is equal on every
    # rank: the engines stamp on rank 0's clock, as the router does.
    results, refused, _, steps, snap, fields = _same_on_every_rank(
        port_results[2], "f_skew")
    statuses = [r[0] for _, r in results]
    assert "expired" in statuses and "shed" in statuses and "ok" in statuses
    assert steps < 60
    # Each submitted request resolves exactly once.
    assert len({rid for rid, _ in results}) == len(results)
    assert all(r is not None for _, r in results)
    assert refused + len(results) == len(SKEW_PLAN)
    # One expiry in the router's queue, one in an engine's (on the step
    # reading the router hands it).
    assert snap["expired_total"] >= 1 and snap["requests_expired"] >= 1
    # The one-token request finished at its first token, on rank 0's
    # clock (100 + whole steps), not a rank's own (skewed by 50 s).
    one, = [f for f in fields if len(f[3]) == 1]
    assert one[1] == "ok"
    assert one[6] == one[7] and one[7] < 100.0 + SKEW
    assert all(f[5] < 100.0 + SKEW for f in fields)


def test_page_moves_follow_rank_zero_topology(port_results):
    picks, log, _ = _same_on_every_rank(port_results[2], "g_topology")
    assert picks == ["2"]
    moves = [e for e in log if e[2] == -1]
    assert moves and all(e[1] == "2" for e in moves)


def test_fleet_trace_written_once_and_merged(port_results):
    from horovod_tpu_torch.serve import trace_merge

    tmp = os.path.join(port_results["tmp"], "w2")
    ranks = [r["h_trace"] for r in port_results[2]]
    every = [p for paths in ranks for p in paths]
    assert len(every) == len(set(every))
    assert ranks[0][0] == os.path.join("fleet_trace", "router.json")
    assert all("router.json" not in p for p in ranks[1])
    for r, paths in enumerate(ranks):
        assert sorted(os.path.basename(p) for p in paths
                      if "replica" in p) == [
            f"replica-{i}-rank{r}.json" for i in range(2)]
    target = os.path.join(tmp, "fleet_trace")
    merged = trace_merge.merge(trace_merge.discover(target))
    assert merged["metadata"]["timebase"].startswith("router wall clock")
    assert len(merged["metadata"]["merged_from"]) == len(every)
    evs = merged["traceEvents"]
    tids = trace_merge.trace_ids(evs)
    assert len(tids) == 6
    row = trace_merge.critical_path(evs, tids[0])
    assert abs(sum(row["breakdown_us"].values()) - row["e2e_us"]) <= 1.0


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2], sys.argv[3], sys.argv[4])
