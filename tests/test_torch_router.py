"""The port's fleet router (``horovod_tpu_torch.serve.router``) against
the JAX package's, on the CPU, f32, ``TransformerConfig.tiny``: the port's
engines hold JAX's parameters from ``PRNGKey(0)`` through
``params_from_jax``, and every scenario runs through both packages on the
same trace, seed and fake clock. Held exactly:

- for each placement (affinity, least, random, round-robin) and with
  ``n_prefill`` 0 and 1: the ``placement_log`` (rid, instance, match
  length, link cost), the token streams, the fleet hit rate and the
  handoff count;
- the ports of ``tests/test_router.py``'s config and submit validation,
  shedding by deadline class, deadline expiry at the router, join and
  drain (with and without moving running sequences), the last-replica
  guard, multi-model routing and capacity isolation, the link-cost
  drain target and the randomized property run: each scenario's
  outcome (results' status, reason, class and tokens, the placement
  log, the rollup's counters, the raised errors) equal between the
  packages, and the reference's own assertions on the port's run.

``ServeRouter(mesh=...)`` refuses a mesh its engines could not serve on,
as ``check_serve_mesh`` does (the fleet on a mesh itself is
``tests/test_torch_router_mesh.py``'s).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import serve as jserve
from horovod_tpu.models import TransformerConfig as JaxConfig
from horovod_tpu.models import init_transformer
from horovod_tpu.serve import migrate as jmig
from horovod_tpu_torch import serve as tserve
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.serve import migrate as tmig

#: The reference's serve test geometry: one compiled program set.
KW = dict(max_batch=4, block_size=4, max_prompt=24, max_new_tokens=6,
          batch_buckets=(4,), prefill_buckets=(4, 8, 16, 24))


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module")
def pkgs():
    """``{"jax": ns, "port": ns}``: each package's router pieces over the
    same weights (JAX's, loaded into the port)."""
    jcfg = JaxConfig.tiny(dtype=jnp.float32, remat=False)
    jp = init_transformer(jcfg, jax.random.PRNGKey(0))
    tcfg = ttr.TransformerConfig.tiny(dtype=torch.float32, remat=False)
    tp = ttr.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    out = {}
    for name, mod, cfg, params, mig, extra in (
            ("jax", jserve, jcfg, jp, jmig, {}),
            ("port", tserve, tcfg, tp, tmig, {"device": "cpu"})):
        ns = types.SimpleNamespace(
            name=name, cfg=cfg, params=params, mig=mig,
            RouterConfig=mod.RouterConfig, ServeConfig=mod.ServeConfig,
            FleetSaturated=mod.FleetSaturated, QueueFull=mod.QueueFull)

        def router(clock=None, serve_kw=None, _mod=mod, _cfg=cfg,
                   _p=params, **rkw):
            return _mod.ServeRouter(
                _cfg, _p, _mod.RouterConfig(**rkw),
                _mod.ServeConfig(**{**KW, **(serve_kw or {})}),
                clock=clock or FakeClock())

        def engine(clock=None, _mod=mod, _cfg=cfg, _p=params, _x=extra,
                   **kw):
            return _mod.ServeEngine(_cfg, _p,
                                    _mod.ServeConfig(**{**KW, **kw}),
                                    clock=clock or FakeClock(), **_x)

        ns.router, ns.engine = router, engine
        out[name] = ns
    return out


def both(pkgs, scenario, *args, **kw):
    """Run ``scenario(ns, ...)`` through both packages; assert equal
    outcomes; return the port's."""
    want = scenario(pkgs["jax"], *args, **kw)
    got = scenario(pkgs["port"], *args, **kw)
    assert got == want
    return got


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
         "shed_total", "expired_total", "handoffs", "worker_deaths",
         "requeued_total", "migrations", "direct_migrations_total",
         "migration_bytes_total", "migration_link_cost_us",
         "tokens_generated", "requests_submitted", "requests_finished",
         "requests_expired", "requests_rejected", "prefix_hit_tokens",
         "prefix_prefill_tokens", "prefix_cache_hit_rate",
         "kv_blocks_in_use", "kv_blocks_cached")


def _snap(router):
    s = router.metrics.snapshot()
    return {k: s.get(k) for k in _SNAP} | {
        k: v for k, v in s.items() if k.startswith("shed_class_")}


# ---------------------------------------------------------------------------
# Placement, handoff, parity with one replica
# ---------------------------------------------------------------------------

def _trace_run(ns, placement, n_prefill, n_replicas, chunk):
    prompts = _tenant_prompts(n_per_tenant=4, n_tenants=3)
    router = ns.router(n_replicas=n_replicas, n_prefill=n_prefill,
                       placement=placement, seed=5,
                       serve_kw={"prefill_chunk": chunk} if chunk else None)
    streams = router.generate(prompts, 4)
    ref = ns.engine().generate(prompts, 4)
    assert streams == ref
    return streams, list(router.placement_log), _snap(router)


@pytest.mark.parametrize("n_prefill,n_replicas,chunk", [
    (0, 3, None), (1, 3, 4)])
@pytest.mark.parametrize("placement",
                         ["affinity", "least", "random", "round_robin"])
def test_placement_log_streams_and_hit_rate_equal_jax(
        pkgs, placement, n_prefill, n_replicas, chunk):
    streams, log, snap = both(pkgs, _trace_run, placement, n_prefill,
                              n_replicas, chunk)
    assert len(streams) == 12 and log
    if n_prefill:
        assert snap["handoffs"] == 12
        assert [m for _, _, m, _ in log].count(-1) == 12
    if placement == "affinity":
        assert snap["prefix_cache_hit_rate"] > 0


def _affinity_groups(ns):
    prompts = _tenant_prompts(n_per_tenant=3, n_tenants=2)
    router = ns.router(n_replicas=2)
    router.generate(prompts, 4)
    by_rid = {rid: inst for rid, inst, _, _ in router.placement_log}
    a = [by_rid[i] for i in range(0, len(prompts), 2)]
    b = [by_rid[i] for i in range(1, len(prompts), 2)]
    assert len(set(a)) == 1 and len(set(b)) == 1 and a[0] != b[0]
    assert all(m > 0 for rid, _, m, _ in router.placement_log if rid >= 2)
    snap = router.metrics.snapshot()
    assert snap["prefix_cache_hit_rate"] > 0.4
    return _snap(router)


def test_affinity_groups_same_prefix_traffic(pkgs):
    both(pkgs, _affinity_groups)


def _capacity(ns):
    prompts = _tenant_prompts(n_per_tenant=4, n_tenants=1)
    router = ns.router(n_replicas=2, serve_kw={"max_queue": 2})
    rids = [router.submit(p, 2) for p in prompts]
    router._place_queued()
    log = list(router.placement_log)
    assert len({inst for _, inst, _, _ in log}) == 2
    assert all(e.metrics.max_queue_depth <= 2 for e in router.engines)
    router.run_until_idle()
    return log, [_res(router.result(r)) for r in rids]


def test_affinity_only_routes_with_capacity(pkgs):
    both(pkgs, _capacity)


def _handoff_pools(ns):
    prompts = _tenant_prompts()
    router = ns.router(n_replicas=2, n_prefill=1)
    first = router.generate(prompts, 4)
    pre, dec = router.engines
    counts = (pre.metrics.decode_steps, pre.metrics.handoffs_out,
              dec.metrics.prefill_steps, dec.metrics.handoffs_in,
              [e.allocator.n_used for e in router.engines])
    # Warm prefixes on the decode replica: a repeat still matches.
    second = router.generate(prompts, 4)
    single = router.generate(prompts[:2], 1)
    return first, second, single, counts, _snap(router)


def test_handoff_parity_and_pool_separation(pkgs):
    first, second, _, counts, _ = both(pkgs, _handoff_pools)
    assert first == second
    assert counts == (0, 6, 0, 6, [0, 0])


# ---------------------------------------------------------------------------
# Validation, shedding, deadlines
# ---------------------------------------------------------------------------

def _errors(call):
    try:
        call()
    except Exception as e:      # noqa: BLE001 — compared by type and text
        return type(e).__name__, str(e), getattr(e, "reason", None)
    return None


def _validation(ns):
    out = [_errors(lambda kw=kw: ns.RouterConfig(**kw)) for kw in (
        dict(n_replicas=0), dict(n_replicas=2, n_prefill=2),
        dict(placement="hash"), dict(heartbeat_every=-1),
        dict(direct_migration="sideways"),
        dict(handoff_compression="int8"))]
    router = ns.router(n_replicas=1, serve_kw={
        "max_prompt": 124, "prefill_buckets": (124,)})
    for args, kw in (([[]], {}), ([[1] * 125], {}),
                     ([[1, 2]], {"max_new_tokens": 7}),
                     ([[1, 2]], {"deadline_class": -1}),
                     ([[1] * 124], {"max_new_tokens": 6}),
                     ([[1, 2]], {"model": "nope"})):
        out.append(_errors(lambda: router.submit(*args, **kw)))
    tight = ns.router(n_replicas=1, serve_kw={"n_blocks": 3})
    out.append(_errors(lambda: tight.submit([1] * 8, max_new_tokens=6)))
    out.append(tight.generate([[1, 2, 3]], 2))
    assert all(e is not None for e in out[:-1])
    return out


def test_config_and_submit_validation_equal_jax(pkgs):
    both(pkgs, _validation)


def _shedding(ns):
    router = ns.router(n_replicas=1, max_queue=2)
    prompts = _tenant_prompts(n_per_tenant=2)
    a = router.submit(prompts[0], 2, deadline_class=2)
    b = router.submit(prompts[1], 2, deadline_class=1)
    c = router.submit(prompts[2], 2, deadline_class=0)
    with pytest.raises(ns.FleetSaturated) as ei:
        router.submit(prompts[3], 2, deadline_class=1)
    err = (ei.value.reason, ei.value.deadline_class, ei.value.http_status,
           ei.value.queue_depth, ei.value.retry_after_s is not None)
    shed = _res(router.result(a))
    router.run_until_idle()
    return shed, err, [_res(router.result(r)) for r in (b, c)], _snap(router)


def test_shed_drops_lowest_class_first(pkgs):
    shed, err, rest, snap = both(pkgs, _shedding)
    assert shed[:4] == ("shed", 503, "shed_low_class", 2)
    assert err[:3] == ("shed_low_class", 1, 503)
    assert [r[0] for r in rest] == ["ok", "ok"]
    assert snap["shed_total"] == 2


def _expiry(ns):
    clock = FakeClock()
    router = ns.router(clock=clock, n_replicas=1,
                       serve_kw={"max_batch": 1, "max_queue": 1})
    prompts = _tenant_prompts(n_per_tenant=2)
    rids = [router.submit(prompts[0], 2), router.submit(prompts[1], 2),
            router.submit(prompts[2], 2, deadline=clock() + 1.0,
                          deadline_class=1)]
    clock.advance(5.0)
    router.run_until_idle()
    return [_res(router.result(r)) for r in rids], _snap(router)


def test_router_deadline_expiry_is_structured(pkgs):
    res, snap = both(pkgs, _expiry)
    assert res[2][:4] == ("expired", 503, "deadline_expired", 1)
    assert snap["expired_total"] == 1


# ---------------------------------------------------------------------------
# Membership
# ---------------------------------------------------------------------------

def _join_drain(ns, migrate_running):
    prompts = _tenant_prompts(n_per_tenant=4)
    router = ns.router(n_replicas=2, serve_kw={"max_batch": 2})
    rids = [router.submit(p, 3) for p in prompts]
    router.step()
    victim = router.replicas[0]
    router.remove_replica(victim, migrate_running=migrate_running)
    joined = router.add_replica()
    router.run_until_idle()
    assert victim not in router.replicas and joined in router.replicas
    results = [_res(router.result(r)) for r in rids]
    assert [r[4] for r in results] == [
        tuple(t) for t in ns.engine().generate(prompts, 3)]
    snap = _snap(router)
    assert snap["requests_submitted"] == snap["requests_finished"] == 8
    live = sum(len(e.metrics.first_token_s) for e in router.engines)
    assert live + len(router.metrics._retired_samples["first_token_s"]) == 8
    return results, list(router.placement_log), snap


@pytest.mark.parametrize("migrate_running", [False, True])
def test_replica_join_and_drain_leave(pkgs, migrate_running):
    both(pkgs, _join_drain, migrate_running)


def _guards(ns):
    out = []
    router = ns.router(n_replicas=1)
    out.append(_errors(lambda: router.remove_replica(router.replicas[0])))
    split = ns.router(n_replicas=2, n_prefill=1)
    for inst in split.replicas:
        out.append(_errors(lambda: split.remove_replica(inst)))
    out.append(_errors(lambda: split.remove_replica("nope")))
    out.append(_errors(lambda: router.add_replica(role="oracle")))
    return out


def test_cannot_remove_last_replica(pkgs):
    out = both(pkgs, _guards)
    assert all(e is not None and "last" in e[1] for e in out[:3])


def _multi_model(ns):
    prompts = _tenant_prompts()
    router = ns.router(n_replicas=2)
    errs = [_errors(lambda: router.add_model("default", ns.cfg, ns.params)),
            _errors(lambda: router.add_model("b", ns.cfg, ns.params,
                                             n_replicas=1, n_prefill=1))]
    b_insts = set(router.add_model("b", ns.cfg, ns.params, n_replicas=2,
                                   serve_cfg=ns.ServeConfig(**KW)))
    a_insts = set(router.replicas) - b_insts
    rids_a = [router.submit(p, 4) for p in prompts]
    rids_b = [router.submit(p, 4, model="b") for p in prompts]
    router.run_until_idle()
    placed = {rid: inst for rid, inst, _, _ in router.placement_log}
    assert all(placed[r] in a_insts for r in rids_a)
    assert all(placed[r] in b_insts for r in rids_b)
    return (errs, [_res(router.result(r)) for r in rids_a + rids_b],
            list(router.placement_log), router.metrics.snapshot_by_model()
            ["b"]["requests_finished"], _snap(router))


def test_multi_model_routing_isolation_and_parity(pkgs):
    both(pkgs, _multi_model)


def _spill(ns):
    prompts = _tenant_prompts(n_per_tenant=4, n_tenants=1)
    router = ns.router(n_replicas=1)
    b_insts = set(router.add_model(
        "b", ns.cfg, ns.params, n_replicas=1,
        serve_cfg=ns.ServeConfig(**{**KW, "max_queue": 2, "max_batch": 1})))
    rids_b = [router.submit(p, 2, model="b") for p in prompts]
    rids_a = [router.submit(p, 2) for p in prompts]
    router._place_queued()
    placed = {rid: inst for rid, inst, _, _ in router.placement_log}
    assert all(r in placed and placed[r] not in b_insts for r in rids_a)
    assert any(r not in placed for r in rids_b)
    router.run_until_idle()
    return sorted(placed.items()), [_res(router.result(r))
                                    for r in rids_a + rids_b]


def test_multi_model_capacity_never_spills_across_groups(pkgs):
    both(pkgs, _spill)


def _decommission(ns):
    router = ns.router(n_replicas=1)
    (b_inst,) = router.add_model("b", ns.cfg, ns.params, n_replicas=1,
                                 serve_cfg=ns.ServeConfig(**KW))
    rid = router.submit([1, 2, 3], 2, model="b")
    out = [_errors(lambda: router.remove_replica(b_inst))]
    router.run_until_idle()
    out.append(_res(router.result(rid)))
    router.remove_replica(b_inst)
    router.step()
    out.append(b_inst in router.replicas)
    out.append(_errors(lambda: router.submit([1, 2, 3], 2, model="b")))
    out.append(_errors(lambda: router.remove_replica(router.replicas[0])))
    return out


def test_remove_last_model_replica_guard(pkgs):
    out = both(pkgs, _decommission)
    assert out[3][2] == "no_replicas" and not out[2]


def _toy_model(np_, cheap, expensive, src=0):
    alpha = [[0.0] * np_ for _ in range(np_)]
    for d in range(np_):
        if d != src:
            alpha[src][d] = expensive
    alpha[src][cheap] = 1.0
    return {"np": np_, "alpha_us": alpha,
            "beta_us_per_byte": [[0.0] * np_ for _ in range(np_)]}


def _link_cost_drain(ns, monkeypatch):
    monkeypatch.setattr(ns.mig, "fleet_topology",
                        lambda: _toy_model(3, cheap=2, expensive=5e6))
    router = ns.router(n_replicas=3)
    r0, r1, r2 = router._replicas
    need = r0.engine.allocator.blocks_for_tokens(8)
    picks = [router._pick_capacity(("unified",), need, exclude=r0,
                                   source=r0).instance]
    prompts = _tenant_prompts(n_per_tenant=2)
    rids = [router.submit(p, 4) for p in prompts]
    router.step()
    router.remove_replica(r0.instance, migrate_running=True)
    router.run_until_idle()
    moves = [e for e in router.placement_log if e[2] == -1]
    assert moves and all(e[1] == r2.instance for e in moves)
    monkeypatch.setattr(ns.mig, "fleet_topology", lambda: None)
    return picks, moves, [_res(router.result(r)) for r in rids]


def test_drain_target_scored_by_link_cost(pkgs, monkeypatch):
    picks, moves, _ = both(pkgs, _link_cost_drain, monkeypatch)
    assert picks == ["2"]
    assert all(e[3] == round(1.0 + 2 * tmig.SPAN_OVERHEAD_US, 3)
               for e in moves)


# ---------------------------------------------------------------------------
# The randomized property run
# ---------------------------------------------------------------------------

def _property_run(ns, seed):
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
    for rid, (m, r) in results.items():
        assert r[0] in ("ok", "shed")
        assert (len(r[4]) >= 1) == (r[0] == "ok")
    for rid, inst, _m, _c in router.placement_log:
        assert inst_model[inst] == results[rid][0]
    assert all(e.metrics.max_queue_depth <= 3 for e in router.engines)
    return list(router.placement_log), results, saturated, _snap(router)


@pytest.mark.parametrize("seed", [7, 8])
def test_router_randomized_property(pkgs, seed):
    log, results, _, _ = both(pkgs, _property_run, seed)
    assert {m for m, _ in results.values()} == {"default", "b"}
    assert len(log) > 10


class _StandInMesh:
    """A ``DeviceMesh`` stand-in: its device type and named axes."""

    def __init__(self, device_type, **axes):
        self.device_type = device_type
        self.mesh_dim_names = tuple(axes)
        self._sizes = tuple(axes.values())

    def size(self, i):
        return self._sizes[i]


@pytest.mark.parametrize("mesh", [
    _StandInMesh("cuda", dp=1, tp=1),
    _StandInMesh("cpu", dp=1, sp=2),
    _StandInMesh("cpu", dp=1, fsdp=2)], ids=["cuda_mesh", "sp", "fsdp"])
def test_router_refuses_a_mesh_its_engines_cannot_serve_on(pkgs, mesh):
    from horovod_tpu_torch.serve.engine import check_serve_mesh

    ns = pkgs["port"]
    with pytest.raises(ValueError) as want:
        check_serve_mesh(ns.cfg, mesh, torch.device("cpu"))
    with pytest.raises(ValueError) as got:
        tserve.ServeRouter(ns.cfg, ns.params, mesh=mesh, clock=FakeClock())
    assert str(got.value) == str(want.value)
