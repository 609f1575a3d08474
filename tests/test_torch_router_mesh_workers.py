"""Worker replicas beside the port's fleet on a mesh (``ServeRouter(mesh=
...)`` with worker replicas): mesh rank 0 holds each worker's connection,
every other rank passes ``rpc.MirrorHandle()`` and mirrors rank 0's calls,
on gloo worlds of 2 (tp=2) and 4 (dp=2 x tp=2) CPU processes, f32,
``TransformerConfig.tiny`` with JAX's parameters from ``PRNGKey(0)``
(``params_from_jax``; the in-thread ``ReplicaWorker``s on rank 0 hold the
same parameters, as ``tests/test_torch_fleet_rpc.py`` loads them), the
geometry of ``tests/test_router.py``. Every case holds the streams, the
placement log, every ``RequestResult`` field and ``metrics.snapshot()``
equal on every rank, and the streams and placement log equal to those of
its twin: the same scenario with each worker replaced by an in-process
mesh replica.

- (1) a unified fleet: one mesh replica and a worker joined by
  ``add_remote_replica``, on tp=2 and on dp=2 x tp=2;
- (2) all-remote: ``ServeRouter(mesh=, workers=[w0, w1])``;
- (3) split fleets (``n_prefill=1``) both ways, mesh prefill -> worker
  decode and worker prefill -> mesh decode, on both worlds: every request
  handed off once, each move counting the whole pages, each rank's pool
  holding its heads of the worker's export bitwise, and the worker
  receiving the tp ranks' heads gathered;
- (4) ``add_model(workers=)``: a worker group beside the mesh group;
- (5) a migrating drain from a worker to the mesh replica and back;
- (6) a spawned worker (``spawn_worker(device="cpu")``) SIGKILLed
  mid-trace: every rank requeues alike and every request resolves once;
- (7) cases (1) and (3) on tp=2 against the JAX package's
  ``ServeRouter(mesh=build_mesh(dp=-1, tp=2))`` with a JAX in-thread worker,
  on the 8 CPU devices of ``tests/conftest.py``;
- ``export_fleet_trace`` of (1) with real clocks: rank 0 writes
  ``router.json`` and the worker's file, each rank its mesh replica's,
  no file twice, and ``trace_merge`` reads the directory onto one
  timebase;
- the mirror connection's outcomes (a reply's tensors as ``meta`` tensors
  off rank 0, a transport failure and another error raised on every rank)
  and the handle check.

Workers run this file as a script (``--worker``) and load torch, numpy
and the port only.
"""

import concurrent.futures
import dataclasses
import os
import pickle
import socket
import sys
import threading
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
#: The worlds: their size and the port's mesh.
WORLDS = {2: {"tp": 2}, 4: {"dp": 2, "tp": 2}}
#: Each world's cases.
CASES = {2: ("c1_unified", "c2_all_remote", "c3_split_mw", "c3_split_wm",
             "c4_add_model", "c5_drain", "c6_sigkill"),
         4: ("c1_unified", "c3_split_mw", "c3_split_wm")}


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _prompts(n_per_tenant=3, n_tenants=2, seed=21):
    rng = np.random.RandomState(seed)
    prefixes = [rng.randint(1, 256, size=12).tolist()
                for _ in range(n_tenants)]
    out = []
    for _ in range(n_per_tenant):
        for p in prefixes:
            out.append(p + rng.randint(
                1, 256, size=int(rng.randint(2, 6))).tolist())
    return out


def _record(router, streams):
    """What every rank must agree on: streams, placement log, every
    result field (rid order) and the fleet snapshot."""
    return {"streams": streams, "log": list(router.placement_log),
            "results": [dataclasses.astuple(r) for _, r in
                        sorted(router.results.items())],
            "snap": router.metrics.snapshot()}


# ---------------------------------------------------------------------------
# The scenarios (``ns`` is a package's router pieces; ``remote=False``
# runs the twin, every worker an in-process mesh replica)
# ---------------------------------------------------------------------------

def _unified(ns, remote):
    router = ns.router(n_replicas=1)
    if remote:
        router.add_remote_replica(ns.worker())
    else:
        router.add_replica()
    return _record(router, router.generate(_prompts(4, 3), 4))


def _all_remote(ns, remote):
    if remote:
        router = ns.router(params=None, n_replicas=2,
                           workers=[ns.worker(), ns.worker()])
    else:
        router = ns.router(n_replicas=2)
    rec = _record(router, router.generate(_prompts(), 4))
    rec["remote"] = [r.remote for r in router._replicas]
    return rec


def _split(ns, remote, layout):
    """``layout`` "mw": mesh prefill -> worker decode; "wm" the other
    way."""
    workers = None
    if remote:
        workers = [None if c == "m" else ns.worker() for c in layout]
    router = ns.router(n_replicas=2, n_prefill=1, workers=workers)
    pages = ns.record_pages(router) if remote else None
    rec = _record(router, router.generate(_prompts(4, 3), 4))
    if pages is not None:
        rec["pages"] = pages
    return rec


def _add_model(ns, remote):
    router = ns.router(n_replicas=1)
    sc = ns.ServeConfig(**KW)
    if remote:
        router.add_model("b", ns.cfg, None, serve_cfg=sc, n_replicas=1,
                         workers=[ns.worker()])
    else:
        router.add_model("b", ns.cfg, ns.params, serve_cfg=sc,
                         n_replicas=1)
    prompts = _prompts()
    rids = [router.submit(p, 4) for p in prompts]
    rids_b = [router.submit(p, 4, model="b") for p in prompts]
    router.run_until_idle()
    rec = _record(router, [router.result(r).tokens for r in rids + rids_b])
    rec["models"] = {r.instance: r.model for r in router._replicas}
    return rec


def _drain(ns, remote):
    """A worker ("1") drained with its running sequences migrated to the
    mesh replica ("0"), then the mesh replica drained onto a second
    worker ("2")."""
    def join():
        return (router.add_remote_replica(ns.worker()) if remote
                else router.add_replica())

    router = ns.router(n_replicas=1)
    first = join()
    rids = [router.submit(p, 6) for p in _prompts()]
    router.step()
    router.step()
    router.remove_replica(first, migrate_running=True)
    router.step()
    join()
    router.remove_replica("0", migrate_running=True)
    router.run_until_idle()
    rec = _record(router, [router.result(r).tokens for r in rids])
    rec["replicas"] = router.replicas
    return rec


def _sigkill(ns, remote):
    """One mesh replica beside a spawned worker process, SIGKILLed by
    rank 0 after two steps."""
    router = ns.router(n_replicas=1)
    handle = None
    if remote:
        handle = ns.spawned()
        router.add_remote_replica(handle)
    else:
        router.add_replica()
    rids = [router.submit(p, 6) for p in _prompts()]
    router.step()
    router.step()
    if handle is not None:
        handle.kill()
    router.run_until_idle()
    return _record(router, [router.result(r).tokens for r in rids])


def _scenario(name, ns, remote):
    if name == "c1_unified":
        return _unified(ns, remote)
    if name == "c2_all_remote":
        return _all_remote(ns, remote)
    if name.startswith("c3_split_"):
        return _split(ns, remote, name[-2:])
    if name == "c4_add_model":
        return _add_model(ns, remote)
    if name == "c5_drain":
        return _drain(ns, remote)
    if name == "c6_sigkill":
        return _sigkill(ns, remote)
    raise KeyError(name)


# ---------------------------------------------------------------------------
# The port (worker side)
# ---------------------------------------------------------------------------

def _thread_worker(params, cfg):
    """A port ``ReplicaWorker`` on a thread of this process over a
    socketpair, holding ``params`` where its configure looks for the
    seed-0 parameters."""
    import torch  # noqa: F401

    from horovod_tpu_torch.serve.rpc import (RpcConn, WorkerHandle,
                                             model_cfg_to_wire)
    from horovod_tpu_torch.serve.worker import ReplicaWorker

    a, b = socket.socketpair()
    w = ReplicaWorker(RpcConn(b), device="cpu")
    w._params_cache.update(
        key=(repr(sorted(model_cfg_to_wire(cfg).items())), 0),
        params=params)
    threading.Thread(target=w.serve, daemon=True).start()
    return WorkerHandle(conn=RpcConn(a))


def _record_pages(router, rank):
    """Wrap the replicas' export and inject to keep the pages of every
    handoff: a mesh replica's export (this rank's heads) and its pool's
    blocks after an inject; on rank 0 the worker's export and the pages
    injected into it (whole pages)."""
    import torch

    rec = {"export": [], "inject": []}

    def keep(kind, k, v):
        rec[kind].append((torch.as_tensor(k).cpu().clone().numpy(),
                          torch.as_tensor(v).cpu().clone().numpy()))

    for r in router._replicas:
        eng = r.engine
        if r.remote and rank != 0:
            continue

        def export(rid, _ex=eng.export_prefilled):
            h = _ex(rid)
            keep("export", h.k_pages, h.v_pages)
            return h

        if r.remote:
            def inject(h, _inj=eng.inject_prefilled):
                keep("inject", h.k_pages, h.v_pages)
                return _inj(h)
        else:
            def inject(h, _inj=eng.inject_prefilled, _eng=eng):
                rid = _inj(h)
                seq = next(s for s in _eng._active if s.rid == rid)
                idx = torch.tensor(seq.blocks[:h.n_pages])
                keep("inject", _eng.cache.k[:, idx], _eng.cache.v[:, idx])
                return rid
        eng.export_prefilled = export
        eng.inject_prefilled = inject
    return rec


def _port_ns(d, axes, seed_params=False):
    """The port's pieces on this rank's mesh: JAX's parameters, or the
    port's seed-0 draw (``seed_params``: what a spawned worker builds)."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch import serve
    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.parallel.mesh import build_mesh
    from horovod_tpu_torch.serve import migrate

    rank = dist.get_rank()
    mesh = build_mesh(**axes)
    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32, remat=False)
    full = (ttr.init_params(cfg, torch.Generator("cpu").manual_seed(0),
                            device="cpu") if seed_params
            else ttr.params_from_jax(d, device="cpu"))
    shards = ttr.shard_params(full, cfg, mesh, serving=True)

    def router(params=shards, clock=None, workers=None, **rkw):
        return serve.ServeRouter(
            cfg, params, serve.RouterConfig(**rkw), serve.ServeConfig(**KW),
            mesh=mesh, clock=clock or FakeClock(), workers=workers,
            device="cpu")

    def worker():
        return (_thread_worker(full, cfg) if rank == 0
                else serve.MirrorHandle())

    def spawned():
        return (serve.spawn_worker(device="cpu",
                                   env={"OMP_NUM_THREADS": "1"})
                if rank == 0 else serve.MirrorHandle())

    return types.SimpleNamespace(
        cfg=cfg, params=shards, router=router, worker=worker,
        spawned=spawned, ServeConfig=serve.ServeConfig,
        record_pages=lambda r: _record_pages(r, rank),
        heads=migrate.kv_head_slice(cfg, mesh))


def _trace_export(d, tmp):
    """(1) with real clocks on tp=2, exported into ``tmp/fleet_trace``;
    returns this rank's paths."""
    import time

    ns = _port_ns(d, WORLDS[2])
    router = ns.router(n_replicas=1, clock=time.perf_counter)
    router.add_remote_replica(ns.worker())
    router.generate(_prompts(), 4)
    return [os.path.relpath(p, tmp) for p in
            router.export_fleet_trace(os.path.join(tmp, "fleet_trace"))]


def _conn_outcomes():
    """The mirror connection on its own: rank 0 wraps a stand-in whose
    calls reply with a tensor, fail the transport or raise; every rank
    reports what it got. And the handle check."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.serve import rpc

    class Stub:
        codec = 0
        trace_id = 0

        def call(self, method, *a, **k):
            if method == "pages":
                return {"k": torch.arange(6.0).reshape(2, 3), "n": 7}
            if method == "dead":
                raise rpc.RpcConnectionError("peer gone")
            raise ValueError("no such sequence")

        def close(self):
            pass

    group = dist.group.WORLD
    root = dist.get_rank() == 0
    conn = rpc.LockstepConn(Stub() if root else None, group)
    out = {}
    got = conn.call("pages")
    out["pages"] = (str(got["k"].device), tuple(got["k"].shape),
                    str(got["k"].dtype), got["n"],
                    got["k"].tolist() if root else None)
    for method in ("err", "dead"):
        try:
            conn.call(method)
            out[method] = None
        except Exception as e:   # noqa: BLE001 — the outcome is the point
            out[method] = (type(e).__name__, str(e))
    out["alive"] = conn.alive
    wrong = rpc.MirrorHandle() if root else rpc.WorkerHandle(conn=None)
    try:
        rpc.lockstep_handle(wrong, group)
        out["handle"] = None
    except ValueError as e:
        out["handle"] = str(e)
    return out


def _worker(store, out, data):
    import torch.distributed as dist

    from horovod_tpu_torch.parallel.mesh import init_process_group

    with open(data, "rb") as f:
        d = pickle.load(f)
    init_process_group("cpu", init_method=f"file://{store}", timeout=120)
    n = dist.get_world_size()
    res = {}
    for case in CASES[n]:
        ns = _port_ns(d, WORLDS[n], seed_params=case == "c6_sigkill")
        res[case] = {"port": _scenario(case, ns, True),
                     "twin": _scenario(case, ns, False),
                     "heads": ns.heads}
    if n == 2:
        res["conn"] = _conn_outcomes()
        res["trace"] = _trace_export(d, os.path.dirname(store))
    with open(out, "wb") as f:
        pickle.dump(res, f)
    # As tests/test_torch_router_mesh.py: end without the interpreter's
    # teardown once every rank has written its results.
    dist.barrier()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


# ---------------------------------------------------------------------------
# The pytest side
# ---------------------------------------------------------------------------

def _jax_params():
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import TransformerConfig, init_transformer

    cfg = TransformerConfig.tiny(dtype=jnp.float32, remat=False)
    return jax.tree.map(np.asarray,
                        init_transformer(cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("router_mesh_workers"))
    data = os.path.join(tmp, "data.pkl")
    with open(data, "wb") as f:
        pickle.dump(_jax_params(), f)
    script = os.path.abspath(__file__)
    for n in WORLDS:
        os.makedirs(os.path.join(tmp, f"w{n}"))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        worlds = {n: pool.submit(run_world, n, os.path.join(tmp, f"w{n}"),
                                 script, (data,))
                  for n in WORLDS}
        out = {n: f.result() for n, f in worlds.items()}
    out["tmp"] = tmp
    return out


def _same_on_every_rank(ranks, case, arm="port"):
    got = [r[case][arm] for r in ranks]
    for g in got[1:]:
        for key in ("streams", "log", "results", "snap"):
            assert g[key] == got[0][key], (case, arm, key)
    return got[0]


CELLS = [(n, c) for n in WORLDS for c in CASES[n]]


@pytest.mark.parametrize("world,case", CELLS,
                         ids=[f"{c}-w{n}" for n, c in CELLS])
def test_every_rank_agrees_and_matches_the_in_process_twin(port_results,
                                                           world, case):
    ranks = port_results[world]
    port = _same_on_every_rank(ranks, case)
    twin = _same_on_every_rank(ranks, case, "twin")
    assert port["streams"] == twin["streams"]
    assert all(port["streams"])
    if case != "c6_sigkill":
        assert port["log"] == twin["log"]
    assert all(r[1] == "ok" for r in port["results"])
    assert port["snap"]["worker_deaths"] == (case == "c6_sigkill")


def test_all_remote_fleet_mirrors_every_replica(port_results):
    port = _same_on_every_rank(port_results[2], "c2_all_remote")
    assert port["remote"] == [True, True]
    assert port["snap"]["requests_finished"] == len(_prompts())


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("layout", ["mw", "wm"])
def test_split_moves_whole_pages_and_each_rank_its_heads(port_results,
                                                         world, layout):
    import torch

    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.serve import migrate

    case = f"c3_split_{layout}"
    ranks = port_results[world]
    port = _same_on_every_rank(ranks, case)
    prompts = _prompts(4, 3)
    assert port["snap"]["handoffs"] == len(prompts)
    assert [m for _, _, m, _ in port["log"]].count(-1) == len(prompts)
    # Every rank counts the whole pages: what crosses the worker's wire.
    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32, remat=False)
    bs = KW["block_size"]
    n_pages = [-(-len(p) // bs) for p in prompts]
    assert port["snap"]["migration_bytes_total"] == (
        sum(n_pages) * migrate.page_nbytes(cfg, bs))
    whole = ranks[0][case]["port"]["pages"]["export" if layout == "wm"
                                            else "inject"]
    assert sorted(k.shape[1] for k, _ in whole) == sorted(n_pages)
    for r in ranks:
        heads = r[case]["heads"]
        mine = r[case]["port"]["pages"]["inject" if layout == "wm"
                                        else "export"]
        assert len(mine) == len(prompts)
        for (wk, wv), (k, v) in zip(whole, mine):
            assert wk.shape[3] == cfg.n_kv_heads
            # Bitwise: this rank's KV heads of the whole pages.
            np.testing.assert_array_equal(k, wk[:, :, :, heads])
            np.testing.assert_array_equal(v, wv[:, :, :, heads])


def test_add_model_puts_a_worker_group_beside_the_mesh(port_results):
    port = _same_on_every_rank(port_results[2], "c4_add_model")
    assert port["models"] == {"0": "default", "1": "b"}
    placed = {rid: inst for rid, inst, _, _ in port["log"]}
    n = len(_prompts())
    assert {placed[r] for r in range(n)} == {"0"}
    assert {placed[r] for r in range(n, 2 * n)} == {"1"}


def test_drain_migrates_from_a_worker_to_the_mesh_and_back(port_results):
    port = _same_on_every_rank(port_results[2], "c5_drain")
    assert port["replicas"] == ["2"]
    assert port["snap"]["migrations"] >= 2
    moved_to = {inst for _, inst, m, _ in port["log"] if m == -1}
    # Worker "1" -> mesh "0", then mesh "0" -> worker "2".
    assert moved_to == {"0", "2"}


def test_a_sigkilled_worker_requeues_alike_on_every_rank(port_results):
    port = _same_on_every_rank(port_results[2], "c6_sigkill")
    snap = port["snap"]
    assert snap["worker_deaths"] == 1 and snap["requeued_total"] >= 1
    n = len(_prompts())
    # Each request resolved exactly once.
    assert [r[0] for r in port["results"]] == list(range(n))


def test_worker_trace_written_once_and_merged(port_results):
    from horovod_tpu_torch.serve import trace_merge

    ranks = [r["trace"] for r in port_results[2]]
    every = [p for paths in ranks for p in paths]
    assert len(every) == len(set(every))
    assert sorted(ranks[0]) == [os.path.join("fleet_trace", f) for f in (
        "replica-0-rank0.json", "replica-1.json", "router.json")]
    assert ranks[1] == [os.path.join("fleet_trace", "replica-0-rank1.json")]
    target = os.path.join(port_results["tmp"], "w2", "fleet_trace")
    merged = trace_merge.merge(trace_merge.discover(target))
    assert merged["metadata"]["timebase"].startswith("router wall clock")
    assert len(merged["metadata"]["merged_from"]) == len(every)
    evs = merged["traceEvents"]
    tids = trace_merge.trace_ids(evs)
    assert len(tids) == len(_prompts())
    row = trace_merge.critical_path(evs, tids[0])
    assert abs(sum(row["breakdown_us"].values()) - row["e2e_us"]) <= 1.0


def test_mirror_connection_outcomes(port_results):
    root, other = (r["conn"] for r in port_results[2])
    assert root["pages"] == ("cpu", (2, 3), "torch.float32", 7,
                             [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]])
    assert other["pages"] == ("meta", (2, 3), "torch.float32", 7, None)
    for got in (root, other):
        assert got["err"] == ("ValueError", "no such sequence")
        assert got["dead"] == ("RpcConnectionError", "peer gone")
        assert got["alive"] is False
        assert "MirrorHandle" in got["handle"]


# ---------------------------------------------------------------------------
# The JAX package's mesh router with a JAX worker beside it
# ---------------------------------------------------------------------------

def _jax_ns():
    import jax
    import jax.numpy as jnp

    from horovod_tpu import serve
    from horovod_tpu.models import TransformerConfig, init_transformer
    from horovod_tpu.parallel import build_mesh
    from horovod_tpu.serve.rpc import RpcConn, WorkerHandle
    from horovod_tpu.serve.worker import ReplicaWorker

    cfg = TransformerConfig.tiny(dtype=jnp.float32, remat=False)
    params = init_transformer(cfg, jax.random.PRNGKey(0))
    mesh = build_mesh(dp=-1, tp=2)

    def router(params=params, clock=None, workers=None, **rkw):
        return serve.ServeRouter(
            cfg, params, serve.RouterConfig(**rkw), serve.ServeConfig(**KW),
            mesh=mesh, clock=clock or FakeClock(), workers=workers)

    def worker():
        a, b = socket.socketpair()
        w = ReplicaWorker(RpcConn(b))
        threading.Thread(target=w.serve, daemon=True).start()
        return WorkerHandle(conn=RpcConn(a))

    return types.SimpleNamespace(cfg=cfg, params=params, router=router,
                                 worker=worker, ServeConfig=serve.ServeConfig,
                                 record_pages=lambda r: None)


@pytest.mark.parametrize("case", ["c1_unified", "c3_split_mw",
                                  "c3_split_wm"])
def test_matches_the_jax_mesh_router_with_a_worker(port_results, case):
    port = _same_on_every_rank(port_results[2], case)
    want = _scenario(case, _jax_ns(), True)
    assert port["streams"] == want["streams"]
    assert port["log"] == want["log"]


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2], sys.argv[3], sys.argv[4])
