"""``chip_smoke.py`` phase 19 and phase 18's (W4) rehearsed on the CPU, at
a tiny size, without JAX:

- ``router_mesh_world`` on four gloo ranks with ``ROUTER_MESH_PASSES``
  ((Y1) tp=4 with affinity and random placement, (Y2) a split fleet on
  tp=4, the skewed pass, then beside a CPU worker process rank 0 spawns
  (Y5) affinity, (Y6) splits both ways and (Y7) a SIGKILL of the worker,
  (Y3) dp=2 x tp=2, (Y4) the MoE configuration on ep=4): the phase raises
  unless every rank's streams, placement log and statuses are equal,
  (Y1)'s, (Y2)'s, (Y5)'s and (Y6)'s placement logs are those of the
  one-card router, every request resolves once (the skewed pass expiring
  some and serving the rest, (Y7) requeuing the worker's), the flash
  launches (none on the CPU) and the pools hold, every served stream
  passes the teacher-forced check and the split fleets hand every
  request off, counting a worker's whole pages;
- ``phase_fleet`` in a fresh process: its (W4) pass through
  ``ServeRouter(mesh=build_mesh(tp=1))`` on a world of one process, and
  its (W5) pass with one in-process replica beside a worker process
  there, give (W1)'s streams and placement log, bitwise, and the
  process's world is down after it.
"""

import multiprocessing
import os

import pytest
import torch

import chip_smoke
from horovod_tpu_torch.models import transformer as ttr

#: Phase 18's trace and engines, cut to the tiny model.
DIMS = dict(n_requests=8, n_tenants=2, prefix_len=16, min_suffix=2,
            max_suffix=4, new=4, max_batch=4, block_size=4, kill_after=2)


def _tiny(dtype=torch.float32):
    return ttr.TransformerConfig.tiny(dtype=dtype, remat=False,
                                      sp_attention="flash")


@pytest.fixture
def clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith(("HOROVOD_", "MASTER_")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_phase19_rehearsed_on_four_gloo_ranks(clean_env):
    cfg = _tiny()
    passes = chip_smoke.ROUTER_MESH_PASSES
    assert [p.name for p in passes] == [
        "Y1 affinity", "Y1 random", "Y2 split", "Y1 skewed",
        "Y5 mesh + worker", "Y6 split mesh -> worker",
        "Y6 split worker -> mesh", "Y7 SIGKILL", "Y3 affinity",
        "Y4 affinity"]
    assert all(p.knobs["rpc_timeout"] < chip_smoke.TP_TIMEOUT
               for p in passes if p.workers)
    torch.multiprocessing.spawn(
        chip_smoke.router_mesh_world,
        args=(4, chip_smoke.free_port(), 0, "cpu", DIMS, passes,
              {"dense": cfg, "moe": chip_smoke.serve_moe_config(cfg)}),
        nprocs=4, join=True)


def test_skewed_pass_sets_every_third_deadline():
    got = chip_smoke.skewed_deadlines(8)
    step = chip_smoke.ROUTER_DEADLINE_STEP_S
    assert got == [0.0, None, None, step, None, None, 2 * step, None]


def _phase18():
    import torch.distributed as dist

    summary, _, mesh_launches = chip_smoke.phase_fleet(
        _tiny(torch.bfloat16), 0, torch.device("cpu"), DIMS)
    checks = summary["fleet"]["checks"]
    return ({k: v for k, v in checks.items() if k[:2] in ("W4", "W5")},
            mesh_launches, dist.is_initialized(),
            summary["fleet"]["passes"]["W5 mesh + worker affinity"])


@pytest.fixture(scope="module")
def phase18():
    saved = dict(os.environ)
    try:
        for k in list(os.environ):
            if k.startswith(("HOROVOD_", "MASTER_")):
                del os.environ[k]
        os.environ["OMP_NUM_THREADS"] = "1"
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(1) as pool:
            return pool.apply(_phase18)
    finally:
        os.environ.clear()
        os.environ.update(saved)


def test_phase18_w4_mesh_fleet_is_bitwise_w1(phase18):
    checks, launches, world_left, _ = phase18
    assert {k: v for k, v in checks.items() if k.startswith("W4")} == {
        "W4 launches": True, "W4 resolved": True,
        "W4 pools in place": True, "W4 streams bitwise W1": True,
        "W4 placement log W1": True}
    assert launches["W4"] == 0 and not world_left


def test_phase18_w5_mesh_fleet_with_a_worker_is_bitwise_w1(phase18):
    checks, launches, _, w5 = phase18
    assert {k: v for k, v in checks.items() if k.startswith("W5")} == {
        "W5 launches": True, "W5 resolved": True,
        "W5 pools in place": True, "W5 streams bitwise W1": True,
        "W5 placement log W1": True}
    assert launches["W5"] == 0
    # One replica in this process, one in the worker (its launches, none
    # on the CPU, read from its beats).
    assert list(w5["programs"]) == ["0"] and list(w5["workers"]) == ["1"]
