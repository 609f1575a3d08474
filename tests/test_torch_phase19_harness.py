"""``chip_smoke.py`` phase 19 and phase 18's (W4) rehearsed on the CPU, at
a tiny size, without JAX:

- ``router_mesh_world`` on four gloo ranks with ``ROUTER_MESH_PASSES``
  ((Y1) tp=4 with affinity and random placement, (Y2) a split fleet on
  tp=4, the skewed pass, (Y3) dp=2 x tp=2, (Y4) the MoE configuration on
  ep=4): the phase raises unless every rank's streams, placement log and
  statuses are equal, (Y1)'s and (Y2)'s placement logs are those of the
  one-card router, every request resolves once (the skewed pass expiring
  some and serving the rest), the flash launches (none on the CPU) and
  the pools hold, every served stream passes the teacher-forced check
  and the split fleet hands every request off;
- ``phase_fleet`` in a fresh process: its (W4) pass through
  ``ServeRouter(mesh=build_mesh(tp=1))`` on a world of one process gives
  (W1)'s streams and placement log, bitwise, and the process's world is
  down after it.
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
    assert [p[0] for p in passes] == ["Y1 affinity", "Y1 random",
                                      "Y2 split", "Y1 skewed",
                                      "Y3 affinity", "Y4 affinity"]
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
    return ({k: v for k, v in checks.items() if k.startswith("W4")},
            mesh_launches, dist.is_initialized())


def test_phase18_w4_mesh_fleet_is_bitwise_w1(clean_env):
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(1) as pool:
        checks, launches, world_left = pool.apply(_phase18)
    assert checks == {"W4 launches": True, "W4 resolved": True,
                      "W4 pools in place": True,
                      "W4 streams bitwise W1": True,
                      "W4 placement log W1": True}
    assert launches == 0 and not world_left
