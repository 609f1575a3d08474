"""Sequence and tensor parallelism over NCCL, one process a card, against
the same worlds on the CPU over gloo. Every test needs two CUDA devices
and skips with fewer; the file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_sp_tp_cuda.py

The CPU side runs the plain versions, which ``tests/test_torch_ring_
attention.py`` and ``tests/test_torch_tensor_parallel.py`` hold to the
JAX package. Here the same f32 inputs from a numpy seed go through a
world of 2 on each side (TF32 off): ring, ring_flash (its chunks
through the kernel's f32 path) and Ulysses attention, forward and the
q/k/v gradients of ``sum(out * cot)``; and two SGD steps of the tp=2
step (the flash kernel on one query head a rank, wk/wv whole) and of
the sp=2 ring_flash step, at head dim 64. Tolerances: 2e-5 on the
attention outputs (f32 sums in another order; the kernel is within
1e-5 of its plain version), 1e-4 on gradients, losses and parameters
(the backward's f32 sums over the sequence on both sides).
"""

import os
import pickle
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

pytestmark = pytest.mark.cuda

B, T, H, D = 2, 256, 4, 64
IMPLS = ("ring", "ring_flash", "ulysses")
STEPS = (("tp", 2, "flash"), ("sp", 2, "ring_flash"))


def _inputs():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32)
            for _ in range(4)]


def _cfg(impl):
    from horovod_tpu_torch.models import transformer as ttr
    return ttr.TransformerConfig.tiny(dtype=torch.float32, d_model=128,
                                      n_heads=2, n_kv_heads=1,
                                      sp_attention=impl)


def _world(rank, n, port, device, out):
    import torch.distributed as dist

    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.parallel import ring_attention as tra
    from horovod_tpu_torch.parallel.mesh import build_mesh, init_process_group

    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                      HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(n),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dev = init_process_group(device, timeout=120)
    results = {}
    mesh = build_mesh(sp=n)
    c = T // n
    q, k, v, cot = (torch.from_numpy(a[:, rank * c:(rank + 1) * c].copy())
                    .to(dev) for a in _inputs())
    for impl in IMPLS:
        qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out_ = tra.sequence_sharded_attention(*qkv, mesh, impl=impl)
        (out_ * cot).sum().backward()
        results[impl] = [t.detach().cpu().numpy()
                         for t in [out_] + [x.grad for x in qkv]]
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 65))).to(dev)
    for axis, size, impl in STEPS:
        cfg = _cfg(impl)
        mesh = build_mesh(**{axis: size})
        init_state, step = ttr.make_train_step(
            cfg, dev, lambda ps: torch.optim.SGD(ps, lr=0.5), mesh=mesh)
        params = ttr.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
        state = init_state(params=ttr.map_params(lambda p: p.to(dev),
                                                 params))
        local = {"tokens": ttr.shard_batch(tokens, mesh)}
        losses = []
        for _ in range(2):
            state, loss = step(state, local)
            losses.append(loss.item())
        full = ttr.gather_params(state, cfg, mesh)
        results[axis] = (losses, [p.detach().cpu().numpy()
                                  for p in ttr.param_leaves(full)])
    dist.destroy_process_group()
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(results, f)


def _run(device, tmp):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = os.path.join(tmp, device)
    mp.spawn(_world, args=(2, port, device, out), nprocs=2, join=True)
    res = []
    for r in range(2):
        with open(f"{out}.{r}", "rb") as f:
            res.append(pickle.load(f))
    return res


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    tmp = str(tmp_path_factory.mktemp("sp_tp_cuda"))
    return {d: _run(d, tmp) for d in ("cpu", "cuda")}


@pytest.mark.parametrize("impl", IMPLS)
def test_sp_attention_over_nccl_matches_gloo(worlds, impl):
    for got, want in zip(worlds["cuda"], worlds["cpu"]):
        (o, *gs), (wo, *wgs) = got[impl], want[impl]
        np.testing.assert_allclose(o, wo, rtol=2e-5, atol=2e-5)
        for g, w in zip(gs, wgs):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("axis", [s[0] for s in STEPS])
def test_parallel_step_over_nccl_matches_gloo(worlds, axis):
    for got, want in zip(worlds["cuda"], worlds["cpu"]):
        (losses, params), (w_losses, w_params) = got[axis], want[axis]
        np.testing.assert_allclose(losses, w_losses, rtol=1e-4)
        for p, w in zip(params, w_params):
            np.testing.assert_allclose(p, w, rtol=1e-4, atol=1e-4)
