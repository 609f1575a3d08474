"""MoE over ep and the pipeline over pp on NCCL, one process a card,
against the same worlds on the CPU over gloo. Every test needs two CUDA
devices and skips with fewer; the file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_moe_pp_cuda.py

The CPU side runs the plain versions, which ``tests/test_torch_moe.py``
and ``tests/test_torch_pipeline.py`` hold to the JAX package. Here the
same f32 inputs from a seed go through a world of 2 on each side (TF32
off): the int8 island's MoE layer at ep=2 (output, aux and gradients),
and two SGD steps of the ep=2 MoE step and of the pp=2 GPipe and 1F1B
steps (4 layers, 2 microbatches), the attention through the flash
kernel on the card (head dim 64). Tolerances: 1e-4 on the steps'
losses and parameters (f32 sums in another order; the kernel is within
1e-5 of its plain version); the island's tensors within 1e-2 of each
one's largest value, room for a few int8 codes that the two sides'
expert outputs, apart by f32 rounding, round to neighbouring steps (a
step is a block's largest value / 127), while a wrong exchange moves
the output by most of its size.
"""

import os
import pickle
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

pytestmark = pytest.mark.cuda

STEPS = (("ep", None), ("pp", "gpipe"), ("pp", "1f1b"))


def _cfg(axis):
    from horovod_tpu_torch.models import transformer as ttr
    kw = {"n_experts": 4} if axis == "ep" else {"n_layers": 4}
    return ttr.TransformerConfig.tiny(dtype=torch.float32, d_model=128,
                                      n_heads=2, n_kv_heads=1,
                                      sp_attention="flash", remat=False, **kw)


def _island_inputs():
    rng = np.random.default_rng(5)
    E, D, F = 4, 256, 64
    lp = {"router": rng.standard_normal((D, E)) * D ** -0.5,
          "w_gate": rng.standard_normal((E, D, F)) * D ** -0.5,
          "w_up": rng.standard_normal((E, D, F)) * D ** -0.5,
          "w_down": rng.standard_normal((E, F, D)) * F ** -0.5}
    return ({k: v.astype(np.float32) for k, v in lp.items()},
            rng.standard_normal((4, 16, D)).astype(np.float32),
            rng.standard_normal((4, 16, D)).astype(np.float32))


def _world(rank, n, port, device, out):
    import torch.distributed as dist

    from horovod_tpu_torch.models import moe
    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.parallel import pipeline as tpl
    from horovod_tpu_torch.parallel.mesh import build_mesh, init_process_group

    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                      HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(n),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dev = init_process_group(device, timeout=120)
    results = {}
    lp, x, w = _island_inputs()
    e = 4 // n
    mine = {k: torch.from_numpy(v if k == "router"
                                else v[rank * e:(rank + 1) * e].copy())
            .to(dev).requires_grad_(True) for k, v in lp.items()}
    xt = torch.from_numpy(x).to(dev).requires_grad_(True)
    y, aux = moe.moe_ffn_island(
        xt, mine, moe.MoEConfig(n_experts=4, top_k=2, capacity_factor=1.25),
        build_mesh(dp=1, ep=n), codec="int8")
    ((y * torch.from_numpy(w).to(dev)).sum() + aux).backward()
    results["island"] = [t.detach().cpu().numpy() for t in
                         [y, aux, xt.grad] + [v.grad for v in mine.values()]]
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (4, 65))).to(dev)
    for axis, sched in STEPS:
        cfg = _cfg(axis)
        mesh = build_mesh(dp=1, **{axis: n})
        sgd = lambda ps: torch.optim.SGD(ps, lr=0.5)  # noqa: E731
        if sched is None:
            init_state, step = ttr.make_train_step(cfg, dev, sgd, mesh=mesh)
        else:
            make = (tpl.make_pp_train_step if sched == "gpipe"
                    else tpl.make_pp_train_step_1f1b)
            init_state, step = make(cfg, mesh, 2, sgd, device=dev)
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
        results[(axis, sched)] = (losses, [p.detach().cpu().numpy()
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
    tmp = str(tmp_path_factory.mktemp("moe_pp_cuda"))
    return {d: _run(d, tmp) for d in ("cpu", "cuda")}


def test_int8_island_over_nccl_matches_gloo(worlds):
    for got, want in zip(worlds["cuda"], worlds["cpu"]):
        for g, w in zip(got["island"], want["island"]):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-2 * np.abs(w).max())


@pytest.mark.parametrize("axis,sched", STEPS)
def test_ep_and_pp_steps_over_nccl_match_gloo(worlds, axis, sched):
    for got, want in zip(worlds["cuda"], worlds["cpu"]):
        (losses, params), (w_losses, w_params) = (got[(axis, sched)],
                                                  want[(axis, sched)])
        np.testing.assert_allclose(losses, w_losses, rtol=1e-4)
        for p, w in zip(params, w_params):
            np.testing.assert_allclose(p, w, rtol=1e-4, atol=1e-4)
