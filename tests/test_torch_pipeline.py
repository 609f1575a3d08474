"""The port's pipeline over pp (``horovod_tpu_torch.parallel.pipeline``
and ``pipeline_1f1b``) against the JAX package, on gloo worlds of 2 and
4 processes (one module fixture), f32 tiny configs:

- ``pipeline_apply`` on pp=4 with a toy stage ``tanh(x @ W_s)`` and 3
  microbatches equals the stages run in sequence (rtol 2e-5, as
  ``tests/test_pipeline.py``), and so do the gradients of
  ``sum(out * cot)`` (rtol 1e-5);
- the GPipe step against JAX's ``make_pp_train_step`` on pp=2 (n_micro
  1, 2 and 4), dp=2 x pp=2 (n_micro 2) and pp=2 x tp=2 (n_micro 4);
  the 1F1B step against ``make_pp_train_step_1f1b`` on pp=2 (n_micro 4)
  and pp=4 (4 layers, n_micro 4); pp=2 x ep=2 MoE (4 experts) on both
  schedules (n_micro 2): two SGD steps (lr 0.5) each, losses and the
  gathered parameters at rtol 2e-5 (atol 1e-6), and the dense runs'
  losses within rtol 2e-5 of the port's flat step;
- after every step the replicated leaves are bitwise equal on the ranks
  that hold them (embed, final_norm and lm_head on every stage);
- the toy 1F1B schedule (``make_1f1b_loss``) against plain autograd on
  the stages in sequence, at S=2 with M=1, 4, 8 and S=4 with M=2, 8,
  16: loss and every gradient (rtol 1e-5), with ``min(M, 2(S - s))``
  microbatches at most held on stage ``s``, never more than ``2S`` (M =
  2S and M = 4S among them);
- layers that do not divide by pp raise, and so does ``B % n_micro``,
  with the reference's messages.

The workers run this file as a script (``--worker``) and load torch,
numpy and the port only.
"""

import concurrent.futures
import functools
import os
import pickle
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))

from test_torch_collectives import run_world  # noqa: E402

AXES = ("dp", "fsdp", "pp", "sp", "tp", "ep")
STEPS = 2
SGD_LR = 0.5
#: (world, mesh axes, schedule, n_micro, config) of every JAX-compared run.
RUNS = [(2, (("pp", 2),), "gpipe", 1, "dense"),
        (2, (("pp", 2),), "gpipe", 2, "dense"),
        (2, (("pp", 2),), "gpipe", 4, "dense"),
        (4, (("dp", 2), ("pp", 2)), "gpipe", 2, "dense"),
        (4, (("pp", 2), ("tp", 2)), "gpipe", 4, "dense"),
        (2, (("pp", 2),), "1f1b", 4, "dense"),
        (4, (("pp", 4),), "1f1b", 4, "dense4"),
        (4, (("pp", 2), ("ep", 2)), "gpipe", 2, "moe"),
        (4, (("pp", 2), ("ep", 2)), "1f1b", 2, "moe")]
#: (stages, microbatches) of the toy 1F1B schedule.
TOY_1F1B = {2: (1, 4, 8), 4: (2, 8, 16)}
CONFIGS = {"dense": {}, "dense4": {"n_layers": 4}, "moe": {"n_experts": 4}}


def _tokens(rows=4, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (rows, 33)).astype(
        np.int32)


def _toy(S, M, seed=0):
    rng = np.random.default_rng(seed)
    D = 8
    w = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)
    head = rng.standard_normal((D,)).astype(np.float32)
    mb = rng.standard_normal((M, 2, 3, D)).astype(np.float32)
    return w, head, mb


def _toy_stage(w, x):
    return torch.tanh(x @ w["w"]) + x, torch.zeros((), device=x.device)


def _toy_last(h, y, m):
    return ((y * h["h"]).sum(-1) ** 2).mean()


def _toy_reference(S, M):
    """Loss and gradients of ``sum_m last(stages(mb[m]))`` by plain
    autograd on one process."""
    w, head, mb = (torch.from_numpy(a).requires_grad_(True)
                   for a in _toy(S, M))
    total = 0.0
    for m in range(M):
        x = mb[m]
        for s in range(S):
            x = _toy_stage({"w": w[s]}, x)[0]
        total = total + _toy_last({"h": head}, x, m)
    total.backward()
    return total.item(), w.grad.numpy(), head.grad.numpy(), mb.grad.numpy()


# ---------------------------------------------------------------------------
# The port (worker side)
# ---------------------------------------------------------------------------

def _port_cfg(kind):
    from horovod_tpu_torch.models import transformer as ttr
    return ttr.TransformerConfig.tiny(dtype=torch.float32,
                                      sp_attention="local", remat=False,
                                      **CONFIGS[kind])


def _train(params, tokens, axes, sched, n_micro, kind):
    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.parallel import pipeline as tpl
    from horovod_tpu_torch.parallel.mesh import axis_index, build_mesh

    cfg = _port_cfg(kind)
    mesh = build_mesh(**dict(axes))
    make = (tpl.make_pp_train_step if sched == "gpipe"
            else tpl.make_pp_train_step_1f1b)
    init_state, step = make(cfg, mesh, n_micro,
                            lambda ps: torch.optim.SGD(ps, lr=SGD_LR),
                            device="cpu")
    state = init_state(params=ttr.params_from_jax(params, "cpu"))
    local = {"tokens": ttr.shard_batch(torch.from_numpy(tokens), mesh)}
    losses, shards = [], []
    for _ in range(STEPS):
        state, loss = step(state, local)
        losses.append(loss.item())
        shards.append([p.detach().numpy().copy()
                       for p in ttr.param_leaves(state["params"])])
    full = ttr.gather_params(state, cfg, mesh)
    coords = {a: axis_index(mesh, a) for a in AXES}
    return (losses, ttr.map_params(lambda p: p.detach().numpy().copy(),
                                   full), coords, shards)


def _apply_toy():
    """pipeline_apply on pp=n: this rank's outputs and its gradients."""
    import torch.distributed as dist

    from horovod_tpu_torch.parallel import pipeline as tpl
    from horovod_tpu_torch.parallel.mesh import build_mesh, pp_group

    n = dist.get_world_size()
    s = dist.get_rank()
    group = pp_group(build_mesh(dp=1, pp=n))
    w, _, mb = _toy(n, 3)
    mb = mb[:, :, 0]
    ws = torch.from_numpy(w[s].copy()).requires_grad_(True)
    x = torch.from_numpy(mb).requires_grad_(True)
    out = tpl.pipeline_apply(lambda p, v: torch.tanh(v @ p), ws, x, group)
    cot = np.random.default_rng(9).standard_normal(out.shape).astype(
        np.float32)
    (out * torch.from_numpy(cot)).sum().backward()
    gx = torch.zeros_like(x) if x.grad is None else x.grad   # stage 0 only
    return out.detach().numpy(), ws.grad.numpy(), gx.numpy(), cot


def _toy_1f1b(M):
    import torch.distributed as dist

    from horovod_tpu_torch.parallel import pipeline_1f1b as t1
    from horovod_tpu_torch.parallel.mesh import build_mesh, pp_group

    n, s = dist.get_world_size(), dist.get_rank()
    group = pp_group(build_mesh(dp=1, pp=n))
    w, head, mb = _toy(n, M)
    ws = {"w": torch.from_numpy(w[s].copy()).requires_grad_(True)}
    hp = ({"h": torch.from_numpy(head).requires_grad_(True)}
          if s == n - 1 else None)
    x = torch.from_numpy(mb).requires_grad_(True)
    loss_fn = t1.make_1f1b_loss(_toy_stage, _toy_last, group)
    loss = loss_fn(ws, hp, x)
    loss.backward()
    return (loss.item(), ws["w"].grad.numpy(),
            None if hp is None else hp["h"].grad.numpy(),
            x.grad.numpy() if s == 0 else None, loss_fn.stats["stash_peak"])


def _raises():
    """The messages of the pp step's usage errors on pp=n."""
    from horovod_tpu_torch.parallel import pipeline as tpl
    from horovod_tpu_torch.parallel.mesh import build_mesh

    out = {}
    mesh = build_mesh(dp=1, pp=4)
    try:
        tpl.make_pp_train_step(_port_cfg("dense"), mesh, 2, device="cpu")
    except ValueError as e:
        out["layers"] = str(e)
    cfg = _port_cfg("dense4")
    init_state, step = tpl.make_pp_train_step(cfg, mesh, 3, device="cpu")
    state = init_state(torch.Generator().manual_seed(0))
    try:
        step(state, {"tokens": torch.from_numpy(_tokens())})
    except ValueError as e:
        out["micro"] = str(e)
    return out


def _worker(store, out, data):
    import torch.distributed as dist

    from horovod_tpu_torch.parallel.mesh import init_process_group

    with open(data, "rb") as f:
        d = pickle.load(f)
    init_process_group("cpu", init_method=f"file://{store}", timeout=120)
    n = dist.get_world_size()
    results = {}
    for world, axes, sched, n_micro, kind in RUNS:
        if world == n:
            results[(axes, sched, n_micro, kind)] = _train(
                d["params"][kind], d["tokens"], axes, sched, n_micro, kind)
    for M in TOY_1F1B[n]:
        results[("toy_1f1b", M)] = _toy_1f1b(M)
    if n == 4:
        results["apply"] = _apply_toy()
        results["raises"] = _raises()
    dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(results, f)


# ---------------------------------------------------------------------------
# The JAX side
# ---------------------------------------------------------------------------

def _jax_cfg(kind):
    import jax.numpy as jnp

    from horovod_tpu.models import TransformerConfig
    return TransformerConfig.tiny(dtype=jnp.float32, sp_attention="local",
                                  remat=False, **CONFIGS[kind])


def _jax_params(kind):
    import jax

    from horovod_tpu.models.transformer import init_params
    return jax.tree.map(np.asarray, init_params(_jax_cfg(kind),
                                                jax.random.PRNGKey(0)))


def _mesh(**axes):
    import jax
    from jax.sharding import Mesh

    shape = [axes.get(a, 1) for a in AXES]
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), AXES)


@functools.lru_cache(maxsize=None)
def _jax_step(axes, sched, n_micro, kind):
    """JAX's pp step: losses and the parameters with the stage dim
    folded back into the layer dim."""
    import jax
    import jax.numpy as jnp
    import optax

    from horovod_tpu.parallel import (make_pp_train_step,
                                      make_pp_train_step_1f1b)

    make = make_pp_train_step if sched == "gpipe" else make_pp_train_step_1f1b
    init_state, step, _ = make(_jax_cfg(kind), _mesh(**dict(axes)), n_micro,
                               optax.sgd(SGD_LR))
    state = init_state(jax.random.PRNGKey(0))
    batch = {"tokens": jnp.asarray(_tokens())}
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, batch)
        losses.append(float(loss))
    params = jax.tree.map(np.asarray, state["params"])
    params["layers"] = jax.tree.map(
        lambda a: a.reshape(-1, *a.shape[2:]), params["layers"])
    return losses, params


@functools.lru_cache(maxsize=None)
def _flat_losses(kind):
    """The port's flat step (no mesh) on the same parameters and batch."""
    from horovod_tpu_torch.models import transformer as ttr

    init_state, step = ttr.make_train_step(
        _port_cfg(kind), "cpu", lambda ps: torch.optim.SGD(ps, lr=SGD_LR))
    state = init_state(params=ttr.params_from_jax(_jax_params(kind), "cpu"))
    batch = {"tokens": torch.from_numpy(_tokens())}
    return [step(state, batch)[1].item() for _ in range(STEPS)]


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pipeline"))
    data = os.path.join(tmp, "data.pkl")
    with open(data, "wb") as f:
        pickle.dump({"params": {k: _jax_params(k) for k in CONFIGS},
                     "tokens": _tokens()}, f)
    script = os.path.abspath(__file__)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        worlds = {n: pool.submit(run_world, n, tmp, script, (data,))
                  for n in (2, 4)}
        return {n: f.result() for n, f in worlds.items()}


def _leaves(tree):
    from horovod_tpu_torch.models.transformer import param_leaves
    return param_leaves(tree)


def test_pipeline_apply_equals_sequential(port_results):
    ranks = [r["apply"] for r in port_results[4]]
    w, _, mb = _toy(4, 3)
    ws = torch.from_numpy(w).requires_grad_(True)
    x = torch.from_numpy(mb[:, :, 0]).requires_grad_(True)
    want = x
    for s in range(4):
        want = torch.tanh(want @ ws[s])
    (want * torch.from_numpy(ranks[0][3])).sum().backward()
    for s, (out, gw, gx, _) in enumerate(ranks):
        np.testing.assert_allclose(out, want.detach().numpy(), rtol=2e-5)
        np.testing.assert_allclose(gw, ws.grad[s].numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(
            gx, x.grad.numpy() if s == 0 else np.zeros_like(gx), rtol=1e-5,
            atol=1e-6)


@pytest.mark.parametrize("world,axes,sched,n_micro,kind", RUNS)
def test_pp_step_matches_jax(port_results, world, axes, sched, n_micro,
                             kind):
    want_losses, want_params = _jax_step(axes, sched, n_micro, kind)
    for rank in port_results[world]:
        losses, params, _, _ = rank[(axes, sched, n_micro, kind)]
        np.testing.assert_allclose(losses, want_losses, rtol=2e-5)
        if kind != "moe":
            np.testing.assert_allclose(losses, _flat_losses(kind), rtol=2e-5)
        for g, w in zip(_leaves(params), _leaves(want_params)):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("world,axes,sched,n_micro,kind", RUNS)
def test_replicated_leaves_bitwise_equal(port_results, world, axes, sched,
                                         n_micro, kind):
    """After each step the ranks holding the same shard of a leaf hold
    the same bits: embed/final_norm/lm_head on every stage (and dp and
    ep rank), a layer leaf on its stage's dp and ep ranks, an expert on
    its stage's dp ranks."""
    from horovod_tpu_torch.models import transformer as ttr

    names = [n for n, _ in ttr.named_param_leaves(ttr.param_shapes(
        _port_cfg(kind)))]
    keys = {"top": ("tp",), "layer": ("pp", "tp"),
            "expert": ("pp", "tp", "ep")}
    for i, name in enumerate(names):
        groups = {}
        for rank in port_results[world]:
            coords, shards = rank[(axes, sched, n_micro, kind)][2:]
            key = tuple(coords[a] for a in keys[ttr.leaf_kind(name)])
            groups.setdefault(key, []).append([s[i] for s in shards])
        for held in groups.values():
            for other in held[1:]:
                for a, b in zip(other, held[0]):
                    assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("S,M", [(S, M) for S, Ms in TOY_1F1B.items()
                                 for M in Ms])
def test_1f1b_matches_autograd_and_bounds_the_stash(port_results, S, M):
    loss, gw, gh, gx = _toy_reference(S, M)
    for s, rank in enumerate(port_results[S]):
        got_loss, got_w, got_h, got_x, peak = rank[("toy_1f1b", M)]
        np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
        np.testing.assert_allclose(got_w, gw[s], rtol=1e-5, atol=1e-6)
        if s == S - 1:
            np.testing.assert_allclose(got_h, gh, rtol=1e-5, atol=1e-6)
        if s == 0:
            np.testing.assert_allclose(got_x, gx, rtol=1e-5, atol=1e-6)
        assert peak <= 2 * S
        assert peak == min(M, 2 * (S - s))


def test_indivisible_layers_and_batch_raise(port_results):
    for rank in port_results[4]:
        msgs = rank["raises"]
        assert msgs["layers"] == "n_layers=2 not divisible by pp=4"
        assert msgs["micro"] == "batch 4 not divisible by n_micro=3"


def test_pp_reshape_layers_and_specs_match_jax():
    import jax

    from horovod_tpu.parallel import pipeline as jpl
    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.parallel import pipeline as tpl

    p_np = _jax_params("dense4")
    want = jax.tree.map(np.asarray, jpl.pp_reshape_layers(p_np, 2))
    got = tpl.pp_reshape_layers(ttr.params_from_jax(p_np, "cpu"), 2)
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="not divisible by pp=3"):
        tpl.pp_reshape_layers(got, 3)
    specs = tpl.pp_param_specs(_port_cfg("moe"), 2)
    assert specs["layers"]["wq"] == ("pp", None, "fsdp", "tp")
    assert specs["layers"]["moe"]["w_down"] == ("pp", None, "ep", "tp",
                                                "fsdp")
    assert specs["embed"] == ("tp", "fsdp")


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2], sys.argv[3], sys.argv[4])
