"""The port's MoE (``horovod_tpu_torch.models.moe`` and the MoE
transformer) against the JAX package, f32, tiny widths:

- ``_route``: probs (rtol 1e-6), and the dispatch/combine one-hots, top1,
  sel and within, which must be equal: random routing, a tie in the
  router probabilities (two equal router columns: ``lax.top_k`` takes
  the lower expert first), and capacity overflow (capacity factor 0.5);
- ``moe_ffn``: output, aux and the gradients of ``sum(y * w) + aux``
  against JAX's ``moe_ffn`` (rtol 1e-4, atol 1e-5, as
  ``tests/test_moe.py``: the combine sums each token's K weighted slots
  in another order than the einsum);
- a 2-layer MoE model: logits, loss and gradients against
  ``forward_with_aux``/``lm_loss`` (rtol 2e-5 / 1e-4), and two AdamW
  steps against JAX's ``make_train_step`` on one device (losses, rtol
  2e-5);
- on gloo worlds of 2 and 4 (one module fixture): two SGD steps (lr
  0.5) on ep=2, dp=2 x ep=2 and ep=2 x tp=2 against JAX's GSPMD step on
  the same mesh of the conftest's CPU devices (losses and the gathered
  parameters, rtol 2e-5, atol 1e-6), with every replicated shard
  bitwise equal on the ranks that hold it;
- the island (``moe_ffn_island``) at ep=2 and ep=4 with codecs bf16 and
  int8: equal (to f32 rounding, rtol 1e-5, atol 1e-6) to a model built
  from JAX's parts (``_route`` and ``_expert_ffn`` per shard, the
  slabs rounded by ``blockwise_int8_encode``/``_decode`` or a bf16
  cast as the wire would); within the codec's band of the port's own
  GSPMD output (bf16 1e-2, int8 4e-2 of the largest output, as
  ``tests/test_moe.py``) and not equal to it; aux equal to GSPMD's
  within rtol 1e-6; gradients reaching every parameter and the input;
- the bench's MoE arms (``bench.run_moe``, the reference's layer at 16
  tokens): the reference's keys, and ``moe_dispatch_bytes_saved_pct``
  as JAX's ``alltoall_wire_bytes`` gives it at that shape;
- the knobs, ``make_moe_ffn``'s routing discipline and the telemetry
  (``moe_routing_stats``, ``record_moe_stats``, the ``"moe"`` exporter's
  Prometheus fragment) against JAX's.

The workers run this file as a script (``--worker``) and load torch,
numpy and the port only.
"""

import concurrent.futures
import dataclasses
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
#: (world, mesh axes) of every JAX-compared ep step.
STEP_RUNS = [(2, (("ep", 2),)), (4, (("dp", 2), ("ep", 2))),
             (4, (("ep", 2), ("tp", 2)))]
ISLAND_CODECS = {"bf16": 1e-2, "int8": 4e-2}
ISLAND = dict(E=8, K=2, cf=1.25, B=8, T=6, D=16, F=32)


def _tokens(rows=4, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (rows, 33)).astype(
        np.int32)


def _route_inputs(case):
    """``(x [2, 16, 16], router [16, 4], capacity_factor)``."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16)).astype(np.float32)
    router = rng.standard_normal((16, 4)).astype(np.float32)
    if case == "tie":
        router[:, 2] = router[:, 1]
    return x, router, 0.5 if case == "overflow" else 1.25


def _island_inputs():
    c = ISLAND
    rng = np.random.default_rng(5)
    lp = {"router": rng.standard_normal((c["D"], c["E"])) * c["D"] ** -0.5,
          "w_gate": rng.standard_normal((c["E"], c["D"], c["F"]))
          * c["D"] ** -0.5,
          "w_up": rng.standard_normal((c["E"], c["D"], c["F"]))
          * c["D"] ** -0.5,
          "w_down": rng.standard_normal((c["E"], c["F"], c["D"]))
          * c["F"] ** -0.5}
    lp = {k: v.astype(np.float32) for k, v in lp.items()}
    x = rng.standard_normal((c["B"], c["T"], c["D"])).astype(np.float32)
    w = rng.standard_normal((c["B"], c["T"], c["D"])).astype(np.float32)
    return lp, x, w


def _port_moe_cfg():
    from horovod_tpu_torch.models import moe
    c = ISLAND
    return moe.MoEConfig(n_experts=c["E"], top_k=c["K"],
                         capacity_factor=c["cf"])


# ---------------------------------------------------------------------------
# The port (worker side)
# ---------------------------------------------------------------------------

def _port_cfg():
    from horovod_tpu_torch.models import transformer as ttr
    return ttr.TransformerConfig.tiny(dtype=torch.float32, n_experts=4,
                                      sp_attention="local", remat=False)


def _train(params, tokens, axes):
    """Losses, the gathered parameters, and this rank's coordinates and
    shards after each step."""
    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.parallel.mesh import axis_index, build_mesh

    cfg = _port_cfg()
    mesh = build_mesh(**dict(axes))
    init_state, step = ttr.make_train_step(
        cfg, "cpu", lambda ps: torch.optim.SGD(ps, lr=SGD_LR), mesh=mesh)
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


def _island(codec):
    """This rank's island output (all rows), aux and gradients, or the
    port's GSPMD path's (``codec=None``), on ``build_mesh(ep=n)``."""
    import torch.distributed as dist

    from horovod_tpu_torch.models import moe
    from horovod_tpu_torch.parallel.mesh import build_mesh

    n = dist.get_world_size()
    mesh = build_mesh(dp=1, ep=n)
    r = dist.get_rank()
    lp, x, w = _island_inputs()
    e = ISLAND["E"] // n
    mine = {k: torch.from_numpy(v if k == "router"
                                else v[r * e:(r + 1) * e].copy())
            .requires_grad_(True) for k, v in lp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    if codec is None:
        y, aux = moe.moe_ffn(xt, mine, _port_moe_cfg(), mesh)
    else:
        y, aux = moe.moe_ffn_island(xt, mine, _port_moe_cfg(), mesh,
                                    codec=codec)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    grads = {k: v.grad.numpy() for k, v in mine.items()}
    grads["x"] = xt.grad.numpy()
    return y.detach().numpy(), aux.item(), grads


def _worker(store, out, data):
    import torch.distributed as dist

    from horovod_tpu_torch.parallel.mesh import init_process_group

    with open(data, "rb") as f:
        d = pickle.load(f)
    init_process_group("cpu", init_method=f"file://{store}", timeout=120)
    n = dist.get_world_size()
    results = {}
    for world, axes in STEP_RUNS:
        if world == n:
            results[axes] = _train(d["params"], d["tokens"], axes)
    for codec in (None, *ISLAND_CODECS):
        results[("island", codec)] = _island(codec)
    from horovod_tpu_torch import bench
    results["bench"] = bench.run_moe(torch.device("cpu"), seq=16, iters=1,
                                     rounds=1)
    dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(results, f)


# ---------------------------------------------------------------------------
# The JAX side
# ---------------------------------------------------------------------------

def _jax_cfg():
    import jax.numpy as jnp

    from horovod_tpu.models import TransformerConfig
    return TransformerConfig.tiny(dtype=jnp.float32, n_experts=4,
                                  sp_attention="local", remat=False)


def _jax_params():
    import jax

    from horovod_tpu.models.transformer import init_params
    return jax.tree.map(np.asarray, init_params(_jax_cfg(),
                                                jax.random.PRNGKey(0)))


def _mesh(**axes):
    import jax
    from jax.sharding import Mesh

    shape = [axes.get(a, 1) for a in AXES]
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), AXES)


@functools.lru_cache(maxsize=None)
def _jax_step(axes):
    import jax
    import jax.numpy as jnp
    import optax

    from horovod_tpu.models import make_train_step

    init_state, step, _ = make_train_step(_jax_cfg(), _mesh(**dict(axes)),
                                          optax.sgd(SGD_LR))
    state = init_state(jax.random.PRNGKey(0))
    batch = {"tokens": jnp.asarray(_tokens())}
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state["params"])


def _jax_moe_cfg(**kw):
    from horovod_tpu.models import moe as jm
    c = ISLAND
    base = dict(n_experts=c["E"], top_k=c["K"], capacity_factor=c["cf"])
    base.update(kw)
    return jm.MoEConfig(**base)


@functools.lru_cache(maxsize=None)
def _jax_island(ep, codec):
    """The island built from JAX's parts: each of ``ep`` shards routes
    its rows (``_route``), packs per-expert slabs by the dispatch
    einsum, the slabs cross the wire rounded by ``codec`` (one int8
    payload per destination slab, as ``quantized_alltoall`` encodes
    them), the owners run ``_expert_ffn``, the outputs come back the
    same way and the shard combines; aux from the shard-averaged f and
    p. Returns ``(y, aux)``."""
    import jax.numpy as jnp

    from horovod_tpu.models import moe as jm
    from horovod_tpu.ops.quantized import (blockwise_int8_decode,
                                           blockwise_int8_encode)

    lp, x, _ = (jnp.asarray(a) if not isinstance(a, dict) else
                {k: jnp.asarray(v) for k, v in a.items()}
                for a in _island_inputs())
    cfg = _jax_moe_cfg()
    B, T, D = x.shape
    E = cfg.n_experts
    C, e_loc, b = jm.capacity(cfg, T), E // ep, B // ep

    def wire(slabs):                  # [ep, ...]: what each peer receives
        if codec == "bf16":
            return slabs.astype(jnp.bfloat16).astype(jnp.float32)
        rows = slabs.reshape(ep, -1)
        q, s = blockwise_int8_encode(rows)
        return blockwise_int8_decode(q, s, rows.shape[-1]).reshape(
            slabs.shape)

    routes = [jm._route(x[r * b:(r + 1) * b], lp["router"], cfg, C)
              for r in range(ep)]
    sent = [wire(jnp.einsum("btec,btd->ebcd", rt[0], x[r * b:(r + 1) * b])
                 .reshape(ep, e_loc, b, C, D))
            for r, rt in enumerate(routes)]
    back = []
    for d in range(ep):
        got = jnp.stack([sent[r][d] for r in range(ep)])
        got = jnp.moveaxis(got, 0, 1).reshape(e_loc, ep * b, C, D)
        w = {k: lp[k][d * e_loc:(d + 1) * e_loc]
             for k in ("w_gate", "w_up", "w_down")}
        out = jm._expert_ffn(got, w, jnp.float32)
        back.append(wire(jnp.moveaxis(out.reshape(e_loc, ep, b, C, D),
                                      1, 0)))
    ys = []
    for r, rt in enumerate(routes):
        full = jnp.concatenate([back[d][r] for d in range(ep)])
        ys.append(jnp.einsum("btec,ebcd->btd", rt[1], full))
    f = jnp.mean(jnp.stack([rt[3].mean((0, 1)) for rt in routes]), 0)
    p = jnp.mean(jnp.stack([rt[2].mean((0, 1)) for rt in routes]), 0)
    aux = cfg.aux_loss_coef * E * jnp.sum(f * p)
    return np.asarray(jnp.concatenate(ys)), float(aux)


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("moe"))
    data = os.path.join(tmp, "data.pkl")
    with open(data, "wb") as f:
        pickle.dump({"params": _jax_params(), "tokens": _tokens()}, f)
    script = os.path.abspath(__file__)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        worlds = {n: pool.submit(run_world, n, tmp, script, (data,))
                  for n in (2, 4)}
        return {n: f.result() for n, f in worlds.items()}


# ---------------------------------------------------------------------------
# Routing, the layer and the model, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "tie", "overflow"])
def test_route_matches_jax(case):
    import jax.numpy as jnp

    from horovod_tpu.models import moe as jm
    from horovod_tpu_torch.models import moe as tm

    x, router, cf = _route_inputs(case)
    jcfg = jm.MoEConfig(n_experts=4, top_k=2, capacity_factor=cf)
    tcfg = tm.MoEConfig(n_experts=4, top_k=2, capacity_factor=cf)
    C = jm.capacity(jcfg, x.shape[1])
    assert tm.capacity(tcfg, x.shape[1]) == C
    want = [np.asarray(a) for a in jm._route(jnp.asarray(x),
                                             jnp.asarray(router), jcfg, C)]
    r = tm._route(torch.from_numpy(x), torch.from_numpy(router), tcfg, C)
    dispatch, combine = r.dense()
    got = [dispatch, combine, r.probs, r.top1, r.sel, r.within]
    for name, g, w in zip(("dispatch", "combine", "probs", "top1", "sel",
                           "within"), got, want):
        g = g.detach().numpy()
        if name in ("combine", "probs"):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    if case == "tie":
        # Experts 1 and 2 tie on every token; at least one token picks
        # only one of them, and it must be expert 1.
        p = r.probs.detach().numpy()
        assert np.array_equal(p[..., 1], p[..., 2])
        one = r.sel[..., 1].sum(-1) != r.sel[..., 2].sum(-1)
        assert one.any()
        assert (r.sel[..., 1].sum(-1)[one] == 1).all()
    if case == "overflow":
        assert float(r.within.sum()) < float(r.sel.sum())


def test_moe_ffn_output_aux_and_gradients_match_jax():
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import moe as jm
    from horovod_tpu_torch.models import moe as tm

    lp, x, w = _island_inputs()
    jcfg = _jax_moe_cfg()

    def jloss(lp, x):
        y, aux = jm.moe_ffn(x, lp, jcfg)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (wy, waux)), wg = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        {k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(x))
    tlp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in lp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = tm.moe_ffn(xt, tlp, _port_moe_cfg())
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(wy),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(waux), rtol=1e-4)
    for k, v in tlp.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(wg[0][k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(wg[1]),
                               rtol=1e-4, atol=1e-5)


def test_moe_model_logits_loss_and_gradients_match_jax():
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtr
    from horovod_tpu_torch.models import transformer as ttr

    p_np = _jax_params()
    toks = _tokens(rows=2)
    jp = jax.tree.map(jnp.asarray, p_np)
    want_logits, want_aux = jtr.forward_with_aux(jp, jnp.asarray(
        toks[:, :-1]), _jax_cfg())
    want_loss, want_grads = jax.value_and_grad(jtr.lm_loss)(
        jp, {"tokens": jnp.asarray(toks)}, _jax_cfg(), None)

    params = ttr.params_from_jax(p_np, device="cpu")
    assert params["layers"]["moe"]["router"].dtype == torch.float32
    leaves = ttr.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    logits, aux = ttr.forward_with_aux(params, torch.from_numpy(toks[:, :-1]),
                                       _port_cfg())
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=2e-5)
    loss = ttr.lm_loss(params, {"tokens": torch.from_numpy(toks)},
                       _port_cfg())
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-5)
    loss.backward()
    names = [n for n, _ in ttr.named_param_leaves(params)]
    assert "layers.moe.router" in names and "layers.w_gate" not in names
    for name, p, w in zip(names, leaves, ttr.param_leaves(
            jax.tree.map(np.asarray, want_grads))):
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_moe_adamw_steps_match_jax():
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtr
    from horovod_tpu.parallel import build_mesh
    from horovod_tpu_torch.models import transformer as ttr

    toks = _tokens(rows=2)
    init_state, step, _ = jtr.make_train_step(
        _jax_cfg(), build_mesh(devices=jax.devices()[:1], dp=1))
    state = init_state(jax.random.PRNGKey(0))
    p_np = jax.tree.map(np.asarray, state["params"])
    want = []
    for _ in range(2):
        state, loss = step(state, {"tokens": jnp.asarray(toks)})
        want.append(float(loss))
    init_t, step_t = ttr.make_train_step(_port_cfg(), device="cpu")
    st = init_t(params=ttr.params_from_jax(p_np, device="cpu"))
    got = [step_t(st, {"tokens": torch.from_numpy(toks)})[1].item()
           for _ in range(2)]
    assert got[1] < got[0]
    np.testing.assert_allclose(got, want, rtol=2e-5)


# ---------------------------------------------------------------------------
# The ep steps and the island, on gloo worlds
# ---------------------------------------------------------------------------

def _leaves(tree):
    from horovod_tpu_torch.models.transformer import param_leaves
    return param_leaves(tree)


@pytest.mark.parametrize("world,axes", STEP_RUNS)
def test_ep_step_matches_jax_gspmd(port_results, world, axes):
    want_losses, want_params = _jax_step(axes)
    for rank in port_results[world]:
        losses, params, _, _ = rank[axes]
        np.testing.assert_allclose(losses, want_losses, rtol=2e-5)
        for g, w in zip(_leaves(params), _leaves(want_params)):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("world,axes", STEP_RUNS)
def test_ep_replicated_shards_bitwise_equal(port_results, world, axes):
    """After every step, the ranks that hold the same shard of a leaf
    (same tp and, for an expert leaf, same ep coordinate) hold the same
    bits: every leaf across dp, every non-expert leaf across ep."""
    from horovod_tpu_torch.models import transformer as ttr

    names = [n for n, _ in ttr.named_param_leaves(ttr.param_shapes(
        _port_cfg()))]
    ranks = port_results[world]
    for i, name in enumerate(names):
        kind = ttr.leaf_kind(name)
        key = ("tp", "ep") if kind == "expert" else ("tp",)
        groups = {}
        for rank in ranks:
            coords, shards = rank[axes][2], rank[axes][3]
            groups.setdefault(tuple(coords[a] for a in key), []).append(
                [s[i] for s in shards])
        for held in groups.values():
            for other in held[1:]:
                for a, b in zip(other, held[0]):
                    assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("codec", list(ISLAND_CODECS))
def test_island_matches_jax_parts_and_gspmd_band(port_results, world, codec):
    want_y, want_aux = _jax_island(world, codec)
    for rank in port_results[world]:
        y, aux, grads = rank[("island", codec)]
        gy, gaux, _ = rank[("island", None)]
        np.testing.assert_allclose(y, want_y, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(aux, want_aux, rtol=1e-6)
        rel = np.abs(y - gy).max() / np.abs(gy).max()
        assert 0.0 < rel < ISLAND_CODECS[codec], (codec, rel)
        np.testing.assert_allclose(aux, gaux, rtol=1e-6)
        for name, g in grads.items():
            assert np.abs(g).max() > 0, name


@pytest.mark.parametrize("world", [2, 4])
def test_gspmd_on_an_ep_mesh_matches_one_device(port_results, world):
    """``moe_ffn`` on ``build_mesh(ep=n)`` (each rank its E/n experts,
    the outputs summed over ep) against JAX's ``moe_ffn`` on the whole
    layer: the output, aux, and the gradients of x and the router (whole
    on every rank) and of this rank's experts."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import moe as jm

    lp, x, w = _island_inputs()
    jcfg = _jax_moe_cfg()

    def jloss(lp, x):
        y, aux = jm.moe_ffn(x, lp, jcfg)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (wy, waux)), (wg, wx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(x))
    e = ISLAND["E"] // world
    for r, rank in enumerate(port_results[world]):
        y, aux, grads = rank[("island", None)]
        np.testing.assert_allclose(y, np.asarray(wy), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(aux, float(waux), rtol=1e-5)
        np.testing.assert_allclose(grads["x"], np.asarray(wx), rtol=1e-4,
                                   atol=1e-5)
        for k in lp:
            want = np.asarray(wg[k])
            if k != "router":
                want = want[r * e:(r + 1) * e]
            np.testing.assert_allclose(grads[k], want, rtol=1e-4, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_bench_moe_arms_report_the_reference_keys(port_results, world):
    from horovod_tpu.models.moe import capacity
    from horovod_tpu.ops.quantized import alltoall_wire_bytes
    from horovod_tpu_torch import bench

    cfg = bench.CFG_MOE
    C = capacity(_jax_moe_cfg(n_experts=cfg.n_experts), 16)
    shape = (world, cfg.n_experts // world, 2, C, cfg.d_model)
    saved = round(100.0 * (1.0 - alltoall_wire_bytes(shape, "int8")
                           / alltoall_wire_bytes(shape, "none")), 1)
    for rank in port_results[world]:
        got = rank["bench"]
        assert set(got) == {"moe_tokens_per_sec_gspmd", "moe_tokens_per_sec_none",
                            "moe_tokens_per_sec_bf16", "moe_tokens_per_sec_int8",
                            "moe_dispatch_bytes_saved_pct"}
        assert all(v > 0 for v in got.values())
        assert got["moe_dispatch_bytes_saved_pct"] == saved


# ---------------------------------------------------------------------------
# Knobs, the routing discipline and the telemetry
# ---------------------------------------------------------------------------

class _EpMesh:
    """Stands in for a ``DeviceMesh`` with dims dp=1 and ep=``n``."""
    mesh_dim_names = ("dp", "ep")

    def __init__(self, n):
        self.n = n

    def size(self, dim):
        return (1, self.n)[dim]


def test_resolve_moe_knobs_env_and_validation(monkeypatch):
    from horovod_tpu.models import moe as jm
    from horovod_tpu_torch.models import moe as tm

    for env in ({}, {"HOROVOD_MOE_DISPATCH": "island",
                     "HOROVOD_MOE_COMPRESSION": "bf16"}):
        monkeypatch.delenv("HOROVOD_MOE_DISPATCH", raising=False)
        monkeypatch.delenv("HOROVOD_MOE_COMPRESSION", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for args in ((), ("gspmd", "none"), ("island", None)):
            assert tm.resolve_moe_knobs(*args) == jm.resolve_moe_knobs(*args)
    with pytest.raises(ValueError, match="dispatch"):
        tm.resolve_moe_knobs("islandd", None)
    monkeypatch.setenv("HOROVOD_MOE_COMPRESSION", "int9")
    with pytest.raises(ValueError, match="codec"):
        tm.resolve_moe_knobs("island", None)


def test_make_moe_ffn_routing_discipline(monkeypatch):
    """gspmd, codec none, no mesh and ep=1 take ``moe_ffn``; island with
    a lossy codec takes ``moe_ffn_island`` with that codec, from the
    config or the env; E % ep raises at build time."""
    from horovod_tpu_torch.models import moe as tm

    monkeypatch.delenv("HOROVOD_MOE_DISPATCH", raising=False)
    monkeypatch.delenv("HOROVOD_MOE_COMPRESSION", raising=False)
    cfg = _port_moe_cfg()
    ep2 = _EpMesh(2)
    for fn in (tm.make_moe_ffn(cfg, ep2),
               tm.make_moe_ffn(cfg, ep2, dispatch="gspmd", codec="int8"),
               tm.make_moe_ffn(cfg, ep2, dispatch="island", codec="none"),
               tm.make_moe_ffn(cfg, None, dispatch="island", codec="int8"),
               tm.make_moe_ffn(cfg, _EpMesh(1), dispatch="island",
                               codec="int8")):
        assert fn.func is tm.moe_ffn
    fn = tm.make_moe_ffn(cfg, ep2, dispatch="island", codec="int8")
    assert fn.func is tm.moe_ffn_island and fn.keywords["codec"] == "int8"
    monkeypatch.setenv("HOROVOD_MOE_DISPATCH", "island")
    monkeypatch.setenv("HOROVOD_MOE_COMPRESSION", "bf16")
    fn = tm.make_moe_ffn(cfg, ep2)
    assert fn.func is tm.moe_ffn_island and fn.keywords["codec"] == "bf16"
    with pytest.raises(ValueError, match="divide"):
        tm.make_moe_ffn(dataclasses.replace(cfg, n_experts=6), _EpMesh(4),
                        dispatch="island", codec="int8")
    lp, x, _ = _island_inputs()
    tlp = {k: torch.from_numpy(v) for k, v in lp.items()}
    with pytest.raises(ValueError, match="batch"):
        tm.moe_ffn_island(torch.from_numpy(x[:5]), tlp, cfg, _EpMesh(2),
                          codec="int8")


def test_routing_stats_record_and_export_match_jax():
    import importlib

    import jax.numpy as jnp

    from horovod_tpu.models import moe as jm
    from horovod_tpu_torch.models import moe as tm

    # The packages' ``metrics`` attributes are the api functions; take
    # the modules themselves.
    jmetrics = importlib.import_module("horovod_tpu.metrics")
    tmetrics = importlib.import_module("horovod_tpu_torch.metrics")
    junreg = jmetrics.unregister_exporter

    x, router, _ = _route_inputs("random")
    for cf in (0.5, 8.0):
        jcfg = jm.MoEConfig(n_experts=4, top_k=2, capacity_factor=cf)
        tcfg = tm.MoEConfig(n_experts=4, top_k=2, capacity_factor=cf)
        want = jm.moe_routing_stats(jnp.asarray(x), jnp.asarray(router), jcfg)
        got = tm.moe_routing_stats(torch.from_numpy(x),
                                   torch.from_numpy(router), tcfg)
        assert got == want
    assert want["moe_dispatch_overflow_tokens_total"] == 0.0
    for lib in (jm, tm):
        with lib._moe_metrics_lock:
            lib._moe_metrics.clear()
    junreg("moe")
    tmetrics.unregister_exporter("moe")
    stats = [tm.moe_routing_stats(torch.from_numpy(x),
                                  torch.from_numpy(router),
                                  tm.MoEConfig(4, 2, 0.5)),
             {"moe_dispatch_overflow_tokens_total": 3.0,
              "moe_dispatch_dropped_token_frac": 0.25,
              "moe_dispatch_bytes_saved_pct": 74.6}]
    try:
        for s in stats:
            jm.record_moe_stats(s)
            tm.record_moe_stats(s)
        assert tm.moe_metrics() == jm.moe_metrics()
        assert tm.moe_metrics()["moe_dispatch_overflow_tokens_total"] == (
            stats[0]["moe_dispatch_overflow_tokens_total"] + 3.0)
        frag = tmetrics._exporters["moe"]()
        assert frag == jmetrics._exporters["moe"]()
        assert "hvd_moe_dispatch_dropped_token_frac 0.25" in frag
    finally:
        for lib in (jm, tm):
            with lib._moe_metrics_lock:
                lib._moe_metrics.clear()
        junreg("moe")
        tmetrics.unregister_exporter("moe")


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2], sys.argv[3], sys.argv[4])
