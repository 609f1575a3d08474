"""The port's data-parallel gradient plane against the JAX package, on a
gloo world of 2 processes (run once for the file by a module fixture):

- the dp ``make_train_step`` against JAX ``make_train_step`` on a dp=2
  mesh of virtual CPU devices: the same f32 tiny-config parameters
  (JAX's, bridged by ``params_from_jax``), the same global [4, 33] token
  batch, ten AdamW steps, with ``sp_attention`` "flash" (its plain
  version on the CPU) and "ring". The loss trajectory is held to rtol
  2e-5, as ``tests/test_torch_train_step.py`` holds the single-device
  one (summation order only); the ranks' parameters must be bitwise
  equal. Adam's first steps barely see the gradients' scale, so one
  more run takes plain SGD on both sides: there a Sum in place of the
  Average doubles every update and leaves the tolerance at once;
- ``DistributedOptimizer(backward_passes_per_step=2)`` against JAX
  ``distributed_optimizer``: SGD (lr 1, momentum 0.9, whose first
  update is the gradient itself) on per-rank, per-microbatch,
  per-element gradients on a grid of quarters, so that the boundary
  update is exactly ``-(g1 + g2)`` averaged over the ranks, bitwise,
  and the mean or the last microbatch, or a sum over the ranks, would
  each give another one;
- ``distributed_value_and_grad``, ``broadcast_parameters`` from a
  nonzero root, ``broadcast_object``/``allgather_object``,
  ``sync_batch_norm`` and its gradients with respect to the input,
  scale and bias against ``horovod_tpu.jax.sync_batch_norm`` under
  ``jax.grad`` (rtol 1e-5, atol 1e-6 for the forward and 1e-5 for the
  gradients: f32 sums over 16 rows), and
  ``make_sp_attention`` on an sp=1 mesh against no mesh (bitwise).

The workers run this file as a script (``--worker``) and load torch,
numpy and the port only.
"""

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

N = 2
STEPS = 10
IMPLS = ("flash", "ring")
SGD_LR = 0.5
SP_IMPLS = ("flash", "local", "ring", "ring_flash", "ulysses")


def _tokens():
    return np.random.default_rng(1).integers(0, 256, (4, 33)).astype(
        np.int32)


def _bn_input():
    return np.random.default_rng(2).standard_normal((16, 5, 3)).astype(
        np.float32)


def _bn_weight():
    return np.random.default_rng(5).standard_normal((16, 5, 3)).astype(
        np.float32)


_BN_SCALE, _BN_BIAS = [1.5, 2.0, 0.5], [0.1, -0.2, 0.0]


def _acc_grads():
    """[rank, microbatch, element] gradients, multiples of 1/4 in
    [-4, 4]: every sum and the halving below are exact in f32."""
    return (np.random.default_rng(4).integers(-16, 17, (N, 2, 8)) / 4
            ).astype(np.float32)


def _worker(store, out, params_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from horovod_tpu_torch import binding
    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.parallel.mesh import build_mesh, init_process_group
    from horovod_tpu_torch.parallel.ring_attention import make_sp_attention

    device = init_process_group("cpu", init_method=f"file://{store}",
                                timeout=120)
    rank = dist.get_rank()
    mesh = build_mesh(dp=N)
    res = {}

    with np.load(params_path) as z:
        flat = {k: z[k] for k in z.files}
    tree = {"layers": {}}
    for k, v in flat.items():
        top, _, sub = k.partition(".")
        (tree["layers"].__setitem__(sub, v) if top == "layers"
         else tree.__setitem__(top, v))
    tokens = ttr.shard_batch(torch.from_numpy(_tokens()), mesh)
    runs = [(impl, impl, None) for impl in IMPLS] + [
        ("sgd", "flash", lambda ps: torch.optim.SGD(ps, lr=SGD_LR))]
    for name, impl, optimizer in runs:
        cfg = ttr.TransformerConfig.tiny(sp_attention=impl,
                                         dtype=torch.float32, remat=False)
        init_state, step = ttr.make_train_step(cfg, device, optimizer,
                                               mesh=mesh)
        state = init_state(params=ttr.params_from_jax(tree, device))
        calls = collectives.grouped_allreduce.calls
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, {"tokens": tokens})
            losses.append(loss.item())
        res[f"train-{name}"] = {
            "losses": losses, "rows": tokens.shape[0],
            "grouped_calls": collectives.grouped_allreduce.calls - calls,
            "params": [p.detach().numpy().copy()
                       for p in ttr.param_leaves(state["params"])]}

    # backward_passes_per_step=2: two microbatches, then one step on the
    # sum; and N=3 held after one pass.
    g = torch.from_numpy(_acc_grads()[rank])

    def sgd(w):
        return torch.optim.SGD([w], lr=1.0, momentum=0.9)

    w = torch.arange(8.0, requires_grad=True)
    acc = binding.DistributedOptimizer(sgd(w), backward_passes_per_step=2)
    trace = []
    for mb in range(2):
        w.grad = g[mb].clone()
        acc.step()
        trace.append((w.detach().clone().numpy(), len(acc.state),
                      acc.count))
    w_ref = torch.arange(8.0, requires_grad=True)
    ref = binding.DistributedOptimizer(sgd(w_ref))
    w_ref.grad = g.sum(0)
    ref.step()
    w_hold = torch.zeros(8, requires_grad=True)
    hold = binding.DistributedOptimizer(sgd(w_hold),
                                        backward_passes_per_step=3)
    w_hold.grad = g[0].clone()
    hold.step()
    res["accumulate"] = {"trace": trace, "ref": w_ref.detach().numpy(),
                         "hold": (w_hold.detach().numpy(), len(hold.state),
                                  hold.count)}

    def loss_fn(p, xs):
        return (p["w"] * xs).sum() + p["b"] * xs.sum(), xs.max()

    dvg = binding.distributed_value_and_grad(loss_fn, has_aux=True)
    p0 = {"w": torch.full((4,), 2.0), "b": torch.tensor(0.5)}
    xs = torch.arange(4.0) + 10 * rank
    (value, aux), grads = dvg(p0, xs)
    res["value_and_grad"] = {
        "value": value.item(), "aux": aux.item(),
        "grads": {k: v.numpy() for k, v in grads.items()},
        "untouched": not p0["w"].requires_grad}

    params = {"a": torch.full((3,), float(rank)),
              "b": [torch.arange(2) * (rank + 1), torch.tensor(rank == 1)]}
    a_before = params["a"]
    got = binding.broadcast_parameters(params, root_rank=1)
    res["broadcast_parameters"] = {
        "same_tree": got is params and got["a"] is a_before,
        "a": got["a"].numpy(), "b0": got["b"][0].numpy(),
        "b1": got["b"][1].item()}
    res["objects"] = {
        "broadcast": binding.broadcast_object({"from": rank}, root_rank=1),
        "allgather": binding.allgather_object(("rank", rank))}

    rows = slice(8 * rank, 8 * (rank + 1))
    xb = torch.from_numpy(_bn_input()[rows]).requires_grad_(True)
    scale = torch.tensor(_BN_SCALE, requires_grad=True)
    bias = torch.tensor(_BN_BIAS, requires_grad=True)
    y, mean, var = binding.sync_batch_norm(xb, scale=scale, bias=bias)
    (y * torch.from_numpy(_bn_weight()[rows])).sum().backward()
    res["sync_batch_norm"] = {
        "y": y.detach().numpy(), "mean": mean.detach().numpy(),
        "var": var.detach().numpy(), "dx": xb.grad.numpy(),
        "dscale": scale.grad.numpy(), "dbias": bias.grad.numpy()}

    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, 16, 4, 16), generator=gen) for _ in range(3))
    res["sp1"] = {impl: torch.equal(make_sp_attention(mesh, impl=impl)(q, k, v),
                                    make_sp_attention(None, impl=impl)(q, k, v))
                  for impl in SP_IMPLS}
    # Sequence parallelism is ported: on an sp mesh the ring runs over
    # the world, and the sp=1 kernel ("flash") raises, naming ring_flash.
    sp_mesh = init_device_mesh("cpu", (N,), mesh_dim_names=("sp",))
    res["sp2_ring"] = make_sp_attention(sp_mesh, impl="ring")(q, k, v).shape
    try:
        make_sp_attention(sp_mesh, impl="flash")
        res["sp2"] = "no error"
    except NotImplementedError as e:
        res["sp2"] = str(e)
    dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def jax_params():
    import jax

    from horovod_tpu.models import transformer as jtr

    cfg = jtr.TransformerConfig.tiny(dtype=np.float32, remat=False)
    return jax.tree.map(np.asarray,
                        jtr.init_params(cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_params):
    tmp = str(tmp_path_factory.mktemp("dp"))
    flat = {("layers." + k if top == "layers" else top): v
            for top, sub in jax_params.items()
            for k, v in (sub.items() if top == "layers" else [(top, sub)])}
    path = os.path.join(tmp, "params.npz")
    np.savez(path, **flat)
    return run_world(N, tmp, os.path.abspath(__file__), args=(path,))


def _dp_mesh():
    import jax

    from horovod_tpu.parallel import build_mesh
    return build_mesh(devices=jax.devices()[:N], dp=N)


@pytest.mark.parametrize("impl", IMPLS)
def test_train_step_matches_jax_dp_mesh(ranks, jax_params, impl):
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jtr

    cfg = jtr.TransformerConfig.tiny(sp_attention=impl, dtype=jnp.float32,
                                     remat=False)
    init_state, jit_step, _ = jtr.make_train_step(cfg, _dp_mesh())
    state = init_state(jax.random.PRNGKey(0))
    for a, b in zip(jax.tree.leaves(state["params"]),
                    jax.tree.leaves(jax_params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    want = []
    for _ in range(STEPS):
        state, loss = jit_step(state, {"tokens": jnp.asarray(_tokens())})
        want.append(float(loss))

    runs = [r[f"train-{impl}"] for r in ranks]
    for run in runs:
        assert run["rows"] == 2 and run["grouped_calls"] == STEPS
        assert run["losses"][-1] < run["losses"][0]
        np.testing.assert_allclose(run["losses"], want, rtol=2e-5)
    for a, b in zip(runs[0]["params"], runs[1]["params"]):
        assert a.tobytes() == b.tobytes()


def test_accumulation_matches_jax_and_one_step_on_the_sum(ranks):
    """Mirrors tests/test_jax_optimizer.py's in-jit accumulation test:
    N=2 microbatches give exactly the update of one step on the summed
    gradients, averaged over the ranks, and nothing moves before the
    boundary."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    import horovod_tpu.jax as hvd
    from horovod_tpu.common.jax_compat import shard_map

    g = _acc_grads()
    w0 = np.arange(8.0, dtype=np.float32)
    exact = w0 - g.sum(axis=(0, 1)) * np.float32(1 / N)
    for wrong in (g.mean(axis=(0, 1)), g[:, 1].mean(axis=0),
                  g.sum(axis=(0, 1))):
        assert not np.any(w0 - wrong == exact)
    params = {"w": jnp.asarray(w0)}
    opt_acc = hvd.distributed_optimizer(optax.sgd(1.0, momentum=0.9),
                                        axis_name="dp",
                                        backward_passes_per_step=2)

    def acc_run(gs):
        state, p = opt_acc.init(params), params
        for mb in range(2):
            updates, state = opt_acc.update({"w": gs[0, mb]}, state, p)
            p = optax.apply_updates(p, updates)
        return p

    want = jax.jit(shard_map(acc_run, mesh=_dp_mesh(), in_specs=(P("dp"),),
                             out_specs=P()))(jnp.asarray(g))["w"]
    np.testing.assert_array_equal(np.asarray(want), exact)
    for r in ranks:
        acc = r["accumulate"]
        (w1, state1, count1), (w2, state2, count2) = acc["trace"]
        np.testing.assert_array_equal(w1, w0)
        assert (state1, count1) == (0, 1) and (state2, count2) == (1, 0)
        np.testing.assert_array_equal(w2, exact)
        np.testing.assert_array_equal(acc["ref"], exact)
        w_hold, state_hold, count_hold = acc["hold"]
        np.testing.assert_array_equal(w_hold, 0.0)
        assert (state_hold, count_hold) == (0, 1)


def test_sgd_train_step_averages_gradients_like_jax(ranks, jax_params):
    """Plain SGD moves each step by the gradient itself, so the loss
    trajectory shows the gradients' scale: a Sum across the two ranks
    would double every update."""
    import jax
    import jax.numpy as jnp
    import optax

    from horovod_tpu.models import transformer as jtr

    cfg = jtr.TransformerConfig.tiny(sp_attention="flash", dtype=jnp.float32,
                                     remat=False)
    init_state, jit_step, _ = jtr.make_train_step(cfg, _dp_mesh(),
                                                  optax.sgd(SGD_LR))
    state = init_state(jax.random.PRNGKey(0))
    want = []
    for _ in range(STEPS):
        state, loss = jit_step(state, {"tokens": jnp.asarray(_tokens())})
        want.append(float(loss))

    runs = [r["train-sgd"] for r in ranks]
    for run in runs:
        assert run["grouped_calls"] == STEPS
        assert run["losses"][-1] < run["losses"][0]
        np.testing.assert_allclose(run["losses"], want, rtol=2e-5)
    for a, b in zip(runs[0]["params"], runs[1]["params"]):
        assert a.tobytes() == b.tobytes()


def test_value_and_grad_reduces_gradients_keeps_local_value(ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import horovod_tpu.jax as hvd
    from horovod_tpu.common.jax_compat import shard_map

    def loss_fn(p, xs):
        return (p["w"] * xs).sum() + p["b"] * xs.sum()

    dvg = hvd.distributed_value_and_grad(loss_fn, axis_name="dp")
    p0 = {"w": jnp.full(4, 2.0), "b": jnp.float32(0.5)}
    xs = np.stack([np.arange(4.0) + 10 * r for r in range(N)]).astype(
        np.float32)
    _, want = jax.jit(shard_map(lambda p, x: dvg(p, x[0]), mesh=_dp_mesh(),
                                in_specs=(P(), P("dp")),
                                out_specs=(P(), P())))(p0, xs)
    for r, got in enumerate(ranks):
        vg = got["value_and_grad"]
        assert vg["value"] == pytest.approx(float(
            (2.0 * xs[r]).sum() + 0.5 * xs[r].sum()))
        assert vg["aux"] == xs[r].max() and vg["untouched"]
        for k in ("w", "b"):
            np.testing.assert_allclose(vg["grads"][k], np.asarray(want[k]),
                                       rtol=1e-6)


def test_broadcast_parameters_and_objects_from_root_1(ranks):
    for r in ranks:
        bp = r["broadcast_parameters"]
        assert bp["same_tree"]
        np.testing.assert_array_equal(bp["a"], 1.0)
        np.testing.assert_array_equal(bp["b0"], [0, 2])
        assert bp["b1"] is True
        assert r["objects"] == {"broadcast": {"from": 1},
                                "allgather": [("rank", 0), ("rank", 1)]}


def test_sync_batch_norm_matches_jax(ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import horovod_tpu.jax as hvd_jax
    from horovod_tpu.common.jax_compat import shard_map

    def f(xs, scale, bias):
        return hvd_jax.sync_batch_norm(xs, axis_name="dp", scale=scale,
                                       bias=bias)

    args = (jnp.asarray(_bn_input()), jnp.asarray(_BN_SCALE),
            jnp.asarray(_BN_BIAS))
    y, mean, var = jax.jit(shard_map(
        f, mesh=_dp_mesh(), in_specs=(P("dp"), P(), P()),
        out_specs=(P("dp"), P(), P())))(*args)

    def rank_losses(xs, scale, bias, w):
        return (f(xs, scale, bias)[0] * w).sum()[None]

    def loss(xs, scale, bias, w):
        # Each rank's sum(y * w), added up: the gradient each rank's own
        # backward computes, with scale and bias summed over the ranks.
        return shard_map(rank_losses, mesh=_dp_mesh(),
                         in_specs=(P("dp"), P(), P(), P("dp")),
                         out_specs=P("dp"))(xs, scale, bias, w).sum()

    dx, dscale, dbias = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *args, jnp.asarray(_bn_weight()))
    for r, got in enumerate(ranks):
        bn = got["sync_batch_norm"]
        rows = slice(8 * r, 8 * (r + 1))
        np.testing.assert_allclose(bn["y"], np.asarray(y)[rows],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(bn["mean"], np.asarray(mean), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(bn["var"], np.asarray(var), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(bn["dx"], np.asarray(dx)[rows],
                                   rtol=1e-5, atol=1e-5)
    for key, want in (("dscale", dscale), ("dbias", dbias)):
        np.testing.assert_allclose(
            sum(got["sync_batch_norm"][key] for got in ranks),
            np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", SP_IMPLS)
def test_sp1_mesh_attention_equals_no_mesh(ranks, impl):
    for r in ranks:
        assert r["sp1"][impl] is True


def test_sp2_mesh_attention_raises_naming_item_10(ranks):
    """Item 10 (sequence parallelism) is ported: the ring runs on an
    sp=2 mesh; what still raises there is the sp=1 kernel, naming the
    ring_flash impl that puts it in the ring."""
    for r in ranks:
        assert r["sp2_ring"] == (2, 16, 4, 16)
        assert "ring_flash" in r["sp2"]


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2], sys.argv[3], sys.argv[4])
