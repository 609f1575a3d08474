"""The port's ResNet (``horovod_tpu_torch.models.resnet``) against the JAX
package's flax ResNet, on the CPU, on the same weights: the flax
variables, bridged by ``params_from_jax``, and the same images and
labels, drawn from a numpy seed.

Every flax BatchNorm scale, bias and running statistic is redrawn from
the seed before the comparison (flax starts each bottleneck's last BN
scale at zero, which would cut every residual branch, and with it the
stride-2 3x3 convs, out of the logits and most gradients).

- A tiny config (``stage_sizes=(1, 1)``, width 8, 10 classes, 4 images
  of 32x32, f32): stage 2's stride-2 3x3 conv sees an even (8x8) input,
  so XLA's asymmetric ``SAME`` padding shows. Logits, loss, every
  gradient and the running statistics after one train-mode step are
  held to rtol 1e-5 with atol 1e-6 (for entries near zero; the largest
  are ~1). Two SGD-momentum steps are held against
  ``optax.sgd(0.01, momentum=0.9)``, the momentum buffer against optax's
  trace, at the same tolerance.
- A world of 2 gloo processes runs the data-parallel step on its halves
  of an 8-image batch; its loss, averaged gradients and running
  statistics are held against the JAX step on the whole batch (global
  BatchNorm statistics, gradient mean) at the same tolerance, and the
  ranks' states must be bitwise equal.
- The real ``resnet50(num_classes=10)`` structure at 2 images of 64x64
  (one module fixture): the bridge's names on all 16 blocks, and logits,
  loss, gradients and running statistics. Its reference runs in f64:
  the JAX package's f32 backward on this CPU drifts from its own f64
  one by up to 2.2e-1 of a leaf's largest gradient (at
  ``Bottleneck_6.Conv_0``), where the port's f32 stays within 8e-6, so
  the port's f32 results are held to the f64 reference: logits and loss
  at rtol 1e-4, gradients within 2e-5 of each leaf's largest entry,
  running statistics at rtol 1e-5 with atol 1e-6.
- The bench's arms at a tiny size on a gloo world of 1 give the
  reference's primary line.

Each parity test fails if the stride-2 conv pads symmetrically or if
the running variance takes the unbiased batch variance.

The workers of the world of 2 run this file as a script (``--worker``)
and load torch, numpy and the port only.
"""

import json
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

TINY = dict(stage_sizes=(1, 1), num_classes=10, width=8)
RTOL, ATOL = 1e-5, 1e-6
LR = 0.01


def _data(seed, batch, size, classes):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    y = rng.integers(0, classes, (batch,)).astype(np.int32)
    return x, y


def _tiny_configs(dtype="float32"):
    import jax.numpy as jnp

    from horovod_tpu.models import resnet as jr
    from horovod_tpu_torch.models import resnet as tr
    return (jr.ResNetConfig(dtype=getattr(jnp, dtype), **TINY),
            tr.ResNetConfig(dtype=getattr(torch, dtype), **TINY))


def _flax_variables(cfg_j, x, seed, last_scale=(0.5, 1.5)):
    """flax's init, then every BN scale, bias and running statistic
    redrawn from ``seed`` (each bottleneck's last scale from
    ``last_scale``)."""
    import jax

    from horovod_tpu.models import resnet as jr

    model = jr.ResNet(cfg_j)
    v = jax.jit(lambda k, xx: model.init(k, xx, train=True))(
        jax.random.PRNGKey(seed), x)
    rng = np.random.default_rng(seed)

    def redraw(path, a):
        a = np.asarray(a, np.float32)
        name, owner = path[-1].key, path[-2].key
        if name == "scale":
            lo, hi = last_scale if owner == "BatchNorm_2" else (0.8, 1.2)
            return rng.uniform(lo, hi, a.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a

    v = jax.tree_util.tree_map_with_path(redraw, v)
    return v["params"], v["batch_stats"]


def _jax_step(cfg_j, params, batch_stats, x, y):
    """The reference bench's loss on ``(x, y)``: ``(loss, logits,
    grads, new batch_stats)`` as numpy."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import resnet as jr

    model = jr.ResNet(cfg_j)

    def loss_fn(p, bs):
        logits, upd = model.apply({"params": p, "batch_stats": bs}, x,
                                  train=True, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits)
        loss = -jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                    axis=-1).mean()
        return loss, (logits, upd["batch_stats"])

    (loss, (logits, new_bs)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params, batch_stats)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return float(loss), np.asarray(logits), to_np(grads), to_np(new_bs)


def _torch_step(cfg_t, params, batch_stats, x, y):
    from horovod_tpu_torch.models import resnet as tr

    model = tr.ResNet(cfg_t, device="cpu")
    model.load_state_dict(tr.params_from_jax(params, batch_stats,
                                             device="cpu"))
    logits = model(torch.from_numpy(x), train=True)
    loss = tr.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    return model, loss.item(), logits.detach().numpy()


def _close(got, want, err_msg="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=err_msg)


# ---------------------------------------------------------------------------
# the tiny config
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg_j, cfg_t = _tiny_configs()
    x, y = _data(0, 4, 32, TINY["num_classes"])
    params, bs = _flax_variables(cfg_j, x, 0)
    want = _jax_step(cfg_j, params, bs, x, y)
    model, loss, logits = _torch_step(cfg_t, params, bs, x, y)
    return {"want": want, "model": model, "loss": loss, "logits": logits,
            "params": params, "bs": bs, "x": x, "y": y}


@pytest.mark.parametrize("size,kernel,stride", [
    (8, 3, 2), (7, 3, 2), (56, 3, 2), (14, 1, 2), (9, 3, 1), (224, 7, 2),
    (5, 3, 3)])
def test_same_padding_matches_xla(size, kernel, stride):
    from jax import lax

    from horovod_tpu_torch.models.resnet import same_padding

    want = lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0]
    assert same_padding(size, kernel, stride) == tuple(want)


def test_tiny_logits_and_loss_match_flax(tiny):
    loss, logits, _, _ = tiny["want"]
    _close(tiny["logits"], logits, "logits")
    _close(tiny["loss"], loss, "loss")


def test_tiny_gradients_match_flax(tiny):
    from horovod_tpu_torch.models import resnet as tr

    want = tr.params_from_jax(tiny["want"][2], device="cpu")
    named = dict(tiny["model"].named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        _close(p.grad, want[name], name)


def test_tiny_running_statistics_match_flax(tiny):
    from horovod_tpu_torch.models import resnet as tr

    want = tr.params_from_jax({}, tiny["want"][3], device="cpu")
    state = tiny["model"].state_dict()
    assert len(want) == 2 * 9    # stem + 2 blocks x 4 BNs, mean and var
    for name, w in want.items():
        _close(state[name], w, name)


def test_tiny_eval_mode_uses_the_running_statistics(tiny):
    import jax

    from horovod_tpu.models import resnet as jr
    from horovod_tpu_torch.models import resnet as tr

    cfg_j, cfg_t = _tiny_configs()
    want = jr.ResNet(cfg_j).apply(
        {"params": tiny["params"], "batch_stats": tiny["bs"]}, tiny["x"],
        train=False)
    model = tr.ResNet(cfg_t, device="cpu")
    model.load_state_dict(tr.params_from_jax(tiny["params"], tiny["bs"],
                                             device="cpu"))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        got = model(torch.from_numpy(tiny["x"]), train=False)
    _close(got, np.asarray(jax.device_get(want)), "eval logits")
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_sgd_momentum_matches_optax(tiny):
    """Two steps: torch's momentum buffer is ``g`` after the first and
    ``0.9·buf + g`` after the second, optax's trace the same from
    zero."""
    import jax
    import optax

    from horovod_tpu.models import resnet as jr
    from horovod_tpu_torch.models import resnet as tr

    cfg_j, cfg_t = _tiny_configs()
    x, y = tiny["x"], tiny["y"]
    model = jr.ResNet(cfg_j)

    def loss_fn(p, bs):
        logits, upd = model.apply({"params": p, "batch_stats": bs}, x,
                                  train=True, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits)
        return -jax.numpy.take_along_axis(
            logp, jax.numpy.asarray(y)[:, None], axis=-1).mean(), \
            upd["batch_stats"]

    opt = optax.sgd(LR, momentum=0.9)
    params, bs = tiny["params"], tiny["bs"]
    opt_state = opt.init(params)
    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    for _ in range(2):
        grads, bs = grad_fn(params, bs)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

    init_state, step = tr.make_train_step(cfg_t, "cpu")
    state = init_state(state_dict=tr.params_from_jax(tiny["params"],
                                                     tiny["bs"], device="cpu"))
    batch = {"images": torch.from_numpy(x), "labels": torch.from_numpy(y)}
    for _ in range(2):
        state, _ = step(state, batch)
    model_t, opt_t = state["model"], state["opt"]
    got = model_t.state_dict()
    for name, w in tr.params_from_jax(jax.device_get(params),
                                      jax.device_get(bs),
                                      device="cpu").items():
        _close(got[name], w, name)
    trace = tr.params_from_jax(jax.device_get(opt_state[0].trace),
                               device="cpu")
    for name, p in model_t.named_parameters():
        _close(opt_t.state[p]["momentum_buffer"], trace[name],
               f"momentum buffer of {name}")


def test_init_params_has_flax_layout_and_initialisers():
    import jax

    from horovod_tpu.models import resnet as jr
    from horovod_tpu_torch.models import resnet as tr

    cfg_j, cfg_t = _tiny_configs()
    x, _ = _data(0, 2, 32, 10)
    shapes = jax.eval_shape(lambda: jr.ResNet(cfg_j).init(
        jax.random.PRNGKey(0), x, train=True))
    want = tr.params_from_jax(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                     shapes["params"]),
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                     shapes["batch_stats"]), device="cpu")
    got = tr.init_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    for k, v in got.items():
        if k.endswith("BatchNorm_2.scale") or k.endswith((".bias", ".mean")):
            assert not v.any(), k
        elif k.endswith((".scale", ".var")):
            assert torch.equal(v, torch.ones_like(v)), k
        else:
            fan_in = np.prod(v.shape[1:])
            bound = 2 * fan_in ** -0.5 / 0.87962566103423978
            assert v.abs().max() <= bound + 1e-6 and v.std() > 0, k


def test_forward_flops_count_every_conv_and_the_dense_layer():
    """:func:`forward_flops` against the convs and the dense layer that a
    ``resnet50`` forward actually runs (their output shapes, read by
    hooks on the meta device): 2·Cin·Cout·k²·H·W and 2·in·out."""
    from horovod_tpu_torch.models import resnet as tr

    model = tr.resnet50(dtype=torch.float32, device="meta")
    counted = []

    def conv_hook(mod, args, out):
        cout, cin, k, _ = mod.weight.shape
        counted.append(2 * cin * cout * k * k * out.shape[2] * out.shape[3])

    for m in model.modules():
        if isinstance(m, tr.Conv):
            m.register_forward_hook(conv_hook)
    model.Dense_0.register_forward_hook(
        lambda m, a, o: counted.append(2 * m.in_features * m.out_features))
    model(torch.empty((1, 224, 224, 3), device="meta"), train=False)
    assert len(counted) == 1 + 16 * 3 + 4 + 1
    assert tr.forward_flops(model.cfg) == sum(counted) == 8_178_368_512


# ---------------------------------------------------------------------------
# a data-parallel world of 2
# ---------------------------------------------------------------------------

DP_BATCH = 8


def _worker(store, out, path):
    import torch.distributed as dist

    from horovod_tpu_torch.models import resnet as tr
    from horovod_tpu_torch.parallel.mesh import build_mesh, init_process_group

    init_process_group("cpu", init_method=f"file://{store}", timeout=120)
    rank, n = dist.get_rank(), dist.get_world_size()
    mesh = build_mesh(dp=n)
    with np.load(path) as z:
        sd = {k[3:]: torch.from_numpy(z[k]) for k in z.files
              if k.startswith("sd.")}
        x, y = z["x"], z["y"]
    rows = x.shape[0] // n
    cfg = tr.ResNetConfig(dtype=torch.float32, **TINY)
    init_state, step = tr.make_train_step(cfg, "cpu", mesh=mesh)
    state = init_state(state_dict=sd)
    state, loss = step(state, {
        "images": torch.from_numpy(x[rank * rows:(rank + 1) * rows]),
        "labels": torch.from_numpy(y[rank * rows:(rank + 1) * rows])})
    model = state["model"]
    res = {"loss": float(loss),
           "grads": {k: p.grad.numpy() for k, p in
                     model.named_parameters()},
           "state": {k: v.numpy() for k, v in model.state_dict().items()}}
    with open(out, "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    from horovod_tpu_torch.models import resnet as tr

    tmp = str(tmp_path_factory.mktemp("resnet_dp"))
    cfg_j, _ = _tiny_configs()
    x, y = _data(2, DP_BATCH, 32, TINY["num_classes"])
    params, bs = _flax_variables(cfg_j, x, 2)
    path = os.path.join(tmp, "inputs.npz")
    sd = tr.params_from_jax(params, bs, device="cpu")
    np.savez(path, x=x, y=y, **{f"sd.{k}": v.numpy() for k, v in sd.items()})
    ranks = run_world(2, tmp, os.path.abspath(__file__), (path,))
    return ranks, _jax_step(cfg_j, params, bs, x, y), params


def test_dp_world_of_2_matches_jax_on_the_whole_batch(dp):
    from horovod_tpu_torch.models import resnet as tr

    ranks, (loss, _, grads, new_bs), params = dp
    want_grads = tr.params_from_jax(grads, device="cpu")
    want_state = tr.params_from_jax(params, new_bs, device="cpu")
    for name, g in want_grads.items():   # the SGD step from the mean
        want_state[name] = want_state[name] - LR * g
    for r in ranks:
        _close(r["loss"], loss, "loss")
        for name, g in want_grads.items():
            _close(r["grads"][name], g, f"grad {name}")
        for name, w in want_state.items():
            _close(r["state"][name], w, name)
    for name, v in ranks[0]["state"].items():
        assert np.array_equal(v, ranks[1]["state"][name]), name


# ---------------------------------------------------------------------------
# the resnet50 structure
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def r50():
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import resnet as jr
    from horovod_tpu_torch.models import resnet as tr

    x, y = _data(3, 2, 64, 10)
    params, bs = _flax_variables(jr.ResNetConfig(num_classes=10,
                                                 dtype=jnp.float32),
                                 x, 3, last_scale=(0.0, 0.2))
    with jax.enable_x64(True):
        to64 = lambda t: jax.tree.map(  # noqa: E731
            lambda a: np.asarray(a, np.float64), t)
        want = _jax_step(jr.ResNetConfig(num_classes=10, dtype=jnp.float64),
                         to64(params), to64(bs), x.astype(np.float64), y)
    model, loss, logits = _torch_step(
        tr.ResNetConfig(num_classes=10, dtype=torch.float32), params, bs,
        x, y)
    return {"want": want, "model": model, "loss": loss, "logits": logits,
            "params": params}


def test_resnet50_bridge_names_every_block(r50):
    from horovod_tpu_torch.models import resnet as tr

    blocks = [k for k in r50["params"] if k.startswith("Bottleneck_")]
    assert sorted(blocks, key=lambda k: int(k.split("_")[1])) == [
        f"Bottleneck_{i}" for i in range(16)]
    want = tr.params_from_jax(r50["params"], r50["want"][3], device="cpu")
    got = r50["model"].state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
    assert {k.split(".")[0] for k in got if ".proj." in k} == {
        "Bottleneck_0", "Bottleneck_3", "Bottleneck_7", "Bottleneck_13"}


def test_resnet50_logits_and_loss_match_flax(r50):
    loss, logits, _, _ = r50["want"]
    _close(r50["logits"], logits, "logits", rtol=1e-4)
    _close(r50["loss"], loss, "loss", rtol=1e-4)


def test_resnet50_gradients_match_flax(r50):
    from horovod_tpu_torch.models import resnet as tr

    want = tr.params_from_jax(r50["want"][2], device="cpu")
    for name, p in r50["model"].named_parameters():
        w = want[name].double().numpy()
        _close(p.grad, w, name, rtol=0, atol=2e-5 * np.abs(w).max())


def test_resnet50_running_statistics_match_flax(r50):
    from horovod_tpu_torch.models import resnet as tr

    want = tr.params_from_jax({}, r50["want"][3], device="cpu")
    state = r50["model"].state_dict()
    assert len(want) == 2 * (1 + 16 * 3 + 4)
    for name, w in want.items():
        _close(state[name], w, name)


# ---------------------------------------------------------------------------
# the bench entry
# ---------------------------------------------------------------------------

def test_bench_prints_the_reference_primary_line(monkeypatch):
    """The bench's two arms at a tiny size on a gloo world of 1, and the
    primary line ``main`` prints from them."""
    import torch.distributed as dist

    from horovod_tpu_torch import bench
    from horovod_tpu_torch.models import resnet as tr
    from horovod_tpu_torch.models.transformer import TransformerConfig
    from horovod_tpu_torch.parallel.mesh import (data_parallel_mesh,
                                                 init_process_group)

    for k in list(os.environ):
        if k.startswith(("HOROVOD_", "MASTER_", "OMPI_", "PMI_", "BENCH_")):
            monkeypatch.delenv(k)
    device = init_process_group("cpu")
    try:
        mesh = data_parallel_mesh()
        r50 = bench.run_resnet(mesh, device, tr.ResNetConfig(
            (1, 1), num_classes=10, width=8), image_size=32, batch=2,
            warmup=1, rounds=1, iters=2)
        tiny = TransformerConfig.tiny(dtype=torch.float32,
                                      sp_attention="flash", remat=False)
        extra = bench.run(mesh, device, (("transformer_std", tiny),
                                         ("transformer", tiny)),
                          batch_per_gpu=1, seq=16, warmup=1, iters=1)
    finally:
        dist.destroy_process_group()
    assert len(r50["losses"]) == 3 and r50["batch"] == 2
    line = json.loads(json.dumps(bench.primary_line(
        r50["images_per_sec_per_gpu"], extra)))
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "extra"]
    assert line["metric"] == "resnet50_images_per_sec_per_chip"
    assert line["unit"] == "images/sec" and line["value"] > 0
    # The bench's and the reference's formula: the unrounded rate over
    # the baseline (the rounded value can round to another third place).
    assert line["vs_baseline"] == round(r50["images_per_sec_per_gpu"] / 207.0,
                                        3)
    assert set(line["extra"]) == {"transformer_std_tokens_per_sec_per_chip",
                                  "transformer_tokens_per_sec_per_chip"}


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2], sys.argv[3], sys.argv[4])
