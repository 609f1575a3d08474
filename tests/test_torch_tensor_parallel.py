"""The port's tensor and sequence parallelism against the JAX package, on
gloo worlds of 2 and 4 processes (each run once for the file by a module
fixture), with the f32 tiny config (2 layers, d_model 64, 4 query and 2
kv heads) and JAX's parameters bridged by ``params_from_jax``:

- ``embed_lookup`` on tp=2 x fsdp=2: the vocab-parallel island (a
  32-row table, so each rank holds a [16, 8] tile) and the
  warn-and-replicate fallback (33 rows, held whole), each with the
  codecs none, bf16, fp16 and int8, against JAX's ``embed_lookup`` on a
  matching mesh of virtual CPU devices: each rank's rows, and the
  gradient of ``sum(rows * w)``: on the island's tile, that of the
  whole batch (the island all-gathers the tokens over fsdp); on the
  fallback's whole table, that of the rank's own rows (JAX's gradient
  of those rows' sum, as JAX accumulates it in the wire dtype);
- ``vocab_parallel_nll`` on the same mesh's tp group against JAX's f32
  ``log_softmax`` cross-entropy: per-token values and the gradient of
  their mean on this rank's vocabulary shard;
- two train steps of ``make_train_step(mesh=...)`` on tp=2, tp=4 (the
  flash path with n_kv_heads 2 < tp, so wk/wv are whole on every rank),
  dp=2 x tp=2, sp=2 x tp=2 (ring_flash), dp=2 x sp=2 (ring), sp=2
  (Ulysses), and the fsdp step composed with them, fsdp=2 x tp=2 and
  fsdp=2 x sp=2 (ring_flash), against JAX's ``make_train_step``
  (GSPMD) on the same mesh and ``sp_attention``, both with plain SGD
  at lr 0.5 (Adam's first
  steps are near ``-lr·sign(g)``, which hides a gradient's scale and
  turns one near its eps into any step in (-lr, lr)): the losses, and
  the parameters the port gathers.

Tolerances: the island and the codecs are exact arithmetic on both
sides (lookups, casts, ``q * scale``), held to 1e-6; the loss differs
from JAX's ``log_softmax`` in f32 summation order, held to 1e-6. The
steps' losses and parameters are held to rtol 2e-5, atol 1e-6 (the
sharded matmuls sum in another order: ~1e-7 relative on the
gradients). The ranks' gathered parameters must be bitwise equal.

The workers run this file as a script (``--worker``) and load torch,
numpy and the port only.
"""

import concurrent.futures
import functools
import os
import pickle
import sys
import warnings

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))

from test_torch_collectives import run_world  # noqa: E402

STEPS = 2
SGD_LR = 0.5
# (world, mesh axes, sp_attention) of every JAX-compared train run.
RUNS = [(2, (("tp", 2),), "ring"), (4, (("tp", 4),), "flash"),
        (4, (("dp", 2), ("tp", 2)), "ring"),
        (4, (("sp", 2), ("tp", 2)), "ring_flash"),
        (4, (("dp", 2), ("sp", 2)), "ring"), (2, (("sp", 2),), "ulysses"),
        (4, (("fsdp", 2), ("tp", 2)), "ring"),
        (4, (("fsdp", 2), ("sp", 2)), "ring_flash")]
AXES = ("dp", "fsdp", "pp", "sp", "tp", "ep")
CODECS = ("none", "bf16", "fp16", "int8")
EMBED_D = 16
EMBED_V = {"island": 32, "fallback": 33}
LOSS_V = 32


def _tokens(rows=4, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (rows, 33)).astype(
        np.int32)


def _embed_inputs(kind):
    rng = np.random.default_rng(7)
    v = EMBED_V[kind]
    table = rng.standard_normal((v, EMBED_D)).astype(np.float32)
    toks = rng.integers(0, v, (4, 8)).astype(np.int32)
    w = rng.standard_normal((4, 8, EMBED_D)).astype(np.float32)
    return table, toks, w


def _loss_inputs():
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((2, 6, LOSS_V)).astype(np.float32) * 3
    return logits, rng.integers(0, LOSS_V, (2, 6)).astype(np.int32)


# ---------------------------------------------------------------------------
# The port (worker side)
# ---------------------------------------------------------------------------

def _port_cfg(impl):
    from horovod_tpu_torch.models import transformer as ttr
    return ttr.TransformerConfig.tiny(dtype=torch.float32, sp_attention=impl)


def _train(params, tokens, axes, impl):
    """Losses, the gathered full parameters (numpy), the collective
    counters of the last step, and this rank's coordinates."""
    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.parallel import tensor_parallel as ttp
    from horovod_tpu_torch.parallel.mesh import axis_index, build_mesh

    cfg = _port_cfg(impl)
    mesh = build_mesh(**dict(axes))
    init_state, step = ttr.make_train_step(
        cfg, "cpu", lambda ps: torch.optim.SGD(ps, lr=SGD_LR), mesh=mesh)
    state = init_state(params=ttr.params_from_jax(params, "cpu"))
    local = {"tokens": ttr.shard_batch(torch.from_numpy(tokens), mesh)}
    losses = []
    for _ in range(STEPS):
        ttp.reset_counters()
        state, loss = step(state, local)
        losses.append(loss.item())
    counters = {k: dict(v) for k, v in ttp.counters.items()}
    full = ttr.gather_params(state, cfg, mesh)
    coords = {a: axis_index(mesh, a) for a in ("dp", "sp", "tp")}
    return (losses, ttr.map_params(lambda p: p.detach().numpy().copy(),
                                   full), counters, coords)


def _embed(kind, codec):
    """This rank's rows and its table gradient on tp=2 x fsdp=2."""
    from horovod_tpu_torch.compression import Compression
    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.parallel.mesh import axis_index, build_mesh

    mesh = build_mesh(fsdp=2, tp=2)
    f, t = axis_index(mesh, "fsdp"), axis_index(mesh, "tp")
    table, toks, w = _embed_inputs(kind)
    v = table.shape[0]
    if kind == "island":
        table = table[t * v // 2:(t + 1) * v // 2,
                      f * EMBED_D // 2:(f + 1) * EMBED_D // 2]
    piece = torch.from_numpy(table.copy()).requires_grad_(True)
    rows = slice(f * 2, (f + 1) * 2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = ttr.embed_lookup(piece, torch.from_numpy(toks[rows]).long(),
                               torch.float32, mesh,
                               compression=getattr(Compression, codec),
                               full_shape=(v, EMBED_D))
    (out * torch.from_numpy(w[rows])).sum().backward()
    return (out.detach().numpy(), piece.grad.numpy(), (f, t),
            any("not divisible" in str(c.message) for c in caught))


def _nll():
    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.parallel.mesh import (axis_index, build_mesh,
                                                 tp_group)

    mesh = build_mesh(fsdp=2, tp=2)
    t = axis_index(mesh, "tp")
    logits, tgt = _loss_inputs()
    shard = torch.from_numpy(
        logits[..., t * LOSS_V // 2:(t + 1) * LOSS_V // 2].copy())
    shard.requires_grad_(True)
    nll = ttr.vocab_parallel_nll(shard, torch.from_numpy(tgt),
                                 tp_group(mesh))
    nll.mean().backward()
    return nll.detach().numpy(), shard.grad.numpy(), t


def _worker(store, out, data):
    import torch.distributed as dist

    from horovod_tpu_torch.parallel.mesh import init_process_group

    with open(data, "rb") as f:
        d = pickle.load(f)
    init_process_group("cpu", init_method=f"file://{store}", timeout=120)
    n = dist.get_world_size()
    results = {}
    for world, axes, impl in RUNS:
        if world == n:
            results[(axes, impl)] = _train(d["params"], d["tokens"], axes,
                                           impl)
    if n == 4:
        for kind in EMBED_V:
            for codec in CODECS:
                results[("embed", kind, codec)] = _embed(kind, codec)
        results["nll"] = _nll()
    dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(results, f)


# ---------------------------------------------------------------------------
# The JAX side
# ---------------------------------------------------------------------------

def _jax_cfg(impl):
    import jax.numpy as jnp

    from horovod_tpu.models import TransformerConfig
    return TransformerConfig.tiny(dtype=jnp.float32, sp_attention=impl)


def _jax_params():
    import jax

    from horovod_tpu.models.transformer import init_params
    return jax.tree.map(np.asarray, init_params(_jax_cfg("ring"),
                                                jax.random.PRNGKey(0)))


def _mesh(**axes):
    import jax
    from jax.sharding import Mesh

    shape = [axes.get(a, 1) for a in AXES]
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), AXES)


def _jax_step(axes, impl):
    import jax
    import jax.numpy as jnp
    import optax

    from horovod_tpu.models import make_train_step

    init_state, step, _ = make_train_step(_jax_cfg(impl), _mesh(**dict(axes)),
                                          optax.sgd(SGD_LR))
    state = init_state(jax.random.PRNGKey(0))
    batch = {"tokens": jnp.asarray(_tokens())}
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state["params"])


@functools.lru_cache(maxsize=None)
def _jax_embed(kind, codec):
    """JAX's rows, and its gradients of ``sum(rows * w)`` over the whole
    batch and over each fsdp rank's two rows."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.compression import Compression
    from horovod_tpu.models.transformer import embed_lookup

    mesh = _mesh(fsdp=2, tp=2)
    table, toks, w = (jnp.asarray(a) for a in _embed_inputs(kind))
    comp = getattr(Compression, codec)

    def lookup(e):
        return embed_lookup(e, toks, jnp.float32, mesh, compression=comp)

    def grad(rows):
        return np.asarray(jax.jit(jax.grad(
            lambda e: jnp.sum(lookup(e)[rows] * w[rows])))(table))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = np.asarray(jax.jit(lookup)(table))
        return out, grad(slice(None)), [grad(slice(f * 2, (f + 1) * 2))
                                        for f in range(2)]


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tensor_parallel"))
    data = os.path.join(tmp, "data.pkl")
    with open(data, "wb") as f:
        pickle.dump({"params": _jax_params(), "tokens": _tokens()}, f)
    script = os.path.abspath(__file__)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        worlds = {n: pool.submit(run_world, n, tmp, script, (data,))
                  for n in (2, 4)}
        return {n: f.result() for n, f in worlds.items()}


def _leaves(tree):
    from horovod_tpu_torch.models.transformer import param_leaves
    return param_leaves(tree)


@pytest.mark.parametrize("kind", list(EMBED_V))
@pytest.mark.parametrize("codec", CODECS)
def test_embed_lookup_matches_jax(port_results, kind, codec):
    want_out, want_grad, want_rows_grad = _jax_embed(kind, codec)
    v = EMBED_V[kind]
    for res in port_results[4]:
        out, grad, (f, t), warned = res[("embed", kind, codec)]
        assert warned == (kind == "fallback")
        np.testing.assert_allclose(out, want_out[f * 2:(f + 1) * 2],
                                   rtol=1e-6, atol=1e-6)
        if kind == "island":
            want = want_grad[t * v // 2:(t + 1) * v // 2,
                             f * EMBED_D // 2:(f + 1) * EMBED_D // 2]
        else:
            want = want_rows_grad[f]
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(grad, want, rtol=1e-6, atol=1e-6)


def test_vocab_parallel_loss_matches_log_softmax(port_results):
    import jax
    import jax.numpy as jnp

    logits, tgt = (jnp.asarray(a) for a in _loss_inputs())

    def nll(z):
        logp = jax.nn.log_softmax(z, axis=-1)
        return -jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]

    want = np.asarray(nll(logits))
    want_grad = np.asarray(jax.grad(lambda z: nll(z).mean())(logits))
    for res in port_results[4]:
        got, grad, t = res["nll"]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            grad, want_grad[..., t * LOSS_V // 2:(t + 1) * LOSS_V // 2],
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world,axes,impl", RUNS)
def test_train_step_matches_jax(port_results, world, axes, impl):
    want_losses, want_params = _jax_step(axes, impl)
    for rank in port_results[world]:
        losses, params, _, _ = rank[(axes, impl)]
        np.testing.assert_allclose(losses, want_losses, rtol=2e-5)
        for g, w in zip(_leaves(params), _leaves(want_params)):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("world,axes,impl", RUNS)
def test_ranks_hold_equal_parameters(port_results, world, axes, impl):
    ranks = port_results[world]
    for rank in ranks[1:]:
        for g, w in zip(_leaves(rank[(axes, impl)][1]),
                        _leaves(ranks[0][(axes, impl)][1])):
            assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("world,axes,impl", RUNS)
def test_step_collectives_are_the_formula(port_results, world, axes, impl):
    """One step's tp all-reduces and sp transfers on each rank: the
    formula ``tp_sp_counts`` of ``chip_smoke.py``, with the remat
    recompute's forward collectives counted once more."""
    from chip_smoke import tp_sp_counts

    cfg = _port_cfg(impl)
    for rank in port_results[world]:
        counters, coords = rank[(axes, impl)][2:]
        want = tp_sp_counts(cfg, dict(axes), rows=4, seq=32,
                            sp_rank=coords["sp"])
        assert counters == want, (counters, want)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2], sys.argv[3], sys.argv[4])
