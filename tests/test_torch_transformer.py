"""The port's decoder LM (horovod_tpu_torch.models.transformer) against
the JAX package's, on the same weights: the JAX parameters, bridged by
``params_from_jax``, run through both packages on the same tokens.

Tolerances (f32): RoPE and RMSNorm are elementwise, 1e-6. Logits, loss
and gradients chain a dozen f32 matmuls whose summation order differs
between XLA and PyTorch: 2e-5 on logits and loss, and 1e-4 absolute on
gradients (whose largest entries are ~1e-1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.parallel.ring_attention import make_sp_attention


def _cfgs(**kw):
    return (jtr.TransformerConfig.tiny(dtype=jnp.float32, remat=False, **kw),
            ttr.TransformerConfig.tiny(dtype=torch.float32, remat=False, **kw))


def _jax_params(cfg_j, seed=0):
    return jax.tree.map(np.asarray,
                        jtr.init_params(cfg_j, jax.random.PRNGKey(seed)))


def _tokens(b=2, t=33, vocab=256, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


@pytest.mark.parametrize("offset", [0, 5])
def test_rope_matches_jax(offset):
    x = np.random.default_rng(0).standard_normal((2, 9, 4, 16)).astype(
        np.float32)
    pos = np.arange(9) + offset
    want = jtr._rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)
    got = ttr._rope(torch.from_numpy(x), torch.from_numpy(pos), 500_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_rope_rotates_interleaved_pairs():
    """Position 1 at theta=1 rotates the pair (x0, x1) by 1 radian: the
    interleaved convention, not rotate-half."""
    x = torch.zeros((1, 2, 1, 4))
    x[0, 1, 0, 0] = 1.0
    y = ttr._rope(x, torch.arange(2), 1.0)
    np.testing.assert_allclose(y[0, 1, 0].numpy(),
                               [np.cos(1.0), np.sin(1.0), 0, 0], atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    want = jtr._rmsnorm(jnp.asarray(x, dtype), jnp.asarray(w, dtype), 1e-5)
    tdt = getattr(torch, dtype)
    got = ttr._rmsnorm(torch.tensor(x, dtype=tdt), torch.tensor(w, dtype=tdt),
                       1e-5)
    assert got.dtype == tdt
    # One rounding to the output dtype at the end on both sides.
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_params_from_jax_keeps_layout_and_bf16():
    cfg_j, cfg_t = _cfgs()
    tree = jax.tree.map(np.asarray, jtr.init_params(
        dataclasses.replace(cfg_j, dtype=jnp.bfloat16),
        jax.random.PRNGKey(0)))
    params = ttr.params_from_jax(tree, device="cpu")
    assert params["layers"]["wq"].shape == (2, 64, 64)
    assert params["layers"]["wk"].shape == (2, 64, 32)
    assert params["lm_head"].shape == (64, 256)
    assert params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params["lm_head"].float().numpy(),
        np.asarray(tree["lm_head"], np.float32))
    shapes = ttr.param_shapes(cfg_t)
    assert tuple(params["layers"]["w_down"].shape) == \
        shapes["layers"]["w_down"]


@pytest.mark.parametrize("impl", ["flash", "local", "ring"])
def test_logits_loss_and_grads_match_jax(impl):
    cfg_j, cfg_t = _cfgs(sp_attention=impl)
    p_np = _jax_params(cfg_j)
    toks = _tokens()

    want_logits = jtr.forward(jax.tree.map(jnp.asarray, p_np),
                              jnp.asarray(toks[:, :-1]), cfg_j)
    want_loss, want_grads = jax.value_and_grad(jtr.lm_loss)(
        jax.tree.map(jnp.asarray, p_np), {"tokens": jnp.asarray(toks)},
        cfg_j, None)

    params = ttr.params_from_jax(p_np, device="cpu")
    leaves = ttr.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    logits = ttr.forward(params, torch.from_numpy(toks[:, :-1]), cfg_t)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=2e-5, atol=2e-5)
    loss = ttr.lm_loss(params, {"tokens": torch.from_numpy(toks)}, cfg_t)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-5)
    loss.backward()
    want_leaves = ttr.param_leaves(jax.tree.map(np.asarray, want_grads))
    for p, w in zip(leaves, want_leaves):
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4, atol=1e-4)


def test_remat_recomputes_to_the_same_grads():
    _, cfg_t = _cfgs(sp_attention="flash")
    params = ttr.init_params(cfg_t, torch.Generator().manual_seed(0),
                             device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens())}
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(cfg_t, remat=remat)
        tree = ttr.map_params(
            lambda p: p.detach().clone().requires_grad_(True), params)
        ttr.lm_loss(tree, batch, cfg).backward()
        grads.append([p.grad for p in ttr.param_leaves(tree)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


class _SpMesh:
    """Stands in for a ``DeviceMesh`` with dims dp=1, sp=2."""
    mesh_dim_names = ("dp", "sp")

    def size(self, dim):
        return (1, 2)[dim]


def test_unported_paths_raise():
    _, cfg_t = _cfgs()
    with pytest.raises(NotImplementedError, match="sp=2.*item 10"):
        make_sp_attention(_SpMesh(), impl="ring")
    with pytest.raises(NotImplementedError, match="item 11"):
        ttr.init_params(dataclasses.replace(cfg_t, n_experts=4),
                        torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        make_sp_attention(_SpMesh(), impl="flash")
    with pytest.raises(ValueError, match="unknown"):
        make_sp_attention(None, impl="nope")
