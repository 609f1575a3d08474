"""The port's single-device train step against the JAX package's
``make_train_step`` on a one-device mesh: the same f32 tiny-config
parameters and token batch, ten AdamW steps, the same loss trajectory.

Tolerance: rtol 2e-5 on each loss. Both sides run f32 with the same
update (optax.adamw(3e-4, weight_decay=0.01) vs torch.optim.AdamW with
the same constants); the trajectories part only by summation order,
which compounds over the steps to a few 1e-6 relative by step 10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from horovod_tpu.models import transformer as jtr
from horovod_tpu.parallel import build_mesh
from horovod_tpu_torch.models import transformer as ttr


def test_ten_step_loss_trajectory_matches_jax():
    cfg_j = jtr.TransformerConfig.tiny(sp_attention="flash",
                                       dtype=jnp.float32, remat=False)
    cfg_t = ttr.TransformerConfig.tiny(sp_attention="flash",
                                       dtype=torch.float32, remat=False)
    toks = np.random.default_rng(1).integers(0, 256, (2, 33)).astype(
        np.int32)

    mesh = build_mesh(devices=jax.devices()[:1], dp=1)
    init_state, jit_step, _ = jtr.make_train_step(cfg_j, mesh)
    state = init_state(jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, state["params"])
    want = []
    for _ in range(10):
        state, loss = jit_step(state, {"tokens": jnp.asarray(toks)})
        want.append(float(loss))

    init_t, step_t = ttr.make_train_step(cfg_t, device="cpu")
    st = init_t(params=ttr.params_from_jax(params_np, device="cpu"))
    got = []
    for _ in range(10):
        st, loss = step_t(st, {"tokens": torch.from_numpy(toks)})
        got.append(loss.item())

    assert st["step"] == 10
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_default_optimizer_is_optax_adamw():
    """One AdamW update on a bf16 and an f32 leaf, against optax's
    formula written out: bias-corrected moments, eps added to the
    corrected root, decoupled decay on every leaf, state in the
    parameter dtype."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal(64).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    for dtype, tol in ((torch.float32, 1e-7), (torch.bfloat16, 8e-3)):
        p = torch.tensor(w0, dtype=dtype, requires_grad=True)
        opt = ttr.default_optimizer([p])
        p.grad = torch.tensor(g, dtype=dtype)
        opt.step()
        assert opt.state[p]["exp_avg"].dtype == dtype
        w, gg = w0.astype(np.float64), g.astype(np.float64)
        mu_hat = (0.1 * gg) / 0.1
        nu_hat = (0.001 * gg * gg) / 0.001
        want = w - 3e-4 * (mu_hat / (np.sqrt(nu_hat) + 1e-8) + 0.01 * w)
        np.testing.assert_allclose(p.detach().float().numpy(), want,
                                   rtol=tol, atol=tol)
