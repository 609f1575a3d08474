"""The port's flash attention (horovod_tpu_torch.ops.flash_attention)
against the JAX package's Pallas kernel, which runs here in interpret
mode. Inputs are drawn once with numpy and fed to both.

On the CPU the port takes its plain PyTorch forward (the same blocked
online softmax as the CUDA kernel); the kernel itself is held against
that plain version on the card (tests/test_torch_kernels_cuda.py and
chip_smoke.py).

Tolerances: f32 agrees to ~1e-7 in the forward, so 1e-5 leaves room
only for summation order; gradients get 1e-4 (several f32 matmul
chains of length T). bf16 is a bounded-error check: each side computes
in f32 and rounds its output once, so they differ by at most about one
bf16 ulp (2^-8 relative), well inside 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu.ops.flash_attention as jfa
import horovod_tpu_torch.ops.flash_attention as tfa

F32_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _qkv(t, h=4, hkv=4, b=1, d=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32) * 0.5
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32) * 0.5
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32) * 0.5
    return q, k, v


def _t(*xs, dtype=torch.float32, grad=False):
    return [torch.tensor(x, dtype=dtype, requires_grad=grad) for x in xs]


def _j(*xs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in xs]


@pytest.mark.parametrize("q_per_kv", [1, 2, 4])
@pytest.mark.parametrize("t", [128, 200])      # aligned and ragged
@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_jax(causal, t, q_per_kv):
    q, k, v = _qkv(t, h=4, hkv=4 // q_per_kv, b=2)
    want = jfa.flash_attention(*_j(q, k, v), causal=causal)
    got = tfa.flash_attention(*_t(q, k, v), causal=causal)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("t", [128, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_with_lse_matches_jax(causal, t):
    q, k, v = (x.transpose(0, 2, 1, 3).reshape(-1, t, 32)
               for x in _qkv(t, b=2))
    out_j, lse_j = jfa.flash_attention_with_lse(*_j(q, k, v), causal=causal)
    out_t, lse_t = tfa.flash_attention_with_lse(*_t(q, k, v), causal=causal)
    assert lse_t.shape == (8, t) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **F32_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **F32_TOL)


def test_forward_bf16_and_out_dtype_bounded():
    """bf16 inputs: the output in bf16 and, with out_dtype=float32, in
    f32 (the ring-merge precision) both stay within bf16 rounding of
    the JAX kernel."""
    t = 200
    q, k, v = (x.transpose(0, 2, 1, 3).reshape(-1, t, 32)
               for x in _qkv(t, b=2))
    for out_dtype, jdt in ((None, None), (torch.float32, jnp.float32)):
        out_j, lse_j = jfa.flash_attention_with_lse(
            *_j(q, k, v, dtype=jnp.bfloat16), causal=True, out_dtype=jdt)
        out_t, lse_t = tfa.flash_attention_with_lse(
            *_t(q, k, v, dtype=torch.bfloat16), causal=True,
            out_dtype=out_dtype)
        assert out_t.dtype == (out_dtype or torch.bfloat16)
        np.testing.assert_allclose(out_t.float().numpy(),
                                   np.asarray(out_j, np.float32), **BF16_TOL)
        # lse is f32 arithmetic on exactly representable bf16 inputs.
        np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                                   **F32_TOL)


@pytest.mark.parametrize("q_per_kv", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_jax(causal, q_per_kv):
    t = 200
    q, k, v = _qkv(t, h=4, hkv=4 // q_per_kv)
    cot = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)

    def loss_j(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, causal=causal) * cot)

    want = jax.grad(loss_j, argnums=(0, 1, 2))(*_j(q, k, v))
    qt, kt, vt = _t(q, k, v, grad=True)
    (tfa.flash_attention(qt, kt, vt, causal=causal)
     * torch.from_numpy(cot)).sum().backward()
    for got, w, name in zip((qt.grad, kt.grad, vt.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=f"d{name}")


def _lse_loss(out, lse, xp):
    """A loss that consumes the logsumexp with nontrivial weights, so
    its cotangent (g_lse) reaches the backward."""
    n = int(np.prod(lse.shape))
    w = xp.arange(n, dtype=xp.float32).reshape(tuple(lse.shape))
    return out.sum() + (w * lse).sum() / n


@pytest.mark.parametrize("t", [128, 200])
def test_lse_cotangent_gradients_match_jax(t):
    q, k, v = (x.transpose(0, 2, 1, 3).reshape(-1, t, 32)
               for x in _qkv(t, h=2, hkv=2))

    def loss_j(q, k, v):
        return _lse_loss(*jfa.flash_attention_with_lse(q, k, v, causal=True),
                         jnp)

    want = jax.grad(loss_j, argnums=(0, 1, 2))(*_j(q, k, v))
    qt, kt, vt = _t(q, k, v, grad=True)
    _lse_loss(*tfa.flash_attention_with_lse(qt, kt, vt, causal=True),
              torch).backward()
    for got, w, name in zip((qt.grad, kt.grad, vt.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=f"d{name}")


def _grads(fn, *xs):
    xs = [torch.tensor(x, requires_grad=True) for x in xs]
    fn(*xs).backward()
    return [x.grad for x in xs]


@pytest.mark.parametrize("t", [192, 200])      # chunk-aligned and padded
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_backward_matches_dense(monkeypatch, causal, t):
    """Forcing the q-chunked backward (above _BWD_CHUNK_T) must
    reproduce the dense gradients, with GQA and a short last chunk."""
    q, k, v = _qkv(t, h=4, hkv=2)

    def loss(q, k, v):
        return tfa.flash_attention(q, k, v, causal=causal).sum()

    dense = _grads(loss, q, k, v)
    monkeypatch.setattr(tfa, "_BWD_CHUNK_T", 100)
    monkeypatch.setattr(tfa, "_BWD_CHUNK", 64)
    chunked = _grads(loss, q, k, v)
    for a, b in zip(dense, chunked):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("t", [192, 200])
def test_chunked_backward_matches_dense_with_lse_cotangent(monkeypatch, t):
    q, k, v = (x.transpose(0, 2, 1, 3).reshape(-1, t, 32)
               for x in _qkv(t, h=2, hkv=2))

    def loss(q, k, v):
        return _lse_loss(*tfa.flash_attention_with_lse(q, k, v, causal=True),
                         torch)

    dense = _grads(loss, q, k, v)
    monkeypatch.setattr(tfa, "_BWD_CHUNK_T", 100)
    monkeypatch.setattr(tfa, "_BWD_CHUNK", 64)
    chunked = _grads(loss, q, k, v)
    for a, b in zip(dense, chunked):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-5)
