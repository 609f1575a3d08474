"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; the
file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances are the kernels' stated error bounds (``kernel_tolerance``
for the forward, ``bwd_kernel_tolerance`` for the backward).
"""

import pytest
import torch

import horovod_tpu_torch.ops.flash_attention as tfa

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.bfloat16, None),
    (torch.bfloat16, torch.float32),
    (torch.float32, None),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,q_per_kv", [
    (64, 1), (64, 4), (64, 8), (128, 1), (128, 2), (128, 4), (128, 8),
])
# T=1 is a tile that is mostly padding, 129 one row past a tile, 256
# whole tiles, 777 and 1000 ragged, 4096 a K/V ring that wraps 16 times
# per query tile.
@pytest.mark.parametrize("t", [1, 100, 129, 256, 777, 1000, 4096])
def test_flash_fwd_matches_plain(cuda_device, dtype, out_dtype, t, d,
                                 q_per_kv, causal):
    g = torch.Generator(cuda_device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    q, k, v = randn(8, t, d), randn(8 // q_per_kv, t, d), \
        randn(8 // q_per_kv, t, d)
    kw = dict(scale=d ** -0.5, causal=causal, out_dtype=out_dtype,
              q_per_kv=q_per_kv)
    before = tfa.flash_fwd_cuda.launches
    out, lse = tfa.flash_fwd_cuda(q, k, v, **kw)
    ref_out, ref_lse = tfa.flash_fwd_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_fwd_cuda.launches == before + 1
    assert out.dtype == (out_dtype or dtype) and lse.dtype == torch.float32
    atol, rtol, lse_tol = tfa.kernel_tolerance(dtype, out_dtype,
                                               v.abs().max().item())
    torch.testing.assert_close(out.float(), ref_out.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=lse_tol, rtol=0)


def test_flash_fwd_rejects_what_it_cannot_launch(cuda_device):
    before = tfa.flash_fwd_cuda.launches
    q = torch.zeros((4, 32, 96), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_fwd_cuda(q, q, q, scale=0.1, causal=True)
    q = torch.zeros((4, 32, 64), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        tfa.flash_fwd_cuda(q, q, q, scale=0.1, causal=True)
    q = torch.zeros((4, 32, 64), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="scale > 0"):
        tfa.flash_fwd_cuda(q, q, q, scale=0.0, causal=True)
    assert tfa.flash_fwd_cuda.launches == before


def _bwd_inputs(device, dtype, out_dtype, b, t, h, hkv, d, causal,
                with_g_lse, seed=0):
    """q, k, v drawn on the card, the forward kernel's out and lse, a
    cotangent of out (in out's dtype) and, where asked, one of lse."""
    g = torch.Generator(device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    q = randn(b * h, t, d).to(dtype)
    k, v = randn(b * hkv, t, d).to(dtype), randn(b * hkv, t, d).to(dtype)
    kw = dict(scale=d ** -0.5, causal=causal, q_per_kv=h // hkv)
    out, lse = tfa.flash_fwd_cuda(q, k, v, out_dtype=out_dtype, **kw)
    dout = randn(*out.shape).to(out.dtype)
    g_lse = randn(*lse.shape) if with_g_lse else None
    return (q, k, v, out, lse), dout, g_lse, kw


def _assert_bwd_close(residuals, dout, g_lse, kw, got):
    want = tfa._bwd(kw["scale"], kw["causal"], residuals, dout, g_lse,
                    kw["q_per_kv"])
    atols, rtol = tfa.bwd_kernel_tolerance(residuals, dout, g_lse, **kw)
    for name, a, w, atol in zip(("dq", "dk", "dv"), got, want, atols):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        excess = ((a.float() - w.float()).abs()
                  - (atol + rtol * w.float().abs())).max().item()
        assert excess <= 0 and torch.isfinite(a.float()).all(), name


@pytest.mark.parametrize("with_g_lse", [False, True])
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.bfloat16, None),
    (torch.bfloat16, torch.float32),
    (torch.float32, None),
    (torch.float32, torch.bfloat16),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,q_per_kv", [
    (64, 1), (64, 4), (128, 1), (128, 2), (128, 4),
])
# T=1 is a tile that is mostly padding, 129 one row past a tile, 128 and
# 2048 whole tiles, 1000 ragged.
@pytest.mark.parametrize("t", [1, 128, 129, 1000, 2048])
def test_flash_bwd_matches_plain(cuda_device, dtype, out_dtype, t, d,
                                 q_per_kv, causal, with_g_lse):
    residuals, dout, g_lse, kw = _bwd_inputs(
        cuda_device, dtype, out_dtype, 2, t, 4, 4 // q_per_kv, d, causal,
        with_g_lse)
    before = tfa.flash_bwd_cuda.launches
    got = tfa.flash_bwd_cuda(*residuals, dout, g_lse, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_bwd_cuda.launches == before + 1
    _assert_bwd_close(residuals, dout, g_lse, kw, got)


@pytest.mark.parametrize("dtype,out_dtype,causal,d,q_per_kv,with_g_lse", [
    (torch.bfloat16, None, True, 128, 4, False),
    (torch.bfloat16, None, False, 64, 2, True),
    (torch.bfloat16, torch.float32, True, 128, 1, True),
    (torch.float32, None, True, 64, 4, False),
])
def test_flash_bwd_matches_plain_t8192(cuda_device, dtype, out_dtype,
                                       causal, d, q_per_kv, with_g_lse):
    """The config's longest sequence: the plain side runs chunked."""
    residuals, dout, g_lse, kw = _bwd_inputs(
        cuda_device, dtype, out_dtype, 1, 8192, 4, 4 // q_per_kv, d,
        causal, with_g_lse)
    got = tfa.flash_bwd_cuda(*residuals, dout, g_lse, **kw)
    torch.cuda.synchronize()
    _assert_bwd_close(residuals, dout, g_lse, kw, got)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_is_bitwise_deterministic(cuda_device, dtype):
    """Every output element is summed by one thread in a fixed order:
    the same inputs give the same bits, run after run."""
    residuals, dout, g_lse, kw = _bwd_inputs(
        cuda_device, dtype, None, 2, 1000, 8, 2, 128, True, True)
    first = tfa.flash_bwd_cuda(*residuals, dout, g_lse, **kw)
    for _ in range(3):
        again = tfa.flash_bwd_cuda(*residuals, dout, g_lse, **kw)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_bwd_allocates_no_t_by_t_buffer(cuda_device):
    """At the training shape (B=4, T=2048, 32/8 heads of 128) the launch
    allocates dq, dk, dv and its [2, B·H, T] f32 rows (delta, lse),
    where a [B·H, T, T] f32 score tensor alone is 2.1 GB."""
    residuals, dout, _, kw = _bwd_inputs(
        cuda_device, torch.bfloat16, None, 4, 2048, 32, 8, 128, True, False)
    q, k, v = residuals[:3]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = tfa.flash_bwd_cuda(*residuals, dout, **kw)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    expected = sum(x.numel() * x.element_size() for x in (q, k, v)) \
        + 2 * q.shape[0] * q.shape[1] * 4
    assert rise <= expected + 2 ** 22
    assert rise < q.shape[0] * q.shape[1] ** 2 * 4 // 16
    del grads


def test_flash_bwd_rejects_what_it_cannot_launch(cuda_device):
    before = tfa.flash_bwd_cuda.launches
    kw = dict(scale=0.1, causal=True)
    x = torch.zeros((4, 32, 96), device=cuda_device, dtype=torch.bfloat16)
    lse = torch.zeros((4, 32), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_bwd_cuda(x, x, x, x, lse, x, **kw)
    x = torch.zeros((4, 32, 64), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        tfa.flash_bwd_cuda(x, x, x, x, lse, x, **kw)
    x = torch.zeros((4, 32, 64), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="out"):
        tfa.flash_bwd_cuda(x, x, x, x[:, :16], lse, x, **kw)
    with pytest.raises(TypeError, match="lse"):
        tfa.flash_bwd_cuda(x, x, x, x, lse.half(), x, **kw)
    with pytest.raises(ValueError, match="g_lse"):
        tfa.flash_bwd_cuda(x, x, x, x, lse, x, lse[:2], **kw)
    with pytest.raises(ValueError, match="q_per_kv"):
        tfa.flash_bwd_cuda(x, x[:3], x[:3], x, lse, x, q_per_kv=2, **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_bwd_cuda(x, x, x, x, lse.cpu(), x, **kw)
    assert tfa.flash_bwd_cuda.launches == before


@pytest.mark.parametrize("lse_output", [False, True])
def test_autograd_backward_launches_the_kernel(cuda_device, monkeypatch,
                                               lse_output):
    """A CUDA tensor's backward goes to the kernel, once a call, and
    never to the dense torch backward."""
    def dense(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the torch backward")

    monkeypatch.setattr(tfa, "_bwd", dense)
    g = torch.Generator(cuda_device).manual_seed(3)
    if lse_output:
        q, k, v = (torch.randn((4, 256, 64), generator=g, device=cuda_device,
                               dtype=torch.bfloat16).requires_grad_(True)
                   for _ in range(3))
        out, lse = tfa.flash_attention_with_lse(
            q, k, v, causal=True, out_dtype=torch.float32)
        loss = out.sum() + lse.sum()
    else:
        q = torch.randn((2, 256, 8, 128), generator=g, device=cuda_device,
                        dtype=torch.bfloat16).requires_grad_(True)
        k, v = (torch.randn((2, 256, 2, 128), generator=g,
                            device=cuda_device,
                            dtype=torch.bfloat16).requires_grad_(True)
                for _ in range(2))
        loss = tfa.flash_attention(q, k, v, causal=True).float().sum()
    before = tfa.flash_bwd_cuda.launches
    loss.backward()
    torch.cuda.synchronize()
    assert tfa.flash_bwd_cuda.launches == before + 1
    assert all(torch.isfinite(x.grad.float()).all() for x in (q, k, v))
