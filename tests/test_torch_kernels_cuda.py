"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; the
file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances are the kernel's stated error bound (``kernel_tolerance``).
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
