"""The port stands alone: importing horovod_tpu_torch loads no JAX,
optax, flax or horovod_tpu module, its entry points refuse to run
without CUDA unless the CPU is asked for, and a request for the card
raises instead of falling back to the CPU or the plain version."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import horovod_tpu_torch
import horovod_tpu_torch.models
import horovod_tpu_torch.ops.flash_attention
import horovod_tpu_torch.ops._kernels
import horovod_tpu_torch.parallel.ring_attention
banned = ("jax", "jaxlib", "optax", "flax", "horovod_tpu")
print(sorted(m for m in sys.modules if m.split(".")[0] in banned))
"""


def test_import_loads_no_jax_or_reference_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    from horovod_tpu_torch import resolve_device
    from horovod_tpu_torch.models import transformer as ttr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32)
    for call in (lambda: ttr.make_train_step(cfg),
                 lambda: ttr.make_train_step(cfg, device="cuda"),
                 lambda: ttr.init_params(cfg, torch.Generator()),
                 lambda: ttr.params_from_jax({}),
                 lambda: resolve_device()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    init_state, _ = ttr.make_train_step(cfg, device="cpu")
    state = init_state(torch.Generator().manual_seed(0))
    assert state["params"]["embed"].device.type == "cpu"


def test_kernel_wrapper_never_falls_back():
    """Only a CPU tensor takes the plain version; any other tensor goes
    to the kernel wrapper, which raises on what it cannot launch."""
    from horovod_tpu_torch.ops import flash_attention as tfa

    meta = torch.empty((1, 16, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_attention(meta, meta, meta)
    cpu = torch.zeros((2, 16, 64))
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_fwd_cuda(cpu, cpu, cpu, scale=0.125, causal=True)
    assert tfa.flash_fwd_cuda.launches == 0


def test_kernel_library_is_keyed_by_its_sources(monkeypatch, tmp_path):
    """An edited source or header gets a new library name, so a stale
    build is never loaded."""
    from horovod_tpu_torch.ops import _kernels

    monkeypatch.setattr(_kernels, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// one\n")
    first = _kernels.library_path("k")
    assert first.parent == _kernels.BUILD_DIR
    assert first.name.startswith("libk_")
    assert _kernels.library_path("k") == first
    (tmp_path / "k.cu").write_text("// two\n")
    second = _kernels.library_path("k")
    (tmp_path / "common.cuh").write_text("// header\n")
    assert len({first, second, _kernels.library_path("k")}) == 3


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from horovod_tpu_torch.ops import _kernels

    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build_all()
    assert not list(tmp_path.glob("*.so"))
