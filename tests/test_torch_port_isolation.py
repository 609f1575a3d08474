"""The port stands alone: importing horovod_tpu_torch loads no JAX,
optax, flax or horovod_tpu module, its entry points refuse to run
without CUDA unless the CPU is asked for, and a request for the card
raises instead of falling back to the CPU or the plain version. The
process world does not come up on gloo when CUDA was asked for, nor
alone when the launcher says there are more ranks, and the unported
paths (Adasum, the quantized codecs, sharded meshes) raise naming their
ROADMAP items."""

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
import horovod_tpu_torch.parallel.mesh
import horovod_tpu_torch.common.ops_enum
import horovod_tpu_torch.common.topology
import horovod_tpu_torch.compression
import horovod_tpu_torch.ops.collectives
import horovod_tpu_torch.binding
import horovod_tpu_torch.functions
import horovod_tpu_torch.bench
import horovod_tpu_torch.graft_entry
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


def _clear_launcher_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith(("HOROVOD_", "OMPI_COMM_WORLD_", "MASTER_")):
            monkeypatch.delenv(k)


def test_process_group_needs_cuda_or_an_explicit_cpu(monkeypatch):
    import torch.distributed as dist
    from horovod_tpu_torch import bench, graft_entry
    from horovod_tpu_torch.parallel.mesh import init_process_group

    _clear_launcher_env(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: init_process_group(),
                 lambda: init_process_group("cuda"),
                 lambda: graft_entry.entry(),
                 lambda: bench.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        assert not dist.is_initialized()


def test_a_larger_world_never_runs_alone(monkeypatch):
    """HOROVOD_SIZE=2 with no rendezvous raises at once; with one that
    nobody answers it raises when its timeout runs out."""
    import socket

    import torch.distributed as dist
    from horovod_tpu_torch.parallel.mesh import build_mesh, init_process_group

    _clear_launcher_env(monkeypatch)
    monkeypatch.setenv("HOROVOD_SIZE", "2")
    monkeypatch.setenv("HOROVOD_RANK", "1")
    with pytest.raises(RuntimeError, match="needs a rendezvous"):
        init_process_group("cpu")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(RuntimeError):
        init_process_group("cpu", init_method=f"tcp://127.0.0.1:{port}",
                           timeout=2)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        build_mesh(dp=2)


class _TpMesh:
    """Stands in for a ``DeviceMesh`` with dims dp=1, tp=2."""
    mesh_dim_names = ("dp", "tp")

    def size(self, dim):
        return (1, 2)[dim]


def test_unported_collective_paths_raise_naming_their_items():
    from horovod_tpu_torch import binding
    from horovod_tpu_torch.common.ops_enum import (Adasum, Average, Max,
                                                   Min, Sum)
    from horovod_tpu_torch.compression import Compression
    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.parallel.mesh import build_mesh

    x = torch.ones(4)
    with pytest.raises(NotImplementedError, match="Adasum.*item 15"):
        collectives.allreduce(x, Adasum)
    with pytest.raises(NotImplementedError, match="Adasum.*item 15"):
        collectives.grouped_allreduce([x], Adasum)
    for call in (lambda: Compression.int8.compress(x),
                 lambda: collectives.allreduce(
                     x, Sum, compression=Compression.int8),
                 lambda: collectives.grouped_allreduce(
                     [x], Average, compression=Compression.bf16),
                 lambda: collectives.allreduce(
                     x, Max, compression=Compression.bf16),
                 lambda: collectives.grouped_allreduce(
                     [x], Min, compression=Compression.fp16),
                 lambda: binding.allreduce_gradients(
                     [x], compression=Compression.int8)):
        with pytest.raises(NotImplementedError, match="item 8"):
            call()
    with pytest.raises(ValueError, match="ef="):
        binding.allreduce_gradients([x], ef=[x])
    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32)
    for codec in (Compression.int8, Compression.bf16, Compression.fp16):
        with pytest.raises(NotImplementedError, match="item 8"):
            ttr.make_train_step(cfg, "cpu", compression=codec)
    with pytest.raises(NotImplementedError, match="item 9"):
        ttr.make_train_step(cfg, "cpu", mesh=_TpMesh())
    for axis in ("fsdp", "tp", "sp", "pp", "ep"):
        with pytest.raises(NotImplementedError, match="item 9"):
            build_mesh(**{axis: 2})


def test_cast_codecs_cast_only_wide_floats():
    from horovod_tpu_torch.compression import Compression

    for codec, narrow in ((Compression.bf16, torch.bfloat16),
                          (Compression.fp16, torch.float16)):
        for dtype in (torch.float32, torch.float64):
            c, ctx = codec.compress(torch.ones(3, dtype=dtype))
            assert c.dtype == narrow and ctx == dtype
            assert codec.decompress(c, ctx).dtype == dtype
        for t in (torch.ones(3, dtype=torch.bfloat16), torch.arange(3)):
            c, ctx = codec.compress(t)
            assert c is t and ctx is None and codec.decompress(c, ctx) is t
    t = torch.ones(2)
    assert Compression.none.compress(t) == (t, None)


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


# Lines of an `nvcc -Xptxas -v` log of csrc/flash_fwd.cu, as the H100
# machine's toolkit printed them (names shortened).
_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN4simtILi128EffEEvPKT0_' for 'sm_90a'
ptxas info    : Function properties for _ZN4simtILi128EffEEvPKT0_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 41088 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN15flash_fwd_wgmmaILi128EfEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN15flash_fwd_wgmmaILi128EfEEv14CUtensorMap_st
    80 bytes stack frame, 80 bytes spill stores, 72 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 80 bytes cumulative stack size
"""


def test_ptxas_report_reads_registers_spills_and_smem():
    from horovod_tpu_torch.ops import _kernels

    report = _kernels.ptxas_report(_PTXAS_LOG)
    assert report == {
        "_ZN4simtILi128EffEEvPKT0_": {
            "registers": 96, "spill_stores": 0, "spill_loads": 0,
            "smem": 41088},
        "_ZN15flash_fwd_wgmmaILi128EfEEv14CUtensorMap_st": {
            "registers": 168, "spill_stores": 80, "spill_loads": 72,
            "smem": 0},
    }
    assert _kernels.ptxas_report("") == {}


def test_ptxas_warnings_catch_lost_register_split_and_wgmma_pipeline():
    from horovod_tpu_torch.ops import _kernels

    lost = [
        "ptxas warning : (C7508) setmaxnreg ignored; unable to determine "
        "register count at entry",
        "ptxas info    : (C7520) Potential Performance Loss: "
        "wgmma.mma_async instructions are serialized due to program "
        "dependence on compiler-inserted WG.AR in divergent path",
    ]
    log = _PTXAS_LOG + "\n".join(lost) + "\n"
    assert _kernels.ptxas_warnings(log) == lost
    assert _kernels.ptxas_warnings(_PTXAS_LOG) == []


def test_build_all_force_rebuilds_what_is_built(monkeypatch, tmp_path):
    """A built library is reused (empty log) unless ``force`` asks for a
    new build, whose compiler log comes back."""
    from horovod_tpu_torch.ops import _kernels

    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = -o ] && '
                    'out="$2"; shift; done\n'
                    'echo "ptxas info    : Used 1 registers"\n: > "$out"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    monkeypatch.setattr(_kernels, "BUILD_DIR", build)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(nvcc))
    built = "ptxas info    : Used 1 registers\n"
    assert _kernels.build_all() == {"k": built}
    assert _kernels.library_path("k").exists()
    assert _kernels.build_all() == {"k": ""}
    assert _kernels.build_all(force=True) == {"k": built}
    assert [p.name for p in build.iterdir()] == [
        _kernels.library_path("k").name]
