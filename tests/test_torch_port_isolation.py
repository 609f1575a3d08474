"""The port stands alone: importing horovod_tpu_torch loads no JAX,
optax, flax, ml_dtypes or horovod_tpu module, its entry points refuse to run
without CUDA unless the CPU is asked for, and a request for the card
raises instead of falling back to the CPU or the plain version. The
process world does not come up on gloo when CUDA was asked for, nor
alone when the launcher says there are more ranks (nor does the eager
runtime without the port's launcher or a controller address), the
unported paths (Adasum; pp and ep composed with sp or fsdp) raise naming
their ROADMAP items, and the quantized codecs raise the reference's
usage errors, a codec on a tp/sp/pp/ep mesh included; serving on a mesh
raises naming its ROADMAP item (17). The launcher and the elastic modules load
no ``cloudpickle`` either. ``chip_smoke.py`` imports none of it."""

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
import horovod_tpu_torch.parallel
import horovod_tpu_torch.parallel.ring_attention
import horovod_tpu_torch.parallel.mesh
import horovod_tpu_torch.parallel.tensor_parallel
import horovod_tpu_torch.common.ops_enum
import horovod_tpu_torch.common.topology
import horovod_tpu_torch.compression
import horovod_tpu_torch.ops.collectives
import horovod_tpu_torch.ops.quantized
import horovod_tpu_torch.binding
import horovod_tpu_torch.functions
import horovod_tpu_torch.bench
import horovod_tpu_torch.graft_entry
import horovod_tpu_torch.common.basics
import horovod_tpu_torch.common.exceptions
import horovod_tpu_torch.ops.nccl_exec
import horovod_tpu_torch.runtime
import horovod_tpu_torch.api
import horovod_tpu_torch.torch
import horovod_tpu_torch.torch.mpi_ops
import horovod_tpu_torch.torch.optimizer
import horovod_tpu_torch.torch.functions
import horovod_tpu_torch.torch.sync_batch_norm
import horovod_tpu_torch.elastic
import horovod_tpu_torch.torch.elastic
import horovod_tpu_torch.runner
import horovod_tpu_torch.runner.api
import horovod_tpu_torch.runner.elastic_driver
import horovod_tpu_torch.runner.hosts
import horovod_tpu_torch.runner.http_kv
import horovod_tpu_torch.runner.launch
import horovod_tpu_torch.runner.rendezvous
import horovod_tpu_torch.runner.run_task
import horovod_tpu_torch.runner.safe_exec
import horovod_tpu_torch.runner.schedulers
import horovod_tpu_torch.runner.mpi_run
import horovod_tpu_torch.runner.js_run
import horovod_tpu_torch.models.resnet
import horovod_tpu_torch.models.moe
import horovod_tpu_torch.parallel.pipeline
import horovod_tpu_torch.parallel.pipeline_1f1b
import horovod_tpu_torch.metrics
import horovod_tpu_torch.serve
import horovod_tpu_torch.serve.bench
import horovod_tpu_torch.serve.decode
import horovod_tpu_torch.serve.engine
import horovod_tpu_torch.serve.kv_cache
import horovod_tpu_torch.serve.metrics
import horovod_tpu_torch.serve.speculative
import horovod_tpu_torch.serve.trace
import chip_smoke
banned = ("jax", "jaxlib", "optax", "flax", "horovod_tpu", "ml_dtypes",
          "cloudpickle")
print(sorted(m for m in sys.modules if m.split(".")[0] in banned))
"""


def test_import_loads_no_jax_or_reference_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    from horovod_tpu_torch import resolve_device, serve
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.models import transformer as ttr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32)
    rcfg = resnet.ResNetConfig((1, 1), 10, 8)
    cpu_params = ttr.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    for call in (lambda: serve.ServeEngine(cfg, cpu_params),
                 lambda: serve.init_kv_cache(cfg, 4, 8),
                 lambda: serve.make_serve_fns(cfg, block_size=8,
                                              table_width=4),
                 lambda: serve.make_draft_target_params(cfg, 3),
                 lambda: ttr.make_train_step(cfg),
                 lambda: ttr.make_train_step(cfg, device="cuda"),
                 lambda: ttr.init_params(cfg, torch.Generator()),
                 lambda: ttr.params_from_jax({}),
                 lambda: resnet.make_train_step(rcfg),
                 lambda: resnet.init_params(rcfg, torch.Generator()),
                 lambda: resnet.params_from_jax({}),
                 lambda: resolve_device()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    init_state, _ = ttr.make_train_step(cfg, device="cpu")
    state = init_state(torch.Generator().manual_seed(0))
    assert state["params"]["embed"].device.type == "cpu"
    eng = serve.ServeEngine(cfg, cpu_params, device="cpu")
    assert eng.cache.k.device.type == "cpu"
    # Parameters on another device than the engine's are refused.
    with pytest.raises(ValueError, match="move the parameters"):
        serve.ServeEngine(cfg, ttr.map_params(
            lambda p: p.to("meta"), cpu_params), device="cpu")


def test_eager_world_needs_a_launcher_or_an_address(monkeypatch):
    """The eager runtime refuses a world of 2 with neither the port's
    launcher (``HOROVOD_RENDEZVOUS_ADDR``) nor a controller address, and
    brings nothing up."""
    import torch.distributed as dist
    from horovod_tpu_torch.runtime import Runtime

    _clear_launcher_env(monkeypatch)
    monkeypatch.setenv("HOROVOD_SIZE", "2")
    monkeypatch.setenv("HOROVOD_RANK", "0")
    rt = Runtime()
    with pytest.raises(RuntimeError, match="launcher"):
        rt.init("cpu")
    assert not rt.initialized() and not dist.is_initialized()


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


class _Mesh:
    """Stands in for a ``DeviceMesh`` with dims dp=1 and ``axis``=2."""

    def __init__(self, axis):
        self.mesh_dim_names = ("dp", axis)

    def size(self, dim):
        return (1, 2)[dim]


def test_unported_collective_paths_raise_naming_their_items():
    from horovod_tpu_torch import binding
    from horovod_tpu_torch.common.ops_enum import (Adasum, Average, Max,
                                                   Min, Sum)
    from horovod_tpu_torch.compression import Compression
    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.ops import collectives, quantized
    from horovod_tpu_torch.parallel.mesh import build_mesh

    x = torch.ones(4)
    with pytest.raises(NotImplementedError, match="Adasum.*item 15"):
        collectives.allreduce(x, Adasum)
    with pytest.raises(NotImplementedError, match="Adasum.*item 15"):
        collectives.grouped_allreduce([x], Adasum)
    # The quantized paths are ported; what they refuse, they refuse with
    # the reference's errors, before any traffic (no world is up here).
    with pytest.raises(NotImplementedError, match="no framework-level"):
        Compression.int8.compress(x)
    for call in (lambda: collectives.allreduce(
                     x, Max, compression=Compression.int8),
                 lambda: collectives.grouped_allreduce(
                     [x], Min, compression=Compression.int8),
                 lambda: binding.allreduce_gradients(
                     [x], op=Max, compression=Compression.int8),
                 lambda: quantized.quantized_allreduce(
                     x, Average, (None, None), codec="int8")):
        with pytest.raises(ValueError,
                           match="Sum/Average|Average/Sum|single process"):
            call()
    with pytest.raises(TypeError, match="cannot quantize"):
        collectives.allreduce(torch.ones(4, dtype=torch.int32), Sum,
                              compression=Compression.bf16)
    with pytest.raises(NotImplementedError, match="single process group"):
        binding.allreduce_gradients([x], group=(None, None),
                                    compression=Compression.int8)
    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32)
    for codec in (Compression.int8, Compression.bf16, Compression.fp16):
        with pytest.raises(ValueError, match="needs a data axis"):
            ttr.make_train_step(cfg, "cpu", compression=codec)
        for axis in ("tp", "sp", "pp", "ep"):
            with pytest.raises(ValueError, match="no explicit gradient"):
                ttr.make_train_step(cfg, "cpu", mesh=_Mesh(axis),
                                    compression=codec)
    # tp, sp, ep and pp are ported (tests/test_torch_tensor_parallel.py,
    # test_torch_moe.py, test_torch_pipeline.py); a pp mesh trains
    # through the pipeline's own steps.
    with pytest.raises(ValueError, match="make_pp_train_step"):
        ttr.make_train_step(cfg, "cpu", mesh=_Mesh("pp"))
    for axes in ({"fsdp": 2}, {"tp": 2}, {"sp": 2}, {"pp": 2}, {"ep": 2}):
        with pytest.raises(RuntimeError, match="init_process_group"):
            build_mesh(**axes)


def test_serving_on_a_mesh_raises_naming_item_17():
    """Serving with tp/ep-sharded params and pool is ROADMAP item 17:
    the engine and the pool refuse a mesh before allocating anything."""
    from horovod_tpu_torch import serve
    from horovod_tpu_torch.models import transformer as ttr

    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32)
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    for axis in ("tp", "ep"):
        with pytest.raises(NotImplementedError, match="item 17"):
            serve.ServeEngine(cfg, params, mesh=_Mesh(axis), device="cpu")
        with pytest.raises(NotImplementedError, match="item 17"):
            serve.init_kv_cache(cfg, 4, 8, mesh=_Mesh(axis), device="cpu")


class _Mesh2:
    """Stands in for a ``DeviceMesh`` with dims dp=1 and ``axes``."""

    def __init__(self, **axes):
        self.mesh_dim_names = ("dp",) + tuple(axes)
        self._sizes = (1,) + tuple(axes.values())

    def size(self, dim):
        return self._sizes[dim]


def test_pp_and_ep_with_sp_or_fsdp_raise_naming_item_16():
    """The compositions left to ROADMAP item 16 raise before any
    traffic; pp + sp + MoE raises the reference's own error first."""
    import dataclasses

    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.parallel import pipeline as tpl

    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32)
    moe = dataclasses.replace(cfg, n_experts=4)
    for axes in ({"pp": 2, "sp": 2}, {"fsdp": 2, "pp": 2},
                 {"fsdp": 2, "ep": 2}, {"sp": 2, "ep": 2}):
        mesh = _Mesh2(**axes)
        with pytest.raises(NotImplementedError, match="item 16"):
            ttr.make_train_step(cfg, "cpu", mesh=mesh)
        with pytest.raises(NotImplementedError, match="item 16"):
            ttr.shard_batch(torch.zeros((4, 9), dtype=torch.long), mesh)
        if "pp" in axes:
            with pytest.raises(NotImplementedError, match="item 16"):
                tpl.make_pp_train_step(cfg, mesh, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="pp \\+ sp \\+ MoE"):
        tpl.make_pp_train_step(moe, _Mesh2(pp=2, sp=2), 2, device="cpu")
    with pytest.raises(NotImplementedError, match="pp \\+ sp \\+ MoE"):
        tpl.make_pp_train_step_1f1b(moe, _Mesh2(pp=2, sp=2), 2,
                                    device="cpu")
    for axes in ({"sp": 2}, {"fsdp": 2}):
        with pytest.raises(NotImplementedError, match="MoE.*item 16"):
            ttr.make_train_step(moe, "cpu", mesh=_Mesh2(**axes))
    with pytest.raises(ValueError, match="pp > 1"):
        tpl.make_pp_train_step(cfg, _Mesh2(tp=2), 2, device="cpu")


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
