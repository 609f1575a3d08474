"""The port stands alone: importing horovod_tpu_torch loads no JAX,
optax, flax, ml_dtypes or horovod_tpu module, its entry points refuse to run
without CUDA unless the CPU is asked for, and a request for the card
raises instead of falling back to the CPU or the plain version. The
process world does not come up on gloo when CUDA was asked for, nor
alone when the launcher says there are more ranks (nor does the eager
runtime without the port's launcher or a controller address), the
paths not ported yet raise naming their ROADMAP items (the MoE island
on an fsdp or sp mesh, 18; serving on a mesh, 17), and Adasum and the
quantized codecs raise the reference's usage errors, a codec on a
tp/sp/pp/ep mesh included. The launcher, the elastic modules and the
Spark and Ray integrations load no ``cloudpickle``, ``pyspark``, ``ray``,
``pyarrow`` or ``fsspec`` either, and the integrations' trainers refuse
the card when there is none. ``chip_smoke.py`` imports none of it, and a
serving fleet's worker process serves where JAX cannot be imported."""

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
import horovod_tpu_torch.ops.adasum
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
import horovod_tpu_torch.serve.rpc
import horovod_tpu_torch.serve.worker
import horovod_tpu_torch.serve.router
import horovod_tpu_torch.serve.migrate
import horovod_tpu_torch.serve.trace_merge
import horovod_tpu_torch.callbacks
import horovod_tpu_torch.spark
import horovod_tpu_torch.spark.elastic
import horovod_tpu_torch.spark.estimator
import horovod_tpu_torch.spark.runner
import horovod_tpu_torch.spark.store
import horovod_tpu_torch.ray
import horovod_tpu_torch.ray.elastic
import horovod_tpu_torch.ray.runner
import chip_smoke
import os
banned = ("jax", "jaxlib", "optax", "flax", "horovod_tpu", "ml_dtypes",
          "cloudpickle", "_adasum_model", "pyspark", "ray", "pyarrow",
          "fsspec")
tests = os.path.join(os.getcwd(), "tests") + os.sep
print(sorted(m for m, mod in list(sys.modules.items())
             if m.split(".")[0] in banned
             or (getattr(mod, "__file__", None) or "").startswith(tests)))
"""


def test_import_loads_no_jax_or_reference_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_a_worker_process_serves_where_jax_cannot_be_imported(tmp_path):
    """A fleet worker (``python -m horovod_tpu_torch.serve.worker``)
    started where ``import jax`` raises serves a router's requests, with
    the streams of an engine in this process on the same seed-built
    weights, and exits 0 at shutdown."""
    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.serve import (RouterConfig, ServeConfig,
                                         ServeEngine, ServeRouter,
                                         spawn_worker)

    poison = tmp_path / "jax"
    poison.mkdir()
    (poison / "__init__.py").write_text(
        "raise ImportError('jax is not installed on this machine')\n")
    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32, remat=False)
    sc = ServeConfig(max_batch=2, block_size=4, max_prompt=16,
                     max_new_tokens=4)
    handle = spawn_worker(device="cpu", start_timeout=120, env={
        "PYTHONPATH": str(tmp_path), "OMP_NUM_THREADS": "1"})
    try:
        router = ServeRouter(cfg, None, RouterConfig(n_replicas=1), sc,
                             workers=[handle])
        prompts = [[1, 2, 3, 4, 5], [9, 8, 7]]
        got = router.generate(prompts, 4)
        router.close()
        assert handle.proc.wait(timeout=60) == 0
    finally:
        handle.kill()
    params = ttr.init_params(cfg, torch.Generator("cpu").manual_seed(0),
                             device="cpu")
    assert got == ServeEngine(cfg, params, sc, device="cpu").generate(
        prompts, 4)


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
    # Adasum is ported (item 15.1, tests/test_torch_adasum.py); it
    # refuses an integer tensor with the reference's TypeError, and int8
    # with the reference's ValueError, before any traffic.
    xi = torch.ones(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="adasum is defined for float"):
        collectives.allreduce(xi, Adasum)
    with pytest.raises(TypeError, match="adasum is defined for float"):
        collectives.grouped_allreduce([xi], Adasum)
    with pytest.raises(ValueError, match="Average/Sum only"):
        binding.allreduce_gradients([x], op=Adasum,
                                    compression=Compression.int8)
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
    """Serving on a tp/ep mesh is ported (ROADMAP item 17,
    tests/test_torch_serve_mesh.py): the pool takes a mesh and holds the
    rank's KV heads, and no serve module names the item. The engine
    refuses, before allocating anything, a mesh of another device type,
    a mesh with an fsdp, sp or pp axis, and parameters that are not the
    rank's shards."""
    import inspect

    from horovod_tpu_torch import serve
    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.serve import (bench, decode, engine, kv_cache,
                                         speculative)

    class CpuMesh(_Mesh):
        device_type = "cpu"

    class CudaMesh(_Mesh):
        device_type = "cuda"

    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32)
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    for axis, heads in (("tp", cfg.n_kv_heads // 2), ("ep", cfg.n_kv_heads)):
        pool = serve.init_kv_cache(cfg, 4, 8, mesh=_Mesh(axis), device="cpu")
        assert pool.k.shape == (cfg.n_layers, 4, 8, heads, cfg.head_dim)
    for axis in ("fsdp", "sp", "pp"):
        with pytest.raises(ValueError, match="serving shards over tp and ep"):
            serve.ServeEngine(cfg, params, mesh=CpuMesh(axis), device="cpu")
    with pytest.raises(ValueError, match="not this rank's shard"):
        serve.ServeEngine(cfg, params, mesh=CpuMesh("tp"), device="cpu")
    with pytest.raises(ValueError, match="cannot serve on cpu"):
        serve.ServeEngine(cfg, params, mesh=CudaMesh("tp"), device="cpu")
    assert not hasattr(kv_cache, "MESH_TODO")
    for mod in (serve, bench, decode, engine, kv_cache, speculative):
        assert "item 17" not in inspect.getsource(mod), mod.__name__


class _Mesh2:
    """Stands in for a ``DeviceMesh`` with dims dp=1 and ``axes``, this
    process at index 1 of each."""

    def __init__(self, **axes):
        self.mesh_dim_names = ("dp",) + tuple(axes)
        self._sizes = (1,) + tuple(axes.values())

    def size(self, dim):
        return self._sizes[dim]

    def get_local_rank(self, name):
        return 0 if name == "dp" else 1


def test_pp_and_ep_with_sp_or_fsdp_raise_naming_item_16():
    """The compositions of ROADMAP item 16 are ported
    (tests/test_torch_compose.py): nothing refuses them before any
    traffic any more, and the batch splits over them; pp + sp + MoE
    raises the reference's own error, and the MoE island is built on
    fsdp and sp meshes (item 18, tests/test_torch_moe_island_mesh.py)."""
    import dataclasses

    from horovod_tpu_torch.models import moe as tmoe
    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.parallel import mesh as tmesh
    from horovod_tpu_torch.parallel import pipeline as tpl

    assert not hasattr(tmesh, "UNPORTED_PAIRS")
    assert not hasattr(tmesh, "SHARDING_TODO")
    assert not hasattr(tmoe, "ISLAND_TODO")
    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32)
    moe = dataclasses.replace(cfg, n_experts=4)
    tokens = torch.arange(4 * 9).reshape(4, 9)
    for axes in ({"pp": 2, "sp": 2}, {"fsdp": 2, "pp": 2},
                 {"fsdp": 2, "ep": 2}, {"sp": 2, "ep": 2}):
        mesh = _Mesh2(**axes)
        for c in (cfg, moe):
            ttr._check_shardable(c, mesh)
        rows = tokens[2:] if "fsdp" in axes else tokens
        want = rows[:, 4:] if "sp" in axes else rows
        assert torch.equal(ttr.shard_batch(tokens, mesh), want)
        if "ep" in axes:
            fn = tmoe.make_moe_ffn(moe.moe, mesh, dispatch="island",
                                   codec="int8")
            assert fn.func is tmoe.moe_ffn_island
    with pytest.raises(NotImplementedError, match="pp \\+ sp \\+ MoE"):
        tpl.make_pp_train_step(moe, _Mesh2(pp=2, sp=2), 2, device="cpu")
    with pytest.raises(NotImplementedError, match="pp \\+ sp \\+ MoE"):
        tpl.make_pp_train_step_1f1b(moe, _Mesh2(pp=2, sp=2), 2,
                                    device="cpu")
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


def test_load_builds_every_unbuilt_source_at_once(monkeypatch, tmp_path):
    """The first ``load`` builds the other unbuilt sources beside its
    own (one nvcc each, started together), so the backward's library is
    there when the first backward needs it."""
    from horovod_tpu_torch.ops import _kernels

    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f"// kernel {name}\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = -o ] && '
                    'out="$2"; shift; done\n: > "$out"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    monkeypatch.setattr(_kernels, "BUILD_DIR", build)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(nvcc))
    loaded = []
    monkeypatch.setattr(_kernels.ctypes, "CDLL", loaded.append)
    _kernels.load.cache_clear()
    try:
        _kernels.load("a")
    finally:
        _kernels.load.cache_clear()
    assert loaded == [str(_kernels.library_path("a"))]
    assert _kernels.library_path("b").exists()


def _fake_ray():
    import types

    ray = types.ModuleType("ray")

    def remote(**_kw):
        def wrap(cls):
            class Handle:
                def __init__(self, inst):
                    self._inst = inst

            class RemoteCls:
                @staticmethod
                def remote(*a, **kw):
                    return Handle(cls(*a, **kw))
            return RemoteCls
        return wrap

    ray.remote = remote
    ray.kill = lambda *_a, **_k: None
    return ray


def _fe_init(generator):
    return {"w": torch.zeros(1, 1)}


def _fe_apply(params, x):
    return x @ params["w"]


def _fe_loss(pred, y):
    return ((pred - y) ** 2).mean()


def test_integrations_refuse_the_card_without_one(monkeypatch, tmp_path):
    """The Spark tasks, the functional estimator's model and the Ray
    actors raise for ``device="cuda"`` (and the default) with no card,
    before any world comes up, rather than train on the CPU."""
    import pickle

    import numpy as np
    import torch.distributed as dist

    from horovod_tpu_torch.ray import RayExecutor
    from horovod_tpu_torch.spark import (FunctionalEstimator,
                                         FunctionalModel, Store,
                                         TorchEstimator)
    from horovod_tpu_torch.spark.estimator import Staged

    _clear_launcher_env(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = Store(str(tmp_path), shard_format="pickle")
    store.write_shard("part.0.c0", np.zeros((4, 2), np.float32))
    store.write_array("part.0.meta", {"rows": 4, "chunks": 1, "cols": 2})
    staged = Staged([[0]], 4)
    common = dict(feature_cols=["x"], label_cols=["y"], store=store,
                  num_proc=1)
    for device in (None, "cuda"):
        ests = (FunctionalEstimator(init_fn=_fe_init, apply_fn=_fe_apply,
                                    loss=_fe_loss, device=device, **common),
                TorchEstimator(model=torch.nn.Linear(1, 1),
                               optimizer=torch.optim.SGD,
                               loss=torch.nn.functional.mse_loss,
                               device=device, **common))
        for est in ests:
            task = pickle.loads(pickle.dumps(est.train_task(store, staged)))
            with pytest.raises(RuntimeError, match="no CUDA device"):
                task()
            assert not dist.is_initialized()
        model = FunctionalModel(apply_fn=_fe_apply, params={"w": np.ones(
            (1, 1), np.float32)}, feature_cols=["x"], label_cols=["y"],
            device=device)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model.predict(np.ones((1, 1), np.float32))
        monkeypatch.setitem(sys.modules, "ray", _fake_ray())
        ex = RayExecutor(num_workers=2, device=device)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ex.start()
        assert ex._kv is None
