"""The port's entry points: ``horovod_tpu_torch.graft_entry.entry()``
against the repository's ``__graft_entry__.entry()``, and the jax-free
bench entry ``horovod_tpu_torch.bench``.

``entry()``'s forward is held against the JAX one on the same weights
(JAX's, bridged by ``params_from_jax``) at the JAX ``_cfg(tiny=True)``
shape in f32: rtol/atol 2e-5 on the logits, the tolerance of
``tests/test_torch_transformer.py`` (f32 matmul summation order). The
flagship config itself is compared field by field.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__ as jentry
from horovod_tpu_torch import bench, graft_entry
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.parallel.mesh import (data_parallel_mesh,
                                             init_process_group)


def test_flagship_config_matches_the_reference():
    for tiny in (False, True):
        want = dataclasses.asdict(jentry._cfg(tiny))
        got = dataclasses.asdict(graft_entry._cfg(tiny))
        for field in ("vocab_size", "d_model", "n_layers", "n_heads",
                      "n_kv_heads", "d_ff", "max_seq", "rope_theta",
                      "norm_eps", "remat", "sp_attention"):
            assert got[field] == want[field], field
        assert got["dtype"] == torch.bfloat16
        assert want["dtype"] == jnp.bfloat16


def test_entry_forward_matches_jax(monkeypatch):
    def tiny_f32(cfg_mod, dtype):
        cfg = dataclasses.replace(cfg_mod._cfg(True), dtype=dtype)
        return lambda tiny=False: cfg

    monkeypatch.setattr(jentry, "_cfg", tiny_f32(jentry, jnp.float32))
    monkeypatch.setattr(graft_entry, "_cfg",
                        tiny_f32(graft_entry, torch.float32))
    fwd_j, (params_j, tokens_j) = jentry.entry()
    fwd_t, (params_t, tokens_t) = graft_entry.entry(device="cpu")

    assert tuple(tokens_t.shape) == tuple(tokens_j.shape) == (4, 512)
    assert not tokens_t.any() and tokens_t.dtype == torch.int32
    assert ({k: tuple(v.shape) for k, v in params_t["layers"].items()}
            == {k: tuple(v.shape) for k, v in params_j["layers"].items()})

    toks = np.random.default_rng(0).integers(0, 512, (2, 64)).astype(
        np.int32)
    want = np.asarray(fwd_j(params_j, jnp.asarray(toks)))
    bridged = ttr.params_from_jax(jax.tree.map(np.asarray, params_j),
                                  device="cpu")
    got = fwd_t(bridged, torch.from_numpy(toks)).numpy()
    assert got.shape == want.shape == (2, 64, 512)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.fixture()
def world_of_one(monkeypatch):
    for k in ("HOROVOD_SIZE", "HOROVOD_RANK", "OMPI_COMM_WORLD_SIZE",
              "OMPI_COMM_WORLD_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    device = init_process_group("cpu")
    try:
        yield device, data_parallel_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("card, keys", [
    ("cpu", ("transformer_std_tokens_per_sec_per_chip",
             "transformer_tokens_per_sec_per_chip")),
    ("NVIDIA H100 80GB HBM3", ("transformer_std_tokens_per_sec_per_chip",
                               "transformer_std_mfu_pct",
                               "transformer_tokens_per_sec_per_chip",
                               "transformer_mfu_pct")),
])
def test_bench_prints_tfextra_lines(world_of_one, monkeypatch, capsys, card,
                                    keys):
    device, mesh = world_of_one
    monkeypatch.setattr(bench, "device_name", lambda device: card)
    arms = [(prefix, dataclasses.replace(
        ttr.TransformerConfig.tiny(dtype=torch.float32, remat=False),
        sp_attention="flash")) for prefix, _ in bench.ARMS]
    out = bench.run(mesh, device, arms, batch_per_gpu=2, seq=16, warmup=1,
                    iters=2)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("TFEXTRA ")]
    assert len(lines) == 2
    last = json.loads(lines[-1][len("TFEXTRA "):])
    assert last == out and tuple(last) == keys
    assert all(v > 0 for k, v in last.items() if "tokens" in k)
    assert all(v >= 0 for k, v in last.items() if "mfu" in k)


def test_peak_flops_is_keyed_on_the_card_name():
    assert bench.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert bench.peak_flops("NVIDIA H100 SXM5 80GB") == 989e12
    assert bench.peak_flops("NVIDIA H100 PCIe") == 756e12
    for other in ("NVIDIA H100 NVL", "NVIDIA A100-SXM4-80GB", "cpu"):
        assert bench.peak_flops(other) is None
    assert bench.ARMS[0][1].d_model == 2048 and bench.ARMS[0][1].n_layers == 8
    assert bench.ARMS[1][1].d_model == 4096 and bench.ARMS[1][1].d_ff == 16384
