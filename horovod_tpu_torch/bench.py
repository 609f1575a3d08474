"""Training throughput of the port — the JAX-free twin of the
repository's ``bench.py``: its headline ResNet-50 arm (``main``) and its
transformer arms (``_transformer_worker``).

Run one process per GPU, with the launcher's environment
(``HOROVOD_RANK``/``HOROVOD_SIZE``/``HOROVOD_LOCAL_RANK`` and
``MASTER_ADDR``/``MASTER_PORT``; a single process needs none of them):

    python -m horovod_tpu_torch.bench

The ResNet-50 arm (:func:`run_resnet`) follows the reference protocol:
bf16, 1000 classes, synthetic normal ``(B, 224, 224, 3)`` images and
labels in ``[0, 1000)`` from a seed, batch 32 per GPU (``BENCH_BATCH``
sets the global batch, as in the reference), f32 log-softmax
cross-entropy, SGD with lr 0.01 and momentum 0.9, 10 warm-up steps and
then 10 rounds of 10 steps timed as one region with one final sync;
it reports images/s per GPU. BatchNorm runs over the global batch
(:mod:`horovod_tpu_torch.models.resnet`).

Then every process runs the same two transformer arms (:func:`run`)
through the data-parallel ``make_train_step`` (bf16, flash attention,
no remat) at 8 rows of 1024 tokens per GPU, 3 warm-up and 20 timed
steps:

* ``transformer_std``: vocab 8192, d_model 2048, 8 layers, 16/8 heads,
  d_ff 8192;
* ``transformer``: d_model 4096, 4 layers, 32/8 heads, d_ff 16384.

Rank 0 prints the card's ``nvidia-smi`` name and power limit, then
``TFEXTRA {json}`` after each transformer arm with ``bench.py``'s keys:
``<arm>_tokens_per_sec_per_chip`` (tokens per second per GPU) and
``<arm>_mfu_pct`` (6·params·tokens/s over the card's dense bf16 peak;
left out on a card whose peak is not known).

Then the compression arms (:func:`run_compression`, the reference's
``comp_arms``): the same data-parallel step at ``compression=None``,
``Compression.bf16`` and ``Compression.int8`` (vocab 4096, d_model
1024, 4 layers, 16/8 heads, d_ff 4096, plain ``"local"`` attention, 512
tokens, 4 rows a GPU), interleaved best-of-3 rounds of 5 steps, keys
``transformer_{comp_none,bf16,int8}_tokens_per_sec_per_chip`` and
``transformer_mfu_{comp_none,bf16,int8}``; on more than one GPU also
the fsdp step over every GPU (``fsdp_comp_{none,bf16,int8}``).

Then the MoE arms (:func:`run_moe`, the reference's ``_moe_worker``):
one MoE layer (d_model 256, 8 experts, top-2, capacity factor 1.25,
vocab 2048, 4 heads, d_ff 512, bf16, plain ``"local"`` attention) on an
ep mesh over every process, 2 rows of 128 tokens a GPU, every rank
holding every row: the GSPMD dispatch and, on more than one GPU, the
quantized-alltoall island at codecs none, bf16 and int8 (none takes the
GSPMD path, as the routing discipline says), interleaved best-of-3
rounds of 3 steps after 2 warm-up steps; keys
``moe_tokens_per_sec_{gspmd,none,bf16,int8}`` and, on more than one
GPU, ``moe_dispatch_bytes_saved_pct`` (int8 against f32 slabs on one
dispatch hop, from ``alltoall_wire_bytes``). Rank 0 prints ``MOEEXTRA
{json}`` after each round.

Then the serve arm (:func:`run_serve`, the reference's
``_serve_worker`` without its fleet tiers): Llama-3-8B at full depth
(``CFG_SERVE``) on every process's own card through
:mod:`horovod_tpu_torch.serve.bench` — continuous, static and chunked
scheduling, the tracing tax, the prefix cache and speculative decoding
(a 2-layer draft, an 8-layer target) — with the reference's ``serve_*``
keys; rank 0 prints ``SERVEEXTRA {json}`` after each tier.

Its last line is the reference's primary line, ``{"metric":
"resnet50_images_per_sec_per_chip", "value", "unit": "images/sec",
"vs_baseline", "extra"}``, with the transformer and serve keys in
``extra``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import time

import torch
import torch.distributed as dist

from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models.moe import capacity as moe_capacity
from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                  make_train_step,
                                                  param_leaves, param_shapes,
                                                  shard_batch)
from horovod_tpu_torch.ops.quantized import alltoall_wire_bytes
from horovod_tpu_torch.parallel.mesh import (build_mesh, data_parallel_mesh,
                                             init_process_group)

CFG_STD = TransformerConfig(
    vocab_size=8192, d_model=2048, n_layers=8, n_heads=16, n_kv_heads=8,
    d_ff=8192, max_seq=1024, dtype=torch.bfloat16, sp_attention="flash",
    remat=False, scan_unroll=8)
CFG_WIDE = TransformerConfig(
    vocab_size=8192, d_model=4096, n_layers=4, n_heads=32, n_kv_heads=8,
    d_ff=16384, max_seq=1024, dtype=torch.bfloat16, sp_attention="flash",
    remat=False, scan_unroll=4)
ARMS = (("transformer_std", CFG_STD), ("transformer", CFG_WIDE))
#: The compression arms' model (the reference's ``comp_arms`` config).
CFG_COMP = TransformerConfig(
    vocab_size=4096, d_model=1024, n_layers=4, n_heads=16, n_kv_heads=8,
    d_ff=4096, max_seq=512, dtype=torch.bfloat16, sp_attention="local",
    remat=False)
COMP_CODECS = (("none", None), ("bf16", Compression.bf16),
               ("int8", Compression.int8))
#: The MoE arms' model (the reference's ``_moe_worker`` config).
CFG_MOE = TransformerConfig(
    vocab_size=2048, d_model=256, n_layers=1, n_heads=4, n_kv_heads=4,
    d_ff=512, max_seq=128, dtype=torch.bfloat16, sp_attention="local",
    remat=False, n_experts=8, moe_top_k=2, moe_capacity_factor=1.25)

#: The serve arm's model (:func:`run_serve`): Llama-3-8B at its full
#: depth, as ``chip_smoke.py`` phase 14 serves it.
CFG_SERVE = TransformerConfig.llama3_8b(sp_attention="flash", remat=False)

#: The reference bench's ResNet-50 baseline, images/s per device (its
#: ``REF_R50_IMG_PER_SEC_PER_DEVICE``, derived from Horovod's published
#: P100 numbers): ``vs_baseline`` is the value over it.
REF_R50_IMG_PER_SEC_PER_DEVICE = 207.0
RESNET50 = resnet.ResNetConfig()


def peak_flops(card_name: str):
    """Dense bf16 peak of the card named ``card_name``
    (``torch.cuda.get_device_name``), or None where it is not known:
    989 TFLOP/s for the H100 SXM (HBM3), 756 for the H100 PCIe."""
    if "H100" not in card_name:
        return None
    if "PCIe" in card_name:
        return 756e12
    if "HBM3" in card_name or "SXM" in card_name:
        return 989e12
    return None


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def card_line() -> str:
    """The first card's ``nvidia-smi`` name and power limit."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def measure(cfg: TransformerConfig, mesh, device, *, batch_per_gpu: int,
            seq: int, warmup: int, iters: int, peak=None):
    """Train ``cfg`` on ``batch_per_gpu`` rows of ``seq`` tokens a rank
    (parameters from seed 0, tokens from seed 1, as ``bench.py``);
    return (tokens/s per GPU over the ``iters`` timed steps, MFU in %
    or None without ``peak``), rounded as ``bench.py`` rounds them."""
    init_state, step = make_train_step(cfg, device, mesh=mesh)
    state = init_state(torch.Generator(device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size,
                           (batch_per_gpu * mesh.size(), seq + 1),
                           generator=torch.Generator(device).manual_seed(1),
                           device=device)
    batch = {"tokens": shard_batch(tokens, mesh)}
    for _ in range(warmup):
        state, loss = step(state, batch)
    loss.item()
    t0 = time.perf_counter()
    for _ in range(iters):
        state, loss = step(state, batch)
    loss.item()    # the loss is averaged over the ranks: all have finished
    dt = time.perf_counter() - t0
    tok_s = batch_per_gpu * seq * iters / dt
    n_params = sum(p.numel() for p in param_leaves(state["params"]))
    mfu = round(100 * 6 * n_params * tok_s / peak, 1) if peak else None
    return round(tok_s, 1), mfu


def run(mesh, device, arms=ARMS, *, batch_per_gpu: int = 8,
        seq: int = 1024, warmup: int = 3, iters: int = 20):
    """Measure each ``(prefix, cfg)`` of ``arms`` on ``mesh``; rank 0
    prints ``TFEXTRA {json}`` after each. Returns the dict."""
    lead = dist.get_rank() == 0
    if lead and device.type == "cuda":
        print(f"card: {card_line()}", flush=True)
    peak = peak_flops(device_name(device))
    out = {}
    for prefix, cfg in arms:
        tok_s, mfu = measure(cfg, mesh, device, batch_per_gpu=batch_per_gpu,
                             seq=seq, warmup=warmup, iters=iters, peak=peak)
        out[f"{prefix}_tokens_per_sec_per_chip"] = tok_s
        if mfu is not None:
            out[f"{prefix}_mfu_pct"] = mfu
        if lead:
            print("TFEXTRA " + json.dumps(out), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def run_compression(device, cfg: TransformerConfig = CFG_COMP, *,
                    batch_per_gpu: int = 4, seq: int = 512, iters: int = 5,
                    rounds: int = 3) -> dict:
    """The compression arms (module docstring): the data-parallel step
    over every process at each codec and, on more than one, the fsdp
    step over every process; each arm's best tokens/s per GPU over
    ``rounds`` interleaved rounds of ``iters`` steps, after 2 warm-up
    steps. Rank 0 prints ``TFEXTRA {json}`` after each plane. Returns
    the keys."""
    n = dist.get_world_size()
    lead = dist.get_rank() == 0
    peak = peak_flops(device_name(device))
    toks = torch.randint(0, cfg.vocab_size, (batch_per_gpu * n, seq + 1),
                         generator=torch.Generator(device).manual_seed(2),
                         device=device)
    # The reference's arm names: comp_none/bf16/int8 on dp, and
    # fsdp_comp_none/bf16/int8 on fsdp.
    planes = [({"none": "comp_none", "bf16": "bf16", "int8": "int8"},
               build_mesh(dp=n))]
    if n > 1:
        planes.append(({c: f"fsdp_comp_{c}" for c, _ in COMP_CODECS},
                       build_mesh(dp=1, fsdp=n)))
    n_params = sum(math.prod(s) for s in param_leaves(param_shapes(cfg)))
    out = {}
    for names, mesh in planes:
        batch = {"tokens": shard_batch(toks, mesh)}
        live, best = {}, {}
        for codec, comp in COMP_CODECS:
            init_state, step = make_train_step(cfg, device, mesh=mesh,
                                               compression=comp)
            state = init_state(torch.Generator(device).manual_seed(0))
            for _ in range(2):
                state, loss = step(state, batch)
            loss.item()
            live[names[codec]], best[names[codec]] = (step, state), 0.0
        for _ in range(rounds):
            for name, (step, state) in live.items():
                t0 = time.perf_counter()
                for _ in range(iters):
                    state, loss = step(state, batch)
                loss.item()
                dt = time.perf_counter() - t0
                best[name] = max(best[name],
                                 batch_per_gpu * seq * iters / dt)
        for name, tok_s in best.items():
            out[f"transformer_{name}_tokens_per_sec_per_chip"] = round(
                tok_s, 1)
            if peak:
                out[f"transformer_mfu_{name}"] = round(
                    100 * 6 * n_params * tok_s / peak, 1)
        if lead:
            print("TFEXTRA " + json.dumps(out), flush=True)
        del live
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def run_moe(device, cfg: TransformerConfig = CFG_MOE, *, rows_per_gpu: int = 2,
            seq: int = 128, iters: int = 3, rounds: int = 3) -> dict:
    """The MoE arms (module docstring) on ``build_mesh(dp=1, ep=n)``:
    each arm's best tokens/s per GPU over ``rounds`` interleaved rounds
    of ``iters`` steps, after 2 warm-up steps. Rank 0 prints ``MOEEXTRA
    {json}`` after each round. Returns the keys."""
    n = dist.get_world_size()
    lead = dist.get_rank() == 0
    mesh = build_mesh(dp=1, ep=n)
    rows = rows_per_gpu * n
    toks = torch.randint(0, cfg.vocab_size, (rows, seq + 1),
                         generator=torch.Generator(device).manual_seed(3),
                         device=device)
    batch = {"tokens": shard_batch(toks, mesh)}
    arms = {"gspmd": ("gspmd", None)}
    if n > 1:
        arms.update({c: ("island", c) for c in ("none", "bf16", "int8")})
    live, best, out = {}, {}, {}
    for name, (disp, codec) in arms.items():
        c = dataclasses.replace(cfg, moe_dispatch=disp, moe_compression=codec)
        init_state, step = make_train_step(c, device, mesh=mesh)
        state = init_state(torch.Generator(device).manual_seed(0))
        for _ in range(2):
            state, loss = step(state, batch)
        loss.item()
        live[name], best[name] = (step, state), 0.0
    for _ in range(rounds):
        for name, (step, state) in live.items():
            t0 = time.perf_counter()
            for _ in range(iters):
                state, loss = step(state, batch)
            loss.item()
            dt = time.perf_counter() - t0
            best[name] = max(best[name], rows * seq * iters / dt / n)
        for name, tok_s in best.items():
            out[f"moe_tokens_per_sec_{name}"] = round(tok_s, 1)
        if lead:
            print("MOEEXTRA " + json.dumps(out), flush=True)
    if n > 1:
        shape = (n, cfg.n_experts // n, rows // n,
                 moe_capacity(cfg.moe, seq), cfg.d_model)
        out["moe_dispatch_bytes_saved_pct"] = round(100.0 * (
            1.0 - alltoall_wire_bytes(shape, "int8")
            / alltoall_wire_bytes(shape, "none")), 1)
        if lead:
            print("MOEEXTRA " + json.dumps(out), flush=True)
    del live
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def run_serve(device, cfg: TransformerConfig = CFG_SERVE, *,
              n_requests: int = 32, spec_requests: int = 24,
              trace_requests: int = 24, repeats: int = 3,
              draft_layers: int = 2, target_layers: int = 8,
              emit=None) -> dict:
    """The serve arm (the reference's ``_serve_worker`` without its fleet
    tiers), one engine on ``device`` with ``cfg``: continuous, static
    and chunked scheduling on the mixed trace
    (``run_serving_benchmark``), the tracing tax
    (``run_trace_overhead_benchmark``), the prefix cache on the
    shared-prompt trace (``run_prefix_benchmark``) and speculative
    decoding with a ``draft_layers`` / ``target_layers`` pair of
    ``cfg``'s widths (``run_spec_benchmark``). ``emit(keys)`` is called
    after each tier. Returns the ``serve_*`` keys and
    ``flight_dump_ms``."""
    from horovod_tpu_torch.serve import bench as sbench

    emit = emit or (lambda keys: None)
    out = sbench.run_serving_benchmark(n_requests, model_cfg=cfg,
                                       repeats=repeats, device=device)
    emit(out)
    out.update(sbench.run_trace_overhead_benchmark(
        trace_requests, model_cfg=cfg, repeats=max(repeats, 2),
        device=device))
    emit(out)
    out.update(sbench.run_prefix_benchmark(n_requests, model_cfg=cfg,
                                           repeats=repeats, device=device))
    emit(out)
    out.update(sbench.run_spec_benchmark(
        spec_requests, draft_cfg=dataclasses.replace(cfg,
                                                     n_layers=draft_layers),
        target_layers=target_layers, repeats=repeats, device=device))
    emit(out)
    return out


def run_resnet(mesh, device, cfg: resnet.ResNetConfig = RESNET50, *,
               image_size: int = 224, batch: int = 0, warmup: int = 10,
               rounds: int = 10, iters: int = 10) -> dict:
    """The reference's ResNet arm on ``mesh``: a global batch of
    ``batch`` rows (default ``BENCH_BATCH``, else 32 a GPU), weights from
    seed 1 and data from seed 0 (as ``bench.py`` draws them), ``warmup``
    steps, then ``rounds * iters`` steps timed as one region. Returns
    ``{"images_per_sec_per_gpu", "step_ms", "batch", "losses"}`` (the
    losses of every step, the global means)."""
    world = mesh.size()
    batch = batch or int(os.environ.get("BENCH_BATCH", str(32 * world)))
    if batch % world:
        raise ValueError(f"global batch {batch} does not divide over "
                         f"{world} GPUs")
    init_state, step = resnet.make_train_step(cfg, device, mesh=mesh)
    state = init_state(torch.Generator(device).manual_seed(1))
    gen = torch.Generator(device).manual_seed(0)
    images = torch.randn((batch, image_size, image_size, 3), generator=gen,
                         device=device).to(torch.bfloat16)
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen,
                           device=device)
    local = {"images": shard_batch(images, mesh),
             "labels": shard_batch(labels, mesh)}
    losses = []
    for _ in range(warmup):
        state, loss = step(state, local)
        losses.append(loss)
    loss.item()
    t0 = time.perf_counter()
    for _ in range(rounds * iters):
        state, loss = step(state, local)
        losses.append(loss)
    loss.item()    # the loss is averaged over the ranks: all have finished
    dt = time.perf_counter() - t0
    return {"images_per_sec_per_gpu": batch * rounds * iters / dt / world,
            "step_ms": 1e3 * dt / (rounds * iters), "batch": batch,
            "losses": torch.stack(losses).tolist(), "state": state}


def primary_line(images_per_sec: float, extra: dict) -> dict:
    """The reference bench's primary JSON line."""
    return {"metric": "resnet50_images_per_sec_per_chip",
            "value": round(images_per_sec, 2), "unit": "images/sec",
            "vs_baseline": round(
                images_per_sec / REF_R50_IMG_PER_SEC_PER_DEVICE, 3),
            "extra": extra}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu runs on gloo (default: this rank's card)")
    args = ap.parse_args(argv)
    device = init_process_group(args.device)
    try:
        mesh = data_parallel_mesh()
        r50 = run_resnet(mesh, device)
        del r50["state"]
        if device.type == "cuda":
            torch.cuda.empty_cache()
        extra = run(mesh, device)
        extra.update(run_compression(device))
        extra.update(run_moe(device))
        lead = dist.get_rank() == 0
        extra.update(run_serve(device, emit=lambda keys: lead and print(
            "SERVEEXTRA " + json.dumps(keys), flush=True)))
        if dist.get_rank() == 0:
            print(json.dumps(primary_line(r50["images_per_sec_per_gpu"],
                                          extra)), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
