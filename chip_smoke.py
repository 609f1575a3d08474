"""Chip smoke test of the PyTorch/CUDA port (``horovod_tpu_torch``) on one
NVIDIA H100. Run it from the repository root:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero with no result line:

1. Environment: the card's name and power limit, torch and CUDA
   versions. TF32 is switched off so f32 comparisons are f32.
2. Build: every kernel source under ``horovod_tpu_torch/csrc`` (one
   nvcc per source, in parallel), with ptxas' register/spill report.
   Fails if the bf16 flash kernel spills, or if ptxas ignored its
   ``setmaxnreg`` (C7508) or serialised its ``wgmma``.
3. Kernels against their plain PyTorch versions on the card, at the
   training shape, at the edge cases and at the config's longest
   sequence (T=8192), within the kernel's stated tolerance; then the
   kernel's time beside the plain version's, a library call's
   (``scaled_dot_product_attention``, timed only) and the bound, at the
   training shape and at T=8192.
4. Model check: a small model through the kernel path and through the
   plain ``local`` attention path agree on loss and gradients.
5. The slice: the train step at Llama-3-8B widths cut to 4 layers, bf16,
   B=4, T=2048, 3 warm-up + 5 timed AdamW steps on a fixed token batch.
   Launch counters are zeroed just before and read just after; every
   loss must be finite and falling, and the flash kernel must have run
   n_layers times per step.
6. Data parallel over NCCL: the same slice through the data-parallel
   train step (``make_train_step(mesh=...)``) on a real ``nccl`` world,
   one process per card (a world of 1 on a one-card machine; NCCL takes
   no two ranks on one card), B=4 rows per rank, the same seed and
   tokens. Every loss finite and falling, within 1e-2 of phase 5's at a
   world of 1; flash launches n_layers per step; one grouped allreduce
   a step, of every gradient byte; parameter digests equal on every
   rank. Then the time of one grouped Average allreduce of the full
   gradient set, between CUDA events.
7. The bench entry: ``horovod_tpu_torch.bench.run`` on phase 6's world,
   printing its ``TFEXTRA`` line.

The last lines are the kernels' JSON, the card's ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``. It imports nothing of JAX.

``--dp-only`` runs phases 1, 6 and 7 alone, on two or more cards: the
multi-card check of the data-parallel path (it prints no result line).
"""

import argparse
import dataclasses
import json
import math
import os
import socket
import statistics
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F

from horovod_tpu_torch import bench
from horovod_tpu_torch.binding import allgather_object
from horovod_tpu_torch.common.ops_enum import Average
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.ops import _kernels
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.parallel.mesh import (data_parallel_mesh,
                                             init_process_group)

H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12   # HBM3


def log(*args):
    print(*args, flush=True)


card_line = bench.card_line


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    between CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(b, t, h, hkv, d, causal, itemsize, out_itemsize,
                       flops_per_s):
    """Least time for the forward: the larger of its operations at the
    peak rate (two products, 2 FLOP per multiply-add, over the keys each
    query row needs) and its bytes at the memory rate (q, k, v read
    once; out and the f32 lse written once)."""
    keys = t * (t + 1) // 2 if causal else t * t
    flops = 4 * b * h * d * keys
    nbytes = (b * t * (h + 2 * hkv) * d * itemsize
              + b * t * h * d * out_itemsize + b * h * t * 4)
    ops_ms = flops / flops_per_s * 1e3
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", flops, nbytes)


# name, B, T, H, Hkv, D, dtype, causal, out_dtype
KERNEL_CASES = [
    ("slice", 4, 2048, 32, 8, 128, "bfloat16", True, None),
    ("f32_causal_gqa_d64", 2, 1024, 8, 2, 64, "float32", True, None),
    ("f32_noncausal_ragged_d128", 1, 1000, 4, 4, 128, "float32", False,
     None),
    ("bf16_noncausal_ragged_t1000", 2, 1000, 16, 4, 128, "bfloat16", False,
     None),
    ("bf16_q_per_kv1_d64", 2, 1024, 8, 8, 64, "bfloat16", True, None),
    ("bf16_out_f32_ragged", 2, 777, 8, 8, 128, "bfloat16", True,
     "float32"),
    # A tile that is mostly padding, one row past a tile, a K/V ring
    # that wraps many times; both head dims, q_per_kv 1, 4 and 8.
    ("bf16_t1_gqa4", 2, 1, 8, 2, 128, "bfloat16", True, None),
    ("bf16_t1_noncausal_d64_out_f32", 1, 1, 8, 1, 64, "bfloat16", False,
     "float32"),
    ("bf16_t100_noncausal_gqa8_d64", 2, 100, 16, 2, 64, "bfloat16", False,
     None),
    ("bf16_t100_causal_q1_out_f32", 2, 100, 4, 4, 128, "bfloat16", True,
     "float32"),
    ("bf16_t129_causal_gqa8", 2, 129, 16, 2, 128, "bfloat16", True, None),
    ("bf16_t129_noncausal_gqa4_d64_out_f32", 2, 129, 8, 2, 64, "bfloat16",
     False, "float32"),
    ("bf16_t4096_causal_gqa8_d64", 1, 4096, 16, 2, 64, "bfloat16", True,
     None),
    ("bf16_t4096_noncausal_gqa4_out_f32", 1, 4096, 8, 2, 128, "bfloat16",
     False, "float32"),
    # The config's max_seq, one sequence at Llama-3-8B's heads.
    ("long_t8192", 1, 8192, 32, 8, 128, "bfloat16", True, None),
]


def time_case(b, t, h, hkv, d, q, k, v, kw, plain_iters):
    """Kernel, plain (when ``plain_iters``) and library times of one
    causal bf16 case, and its bound."""
    kern_ms = cuda_ms(lambda: tfa.flash_fwd_cuda(q, k, v, **kw), iters=20)
    plain_ms = (cuda_ms(lambda: tfa.flash_fwd_reference(q, k, v, **kw),
                        iters=plain_iters, warmup=1)
                if plain_iters else None)
    q4, k4, v4 = (x.view(b, -1, t, d) for x in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, enable_gqa=True), iters=20)
    bound = attention_bound_ms(b, t, h, hkv, d, True, 2, 2, H100_BF16_FLOPS)
    return kern_ms, plain_ms, lib_ms, bound


def phase_build():
    """Phase 2: build every kernel source anew (so ptxas reports on
    each) and hold the bf16 flash kernel to no spills and to the
    register split and wgmma pipeline its source asks for."""
    t0 = time.perf_counter()
    logs = _kernels.build_all(force=True)
    log(f"  built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for kernel, r in _kernels.ptxas_report(text).items():
            log(f"  {name}: {kernel}: {r['registers']} registers, "
                f"{r['spill_stores']} / {r['spill_loads']} bytes spill "
                f"stores / loads, {r['smem']} bytes static shared memory")
    warnings = [w for text in logs.values()
                for w in _kernels.ptxas_warnings(text)]
    for w in warnings:
        log(f"  ptxas: {w}")
    bf16 = [r for kernel, r in _kernels.ptxas_report(
        logs["flash_fwd"]).items() if "flash_fwd_wgmma" in kernel]
    if (not bf16 or warnings
            or any(r["spill_stores"] or r["spill_loads"] for r in bf16)):
        raise AssertionError("the bf16 flash kernel spills, is missing "
                             "from the ptxas report, or ptxas ignored its "
                             "setmaxnreg or serialised its wgmma")


def phase_kernels(seed):
    """Phase 3: kernel vs plain on the card, then timing at the slice
    shape and at T=8192. Returns the kernel's JSON entry (launches
    filled later)."""
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(seed)
    slice_err = None
    timed = {}
    for name, b, t, h, hkv, d, dt, causal, odt in KERNEL_CASES:
        dtype = getattr(torch, dt)
        out_dtype = getattr(torch, odt) if odt else None

        def randn(n):
            return torch.randn((n, t, d), generator=gen,
                               device=dev).to(dtype)

        q, k, v = randn(b * h), randn(b * hkv), randn(b * hkv)
        kw = dict(scale=d ** -0.5, causal=causal, out_dtype=out_dtype,
                  q_per_kv=h // hkv)
        out, lse = tfa.flash_fwd_cuda(q, k, v, **kw)
        ref_out, ref_lse = tfa.flash_fwd_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        atol, rtol, lse_tol = tfa.kernel_tolerance(dtype, out_dtype,
                                                   v.abs().max().item())
        diff = (out.float() - ref_out.float()).abs()
        err = diff.max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        excess = (diff - (atol + rtol * ref_out.float().abs())).max().item()
        ok = (out.dtype == (out_dtype or dtype) and excess <= 0
              and lse_err <= lse_tol and math.isfinite(err))
        log(f"  kernel-vs-plain {name}: B={b} T={t} H={h} Hkv={hkv} D={d} "
            f"{dt} causal={causal} out={odt or dt}: max|dout|={err:.3e} "
            f"(atol {atol:.2e} + rtol {rtol:.2e}*|ref|) "
            f"max|dlse|={lse_err:.3e} (tol {lse_tol:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_fwd kernel disagrees with its "
                                 f"plain version in case {name}")
        if name == "slice":
            slice_err = err
        if name in ("slice", "long_t8192"):
            # The plain version is timed at the slice shape only.
            timed[name] = (b, t, h, hkv, d) + time_case(
                b, t, h, hkv, d, q, k, v, kw, 3 if name == "slice" else 0)
        del q, k, v, out, lse, ref_out, ref_lse, diff

    for name, (b, t, h, hkv, d, kern_ms, plain_ms, lib_ms,
               (bound_ms, bound_by, flops, nbytes)) in timed.items():
        plain = "" if plain_ms is None else f"plain {plain_ms:.4f} ms, "
        log(f"  flash_fwd at {name} (bf16 B={b} T={t} H={h} Hkv={hkv} D={d} "
            f"causal): kernel {kern_ms:.4f} ms "
            f"({flops / kern_ms / 1e9:.1f} TFLOP/s), {plain}"
            f"sdpa {lib_ms:.4f} ms (kernel / sdpa time "
            f"{kern_ms / lib_ms:.3f}); bound {bound_ms:.4f} ms by {bound_by} "
            f"({flops:.4e} FLOP, {nbytes:.4e} bytes); kernel at "
            f"{100 * bound_ms / kern_ms:.1f}% of bound")
    _, _, _, _, _, kern_ms, plain_ms, lib_ms, (bound_ms, bound_by, _, _) = \
        timed["slice"]
    return {"name": "flash_fwd", "route": "cuda",
            "source": "horovod_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "horovod_tpu/ops/flash_attention.py:34",
            "launches": None, "max_abs_err": slice_err, "ms": kern_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


def phase_model_check(seed, device):
    """Phase 4: a small model (head dim 64, GQA) through the kernel path
    and through plain attention, on the same weights and tokens."""
    base = ttr.TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                                 n_heads=4, n_kv_heads=2, d_ff=512,
                                 max_seq=256, remat=False)
    gen = torch.Generator(device).manual_seed(seed)
    tokens = torch.randint(0, base.vocab_size, (2, 257), generator=gen,
                           device=device)
    # f32: the f32 kernel keeps f32 arithmetic, so loss and gradients
    # agree to summation order. bf16: both paths round P to bf16 (the
    # plain one casts P to v's dtype) and the layers round activations,
    # so the loss is held to 1e-2 relative.
    for dtype, loss_rtol, grad_atol in ((torch.float32, 1e-5, 1e-4),
                                        (torch.bfloat16, 1e-2, None)):
        cfg = dataclasses.replace(base, dtype=dtype)
        params = ttr.init_params(cfg, gen, device=device)
        results = []
        for impl in ("flash", "local"):
            c = dataclasses.replace(cfg, sp_attention=impl)
            tree = ttr.map_params(
                lambda p: p.detach().clone().requires_grad_(True), params)
            loss = ttr.lm_loss(tree, {"tokens": tokens}, c)
            loss.backward()
            results.append((loss.item(),
                            [p.grad for p in ttr.param_leaves(tree)]))
        (lf, gf), (ll, gl) = results
        gerr = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(gf, gl))
        ok = (math.isfinite(lf) and abs(lf - ll) <= loss_rtol * abs(ll)
              and (grad_atol is None or gerr <= grad_atol))
        log(f"  model check {str(dtype)[6:]}: loss flash {lf:.7f} vs local "
            f"{ll:.7f} (rtol {loss_rtol:.0e}), max|dgrad|={gerr:.3e}"
            f"{'' if grad_atol is None else f' (atol {grad_atol:.0e})'} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("kernel path and plain path disagree")


def phase_slice(cfg, seed, batch, seq, warmup, steps, device):
    """Phase 5: the train step on ``cfg``, ``warmup + steps`` steps."""
    log(f"  config: d_model={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"layers={cfg.n_layers} dtype={cfg.dtype} B={batch} T={seq}")
    gen = torch.Generator(device).manual_seed(seed)
    t0 = time.perf_counter()
    init_state, step = ttr.make_train_step(cfg, device=device)
    state = init_state(gen)
    n_params = sum(p.numel() for p in ttr.param_leaves(state["params"]))
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=gen, device=device)
    torch.cuda.synchronize()
    log(f"  init: {n_params:,} parameters in "
        f"{time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    tfa.flash_fwd_cuda.launches = 0
    losses, times = [], []
    for _ in range(warmup + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, {"tokens": tokens})
        losses.append(loss.item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = tfa.flash_fwd_cuda.launches
    torch.cuda.synchronize()   # surfaces any fault from the steps
    peak = torch.cuda.max_memory_allocated()

    timed = times[warmup:]
    step_s = statistics.median(timed)
    tok_s = batch * seq / step_s
    mfu = 6 * n_params * tok_s / H100_BF16_FLOPS
    want = cfg.n_layers * (warmup + steps)
    log(f"  losses: {[round(x, 5) for x in losses]}")
    log(f"  step times (s): {[round(x, 4) for x in times]}")
    log(f"  step {1e3 * step_s:.1f} ms (median of {steps}; min "
        f"{1e3 * min(timed):.1f}, max {1e3 * max(timed):.1f}), "
        f"{tok_s:.1f} tokens/s, MFU {100 * mfu:.2f}% "
        f"(6 * {n_params} params * tokens/s / 989e12), peak memory "
        f"{peak / 2**30:.2f} GiB; flash_fwd launches {launches} "
        f"(want {want})")
    ok = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
          and launches == want)
    if not ok:
        raise AssertionError("slice failed: losses must be finite and "
                             "falling, and flash_fwd must launch "
                             f"{want} times (got {launches})")

    # The slice's own output against plain attention, at full width: the
    # same final parameters and tokens through the "local" path.
    with torch.no_grad():
        lf = ttr.lm_loss(state["params"], {"tokens": tokens}, cfg).item()
        ll = ttr.lm_loss(state["params"], {"tokens": tokens},
                         dataclasses.replace(cfg, sp_attention="local")
                         ).item()
    log(f"  slice loss after training: flash {lf:.6f} vs local {ll:.6f} "
        f"(rel {abs(lf - ll) / abs(ll):.2e}, tol 1e-2)")
    if not (math.isfinite(lf) and abs(lf - ll) <= 1e-2 * abs(ll)):
        raise AssertionError("slice loss through the kernel disagrees with "
                             "plain attention")
    summary = {"slice": {
        "d_model": cfg.d_model, "n_layers": cfg.n_layers,
        "dtype": str(cfg.dtype),
        "batch": batch, "seq": seq, "n_params": n_params,
        "step_ms_median": 1e3 * step_s, "step_ms": [1e3 * x for x in timed],
        "tokens_per_s": tok_s, "mfu_6N": mfu, "peak_mem_bytes": peak,
        "losses": losses, "flash_fwd_launches": launches}}
    log(json.dumps(summary))
    return launches, losses


def param_digest(params):
    """One integer per parameter tensor: the sum of its bits (as 16- or
    32-bit integers) weighted by position, on the device. Equal
    parameters give equal digests."""
    out = []
    for p in ttr.param_leaves(params):
        bits = p.detach().reshape(-1).view(
            torch.int16 if p.element_size() == 2 else torch.int32)
        total = 0
        for c in range(0, bits.numel(), 1 << 26):
            chunk = bits[c:c + (1 << 26)].to(torch.int64)
            pos = torch.arange(c, c + chunk.numel(), device=p.device)
            total += int((chunk * (pos % 65521 + 1)).sum())
        out.append(total)
    return out


def phase_dp(cfg, seed, batch, seq, warmup, steps, device, mesh,
             slice_losses):
    """Phase 6 on every rank of ``mesh``'s world: the data-parallel
    train step on ``batch`` rows a rank, checks, and the grouped
    allreduce's time. Rank 0 prints."""
    n, rank = mesh.size(), dist.get_rank()
    say = log if rank == 0 else (lambda *a: None)
    cuda = device.type == "cuda"
    say(f"  world: {n} process(es), backend {dist.get_backend()}, rank 0 "
        f"on {device}; B={batch} rows a rank of a global batch of "
        f"{batch * n}")
    gen = torch.Generator(device).manual_seed(seed)
    init_state, step = ttr.make_train_step(cfg, device=device, mesh=mesh)
    state = init_state(gen)
    leaves = ttr.param_leaves(state["params"])
    n_params = sum(p.numel() for p in leaves)
    grad_bytes = sum(p.numel() * p.element_size() for p in leaves)
    # The same draws as phase 5: at a world of 1, its parameters and
    # tokens.
    tokens = torch.randint(0, cfg.vocab_size, (batch * n, seq + 1),
                           generator=gen, device=device)
    local = {"tokens": ttr.shard_batch(tokens, mesh)}

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    tfa.flash_fwd_cuda.launches = 0
    collectives.grouped_allreduce.calls = 0
    collectives.grouped_allreduce.bytes = 0
    losses, times = [], []
    for _ in range(warmup + steps):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, local)
        losses.append(loss.item())
        if cuda:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = tfa.flash_fwd_cuda.launches
    calls = collectives.grouped_allreduce.calls
    reduced = collectives.grouped_allreduce.bytes
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    timed = times[warmup:]
    step_s = statistics.median(timed)
    tok_s = batch * seq / step_s
    mfu = 6 * n_params * tok_s / H100_BF16_FLOPS
    digests = allgather_object(param_digest(state["params"]))
    want = warmup + steps
    say(f"  losses: {[round(x, 5) for x in losses]}")
    if n == 1:
        say(f"  phase 5 losses: {[round(x, 5) for x in slice_losses]}")
    say(f"  step times (s): {[round(x, 4) for x in times]}")
    say(f"  step {1e3 * step_s:.1f} ms (median of {steps}; min "
        f"{1e3 * min(timed):.1f}, max {1e3 * max(timed):.1f}), "
        f"{tok_s:.1f} tokens/s/GPU, MFU {100 * mfu:.2f}% "
        f"(6 * {n_params} params * tokens/s / 989e12), peak memory "
        f"{peak / 2**30:.2f} GiB; flash_fwd launches {launches} (want "
        f"{cfg.n_layers * want if cuda else 0}); grouped allreduces "
        f"{calls} of {reduced} bytes (want {want} of {want * grad_bytes}); "
        f"parameter digests equal on {len(digests)} rank(s): "
        f"{all(d == digests[0] for d in digests)}")
    ok = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
          and (n > 1 or all(abs(a - b) <= 1e-2 * abs(b)
                            for a, b in zip(losses, slice_losses)))
          and launches == (cfg.n_layers * want if cuda else 0)
          and calls == want and reduced == want * grad_bytes
          and all(d == digests[0] for d in digests))
    if not ok:
        raise AssertionError("data-parallel step failed: losses must be "
                             "finite, falling and (world of 1) within 1e-2 "
                             "of phase 5's; flash_fwd and the grouped "
                             "allreduce must run once a layer and once a "
                             "step; parameters must agree on every rank")

    grads = [p.grad for p in leaves]
    group = mesh.get_group("dp")
    ar_ms = cuda_ms(lambda: collectives.grouped_allreduce(
        grads, Average, group), iters=5, warmup=1) if cuda else float("nan")
    say(f"  grouped Average allreduce of every gradient: {grad_bytes} "
        f"bytes in {ar_ms:.3f} ms ({grad_bytes / ar_ms / 1e6:.1f} GB/s, "
        f"CUDA events, mean of 5)")
    say(json.dumps({"data_parallel": {
        "world": n, "batch_per_rank": batch, "seq": seq,
        "step_ms_median": 1e3 * step_s, "step_ms": [1e3 * x for x in timed],
        "tokens_per_s_per_gpu": tok_s, "mfu_6N": mfu,
        "peak_mem_bytes": peak, "losses": losses,
        "flash_fwd_launches": launches, "grouped_allreduce_calls": calls,
        "grouped_allreduce_bytes": reduced, "grad_bytes": grad_bytes,
        "allreduce_ms": ar_ms}}))


# Phase 6's slice (phase 5's) and phase 7's bench arguments (bench.run's
# defaults: bench.py's arms and sizes).
DP_DIMS = dict(batch=4, seq=2048, warmup=3, steps=5)
BENCH_DIMS = {}


def dp_world(rank, n, port, cfg, seed, slice_losses, device=None,
             dims=(DP_DIMS, BENCH_DIMS)):
    """Phases 6 and 7 as rank ``rank`` of ``n`` (one process per card).
    ``device="cpu"`` and smaller ``dims`` rehearse them on gloo."""
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    device = init_process_group(device)
    try:
        mesh = data_parallel_mesh()
        phase_dp(cfg, seed, **dims[0], device=device, mesh=mesh,
                 slice_losses=slice_losses)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if rank == 0:
            log("phase 7: the bench entry (horovod_tpu_torch.bench)")
        out = bench.run(mesh, device, **dims[1])
        keys = ("transformer_std_tokens_per_sec_per_chip",
                "transformer_tokens_per_sec_per_chip")
        if device.type == "cuda" and bench.peak_flops(bench.device_name(
                device)):
            keys += ("transformer_std_mfu_pct", "transformer_mfu_pct")
        if not all(out.get(k, 0) > 0 for k in keys):
            raise AssertionError(f"bench entry: want {keys}, got {out}")
    finally:
        dist.destroy_process_group()


def run_dp(cfg, seed, slice_losses):
    """Phases 6-7: one process per card (NCCL refuses two ranks on
    one); a world of 1 runs in this process."""
    n = torch.cuda.device_count()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    log(f"phase 6: data parallel over NCCL ({n} card(s), one process "
        f"each)")
    dp_args = (n, port, cfg, seed, slice_losses)
    if n == 1:
        dp_world(0, *dp_args)
    else:
        mp.spawn(dp_world, args=dp_args, nprocs=n, join=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dp-only", action="store_true",
                    help="run phases 1, 6 and 7 only, on two or more "
                         "cards: the multi-card check of the data-parallel "
                         "path")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    if args.dp_only and torch.cuda.device_count() < 2:
        print("chip_smoke: --dp-only needs two or more cards",
              file=sys.stderr)
        return 1

    log("phase 1: environment")
    card = card_line()
    log(f"  card: {card}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Llama-3-8B at its published widths, depth cut from 32 layers to 4.
    cfg = dataclasses.replace(ttr.TransformerConfig.llama3_8b(), n_layers=4,
                              sp_attention="flash", remat=False)
    if args.dp_only:
        run_dp(cfg, args.seed, slice_losses=None)
        print(card_line(), flush=True)
        return 0

    log("phase 2: build")
    phase_build()

    log("phase 3: kernels vs plain versions")
    entry = phase_kernels(args.seed)
    torch.cuda.empty_cache()

    log("phase 4: model check (kernel path vs plain attention)")
    phase_model_check(args.seed, torch.device("cuda"))
    torch.cuda.empty_cache()

    log("phase 5: the slice (train step, Llama-3-8B widths, 4 layers)")
    entry["launches"], slice_losses = phase_slice(
        cfg, args.seed, batch=4, seq=2048, warmup=3, steps=5,
        device=torch.device("cuda"))
    torch.cuda.empty_cache()

    run_dp(cfg, args.seed, slice_losses)

    torch.cuda.synchronize()
    print(json.dumps({"kernels": [entry]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
