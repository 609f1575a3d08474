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
8. The eager plane at full width: ``horovod_tpu_torch.torch.init()``
   (the port's build of the native coordination core, and the
   NCCL executor), one process per card, phase 5's configuration, seed
   and tokens, 3 warm-up + 5 timed steps of forward, ``lm_loss``,
   ``loss.backward()`` (whose hooks enqueue one named async allreduce a
   gradient) and ``optimizer.step()`` on ``hvd.DistributedOptimizer``
   over phase 5's AdamW. Launch and executor counters are zeroed just
   before the steps and read just after. Every loss finite and falling,
   within 1e-2 of phase 5's at a world of 1; flash launches n_layers per
   step; the executor ran every gradient byte each step and the host
   plane none; parameter digests equal on every rank. It prints the
   step, tokens/s/GPU, MFU, peak memory, the exposed communication (CUDA
   events from the end of ``backward()`` to the end of
   ``synchronize()``), and one ``hvd.grouped_allreduce`` of the full
   gradient set beside phase 6's ``collectives.grouped_allreduce`` of
   the same bytes. Then it reads the telemetry and core surfaces
   (``metrics()`` and its cost a snapshot, ``metrics_prometheus``,
   ``metrics_aggregate`` over the ranks, ``flight_events``,
   ``steady_*``, ``collective_algo``, ``topology``, ``reduce_threads``,
   ``stalled_tensors``).
9. The launcher and elastic training (``python -m
   horovod_tpu_torch.runner``): a static launch, two in-place resets and
   a respawn of an elastic worker.
10. ResNet-50, the bench's headline arm: first the bf16 step against
   the f32 step from the same weights at 64x64 (8 images, 3 SGD steps,
   TF32 off), losses within ``RESNET_BF16_RTOL``; then
   ``horovod_tpu_torch.bench.run_resnet`` at full width (1000 classes,
   224², batch 32 a card, bf16, SGD lr 0.01 momentum 0.9, 10 warm-up
   steps, then 10 rounds of 10 timed as one region), in a fresh process
   as the bench runs it, not after the earlier phases. It prints images/s
   per GPU, the step, peak memory, the losses (finite and falling) and
   the model-FLOP share: 3 forward passes' conv and dense FLOPs a
   training image (``resnet.forward_flops``, 24.5 GFLOP at 224²) times
   images/s over 989e12.

11. The quantized gradient plane, in a fresh process (as phase 10):
   the int8 codec on the slice's ``[128256, 4096]`` embedding leaf,
   bitwise against its CPU version, then its encode, decode and fused
   pieces' ms beside their byte bound; then phase 5's slice, seed and
   tokens through ``make_train_step(mesh=dp 1, compression=...)`` with
   ``Compression.int8`` (error feedback) and ``Compression.bf16``, 3
   warm-up + 5 timed steps, counters zeroed just before and read just
   after. Every loss finite, falling and within ``COMP_LOSS_SHARE`` of
   phase 5's drop (first less last loss) of phase 5's; flash launches
   n_layers a step; the quantized plane's collective calls and send
   bytes a step equal to the formula (``plane_counts``). It prints the
   step, tokens/s/GPU, MFU, peak memory and the gradient plane's own ms
   and share of the step.

12. Tensor and sequence parallelism, on one card: one B=1, T=8192
   sequence (Llama-3-8B's heads, bf16) cut into 4 chunks, each chunk's
   queries run through ``ring_flash_attention``'s attend-and-merge over
   the chunks in ring order (the kernel on every chunk at or before the
   own, causal on the own), forward and backward, against the
   whole-sequence ``flash_attention_with_lse`` (``phase_ring_merge``;
   the NCCL rotation itself runs only on more cards).

13. MoE on one card (``phase_moe``): Llama-3-8B's widths with 8
   experts, top-2, capacity factor 1.25 in each of 2 layers, bf16,
   flash, B=4, T=2048, 3 warm-up + 5 timed AdamW steps; flash launches
   zeroed just before and read just after (n_layers a step). It prints
   the step, tokens/s, MFU on the active parameters (``active_params``),
   peak memory and each layer's dropped share of (token, choice) claims
   (``moe_routing_stats``, recorded into the ``"moe"`` metrics series);
   every loss finite, falling, and within 1e-2 of the same steps through
   plain ``"local"`` attention.

14. Serving (``phase_serve``): Llama-3-8B at full depth (32 layers,
   bf16, 16.06 GB of weights from the seed), one model shared by every
   engine (``ServeEngine``: max batch 8, prompts up to 512 tokens, 64
   new, 16-token KV blocks). ``make_trace`` (16 requests, prompts of
   64-512 tokens, 16-64 new) through continuous, static and chunked
   (``prefill_chunk`` 128) engines, then ``make_shared_prefix_trace``
   (a 256-token system prompt) with the prefix cache on and off; then a
   2-layer draft and an 8-layer target at the same widths
   (``make_draft_target_params``) through a plain and a speculative
   (``spec_k`` 4) engine on the first trace. Flash launches are zeroed
   just before each group of engines runs and read just after, per
   program (``count_program_launches``). Holds: the kernel launched
   n_layers times per monolithic prefill and in no other program; every
   stream passes the teacher-forced check (one full-context ``forward``
   a request: at each generated position the stream's token is the
   argmax, or its logit lies within ``teacher_gap_tol`` of the largest);
   the cache-on run hits; the pair's accept rate is at least
   ``SPEC_ACCEPT_FLOOR``; every pool's ``data_ptr`` is unchanged. One
   more pass runs the first trace through ``ServeEngine(mesh=
   build_mesh(tp=1))`` on a world of this one process, whose streams
   must equal the meshless continuous engine's, bitwise. It
   prints tokens/s with first-token and per-token p50/p99 per engine,
   the decode step at full batch against its weight-read floor, the
   monolithic prefill's ms per bucket and peak memory.

18. The serving fleet (``phase_fleet``), right after phase 14, at its
   model (Llama-3-8B, 32 layers, bf16, from the seed) on
   ``make_multi_tenant_trace`` (``FLEET_DIMS``: 24 requests of 4 tenants,
   a 256-token shared prefix each, 2-8-token suffixes, 16 new tokens;
   every replica max batch 8, 16-token blocks): (W1) two in-process
   replicas sharing one set of weights, with cache-affinity and with
   random placement, each a cold fleet; (W2) a split fleet (one prefill
   and one decode replica, the prefix cache off) against one cache-off
   engine, every request handed off once; (W3) two worker processes
   (``python -m horovod_tpu_torch.serve.worker``) on the card, each
   building the model from the seed: the affinity fleet against (W1)'s,
   the split fleet with direct and with relayed migration, a SIGKILL to
   one worker mid-trace, and ``export_fleet_trace`` merged by
   ``trace_merge`` with one request's critical path; (W4) (W1)'s
   affinity fleet through ``ServeRouter(mesh=build_mesh(tp=1))`` on a
   world of this one process, whose streams and placement log must be
   (W1)'s, bitwise (its flash launches are a path of their own in the
   kernels' line); (W5) the same world-1 mesh router with one in-process
   replica beside one of (W3)'s worker processes (``workers=[None,
   worker]``), bitwise (W1) affinity's too (a path of its own as well).
   Holds: the kernel
   ran n_layers times per monolithic prefill and nowhere else in every
   replica (per program in this process, launches against monolithic
   prefills in a worker); affinity's prefix hit rate above random's;
   every stream teacher-forced against the full-context ``forward``;
   streams bitwise equal where the same programs serve the same batches
   ((W3) against (W1), direct against relayed, (W3)'s split against
   (W2)), a stream that parts printed with its step and held to the
   teacher-forced check (``hold_bitwise``); the direct pass moved every
   page itself; every request resolved once through the SIGKILL; the
   critical path's rows sum to the request's ``router:e2e``. It prints
   each arm's tokens/s, first-token and per-token p50/p99, flash
   launches per replica and program, prefix hit rate, migration bytes
   and ms, peak memory per process and seconds.

16. The rest of the training surface on one card: (a) the callbacks
   drive phase 5's train step (``run_phase16a``; Llama-3-8B widths, 4
   layers, bf16, flash, B=4, T=2048, AdamW from ``CB_BASE_LR``) for 3
   epochs of 2 steps: ``BroadcastParametersCallback`` at train begin,
   then each epoch ``MetricAverageCallback``, ``LearningRateWarmupCallback
   (size=4)`` (the learning rate after epoch e equal to
   ``warmup_schedule`` at step e + 1) and ``BestModelCheckpoint``, which
   writes the parameters with ``torch.save`` into a temporary directory.
   Flash launches are zeroed just before the steps and read just after
   (n_layers a step); every loss finite and falling; the checkpoint read
   back bitwise equal to the live parameters and with the same loss on
   the next batch. It prints the step (beside phase 5's), the
   checkpoint's writes and size, and peak memory. (b) The estimators'
   per-rank tasks (``TorchEstimator``'s and ``FunctionalEstimator``'s,
   called as a Spark barrier task calls them) at a world of 1 on the
   card, over 65,536 rows of 256 features from the seed staged with
   ``Store.write_shard`` (pickle format): an f32 MLP 256-4096-4096-1, 2
   epochs at batch 1,024; the parameters stay on the card, the loss
   falls, and ``predict`` on the card is within ``EST_PREDICT_RTOL`` of
   the same parameters on the CPU. (c) The bench's host-bus arm (np=4 on
   the native host plane) and elastic-chaos arm (a kill and a grow on
   the port's elastic driver, every worker on the host plane), sharing
   ``HOST_ARMS_BUDGET_S``; their keys printed, either failing fails the
   phase.

Phase 3 also checks and times a ring chunk of phase 12 (B=1, T=2048,
32 heads, q_per_kv 1, bf16 in, f32 out; an earlier chunk and the own,
causal), every other shape at which phase 12's, 13's and 15's
multi-card runs launch the kernel on a rank (``plan_kernel_cases``; a
pipeline microbatch of one row among them), and the monolithic prefill
at every prefill bucket with a tp rank's heads (``serve_kernel_cases``:
B=1, T 16-512, causal; 32/8 heads for phase 14, 16/4 and 8/2 for
phase 17's tp=2 and tp=4, and 32/8 and 16/4 in f32 for its MoE model).
Phase 7 also runs the bench's compression arms
(``bench.run_compression``). The last lines are the kernels' JSON, the
card's ``nvidia-smi`` line and ``{"ok": true, "device": {...}}``. It
imports nothing of JAX.

``--dp-only`` runs phases 1, 6, 7, 8, 10, 12, 13, 15, 16, 17, 18 and 19 alone, on
two or more cards: the multi-card check of the data-parallel path, the
eager plane and the ResNet arm (world 1 on card 0, then every card; the
parameter digests must agree on every rank), then, on four or more
cards, phase 11's four-card planes (the dp step with int8, fsdp=4 with
"none" and int8, dp=2 x fsdp=2 with int8; the gathered parameters'
digests equal on every rank, per-rank peak memory) and phase 9's
four-card scenario,
and last phase 12 over NCCL, one process a card (``TP_PLANS``): (A)
tp=4 with "flash" on phase 5's batch (B=4, T=2048), (B) sp=4 with
"ring_flash", (C) sp=4 with "ulysses" and (D) tp=2 x sp=2 with
"ring_flash", each on one B=1, T=8192 sequence; on two cards tp=2 and
sp=2 instead. Each takes 3 warm-up and 5 timed steps, its losses held
within ``TP_LOSS_RTOL`` of a one-card "flash" run of its batch (run
first in the same world, each batch alone on its own card); flash
launches and the tp all-reduces and sp transfers (calls and bytes)
must equal the formulas
(``flash_launches_per_step``, ``tp_sp_counts``) on every rank; the
dp x sp replicas' shards and the gathered parameters must agree. It
prints the step, tokens/s/GPU, MFU, per-rank peak memory and the tp/sp
collectives' ms (CUDA events). Then phase 13 over NCCL
(``MOE_PP_PLANS``): (F) ep=4 and (G) ep=4 with the int8 island on the
MoE configuration, (H) ep=2 x tp=2, (I) pp=4 GPipe and (J) pp=4 1F1B
with 4 microbatches on phase 5's configuration, (K) pp=2 x ep=2 GPipe
with 4 microbatches on the MoE configuration (one layer a stage), all
on phase 5's batch (B=4, T=2048); on two cards ep=2 and pp=2 GPipe.
Each takes 3 warm-up and 5 timed steps beside a one-card flash run of
its configuration and batch (run first in the same world): every loss
finite and falling, the first (the same parameters) within
``FIRST_LOSS_RTOL`` of the one-card run's, the trained parameters'
loss through the plan within ``TP_LOSS_RTOL`` of theirs through one
card, and the dense plans' every loss within ``TP_LOSS_RTOL``; flash
launches and the model
collectives (tp, the MoE layer's, the island's all-to-alls, the
pipeline's hops: calls and bytes) must equal the formulas
(``flash_launches_pp``, ``moe_pp_counts``) on every rank, and the
replicated shards' digests agree on the ranks that hold them. (G) also
holds one full-width layer's int8 output within ``ISLAND_INT8_BAND``
of the GSPMD path's, and a control with one rank's dispatch slabs
zeroed outside it. It prints the step, tokens/s/GPU, MFU on the active
parameters, per-rank peak memory, the collectives' ms and, for pp,
each stage's ms in its hops. Last, on four cards, phase 15 over NCCL
(``run_phase15``): ``COMPOSE_PLANS`` through phase 13's machinery and
checks, (L) pp=2 x sp=2 GPipe and (M) 1F1B with "ring_flash" (the
kernel in every stage's ring) on phase 5's configuration, B=2, T=4096,
2 microbatches, (N) pp=2 x fsdp=2 GPipe with "flash" (B=4, T=2048, 2
microbatches), and the MoE configuration on (O) ep=2 x fsdp=2 (B=4,
T=2048) and (P) ep=2 x sp=2 with "ring_flash" (B=2, T=4096); then on
the eager runtime's world (``adasum_world``) (Q) ``hvd.allreduce`` and
``hvd.grouped_allreduce`` with ``op=Adasum`` on the cards' f32 and
bf16 tensors, every rank's digest equal and within its bound of an f64
twin of the reference's tree (``adasum_twin``), and (R) phase 5's
configuration at dp=4 through the hook ``DistributedOptimizer(op=
Adasum)``: with the one-card batch on every rank the losses within
``TP_LOSS_RTOL`` of a one-card run's, with each rank's rows every loss
finite and falling, then one eager Adasum reduction of the gradient
set beside the eager and the packed Average's. Last, phase 16 over
NCCL on up to four cards: ``graft_entry.dryrun_multichip`` (on four
cards the dense configuration alone, as the reference gates it) and
phase 16 (a) at dp over the cards, each rank drawing its own parameters:
the parameters bitwise equal on every rank after
``BroadcastParametersCallback``, and ``MetricAverageCallback``'s averages
equal to the mean of the ranks' values. Last, on four cards, phase 17
(``run_phase17``): serving on a mesh, one engine a process, every rank
submitting the same requests (``SERVE_MESH_PLANS``): (S) Llama-3-8B at
32 layers on tp=4 through phase 14's continuous, chunked and cache-on
engines and its speculative pair (the 2-layer draft over the 8-layer
target) on the same mesh, (T) the MoE configuration in f32 at capacity
factor 4 on ep=4 and (T2) on ep=2 x tp=2, (V) Llama-3-8B on dp=2 x tp=2 (the
dp replicas serve the same stream); each holds the tokens equal on
every rank, every stream to the teacher-forced check against the
one-card ``forward``, n_layers flash launches per monolithic prefill
and none elsewhere, each decode step's model collectives (calls and
bytes) to ``serve_counts``, and every pool's ``data_ptr``; it prints
tokens/s, the first-token and per-token tails, the decode step against
the per-rank weight-read floor, the collectives' ms a decode step and
peak memory per rank. Then (U) the int8 MoE island in training
(``ISLAND_PLANS``, phase 13's machinery and checks, (G)'s layer band):
ep=2 x fsdp=2 (B=4, T=2048) and ep=2 x sp=2 with "ring_flash" (B=2,
T=4096). Last, on four cards, phase 18 (X) (``phase_fleet_cards``): one
worker process a card, each building Llama-3-8B at full depth from the
seed, the router in this process: the unified fleet with affinity and
with random placement, a split fleet of 2 prefill and 2 decode replicas
moving pages between cards over direct and over relayed migration
(bytes and p50 ms of each; streams equal between the two, or held as
phase 18 holds them), and the split fleet again with a decode worker
SIGKILLed mid-trace; every request resolved once, every stream
teacher-forced on card 0 once the fleet is down. Last, on four cards,
phase 19 (``run_phase19``): the fleet on a mesh, one process a card,
every rank running the same ``ServeRouter(mesh=)`` over its shards of
the whole parameters (drawn from the seed, broadcast) on phase 18's
trace, two replicas a fleet (``ROUTER_MESH_PASSES``): (Y1)
Llama-3-8B at 32 layers on tp=4 with affinity and with random
placement, (Y2) a split fleet of one prefill and one decode replica on
tp=4 (each handoff moves the rank's KV heads), the affinity fleet again
with rank r's clock reading 50·r s ahead and a deadline on every third
request, (Y3) dp=2 x tp=2 and (Y4) the MoE configuration of phase 17
on ep=4; then, beside a worker process rank 0 spawns on the last card
(every other rank mirroring its calls), (Y5) one tp=4 replica and the
worker with affinity, (Y6) split fleets both ways (a tp=4 prefill
replica handing off to the worker, the worker to a tp=4 decode
replica), and (Y7) (Y5) with the worker SIGKILLed mid-trace. Holds on
every rank: streams, placement logs and statuses equal on every rank;
(Y1)'s, (Y2)'s, (Y5)'s and (Y6)'s placement logs those of a one-card
router on the same trace (run first on every card); every request
resolved once (the skewed pass expiring some, the same on every rank,
and serving the rest; (Y7) requeuing the worker's); n_layers flash
launches per monolithic prefill per replica, the worker's from its
beats, and none elsewhere; every pool's ``data_ptr``; every served
stream teacher-forced against the one-card ``forward``; the split
fleets handing every request off once, a move to or from the worker
counting its whole pages on every rank. It prints tokens/s, the
first-token and per-token tails, the hit rate, handoffs with their
bytes per rank and p50 ms, the mirror broadcasts a router step,
per-rank and per-worker peak memory and the seconds, beside the card's
``nvidia-smi`` line. ``--dp-only`` prints no result line.
"""

import argparse
import dataclasses
import gc
import json
import math
import os
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch import bench, graft_entry
from horovod_tpu_torch.binding import allgather_object
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.ops_enum import Average
from horovod_tpu_torch.device import resolve_device
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.ops import _kernels
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.ops import quantized as tq
from horovod_tpu_torch.parallel import tensor_parallel as ttp
from horovod_tpu_torch.parallel.mesh import (build_mesh, data_parallel_mesh,
                                             init_process_group)
from horovod_tpu_torch.runtime import get_runtime
from horovod_tpu_torch.serve import bench as sbench
from horovod_tpu_torch.serve import engine as sengine
from horovod_tpu_torch.serve import rpc as srpc
from horovod_tpu_torch.serve.speculative import (DraftConfig,
                                                 make_draft_target_params)

H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak, H100 SXM
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores, H100 SXM
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
    # A ring_flash chunk of phase 12 (T=8192 over sp=4): K/V tiled to the
    # query heads, f32 out; an earlier chunk (no mask) and the own one.
    ("ring_chunk", 1, 2048, 32, 32, 128, "bfloat16", False, "float32"),
    ("ring_chunk_diag", 1, 2048, 32, 32, 128, "bfloat16", True, "float32"),
]
#: The cases timed, and those whose plain version is timed too (with
#: every per-rank shape of the plans).
TIMED_CASES = ("slice", "long_t8192", "ring_chunk", "ring_chunk_diag")
PLAIN_TIMED = ("slice", "ring_chunk", "ring_chunk_diag")


def plan_kernel_cases(cfg, plans):
    """The kernel's per-rank shapes on phase 12's multi-card runs, as
    :data:`KERNEL_CASES` rows: ``"flash"`` runs it causal on the rank's
    rows, whole sequence and ``H / tp`` query heads (K/V heads ``Hkv /
    tp``, or tiled to the query heads where tp does not divide them);
    ``"ring_flash"`` on one sequence chunk (``T / sp``) with K/V tiled
    to the query heads and f32 out, both on an earlier chunk and on the
    own (causal). Ulysses and sp=1 rings run no kernel. Phase 13's
    plans (:data:`MOE_PP_PLANS`) run it as ``"flash"`` on every row a
    rank holds (the ep ranks hold the same rows), a pipeline stage on
    one microbatch of ``rows / n_micro``; and their one-card check
    (``_one``, :func:`one_card_loss`) on the whole batch with every
    head, or an MoE pipeline's microbatch (every dp rank's block)."""
    out, dt = [], str(cfg.dtype).removeprefix("torch.")
    for plan in plans:
        name, axes, impl, rows, seq = plan[:5]
        n_micro = plan[6] if len(plan) > 5 else 1
        if len(plan) > 5:
            one = rows // n_micro if plan[5] and plan[7] == "moe" else rows
            out.append((f"{name}_one", one, seq, cfg.n_heads,
                        cfg.n_kv_heads, cfg.head_dim, dt, True, None))
        tp, sp = axes.get("tp", 1), axes.get("sp", 1)
        b = rows // (axes.get("dp", 1) * axes.get("fsdp", 1)) // n_micro
        h = cfg.n_heads // tp
        hkv = cfg.n_kv_heads // tp if cfg.n_kv_heads % tp == 0 else h
        if impl == "flash":
            out.append((f"{name}_rank", b, seq, h, hkv, cfg.head_dim, dt,
                        True, None))
        elif impl == "ring_flash" and sp > 1:
            out += [(f"{name}_chunk{tag}", b, seq // sp, h, h, cfg.head_dim,
                     dt, causal, "float32")
                    for tag, causal in (("", False), ("_diag", True))]
    return out


def serve_buckets(block_size, max_prompt):
    """The engine's prefill bucket menu (``ServeEngine``'s default)."""
    return sengine._pow2_menu(block_size,
                              -(-max_prompt // block_size) * block_size)


def serve_kernel_cases(cfg, dims=None, tp=1):
    """The kernel's shapes in a monolithic prefill of one request at
    every prefill bucket, causal, with a tp rank's heads: ``H / tp``
    query heads and the KV heads they read (``Hkv / tp``, or tiled to
    the query heads where tp does not divide them), in ``cfg.dtype``.
    tp 1 is phase 14's; 2 and 4 are phase 17's meshes (and f32, its
    MoE model's, at tp 1 and 2)."""
    dims = SERVE_DIMS if dims is None else dims
    dt = str(cfg.dtype).removeprefix("torch.")
    h = cfg.n_heads // tp
    hkv = cfg.n_kv_heads // tp if cfg.n_kv_heads % tp == 0 else h
    tag = ("" if tp == 1 else f"_tp{tp}") + (
        "" if dt == "bfloat16" else f"_{dt}")
    return [(f"serve_prefill{tag}_t{t}", 1, t, h, hkv, cfg.head_dim, dt,
             True, None)
            for t in serve_buckets(dims["block_size"], dims["max_prompt"])]


def kernel_cases(cfg):
    """:data:`KERNEL_CASES` and every per-rank shape of phase 12's,
    13's, 15's and 17's plans (on two and four cards) and of phase 14's
    and 17's prefill buckets that they do not already hold."""
    seen = {case[1:] for case in KERNEL_CASES}
    extra = []
    for case in plan_kernel_cases(cfg, TP_PLANS + TP_PLANS_2 + MOE_PP_PLANS
                                  + MOE_PP_PLANS_2 + COMPOSE_PLANS
                                  + ISLAND_PLANS) + [
            c for tp in SERVE_TP for c in serve_kernel_cases(cfg, tp=tp)] + [
            c for tp in SERVE_MOE_TP for c in serve_kernel_cases(
                serve_moe_config(cfg), tp=tp)]:
        if case[1:] not in seen:
            seen.add(case[1:])
            extra.append(case)
    return KERNEL_CASES + extra


def time_case(b, t, h, hkv, d, q, k, v, kw, plain_iters):
    """Kernel, plain (when ``plain_iters``) and library times of one
    case, and its bound (a bf16 case's operations at the tensor cores'
    peak, an f32 case's, which the kernel runs in f32 arithmetic, at the
    f32 peak). The library call (``scaled_dot_product_attention``)
    writes the input dtype where a bf16 case's out is f32, and returns
    no logsumexp."""
    kern_ms = cuda_ms(lambda: tfa.flash_fwd_cuda(q, k, v, **kw), iters=20)
    plain_ms = (cuda_ms(lambda: tfa.flash_fwd_reference(q, k, v, **kw),
                        iters=plain_iters, warmup=1)
                if plain_iters else None)
    q4, k4, v4 = (x.view(b, -1, t, d) for x in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=kw["causal"], enable_gqa=True), iters=20)
    itemsize = q.element_size()
    out_itemsize = (itemsize if kw["out_dtype"] is None
                    else kw["out_dtype"].itemsize)
    bound = attention_bound_ms(b, t, h, hkv, d, kw["causal"], itemsize,
                               out_itemsize,
                               H100_BF16_FLOPS if itemsize == 2
                               else H100_F32_FLOPS)
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


def phase_kernels(seed, cfg):
    """Phase 3: kernel vs plain on the card (:func:`kernel_cases`), then
    timing at the slice shape, at T=8192, at the ring chunks and at
    phase 12's per-rank shapes. Returns the kernel's JSON entry
    (launches filled later)."""
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(seed)
    slice_err = None
    timed = {}
    plan_names = {c[0] for c in kernel_cases(cfg)} - {
        c[0] for c in KERNEL_CASES}
    for name, b, t, h, hkv, d, dt, causal, odt in kernel_cases(cfg):
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
        if name in TIMED_CASES or name in plan_names:
            timed[name] = (b, t, h, hkv, d, causal, odt or dt) + time_case(
                b, t, h, hkv, d, q, k, v, kw,
                3 if name in PLAIN_TIMED or name in plan_names else 0)
        del q, k, v, out, lse, ref_out, ref_lse, diff

    for name, (b, t, h, hkv, d, causal, odt, kern_ms, plain_ms, lib_ms,
               (bound_ms, bound_by, flops, nbytes)) in timed.items():
        plain = "" if plain_ms is None else f"plain {plain_ms:.4f} ms, "
        log(f"  flash_fwd at {name} (B={b} T={t} H={h} Hkv={hkv} D={d} "
            f"causal={causal} out={odt}): kernel {kern_ms:.4f} ms "
            f"({flops / kern_ms / 1e9:.1f} TFLOP/s), {plain}"
            f"sdpa {lib_ms:.4f} ms (kernel / sdpa time "
            f"{kern_ms / lib_ms:.3f}); bound {bound_ms:.4f} ms by {bound_by} "
            f"({flops:.4e} FLOP, {nbytes:.4e} bytes); kernel at "
            f"{100 * bound_ms / kern_ms:.1f}% of bound")
    kern_ms, plain_ms, lib_ms, (bound_ms, bound_by, _, _) = timed["slice"][7:]
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
    """Phase 5: the train step on ``cfg``, ``warmup + steps`` steps.
    Returns the flash launches, the losses and the median step's ms."""
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
    return launches, losses, 1e3 * step_s


def param_digest(params):
    """One integer per parameter tensor: the sum of its bits (as 16- or
    32-bit integers) weighted by position, on the device. Equal
    parameters give equal digests."""
    return tensor_digest(ttr.param_leaves(params))


def tensor_digest(tensors):
    """:func:`param_digest` of a list of tensors."""
    out = []
    for p in tensors:
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
COMP_BENCH_DIMS = {}
MOE_BENCH_DIMS = {}


def dp_world(rank, n, port, cfg, seed, slice_losses, device=None,
             dims=(DP_DIMS, BENCH_DIMS, COMP_BENCH_DIMS, MOE_BENCH_DIMS)):
    """Phases 6 and 7 (the bench's transformer, compression and MoE arms) as
    rank ``rank`` of ``n`` (one process per card). ``device="cpu"`` and
    smaller ``dims`` rehearse them on gloo."""
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
        comp = bench.run_compression(device, **dims[2])
        names = ("comp_none", "bf16", "int8") + (
            ("fsdp_comp_none", "fsdp_comp_bf16", "fsdp_comp_int8")
            if n > 1 else ())
        keys = tuple(f"transformer_{k}_tokens_per_sec_per_chip"
                     for k in names)
        if not all(comp.get(k, 0) > 0 for k in keys):
            raise AssertionError(f"bench compression arms: want {keys}, "
                                 f"got {comp}")
        moe = bench.run_moe(device, **dims[3])
        keys = tuple(f"moe_tokens_per_sec_{k}" for k in (
            ("gspmd", "none", "bf16", "int8") if n > 1 else ("gspmd",)))
        keys += ("moe_dispatch_bytes_saved_pct",) if n > 1 else ()
        if not all(moe.get(k, 0) > 0 for k in keys):
            raise AssertionError(f"bench MoE arms: want {keys}, got {moe}")
    finally:
        dist.destroy_process_group()


def phase_eager(cfg, seed, batch, seq, warmup, steps, slice_losses):
    """Phase 8 on this rank of the eager runtime's world (``hvd.init()``
    has run): the slice through the hook-based DistributedOptimizer,
    checks, and the eager grouped allreduce beside phase 6's. Rank 0
    prints."""
    rt = get_runtime()
    n, rank, device = hvd.size(), hvd.rank(), hvd.device()
    cuda = device.type == "cuda"
    say = log if rank == 0 else (lambda *a: None)
    say(f"  world: {n} process(es), executor on {device} "
        f"({dist.get_backend(rt.executor.group)}); B={batch} rows "
        f"a rank of a global batch of {batch * n}")
    # Phase 5's draws: its parameters and, at a world of 1, its tokens.
    gen = torch.Generator(device).manual_seed(seed)
    params = ttr.init_params(cfg, gen, device)
    tokens = torch.randint(0, cfg.vocab_size, (batch * n, seq + 1),
                           generator=gen, device=device)
    local = {"tokens": tokens[rank * batch:(rank + 1) * batch]}
    named = ttr.named_param_leaves(params)
    for _, p in named:
        p.requires_grad_(True)
    hvd.broadcast_parameters(named, root_rank=0)
    leaves = [p for _, p in named]
    opt = hvd.DistributedOptimizer(ttr.default_optimizer(leaves),
                                   named_parameters=named)
    n_params = sum(p.numel() for p in leaves)
    grad_bytes = sum(p.numel() * p.element_size() for p in leaves)

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    ex = rt.executor
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    ex.responses = ex.collectives = ex.bytes = 0
    ex.wait_seconds = ex.host_seconds = ex.issue_seconds = 0.0
    rt.host_bytes = 0
    tfa.flash_fwd_cuda.launches = 0
    losses, times, exposed = [], [], []
    for _ in range(warmup + steps):
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = ttr.lm_loss(params, local, cfg)
        loss.backward()
        bwd_end = event() if cuda else None
        opt.synchronize()
        sync_end = event() if cuda else None
        with opt.skip_synchronize():
            opt.step()
        losses.append(loss.detach())
        if cuda:
            torch.cuda.synchronize(device)
            exposed.append(bwd_end.elapsed_time(sync_end))
        times.append(time.perf_counter() - t0)
    launches = tfa.flash_fwd_cuda.launches
    responses, issued, ran = ex.responses, ex.collectives, ex.bytes
    wait_ms, callback_ms, issue_ms = (
        1e3 * ex.wait_seconds, 1e3 * ex.host_seconds, 1e3 * ex.issue_seconds)
    host = rt.host_bytes
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    losses = hvd.allreduce(torch.stack(losses), name="phase8.losses").tolist()
    digests = hvd.allgather_object(param_digest(params))

    total = warmup + steps
    timed = times[warmup:]
    step_s = statistics.median(timed)
    tok_s = batch * seq / step_s
    mfu = 6 * n_params * tok_s / H100_BF16_FLOPS
    exposed_ms = statistics.median(exposed[warmup:]) if cuda else 0.0
    say(f"  losses (mean over ranks): {[round(x, 5) for x in losses]}")
    if n == 1:
        say(f"  phase 5 losses: {[round(x, 5) for x in slice_losses]}")
    say(f"  step times (s): {[round(x, 4) for x in times]}")
    say(f"  step {1e3 * step_s:.1f} ms (median of {steps}; min "
        f"{1e3 * min(timed):.1f}, max {1e3 * max(timed):.1f}), "
        f"{tok_s:.1f} tokens/s/GPU, MFU {100 * mfu:.2f}% "
        f"(6 * {n_params} params * tokens/s / 989e12), peak memory "
        f"{peak / 2**30:.2f} GiB")
    say(f"  exposed communication (end of backward() to end of "
        f"synchronize(), CUDA events): median {exposed_ms:.3f} ms of the "
        f"timed steps; all steps {[round(x, 3) for x in exposed]}")
    say(f"  executor: {responses / total:g} responses, "
        f"{issued / total:g} collectives, {ran // total} bytes (want "
        f"{grad_bytes}) a step; host ms: {wait_ms / responses:.3f} from "
        f"enqueue to launch (mean over responses); a step: "
        f"{callback_ms / total:.3f} in the callback, "
        f"{issue_ms / total:.3f} of it in the collective calls; host plane "
        f"{host} bytes (want 0); "
        f"flash_fwd launches {launches} (want "
        f"{cfg.n_layers * total if cuda else 0}); parameter digests equal "
        f"on {len(digests)} rank(s): "
        f"{all(d == digests[0] for d in digests)}")
    ok = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
          and (n > 1 or all(abs(a - b) <= 1e-2 * abs(b)
                            for a, b in zip(losses, slice_losses)))
          and launches == (cfg.n_layers * total if cuda else 0)
          and ran == total * grad_bytes and host == 0
          and all(d == digests[0] for d in digests))
    if not ok:
        raise AssertionError(
            "eager plane failed: losses must be finite, falling and (world "
            "of 1) within 1e-2 of phase 5's; flash_fwd must run once a "
            "layer; the executor must run every gradient byte and the host "
            "plane none; parameters must agree on every rank")

    grads = [p.grad for p in leaves]
    if cuda:
        eager_ms = cuda_ms(lambda: hvd.grouped_allreduce(
            grads, name="phase8.grouped"), iters=5, warmup=1)
        grouped_responses = (ex.responses - responses) / 6
        grouped_wait_ms = ((1e3 * ex.wait_seconds - wait_ms)
                           / (ex.responses - responses))
        grouped_callback_ms = (1e3 * ex.host_seconds - callback_ms) / 6
        grouped_issue_ms = (1e3 * ex.issue_seconds - issue_ms) / 6
        plane_ms = cuda_ms(lambda: collectives.grouped_allreduce(
            grads, Average), iters=5, warmup=1)
    else:
        eager_ms = plane_ms = float("nan")
        grouped_responses = grouped_wait_ms = float("nan")
        grouped_callback_ms = grouped_issue_ms = float("nan")
    say(f"  grouped Average allreduce of every gradient ({grad_bytes} "
        f"bytes, CUDA events, mean of 5): eager plane "
        f"(hvd.grouped_allreduce) {eager_ms:.3f} ms, phase 6's "
        f"collectives.grouped_allreduce {plane_ms:.3f} ms; negotiation "
        f"and callback cost {eager_ms - plane_ms:.3f} ms; the eager one "
        f"ran {grouped_responses:g} responses; host ms: "
        f"{grouped_wait_ms:.3f} from enqueue to launch (mean over "
        f"responses); a call: {grouped_callback_ms:.3f} in the callback, "
        f"{grouped_issue_ms:.3f} "
        f"of it in the collective calls")
    surfaces = read_surfaces(say)
    say(json.dumps({"eager": {
        "world": n, "batch_per_rank": batch, "seq": seq,
        "step_ms_median": 1e3 * step_s, "step_ms": [1e3 * x for x in timed],
        "tokens_per_s_per_gpu": tok_s, "mfu_6N": mfu,
        "peak_mem_bytes": peak, "losses": losses,
        "exposed_comm_ms_median": exposed_ms, "exposed_comm_ms": exposed,
        "responses_per_step": responses / total,
        "collectives_per_step": issued / total,
        "executor_bytes_per_step": ran / total, "grad_bytes": grad_bytes,
        "wait_ms_per_response": wait_ms / responses,
        "callback_ms_per_step": callback_ms / total,
        "issue_ms_per_step": issue_ms / total,
        "host_plane_bytes": host, "flash_fwd_launches": launches,
        "eager_grouped_allreduce_ms": eager_ms,
        "collectives_grouped_allreduce_ms": plane_ms,
        "eager_grouped_responses": grouped_responses,
        "eager_grouped_wait_ms": grouped_wait_ms,
        "eager_grouped_callback_ms": grouped_callback_ms,
        "eager_grouped_issue_ms": grouped_issue_ms,
        "surfaces": surfaces}}))


def read_surfaces(say, reads=100):
    """Phase 8's read of the telemetry and core surfaces on every rank
    (``metrics_aggregate`` is a collective); ``say`` prints. Returns
    what rank 0 prints."""
    t0 = time.perf_counter()
    for _ in range(reads):
        snap = hvd.metrics()
    snap_ms = 1e3 * (time.perf_counter() - t0) / reads
    t0 = time.perf_counter()
    prom = hvd.metrics_prometheus()
    prom_ms = 1e3 * (time.perf_counter() - t0)
    agg = hvd.metrics_aggregate()
    events = hvd.flight_events()
    kinds = sorted({e["event"] for e in events})
    topo = hvd.topology()
    out = {"metrics_series": len(snap), "snapshot_ms": snap_ms,
           "prometheus_bytes": len(prom), "prometheus_ms": prom_ms,
           "responses_allreduce_total": agg["responses_allreduce_total"],
           "flight_events": len(events), "flight_kinds": kinds,
           "steady_lock_engaged": hvd.steady_lock_engaged(),
           "steady_persistent": hvd.steady_persistent(),
           "collective_algo": hvd.collective_algo(),
           "topology_np": topo["np"] if topo else None,
           "topology_probe_ms": snap["topology_probe_ms"],
           "reduce_threads": hvd.reduce_threads(),
           "stalled_tensors": hvd.stalled_tensors()}
    say(f"  surfaces: metrics() {len(snap)} series, {snap_ms:.4f} ms a "
        f"snapshot (mean of {reads}); metrics_prometheus {len(prom)} bytes "
        f"in {prom_ms:.3f} ms; metrics_aggregate responses_allreduce_total "
        f"{out['responses_allreduce_total']}; flight events {len(events)} "
        f"{kinds}; steady lock engaged {out['steady_lock_engaged']}, "
        f"persistent {out['steady_persistent']}; collective_algo "
        f"{out['collective_algo']}; topology np {out['topology_np']} "
        f"(probe {out['topology_probe_ms']} ms); "
        f"reduce_threads {out['reduce_threads']}; stalled tensors "
        f"{out['stalled_tensors']}")
    if not (snap and "# TYPE hvd_" in prom and events
            and agg["responses_allreduce_total"]["min"] > 0
            and not out["stalled_tensors"]):
        raise AssertionError(f"surfaces: want a populated registry, "
                             f"exposition and flight ring, allreduce "
                             f"responses on every rank and no stall; got "
                             f"{out}")
    return out


# Phase 8's slice: phase 5's.
EAGER_DIMS = dict(batch=4, seq=2048, warmup=3, steps=5)


def eager_world(rank, n, port, ctrl_port, cfg, seed, slice_losses,
                device=None, dims=EAGER_DIMS):
    """Phase 8 as rank ``rank`` of ``n`` (one process per card), on the
    eager runtime's own world. ``device="cpu"`` and smaller ``dims``
    rehearse it on gloo."""
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(n), HOROVOD_CROSS_RANK="0",
                      HOROVOD_CROSS_SIZE="1", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port),
                      HOROVOD_CONTROLLER_ADDR=f"127.0.0.1:{ctrl_port}")
    hvd.init(device)
    try:
        phase_eager(cfg, seed, **dims, slice_losses=slice_losses)
    finally:
        hvd.shutdown()


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_eager(cfg, seed, slice_losses):
    """Phase 8: one process per card; a world of 1 in this process."""
    n = torch.cuda.device_count()
    log(f"phase 8: the eager plane (hook-based DistributedOptimizer, "
        f"native core, NCCL executor; {n} card(s), one process each)")
    t0 = time.perf_counter()
    basics.build_native()
    log(f"  native core: the port's build ({basics.LIB_PATH}) in "
        f"{time.perf_counter() - t0:.1f} s")
    args = (n, free_port(), free_port(), cfg, seed, slice_losses)
    if n == 1:
        eager_world(0, *args)
    else:
        mp.spawn(eager_world, args=args, nprocs=n, join=True)


def run_dp(cfg, seed, slice_losses):
    """Phases 6-7: one process per card (NCCL refuses two ranks on
    one); a world of 1 runs in this process."""
    n = torch.cuda.device_count()
    port = free_port()
    log(f"phase 6: data parallel over NCCL ({n} card(s), one process "
        f"each)")
    dp_args = (n, port, cfg, seed, slice_losses)
    if n == 1:
        dp_world(0, *dp_args)
    else:
        mp.spawn(dp_world, args=dp_args, nprocs=n, join=True)


# ---------------------------------------------------------------------------
# Phase 9: the launcher and elastic training
# ---------------------------------------------------------------------------

def _leaf_module(params):
    """The parameter tree's leaves as ``nn.Parameter``s, their names, and
    a module holding them (what ``TorchState`` saves and restores)."""
    params = ttr.map_params(lambda p: torch.nn.Parameter(p.detach()), params)
    named = ttr.named_param_leaves(params)
    holder = torch.nn.ParameterDict(
        {n.replace(".", "__"): p for n, p in named})
    return params, named, holder


def train_worker(args):
    """``--worker``: one process of a job that ``python -m
    horovod_tpu_torch.runner`` started. Trains ``args.steps`` steps of
    the slice (phase 5's draws: the parameters, then a global batch of
    ``args.rows`` rows that every step reuses; rank r of n takes rows
    [r*rows/n, (r+1)*rows/n)) through the hook ``DistributedOptimizer``
    over AdamW. ``static`` steps plainly; ``elastic`` runs under
    ``@hvd.elastic.run`` with a ``TorchState`` committed every step and
    injects the events the flags name. Each process appends its events
    (steps begun and done, resets, memory around in-place resets, the
    end) to ``<out>/<identity>.jsonl``."""
    from horovod_tpu_torch import elastic as core_elastic

    device = torch.device(args.device) if args.device else None
    ident = os.environ.get("HOROVOD_ELASTIC_ID",
                           f"rank:{os.environ.get('HOROVOD_RANK', '0')}")
    cfg = (ttr.TransformerConfig.tiny(sp_attention="flash", remat=False,
                                      dtype=torch.float32)
           if args.tiny else dataclasses.replace(
               ttr.TransformerConfig.llama3_8b(), n_layers=4,
               sp_attention="flash", remat=False))
    hvd.init(device)
    rt = get_runtime()
    device = hvd.device()
    cuda = device.type == "cuda"
    log_f = open(os.path.join(args.out, ident.replace(":", "_") + ".jsonl"),
                 "a")

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def memory():
        sync()
        return ((torch.cuda.memory_allocated(device),
                 torch.cuda.mem_get_info(device)[0]) if cuda else (0, 0))

    def note(kind, **kw):
        kw.update(kind=kind, ident=ident, t=time.time(), rank=hvd.rank(),
                  size=hvd.size(), card=device.index, world=rt.worlds,
                  store=rt.store_addr, epoch=int(os.environ.get(
                      "HOROVOD_ELASTIC_EPOCH", "0")))
        log_f.write(json.dumps(kw) + "\n")
        log_f.flush()

    gen = torch.Generator(device).manual_seed(args.seed)
    params, named, holder = _leaf_module(ttr.init_params(cfg, gen, device))
    tokens = torch.randint(0, cfg.vocab_size, (args.rows, args.seq + 1),
                           generator=gen, device=device)
    opt = hvd.DistributedOptimizer(
        ttr.default_optimizer([p for _, p in named]), named_parameters=named)
    state = hvd.elastic.TorchState(holder, opt, step=0)

    def one_step(i):
        """Forward, backward through the hooks and the AdamW step on this
        rank's rows; returns the global mean loss and the step's ms."""
        note("begin", step=i)
        sync()
        t0 = time.perf_counter()
        n, r = hvd.size(), hvd.rank()
        rows = args.rows // n
        opt.zero_grad(set_to_none=True)
        loss = ttr.lm_loss(params,
                           {"tokens": tokens[r * rows:(r + 1) * rows]}, cfg)
        loss.backward()
        opt.step()
        loss = hvd.allreduce(loss.detach(), name="phase9.loss").item()
        sync()
        return loss, 1e3 * (time.perf_counter() - t0)

    if args.kill_ident == ident:
        # Dies in the backward of the kill step, when its executor is
        # handed the first response of that backward: the other ranks
        # run that allreduce, so theirs are in flight on a dead peer.
        # The slot leaves discovery with the process, as a lost host's
        # would: discovery shows the shrunk hosts once this pid is gone
        # (``launch``'s discover.sh), so the driver never sees the fewer
        # slots while this worker still lives and drops another one.
        armed = []
        params["lm_head"].register_post_accumulate_grad_hook(
            lambda _: armed.append(state.step == args.kill_step))
        execute = rt.executor.execute

        def doomed(*a, **kw):
            if any(armed):
                with open(args.hosts_file + ".next", "w") as f:
                    f.write(f"localhost:{args.shrink_to}\n")
                with open(args.hosts_file + ".pid.tmp", "w") as f:
                    f.write(str(os.getpid()))
                os.replace(args.hosts_file + ".pid.tmp",
                           args.hosts_file + ".pid")
                note("killed", step=state.step)
                os.kill(os.getpid(), signal.SIGKILL)
            return execute(*a, **kw)
        rt.executor.execute = doomed

    resets_at = set(args.reset_at if ident.endswith(":0") else ())
    seen = {"resets": 0, "small": 0, "grown": False}
    pending_mem = []

    @hvd.elastic.run
    def train(state):
        for e in core_elastic.resets[seen["resets"]:]:
            note("reset", **e)
        seen["resets"] = len(core_elastic.resets)
        if pending_mem:
            allocated, free = memory()
            note("memory", after=allocated, free_after=free,
                 **pending_mem.pop())
        while state.step < args.steps:
            i = state.step
            loss, ms = one_step(i)
            if i in resets_at:
                # An in-place reset: a failure after the step and before
                # its commit, so the step replays.
                resets_at.discard(i)
                allocated, free = memory()
                pending_mem.append(dict(step=i, loss_first=loss,
                                        before=allocated, free_before=free))
                raise hvd.HorovodInternalError(f"injected after step {i}")
            sync()
            t0 = time.perf_counter()
            state.step += 1
            state.save()
            sync()
            commit_ms = 1e3 * (time.perf_counter() - t0)
            note("done", step=i, loss=loss, ms=ms, commit_ms=commit_ms)
            if args.die_step == state.step and ident.endswith(":0"):
                os._exit(1)   # a hard exit after the commit, no cleanup
            state.check_host_updates()
            if hvd.size() == args.shrink_to and args.grow_after:
                seen["small"] += 1
                if seen["small"] >= args.grow_after:
                    # Hold at the commit until the world has grown back.
                    if hvd.rank() == 0 and not seen["grown"]:
                        seen["grown"] = True
                        with open(args.hosts_file, "w") as f:
                            f.write(f"localhost:{args.grow_to}\n")
                        note("grow")
                    deadline = time.monotonic() + 240
                    while time.monotonic() < deadline:
                        state.check_host_updates()
                        time.sleep(0.01)
                    raise RuntimeError("the world did not grow back")

    tfa.flash_fwd_cuda.launches = 0
    if args.worker == "static":
        for i in range(args.steps):
            loss, ms = one_step(i)
            note("done", step=i, loss=loss, ms=ms)
    else:
        train(state)
    note("end", digest=param_digest(params), aborts=rt.aborts,
         flash_launches=tfa.flash_fwd_cuda.launches,
         peak_mem_bytes=(torch.cuda.max_memory_allocated(device) if cuda
                         else 0))
    log_f.close()
    hvd.shutdown()


JOB_TAG_ENV = "CHIP_SMOKE_JOB"


def _tagged_processes(tag):
    """Pids of the live processes whose environment carries
    ``CHIP_SMOKE_JOB=<tag>``: a launched job's launcher and workers,
    each worker in a session of its own."""
    needle = f"{JOB_TAG_ENV}={tag}".encode()
    pids = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/environ", "rb") as f:
                if needle in f.read().split(b"\0"):
                    pids.append(int(name))
        except OSError:
            pass   # exited meanwhile
    return pids


def _kill_tagged(tag):
    """SIGKILLs what is left of a launched job; returns the pids."""
    pids = _tagged_processes(tag)
    for pid in pids:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    return pids


def launch(out, np_, worker_args, elastic=None, timeout=400):
    """``python -m horovod_tpu_torch.runner`` on this script's worker
    mode; ``elastic`` is ``(min_np, max_np, first hosts line)`` for the
    discovery file. Returns the launcher's exit code and output, and
    every process's events by identity. The children get this process's
    environment without its rendezvous variables, and a tag by which
    every process of the job is found and killed once the launcher has
    exited: a process left then fails the phase."""
    os.makedirs(out, exist_ok=True)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", str(np_)]
    hosts_file = os.path.join(out, "hosts")
    if elastic is not None:
        min_np, max_np, hosts = elastic
        with open(hosts_file, "w") as f:
            f.write(hosts + "\n")
        script = os.path.join(out, "discover.sh")
        with open(script, "w") as f:
            # A worker that kills itself leaves its pid and the hosts to
            # show once it is gone (reaped by the driver).
            f.write(f"#!/bin/sh\nif [ -f {hosts_file}.pid ] && ! kill -0 "
                    f"\"$(cat {hosts_file}.pid)\" 2>/dev/null; then\n"
                    f"  mv {hosts_file}.next {hosts_file}; "
                    f"rm -f {hosts_file}.pid\nfi\ncat {hosts_file}\n")
        os.chmod(script, 0o755)
        cmd += ["--min-np", str(min_np), "--max-np", str(max_np),
                "--host-discovery-script", script]
    here = os.path.dirname(os.path.abspath(__file__))
    cmd += [sys.executable, os.path.join(here, "chip_smoke.py"), "--worker",
            *worker_args, "--out", out, "--hosts-file", hosts_file]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "MASTER_"))}
    env.setdefault("PYTHONFAULTHANDLER", "1")   # tracebacks on a crash
    tag = env[JOB_TAG_ENV] = f"{os.getpid()}.{time.monotonic_ns()}"
    proc = subprocess.Popen(cmd, env=env, cwd=here, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        raise AssertionError(f"launched job did not end in {timeout} s:\n"
                             + text.decode(errors="replace")[-6000:])
    finally:
        left = _kill_tagged(tag)
    text = text.decode(errors="replace")
    if left:
        raise AssertionError(f"the launched job left processes {left} "
                             f"running after its launcher exited:\n"
                             + text[-6000:])
    with open(os.path.join(out, "launcher.log"), "w") as f:
        f.write(text)
    events = {}
    for name in sorted(os.listdir(out)):
        if name.endswith(".jsonl"):
            with open(os.path.join(out, name)) as f:
                events[name[:-6].replace("_", ":")] = [
                    json.loads(ln) for ln in f]
    return proc.returncode, text, events


def _rel(a, b):
    return abs(a - b) / abs(b)


def _kinds(evs, kind, **match):
    return [e for e in evs if e["kind"] == kind
            and all(e.get(k) == v for k, v in match.items())]


def _losses(events):
    """step -> loss of rank 0's completed attempt, over every identity."""
    done = sorted((e for evs in events.values() for e in evs
                   if e["kind"] == "done" and e["rank"] == 0),
                  key=lambda e: e["t"])
    return {e["step"]: e["loss"] for e in done}


def _reset_ms(e):
    return {k: round(1e3 * e[k], 1) for k in ("shutdown_s", "init_s",
                                               "sync_s") if k in e}


def phase_launch_static(out, slice_losses, extra=()):
    """Phase 9 (a): a static one-rank launch; losses equal phase 5's."""
    steps = len(slice_losses)
    rc, text, events = launch(out, 1, ["static", "--steps", str(steps),
                                       *extra])
    done = _kinds(events.get("rank:0", []), "done")
    losses = [e["loss"] for e in done]
    dev = [_rel(a, b) for a, b in zip(losses, slice_losses)]
    ok = rc == 0 and len(done) == steps and max(dev) <= 1e-2
    ms = statistics.median(e["ms"] for e in done[3:]) if done[3:] else 0.0
    log(f"  (a) static launch (-np 1): exit {rc}; losses "
        f"{[round(x, 5) for x in losses]}; max rel diff from phase 5's "
        f"{max(dev, default=float('nan')):.2e} (tol 1e-2); step {ms:.1f} ms "
        f"(median of the {len(done[3:])} timed steps)")
    if not ok:
        raise AssertionError("phase 9 (a) failed:\n" + text[-6000:])
    return {"static_step_ms": ms, "static_losses": losses}


# In-place resets after these steps (each uncommitted, so it replays),
# then a hard exit after the commit of DIE_STEP - 1.
RESET_AT, DIE_STEP = (2, 5), 6
MEM_BOUND = 256 * 2**20


def phase_elastic_one_card(out, slice_losses, extra=()):
    """Phase 9 (b) and (c): one elastic worker on the card."""
    steps = len(slice_losses)
    rc, text, events = launch(
        out, 1, ["elastic", "--steps", str(steps), "--reset-at",
                 *map(str, RESET_AT), "--die-step", str(DIE_STEP), *extra],
        elastic=(1, 1, "localhost:1"))
    first = events.get("localhost:0", [])
    second = events.get("localhost:1", [])
    log(f"  elastic job (--min-np 1 --max-np 1, discovery localhost:1): "
        f"exit {rc}; identities {sorted(events)}")
    ok = rc == 0 and bool(first) and bool(second)

    done0 = {e["step"]: e for e in _kinds(first, "done")}
    dev0 = [_rel(done0[i]["loss"], slice_losses[i]) for i in sorted(done0)]
    resets = _kinds(first, "reset")
    mems = _kinds(first, "memory")
    worlds = [(e["world"], e["store"]) for e in _kinds(first, "done")]
    ok = ok and sorted(done0) == list(range(DIE_STEP)) and len(resets) == 2
    ok = ok and all(d <= 1e-2 for d in dev0)
    ok = ok and sorted({w for w, _ in worlds}) == [1, 2, 3]
    ok = ok and len(mems) == 2 and all(
        abs(m["after"] - m["before"]) <= MEM_BOUND for m in mems)
    log(f"  (b) two in-place resets (after steps {list(RESET_AT)}, before "
        f"their commits): steps done {sorted(done0)}; losses vs phase 5 "
        f"max rel diff {max(dev0, default=float('nan')):.2e} (tol 1e-2); "
        f"replayed steps' first and second losses "
        f"{[(m['step'], m['loss_first'], done0[m['step']]['loss']) for m in mems if m['step'] in done0]}")
    log(f"      worlds this process formed, by the steps done in them: "
        f"{sorted(set(w for w, _ in worlds))} — each reset took the NCCL "
        f"communicators down and brought new ones up")
    for e, m in zip(resets, mems):
        log(f"      reset after step {m['step']}: {_reset_ms(e)} ms "
            f"(shutdown, re-init through the first collective, sync); "
            f"memory_allocated {m['before']} -> {m['after']} bytes "
            f"(delta {m['after'] - m['before']}, bound {MEM_BOUND}); free "
            f"card memory {m['free_before']} -> {m['free_after']}")

    done1 = {e["step"]: e for e in _kinds(second, "done")}
    dev1 = [_rel(done1[i]["loss"], slice_losses[i]) for i in sorted(done1)]
    end1 = _kinds(second, "end")
    ok = ok and sorted(done1) == list(range(steps)) and bool(end1)
    ok = ok and all(d <= 1e-2 for d in dev1)
    commit = [e["commit_ms"] for e in done1.values()]
    log(f"  (c) hard exit after the commit of step {DIE_STEP - 1}: the "
        f"driver respawned a new identity (localhost:1) at epoch "
        f"{sorted({e['epoch'] for e in second})} on card "
        f"{sorted({e['card'] for e in second})}. At a world of 1 no "
        f"survivor holds the state, so it trained from step 0 (not a "
        f"resume): steps {sorted(done1)}, losses vs phase 5 max rel diff "
        f"{max(dev1, default=float('nan')):.2e}; commit (state.save of "
        f"model and AdamW state, CUDA-synchronized) median "
        f"{statistics.median(commit or [float('nan')]):.2f} ms; peak memory "
        f"{(end1[0]['peak_mem_bytes'] if end1 else 0) / 2**30:.2f} GiB")
    if not ok:
        raise AssertionError("phase 9 (b)/(c) failed:\n" + text[-8000:])
    return {"reset_ms": [_reset_ms(e) for e in resets],
            "reset_memory": [{k: m[k] for k in ("step", "before", "after",
                                                "free_before", "free_after")}
                             for m in mems],
            "commit_ms": commit,
            "respawn_losses": [done1[i]["loss"] for i in sorted(done1)],
            "respawn_peak_mem_bytes": end1[0]["peak_mem_bytes"]}


def run_phase9(root, slice_losses, extra=()):
    log("phase 9: the launcher and elastic training (python -m "
        "horovod_tpu_torch.runner, one card)")
    out = {}
    out.update(phase_launch_static(os.path.join(root, "a"), slice_losses,
                                   extra))
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    out.update(phase_elastic_one_card(os.path.join(root, "bc"), slice_losses,
                                      extra))
    log(json.dumps({"launcher_elastic": out}))


# The four-card scenario: a global batch of 12 rows (3 a rank at 4, 4 at
# 3); identity localhost:1 (rank 1) dies in the backward of step 4, the
# world re-forms at 3, trains GROW_AFTER steps, and grows back to 4.
FOUR = dict(steps=10, rows=12, kill_step=4, grow_after=3)


def run_phase9_four_cards(root, extra=(), dims=FOUR):
    log("phase 9: elastic training on four cards: rank 1 killed in step "
        f"{dims['kill_step']}'s backward, re-formed at 3, grown back to 4")
    common = ["--steps", str(dims["steps"]), "--rows", str(dims["rows"]),
              *extra]
    rc, text, ref = launch(os.path.join(root, "ref"), 4,
                           ["static", *common])
    ref_losses = _losses(ref)
    log(f"  uninterrupted four-rank run: exit {rc}; losses "
        f"{[round(ref_losses[i], 5) for i in sorted(ref_losses)]}")
    if rc != 0 or len(ref_losses) != dims["steps"]:
        raise AssertionError("the uninterrupted run failed:\n" + text[-6000:])
    rc, text, events = launch(
        os.path.join(root, "elastic"), 4,
        ["elastic", *common, "--kill-ident", "localhost:1", "--kill-step",
         str(dims["kill_step"]), "--shrink-to", "3", "--grow-after",
         str(dims["grow_after"]), "--grow-to", "4"],
        elastic=(3, 4, "localhost:4"))
    log(f"  elastic job: exit {rc}; identities {sorted(events)}")
    killed = _kinds(events.get("localhost:1", []), "killed")
    losses = _losses(events)
    ok = rc == 0 and len(killed) == 1 and sorted(losses) == sorted(ref_losses)
    dev = [abs(losses[i] - ref_losses[i]) / abs(ref_losses[i])
           for i in sorted(losses)]
    ok = ok and max(dev) <= 1e-2
    log(f"  losses {[round(losses[i], 5) for i in sorted(losses)]}; max rel "
        f"diff from the uninterrupted run {max(dev, default=float('nan')):.2e}"
        f" (tol 1e-2)")
    t_kill = killed[0]["t"] if killed else float("nan")
    cards = sorted({(e["epoch"], e["ident"], e["rank"], e["card"])
                    for evs in events.values() for e in evs
                    if e["kind"] == "done"})
    log(f"  cards (epoch, identity, rank, card): {cards}")
    by_epoch = {}
    for ep, ident, _, card in cards:
        by_epoch.setdefault(ep, {})[ident] = card
    # No two identities of an epoch on one card (a CPU rehearsal has no
    # cards to hold).
    ok = ok and all(len(set(c.values())) == len(c) for c in by_epoch.values()
                    if None not in c.values())
    summary = {"per_reset": []}
    survivors = [i for i in ("localhost:0", "localhost:2", "localhost:3")]
    for ident in survivors:
        evs = events.get(ident, [])
        resets = _kinds(evs, "reset")
        begins = len(_kinds(evs, "begin"))
        done = len(_kinds(evs, "done"))
        failure = [e for e in resets if e["reason"] != "hosts updated"]
        grow = [e for e in resets if e["reason"] == "hosts updated"]
        first3 = [e for e in _kinds(evs, "done") if e["size"] == 3][:1]
        first4 = [e for e in _kinds(evs, "done")
                  if e["size"] == 4 and e["epoch"] > 1][:1]
        row = {"ident": ident, "resets": len(resets),
               "replayed": begins - done}
        if failure:
            f = failure[0]
            row.update(
                detect_ms=1e3 * (f["t_error"] - t_kill),
                reform_ms=1e3 * (f["shutdown_s"] + f["init_s"]),
                recover_ms=(1e3 * (first3[0]["t"] - t_kill) if first3
                            else None),
                reason=f["reason"], **{f"fail_{k}": v
                                       for k, v in _reset_ms(f).items()})
        if grow:
            row.update({f"grow_{k}": v for k, v in _reset_ms(grow[0]).items()},
                       grow_to_step_ms=(1e3 * (first4[0]["t"]
                                               - grow[0]["t_error"])
                                        if first4 else None))
        commits = [e["commit_ms"] for e in _kinds(evs, "done")]
        row["commit_ms_median"] = statistics.median(commits or [0.0])
        summary["per_reset"].append(row)
        ok = ok and bool(failure) and row["detect_ms"] < 60e3
        ok = ok and row["replayed"] <= len(resets)
        log(f"  {ident}: {row}")
    ends = {i: _kinds(evs, "end") for i, evs in events.items()}
    final = {i: e[0] for i, e in ends.items() if e}
    digests = [e["digest"] for e in final.values()]
    ok = ok and len(final) == 4 and all(d == digests[0] for d in digests)
    log(f"  final world: {sorted(final)} on cards "
        f"{[final[i]['card'] for i in sorted(final)]}; parameter digests "
        f"equal on all ranks: {all(d == digests[0] for d in digests)}; "
        f"aborted worlds per process "
        f"{ {i: e['aborts'] for i, e in final.items()} }")
    log(json.dumps({"elastic_four_cards": dict(
        summary, losses=[losses[i] for i in sorted(losses)],
        ref_losses=[ref_losses[i] for i in sorted(ref_losses)],
        cards=cards)}))
    if not ok:
        raise AssertionError("phase 9 four-card scenario failed:\n"
                             + text[-10000:])


# ---------------------------------------------------------------------------
# Phase 10: ResNet-50, the bench's headline arm
# ---------------------------------------------------------------------------

#: The bf16 step's losses against the f32 step's from the same weights
#: (ResNet-50, 8 images of 64x64, 3 SGD steps) may differ by this much,
#: relatively (the same check on the CPU differs by at most 4.8e-3).
RESNET_BF16_RTOL = 2e-2
#: Phase 10's bench arguments (``bench.run_resnet``'s defaults: the
#: reference protocol at full width).
RESNET_DIMS = {}


def phase_resnet_check(seed, device, batch=8, size=64, steps=3):
    """Phase 10's small-input check: the bf16 step against the f32 step
    (TF32 off) from the same weights and images."""
    cfg = dataclasses.replace(bench.RESNET50, dtype=torch.float32)
    weights = resnet.init_params(cfg, torch.Generator(device).manual_seed(
        seed), device)
    gen = torch.Generator(device).manual_seed(seed + 1)
    batch_ = {"images": torch.randn((batch, size, size, 3), generator=gen,
                                    device=device),
              "labels": torch.randint(0, cfg.num_classes, (batch,),
                                      generator=gen, device=device)}
    losses = {}
    for dtype in (torch.float32, torch.bfloat16):
        init_state, step = resnet.make_train_step(
            dataclasses.replace(cfg, dtype=dtype), device)
        state = init_state(state_dict={k: v.clone()
                                       for k, v in weights.items()})
        losses[dtype] = [step(state, batch_)[1].item() for _ in range(steps)]
    f32, bf16 = losses[torch.float32], losses[torch.bfloat16]
    rel = max(abs(a - b) / abs(b) for a, b in zip(bf16, f32))
    log(f"  small-input check ({batch} images of {size}x{size}, {steps} "
        f"SGD steps from the same weights): f32 losses "
        f"{[round(x, 5) for x in f32]}, bf16 {[round(x, 5) for x in bf16]}; "
        f"max rel diff {rel:.3e} (bound {RESNET_BF16_RTOL})")
    if not (rel <= RESNET_BF16_RTOL and f32[-1] < f32[0]
            and all(math.isfinite(x) for x in bf16)):
        raise AssertionError("ResNet small-input check failed: the bf16 "
                             "losses must be finite and within "
                             f"{RESNET_BF16_RTOL} of the f32 ones, which "
                             "must fall")
    return {"f32_losses": f32, "bf16_losses": bf16, "max_rel_diff": rel}


def phase_resnet(device, mesh, dims=RESNET_DIMS, world1_ms=None):
    """Phase 10's bench arm on this rank of ``mesh``'s world, with
    checks; rank 0 prints. Returns the step ms."""
    n, rank = mesh.size(), dist.get_rank()
    say = log if rank == 0 else (lambda *a: None)
    cuda = device.type == "cuda"
    base = 0
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    out = bench.run_resnet(mesh, device, **dims)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    model = out.pop("state")["model"]
    digests = allgather_object(tensor_digest(
        list(model.state_dict().values())))
    losses = out["losses"]
    flops = 3 * resnet.forward_flops(model.cfg, dims.get("image_size", 224))
    share = flops * out["images_per_sec_per_gpu"] / H100_BF16_FLOPS
    batch = out["batch"]
    say(f"  world: {n} process(es) on {device.type}; a global batch of "
        f"{batch} ({batch // n} a rank)")
    say(f"  losses (global mean; 10 warm-up steps, then the timed ones, "
        f"every 10th): {[round(x, 5) for x in losses[::10]]}, last "
        f"{losses[-1]:.5f}")
    say(f"  {out['images_per_sec_per_gpu']:.2f} images/s per GPU, step "
        f"{out['step_ms']:.3f} ms (mean of the timed steps"
        + (f"; world of 1: {world1_ms:.3f} ms" if world1_ms else "")
        + f"), peak memory {(peak - base) / 2**30:.2f} GiB above the "
        f"{base / 2**30:.2f} GiB held before the arm, model-FLOP share "
        f"{100 * share:.2f}% ({flops / 1e9:.4f} GFLOP a training image = 3 "
        f"x the forward's conv and dense FLOPs, x images/s / 989e12); "
        f"parameter digests equal on {len(digests)} rank(s): "
        f"{all(d == digests[0] for d in digests)}")
    say(json.dumps({"resnet50": dict(
        out, world=n, peak_mem_bytes=peak - base, held_before_bytes=base,
        flops_per_image=flops,
        model_flop_share=share, world1_step_ms=world1_ms)}))
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and all(d == digests[0] for d in digests)):
        raise AssertionError("ResNet arm failed: losses must be finite and "
                             "falling, parameters equal on every rank")
    return out["step_ms"]


def resnet_world(rank, n, port, world1_ms=None, device=None,
                 dims=RESNET_DIMS):
    """Phase 10's bench arm as rank ``rank`` of ``n`` (one process per
    card); returns the step ms. ``device="cpu"`` and smaller ``dims``
    rehearse it on gloo."""
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    device = init_process_group(device)
    try:
        return phase_resnet(device, data_parallel_mesh(), dims, world1_ms)
    finally:
        dist.destroy_process_group()


def run_resnet(seed, cards=1):
    """Phase 10: the small-input check (one card, in this process), the
    arm at a world of 1 in a fresh process (the host-bound step's time
    depends on what the process ran before; a fresh one is what
    ``python -m horovod_tpu_torch.bench`` measures), then on ``cards``
    cards, one process each."""
    log("phase 10: ResNet-50, the bench's headline arm (224², batch 32 a "
        "card, bf16, SGD)")
    gc.collect()    # earlier phases' reference cycles hold card memory
    if cards == 1:
        phase_resnet_check(seed, torch.device("cuda"))
        torch.cuda.empty_cache()
    with mp.get_context("spawn").Pool(1) as pool:
        world1_ms = pool.apply(resnet_world, (0, 1, free_port()))
    if cards > 1:
        log(f"  on {cards} cards:")
        mp.spawn(resnet_world, args=(cards, free_port(), world1_ms),
                 nprocs=cards, join=True)


# ---------------------------------------------------------------------------
# Phase 11: the quantized gradient plane
# ---------------------------------------------------------------------------

#: Every loss of a compressed step may differ from phase 5's (phase 6's
#: at a world of 1, within 1e-2 of it) by this share of phase 5's drop
#: (its first loss less its last): the bound ``tests/test_quantized.py``
#: holds the JAX int8 step's converged loss to. The slice overfits one
#: batch with AdamW in 8 steps, so a gradient rounded to 1/127 of its
#: block's absmax (int8) or to 8 bits (bf16) moves the later losses.
COMP_LOSS_SHARE = 0.1
#: Phase 11's steps: phase 5's slice, B=4 rows a rank.
COMP_DIMS = dict(batch=4, seq=2048, warmup=3, steps=5)
#: The embedding leaf of the slice, the plane's largest.
CODEC_LEAF = (128256, 4096)


def _packed_bytes(k: int) -> int:
    """Bytes of one packed int8 row of ``k`` elements."""
    nb = tq.int8_blocks(k)
    return 4 * nb + tq.INT8_BLOCK_ELEMS * nb


def _allreduce_counts(m: int, p: int, codec: str, elem: int):
    """(calls, send bytes) of one ``quantized_allreduce`` of ``m``
    elements (``elem`` bytes each) over ``p`` ranks."""
    k = -(-m // p)
    if codec == "none":
        return 1, m * elem
    if codec == "int8":
        return 2, p * _packed_bytes(k) + _packed_bytes(k)
    return 2, 2 * p * k + 2 * k


def plane_counts(cfg, dp: int, fsdp: int, codec: str):
    """(calls, send bytes) a step of the quantized gradient plane of
    ``make_train_step(mesh=dp x fsdp, compression=codec)`` on one rank:
    the formula, from the leaf shapes alone."""
    elem = torch.tensor([], dtype=cfg.dtype).element_size()
    shapes = ttr.param_leaves(ttr.param_shapes(cfg))
    dims = ttr.param_leaves(ttr.map_params(ttr._fsdp_spec_dim,
                                           ttr.param_specs(cfg)))
    calls = nbytes = 0
    for shape, d in zip(shapes, dims):
        m = math.prod(shape)
        if fsdp == 1:
            c, b = _allreduce_counts(m, dp, codec, elem)
        elif d is None:
            c, b = _allreduce_counts(m, fsdp, codec, elem)
        else:
            c = 1
            b = (fsdp * _packed_bytes(m // fsdp) if codec == "int8"
                 else 2 * m if codec in ("bf16", "fp16") else 4 * m)
        calls, nbytes = calls + c, nbytes + b
        if fsdp > 1 and dp > 1:
            c, b = _allreduce_counts(m // fsdp if d is not None else m, dp,
                                     codec, elem)
            calls, nbytes = calls + c, nbytes + b
    return calls, nbytes


def phase_codec(seed, device):
    """Phase 11 (1): the int8 codec on the slice's embedding leaf,
    bitwise against its CPU version, then its device ms beside the
    least time its bytes take."""
    rows, c = CODEC_LEAF
    n = rows * c
    gen = torch.Generator(device).manual_seed(seed)
    x = torch.randn(CODEC_LEAF, generator=gen, device=device).mul_(0.02)
    t0 = time.perf_counter()
    q, s = tq.blockwise_int8_encode(x)
    qc, sc = tq.blockwise_int8_encode(x.cpu())
    same = (q.cpu().equal(qc) and s.cpu().view(torch.int32).equal(
        sc.view(torch.int32)))
    same = same and tq.blockwise_int8_decode(q, s, c).cpu().view(
        torch.int32).equal(tq.blockwise_int8_decode(qc, sc, c).view(
            torch.int32))
    del qc, sc
    log(f"  codec on the embedding leaf {list(CODEC_LEAF)} f32 ({n:,} "
        f"elements): q, scales and decode bitwise equal to the CPU "
        f"version: {same} ({time.perf_counter() - t0:.1f} s)")
    if not same:
        raise AssertionError("the int8 codec on the card disagrees with its "
                             "CPU version")
    nb = tq.int8_blocks(c) * rows
    enc_bytes = 4 * n + n + 4 * nb
    flat = x.view(1, -1)
    packed = tq._pack(flat)
    pq, ps = tq._unpack(packed, n)
    timings = {
        "encode": (cuda_ms(lambda: tq.blockwise_int8_encode(x), iters=5),
                   enc_bytes),
        "decode": (cuda_ms(lambda: tq.blockwise_int8_decode(q, s, c),
                           iters=5), enc_bytes),
        # As the allreduce runs them on the leaf at a world of 1: hop 1's
        # packed encode, the fused decode + fold, the encode error.
        "pack": (cuda_ms(lambda: tq._pack(flat), iters=3), enc_bytes),
        "decode_fold": (cuda_ms(lambda: tq._decode_fold(pq, ps, n),
                                iters=3), enc_bytes),
        "encode_error": (cuda_ms(lambda: tq._encode_error(flat, pq, ps),
                                 iters=3), 4 * n + n + 4 * nb + 4 * n),
    }
    out = {}
    for name, (ms, nbytes) in timings.items():
        bound = nbytes / H100_BYTES_PER_S * 1e3
        out[name] = {"ms": ms, "bytes": nbytes, "bound_ms": bound}
        log(f"  {name}: {ms:.3f} ms, bound {bound:.3f} ms by bytes "
            f"({nbytes:,} bytes at 3.35 TB/s; {100 * bound / ms:.1f}% of "
            f"bound)")
    return out


def phase_compressed(cfg, seed, batch, seq, warmup, steps, device, mesh,
                     compression, ref_losses=None):
    """Phase 11 (2, 3) on this rank of ``mesh``'s world: the compressed
    step, counters zeroed just before its steps and read just after,
    and checks. Rank 0 prints. Returns the summary."""
    from horovod_tpu_torch import binding
    from horovod_tpu_torch.compression import in_jit_codec
    from horovod_tpu_torch.parallel.mesh import mesh_axis_size

    codec = in_jit_codec(compression)
    n, rank = mesh.size(), dist.get_rank()
    dp, fsdp = mesh_axis_size(mesh, "dp"), mesh_axis_size(mesh, "fsdp")
    say = log if rank == 0 else (lambda *a: None)
    cuda = device.type == "cuda"
    gen = torch.Generator(device).manual_seed(seed)
    init_state, step = ttr.make_train_step(cfg, device=device, mesh=mesh,
                                           compression=compression)
    state = init_state(gen)
    tokens = torch.randint(0, cfg.vocab_size, (batch * n, seq + 1),
                           generator=gen, device=device)
    local = {"tokens": ttr.shard_batch(tokens, mesh)}
    n_params = sum(math.prod(sh) for sh in ttr.param_leaves(
        ttr.param_shapes(cfg)))
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    tfa.flash_fwd_cuda.launches = 0
    tq.reset_counters()
    losses, times = [], []
    for _ in range(warmup + steps):
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, loss = step(state, local)
        losses.append(loss.item())
        if cuda:
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    launches = tfa.flash_fwd_cuda.launches
    calls, wire = tq.counters["calls"], tq.counters["wire_bytes"]
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    total = warmup + steps
    want_calls, want_bytes = plane_counts(cfg, dp, fsdp, codec)
    digests = allgather_object(param_digest(ttr.gather_params(state, cfg,
                                                              mesh)))
    peaks = allgather_object(peak)
    timed = times[warmup:]
    step_s = statistics.median(timed)
    tok_s = batch * seq / step_s
    mfu = 6 * n_params * tok_s / H100_BF16_FLOPS
    plane_ms = float("nan")
    if cuda and fsdp == 1:
        # The gradient plane alone on this step's gradients: every leaf's
        # encode, hops and decode (the residuals are not kept).
        opt = state["opt"]
        grads = [p.grad for p in opt._params()]
        plane_ms = cuda_ms(lambda: binding.allreduce_gradients(
            grads, group=opt.group, compression=compression, ef=opt.ef),
            iters=3, warmup=1)
    name = f"dp={dp} fsdp={fsdp} {codec}"
    say(f"  {name}: losses {[round(x, 5) for x in losses]}")
    if ref_losses:
        diff = max(abs(a - b) for a, b in zip(losses, ref_losses))
        bound = COMP_LOSS_SHARE * (ref_losses[0] - ref_losses[-1])
        say(f"  {name}: phase 5 losses {[round(x, 5) for x in ref_losses]}; "
            f"max |diff| {diff:.4f} (bound {COMP_LOSS_SHARE} x phase 5's "
            f"drop = {bound:.4f})")
    say(f"  {name}: step {1e3 * step_s:.1f} ms (median of {steps}; min "
        f"{1e3 * min(timed):.1f}, max {1e3 * max(timed):.1f}), "
        f"{tok_s:.1f} tokens/s/GPU, MFU {100 * mfu:.2f}% (6 * {n_params} "
        f"params * tokens/s / 989e12), peak memory per rank "
        f"{[round(x / 2**30, 2) for x in peaks]} GiB; flash_fwd launches "
        f"{launches} (want {cfg.n_layers * total if cuda else 0}); "
        f"quantized-plane calls {calls} (want {total * want_calls}) and "
        f"send bytes {wire} (want {total * want_bytes}); gradient plane "
        f"alone {plane_ms:.3f} ms ({100 * plane_ms / (1e3 * step_s):.1f}% "
        f"of the step); gathered-parameter digests equal on {len(digests)} "
        f"rank(s): {all(d == digests[0] for d in digests)}")
    tol = (COMP_LOSS_SHARE * (ref_losses[0] - ref_losses[-1])
           if ref_losses else None)
    ok = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
          and (not ref_losses or all(abs(a - b) <= tol
                                     for a, b in zip(losses, ref_losses)))
          and launches == (cfg.n_layers * total if cuda else 0)
          and calls == total * want_calls and wire == total * want_bytes
          and all(d == digests[0] for d in digests))
    if not ok:
        raise AssertionError(
            f"compressed step {name} failed: losses must be finite, falling "
            f"and within {COMP_LOSS_SHARE} x phase 5's drop of its losses "
            "where given; "
            "flash_fwd must run once a layer; the plane's calls and bytes "
            "must equal the formula's; parameters must agree on every rank")
    out = {"dp": dp, "fsdp": fsdp, "codec": codec, "world": n,
           "batch_per_rank": batch, "seq": seq,
           "step_ms_median": 1e3 * step_s, "step_ms": [1e3 * x for x in timed],
           "tokens_per_s_per_gpu": tok_s, "mfu_6N": mfu,
           "peak_mem_bytes": peaks, "losses": losses,
           "flash_fwd_launches": launches, "plane_calls_per_step":
           calls / total, "plane_bytes_per_step": wire / total,
           "plane_ms": plane_ms}
    say(json.dumps({"compressed": out}))
    del state
    if cuda:
        torch.cuda.empty_cache()
    return out


# Phase 11's meshes on four cards: (dp, fsdp, codec).
FOUR_CARD_PLANES = ((4, 1, "int8"), (1, 4, "none"), (1, 4, "int8"),
                    (2, 2, "int8"))


def comp_world(rank, n, port, cfg, seed, slice_losses, device=None,
               dims=COMP_DIMS, codec_check=True):
    """Phase 11 as rank ``rank`` of ``n``: on one process the codec
    check and the dp step with int8 and bf16; on four, the planes of
    :data:`FOUR_CARD_PLANES`. ``device="cpu"`` and smaller ``dims``
    rehearse it on gloo."""
    from horovod_tpu_torch.compression import Compression
    from horovod_tpu_torch.parallel.mesh import build_mesh

    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    device = init_process_group(device)
    try:
        out = {}
        if n == 1:
            if codec_check and device.type == "cuda":
                out["codec"] = phase_codec(seed, device)
                torch.cuda.empty_cache()
            mesh = build_mesh(dp=1)
            for codec in ("int8", "bf16"):
                out[codec] = phase_compressed(
                    cfg, seed, **dims, device=device, mesh=mesh,
                    compression=getattr(Compression, codec),
                    ref_losses=slice_losses)
        else:
            for dp, fsdp, codec in FOUR_CARD_PLANES:
                mesh = build_mesh(dp=dp, fsdp=fsdp)
                out[f"{dp}x{fsdp}-{codec}"] = phase_compressed(
                    cfg, seed, **dims, device=device, mesh=mesh,
                    compression=getattr(Compression, codec))
        return out
    finally:
        dist.destroy_process_group()


def run_phase11(cfg, seed, slice_losses, cards=1):
    """Phase 11: the quantized gradient plane, in a fresh process on one
    card (as phase 10 runs), or one process a card on four."""
    log(f"phase 11: the quantized gradient plane ({cards} card(s); "
        f"Compression.int8 with error feedback, bf16, the fsdp step)")
    gc.collect()
    if cards == 1:
        with mp.get_context("spawn").Pool(1) as pool:
            return pool.apply(comp_world,
                              (0, 1, free_port(), cfg, seed, slice_losses))
    mp.spawn(comp_world, args=(cards, free_port(), cfg, seed, None),
             nprocs=cards, join=True)
    return None


# ---------------------------------------------------------------------------
# Phase 12: tensor and sequence parallelism
# ---------------------------------------------------------------------------

def tp_sp_counts(cfg, axes, rows, seq, sp_rank=0):
    """``{kind: {"calls", "bytes"}}`` of one train step's model
    collectives on sp rank ``sp_rank`` of a ``axes`` mesh (``{"dp": ..,
    "fsdp": .., "sp": .., "tp": ..}``), for a global batch of ``rows`` x
    ``seq`` tokens: the formula the counters of :mod:`horovod_tpu_torch.
    parallel.tensor_parallel` must meet (the fsdp step's gathers and
    reduce-scatters are not among them).

    With tp, each of the B·T/sp local tokens' ``d_model`` activations
    is all-reduced (cfg.dtype) in the forward once by the embedding
    island, twice a layer (attention and MLP outputs), and in the
    backward twice a layer (the inputs of the column-parallel matmuls)
    and once before lm_head; the loss all-reduces three f32 values a
    token (max, sum of exp, target logit); where ``n_kv_heads % tp``
    the whole wk/wv gradients are summed too (two a layer). With sp the
    ring rotates the stacked K/V of the rank's ``H / tp`` (K/V tiled to
    the query heads) ``sp - 1`` times a layer each way; Ulysses makes
    two all-to-alls a layer each way (q/k/v stacked, then the output).
    With ``cfg.remat`` a layer's forward runs again in the backward."""
    tp, sp, dp, fsdp = (axes.get(a, 1) for a in ("tp", "sp", "dp", "fsdp"))
    elem = torch.tensor([], dtype=cfg.dtype).element_size()
    L, D, dh = cfg.n_layers, cfg.d_model, cfg.head_dim
    tokens = rows // (dp * fsdp) * (seq // sp)
    act = tokens * D * elem
    fwd = 2 if cfg.remat else 1
    out = {k: {"calls": 0, "bytes": 0} for k in ttp.KINDS}

    def add(kind, calls, nbytes):
        out[kind]["calls"] += calls
        out[kind]["bytes"] += calls * nbytes

    if tp > 1:
        add("tp", 1 + 2 * L * fwd + 2 * L + 1, act)
        add("tp", 3, tokens * 4)
        if cfg.n_kv_heads % tp:
            add("tp", 2 * L, D * cfg.n_kv_heads * dh * elem)
    if sp > 1:
        heads = tokens * (cfg.n_heads // tp) * dh * elem
        if cfg.sp_attention in ("ring", "ring_flash"):
            add("sp_p2p", (sp - 1) * L * (fwd + 1), 2 * heads)
        elif cfg.sp_attention == "ulysses":
            add("sp_a2a", L * (fwd + 1), 3 * heads)
            add("sp_a2a", L * (fwd + 1), heads)
    return out


def flash_launches_per_step(cfg, sp: int, sp_rank: int) -> int:
    """Flash kernel launches a step on sp rank ``sp_rank``: one a layer
    for ``"flash"``; for the causal ``"ring_flash"``, one a layer for
    each chunk at or before the rank's own (``sp_rank + 1``; the ring's
    ``sp (sp + 1) / 2``); none for the plain impls."""
    if cfg.sp_attention == "flash":
        return cfg.n_layers
    if cfg.sp_attention == "ring_flash":
        return cfg.n_layers * (sp_rank + 1 if sp > 1 else 1)
    return 0


def phase_ring_merge(seed, b=1, t=8192, h=32, d=128, sp=4):
    """Phase 12 (one card): one ``[b, t]`` sequence cut into ``sp``
    chunks; for each chunk's queries, :func:`~horovod_tpu_torch.parallel.
    ring_attention.attend_and_merge` over the chunks in ring order
    (through the kernel, causal), then the backward of a random
    cotangent on out and lse; held against the whole sequence's
    ``flash_attention_with_lse``. The rotations between cards are not
    exercised here (four cards run them). Bounds: out within twice the
    kernel's own bound (each side is within it of the exact result)
    plus 1e-5; lse within 3e-4 (1e-4 each, and the f32 merge); dq, dk,
    dv (bf16) within 2^-5 of the largest reference gradient (bf16
    chunk gradients summed over up to ``sp`` chunks, each rounded to
    2^-9, and P rounded to bf16 in the kernel's P·V)."""
    from horovod_tpu_torch.parallel import ring_attention as tra

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(seed)
    bh, c, scale = b * h, t // sp, d ** -0.5

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    q, k, v = (randn(bh, t, d).to(torch.bfloat16).requires_grad_(True)
               for _ in range(3))
    g_out, g_lse = randn(bh, t, d), randn(bh, t)
    tfa.flash_fwd_cuda.launches = 0
    outs, lses = [], []
    for r in range(sp):
        qr = q[:, r * c:(r + 1) * c]
        carry = tra.ring_carry(qr)
        for i in range(sp):
            src = (r + i) % sp
            carry = tra.attend_and_merge(
                qr, k[:, src * c:(src + 1) * c], v[:, src * c:(src + 1) * c],
                carry, case=tra.chunk_case(src, r, True), scale=scale)
        out, lse = tra.merged_result(carry)
        outs.append(out)
        lses.append(lse)
    out, lse = torch.cat(outs, 1), torch.cat(lses, 1)
    launches = tfa.flash_fwd_cuda.launches
    got = torch.autograd.grad((out * g_out).sum() + (lse * g_lse).sum(),
                              (q, k, v))
    w_out, w_lse = tfa.flash_attention_with_lse(q, k, v, causal=True,
                                                scale=scale,
                                                out_dtype=torch.float32)
    want = torch.autograd.grad((w_out * g_out).sum() + (w_lse * g_lse).sum(),
                               (q, k, v))
    torch.cuda.synchronize()
    atol = 2 * tfa.kernel_tolerance(torch.bfloat16, torch.float32,
                                    v.abs().max().item())[0] + 1e-5
    out_err = (out - w_out).abs().max().item()
    lse_err = (lse - w_lse).abs().max().item()
    grad_err = [((a.float() - w.float()).abs().max()
                 / w.float().abs().max()).item() for a, w in zip(got, want)]
    want_launches = sp * (sp + 1) // 2
    ok = (out_err <= atol and lse_err <= 3e-4
          and all(e <= 2 ** -5 for e in grad_err)
          and launches == want_launches)
    log(f"  ring merge on one card (B={b} T={t} H={h} D={d} bf16, {sp} "
        f"chunks of {c}; no NCCL rotation here): max|dout| {out_err:.3e} "
        f"(bound {atol:.3e}), max|dlse| {lse_err:.3e} (bound 3e-4), "
        f"max|dgrad| / max|grad| dq {grad_err[0]:.3e} dk {grad_err[1]:.3e} "
        f"dv {grad_err[2]:.3e} (bound {2 ** -5:.3e}); chunk launches "
        f"{launches} (want {want_launches}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("ring_flash's attend-and-merge over chunks "
                             "disagrees with the whole-sequence kernel")


#: Phase 12 on four cards: (name, mesh axes, sp_attention, global rows,
#: sequence), each held against a one-card "flash" run of its batch.
#: (The fsdp step composed with tp and sp is held against JAX's on the
#: CPU, ``tests/test_torch_tensor_parallel.py``.)
TP_PLANS = (("A", {"tp": 4}, "flash", 4, 2048),
            ("B", {"sp": 4}, "ring_flash", 1, 8192),
            ("C", {"sp": 4}, "ulysses", 1, 8192),
            ("D", {"tp": 2, "sp": 2}, "ring_flash", 1, 8192))
#: On two cards.
TP_PLANS_2 = (("tp2", {"tp": 2}, "flash", 4, 2048),
              ("sp2", {"sp": 2}, "ring_flash", 1, 8192))
TP_DIMS = dict(warmup=3, steps=5)
#: Each loss within this share of its one-card reference.
TP_LOSS_RTOL = 1e-2
#: Seconds before a collective that cannot reach its peer raises.
TP_TIMEOUT = 300


def one_card_losses(cfg, seed, rows, seq, device, warmup, steps):
    """The losses of ``warmup + steps`` ``"flash"`` steps with no mesh
    (one card, no collective) from the seed's parameters and tokens, the
    draws every rank of a phase-12 run makes."""
    init_state, step = ttr.make_train_step(
        dataclasses.replace(cfg, sp_attention="flash"), device=device)
    gen = torch.Generator(device).manual_seed(seed)
    state = init_state(gen)
    tokens = torch.randint(0, cfg.vocab_size, (rows, seq + 1),
                           generator=gen, device=device)
    out = [step(state, {"tokens": tokens})[1].item()
           for _ in range(warmup + steps)]
    del state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def tp_references(cfg, seed, plans, device, dims=TP_DIMS):
    """Phase 12's one-card references, ``{(rows, seq): losses}`` for
    each batch of ``plans``: batch ``i`` runs alone on rank ``i % n``'s
    card (:func:`one_card_losses`), the batches in parallel, and every
    rank receives them all."""
    shapes = sorted({(rows, seq) for *_, rows, seq in plans})
    rank, n = dist.get_rank(), dist.get_world_size()
    mine = {shape: one_card_losses(cfg, seed, *shape, device, **dims)
            for i, shape in enumerate(shapes) if i % n == rank}
    return {k: v for part in allgather_object(mine) for k, v in part.items()}


def phase_tp(cfg, seed, name, axes, impl, rows, seq, warmup, steps, device,
             ref_losses):
    """Phase 12 on this rank: ``make_train_step(mesh=build_mesh(**axes))``
    with ``sp_attention=impl`` on a global ``rows x seq`` batch; flash
    launches and tp/sp collective counters zeroed just before the steps
    and read just after; checks; rank 0 prints."""
    from horovod_tpu_torch.parallel.mesh import axis_index, build_mesh

    cfg = dataclasses.replace(cfg, sp_attention=impl)
    mesh = build_mesh(**axes)
    n, rank = mesh.size(), dist.get_rank()
    sp = axes.get("sp", 1)
    s_rank = axis_index(mesh, "sp")
    shard_of = (axis_index(mesh, "fsdp"), axis_index(mesh, "tp"))
    say = log if rank == 0 else (lambda *a: None)
    cuda = device.type == "cuda"
    gen = torch.Generator(device).manual_seed(seed)
    init_state, step = ttr.make_train_step(cfg, device=device, mesh=mesh)
    state = init_state(gen)
    tokens = torch.randint(0, cfg.vocab_size, (rows, seq + 1),
                           generator=gen, device=device)
    local = {"tokens": ttr.shard_batch(tokens, mesh)}
    n_params = sum(math.prod(sh) for sh in ttr.param_leaves(
        ttr.param_shapes(cfg)))
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    tfa.flash_fwd_cuda.launches = 0
    ttp.reset_counters(timing=cuda)
    losses, times, coll = [], [], []
    for _ in range(warmup + steps):
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, loss = step(state, local)
        losses.append(loss.item())
        if cuda:
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
        coll.append(ttp.collective_ms(clear=True))
    launches = tfa.flash_fwd_cuda.launches
    counters = {k: dict(v) for k, v in ttp.counters.items()}
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    total = warmup + steps
    want_counts = {k: {kk: total * vv for kk, vv in v.items()} for k, v in
                   tp_sp_counts(cfg, axes, rows, seq, s_rank).items()}
    want_launches = (total * flash_launches_per_step(cfg, sp, s_rank)
                     if cuda else 0)
    counts_ok = allgather_object(counters == want_counts
                                 and launches == want_launches)
    shard = allgather_object((shard_of, param_digest(state["params"])))
    full = allgather_object(param_digest(ttr.gather_params(state, cfg,
                                                           mesh)))
    peaks = allgather_object(peak)
    timed = times[warmup:]
    step_s = statistics.median(timed)
    tok_gpu = rows * seq / step_s / n
    mfu = 6 * n_params * tok_gpu / H100_BF16_FLOPS
    coll_ms = {k: statistics.mean(c[k] for c in coll[warmup:])
               for k in ttp.KINDS}
    coll_all = allgather_object(coll_ms)
    shards_equal = all(d == e for t, d in shard for u, e in shard if t == u)
    bound = f"rtol {TP_LOSS_RTOL}"
    diff = max(abs(a - b) for a, b in zip(losses, ref_losses))
    ok_losses = (all(math.isfinite(x) for x in losses)
                 and losses[-1] < losses[0]
                 and all(abs(a - b) <= TP_LOSS_RTOL * abs(b)
                         for a, b in zip(losses, ref_losses)))
    tag = f"  ({name}) {axes} {impl} B={rows} T={seq}"
    say(f"{tag}: losses {[round(x, 5) for x in losses]}; one-card flash "
        f"{[round(x, 5) for x in ref_losses]}; max |diff| {diff:.5f} "
        f"({bound})")
    say(f"{tag}: step {1e3 * step_s:.1f} ms (median of {steps}; min "
        f"{1e3 * min(timed):.1f}, max {1e3 * max(timed):.1f}), "
        f"{tok_gpu:.1f} tokens/s/GPU, MFU {100 * mfu:.2f}% (6 * {n_params} "
        f"params * global tokens/s / {n} GPUs / 989e12), peak memory per "
        f"rank {[round(x / 2**30, 2) for x in peaks]} GiB")
    say(f"{tag}: rank 0 flash_fwd launches {launches} (want "
        f"{want_launches}), model collectives {counters} (want "
        f"{want_counts}); every rank's counts equal the formula: "
        f"{all(counts_ok)}; collective ms a step (CUDA events, mean of "
        f"{steps}) per rank "
        f"{[{k: round(v, 3) for k, v in c.items()} for c in coll_all]}; "
        f"shard digests equal across the dp x sp replicas: {shards_equal}; "
        f"gathered digests equal on {len(full)} ranks: "
        f"{all(d == full[0] for d in full)}")
    say(json.dumps({"parallel": {
        "name": name, "axes": axes, "impl": impl, "rows": rows, "seq": seq,
        "world": n, "step_ms_median": 1e3 * step_s,
        "step_ms": [1e3 * x for x in timed], "tokens_per_s_per_gpu": tok_gpu,
        "mfu_6N": mfu, "peak_mem_bytes": peaks, "losses": losses,
        "ref_losses": ref_losses, "flash_fwd_launches_rank0": launches,
        "counters_rank0": counters, "collective_ms": coll_all}}))
    if not (ok_losses and all(counts_ok) and shards_equal
            and all(d == full[0] for d in full)):
        raise AssertionError(
            f"phase 12 ({name}) failed: losses must be finite, falling and "
            f"within {bound} of the one-card run; flash launches and "
            "collective counts must equal the formula on every rank; the "
            "replicas' shards and the gathered parameters must agree")
    del state
    if cuda:
        torch.cuda.empty_cache()


def tp_world(rank, n, port, cfg, seed, device=None, plans=TP_PLANS,
             dims=TP_DIMS):
    """Phase 12's runs as rank ``rank`` of ``n`` (one process a card):
    the one-card references (:func:`tp_references`), then each plan.
    ``device="cpu"``, a small config and small plans rehearse it on
    gloo."""
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    device = init_process_group(device, timeout=TP_TIMEOUT)
    try:
        t0 = time.perf_counter()
        refs = tp_references(cfg, seed, plans, device, dims)
        if rank == 0:
            log(f"  one-card references {sorted(refs)} in "
                f"{time.perf_counter() - t0:.1f} s")
        for name, axes, impl, rows, seq in plans:
            t0 = time.perf_counter()
            phase_tp(cfg, seed, name, axes, impl, rows, seq, **dims,
                     device=device, ref_losses=refs[(rows, seq)])
            if rank == 0:
                log(f"  ({name}) in {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()


def run_phase12(cfg, seed, cards):
    """Phase 12 on ``cards`` cards (four: runs A-D; two: tp=2 and sp=2),
    one process a card."""
    plans = TP_PLANS if cards >= 4 else TP_PLANS_2
    log(f"phase 12: tensor and sequence parallelism over NCCL ({cards} "
        f"cards; the one-card flash references first, each batch on its "
        f"own card)")
    gc.collect()
    mp.spawn(tp_world, args=(cards, free_port(), cfg, seed, None, plans),
             nprocs=cards, join=True)


# ---------------------------------------------------------------------------
# Phase 13: MoE over ep and the pipeline over pp
# ---------------------------------------------------------------------------

def moe_config(cfg, n_layers: int = 2):
    """Phase 13's MoE configuration: ``cfg``'s widths (Llama-3-8B's)
    with 8 experts, top-2, capacity factor 1.25 in every layer, cut to
    ``n_layers`` (4 would take ~55 GB before activations)."""
    return dataclasses.replace(cfg, n_experts=8, moe_top_k=2,
                               moe_capacity_factor=1.25, n_layers=n_layers)


def active_params(cfg):
    """``(N, N_active)``: every parameter, and those one token meets,
    ``N - N_experts + (top_k / E) · N_experts``."""
    named = ttr.named_param_leaves(ttr.param_shapes(cfg))
    n = sum(math.prod(sh) for _, sh in named)
    experts = sum(math.prod(sh) for name, sh in named
                  if ttr.leaf_kind(name) == "expert")
    if not experts:
        return n, n
    return n, n - experts + cfg.moe_top_k * experts // cfg.n_experts


def moe_pp_counts(cfg, axes, rows, seq, sched=None, n_micro=1, stage=0):
    """``{kind: {"calls", "bytes"}}`` of one train step's model
    collectives on pp stage ``stage`` of an ``axes`` mesh (dp, fsdp, sp,
    tp, ep, pp), a global batch of ``rows`` x ``seq`` tokens and
    ``n_micro`` microbatches under ``sched`` ("gpipe", "1f1b" or None
    for the flat step): the formula the counters of :mod:`horovod_tpu_
    torch.parallel.tensor_parallel` must meet. A rank holds ``rows / (dp
    · fsdp)`` rows and ``seq / sp`` tokens of each (the fsdp gathers and
    reduce-scatters are not among the counted collectives).

    With tp: the embedding island's all-reduce (stage 0, the rank's
    rows), two a layer (attention forward, its input's gradient) and,
    for the dense FFN, two more; lm_head's input gradient and the loss's
    three f32 all-reduces (the last stage: once on the banked rows, or
    each microbatch under 1F1B); wk/wv's whole gradients where
    ``n_kv_heads % tp``. With sp, the attention: the ring rotates the
    stacked K/V of the rank's ``H / tp`` heads (tiled to the query
    heads) ``sp - 1`` times a layer each way; Ulysses makes two
    all-to-alls a layer each way. The GSPMD MoE layer (``"moe"`` over tp
    x ep): the output's Sum forward, and the gradients of the experts'
    input and of the f32 gates backward; with dp x fsdp x sp > 1 also
    the f and p routing statistics (two f32 ``[E]`` all-reduces
    forward); with sp the earlier chunks' claim counts (one int32 ``[b,
    E]`` all-gather forward). The island over ep (tp 1): f and p over dp
    x fsdp x sp x ep, the rows' all-gather forward, with sp the earlier
    chunks' claim counts (one int32 ``[b/ep, E]`` all-gather forward),
    the row split's all-gather and the router's f32 ``[D, E]`` gradient
    backward, and (``"moe_a2a"``) the dispatch and combine all-to-alls
    each way, ``E · b/ep · C · D`` elements each (``C`` the whole row's
    capacity). The pipeline (``"pp_p2p"``): one exchange a tick on
    which the stage sends or receives, forward and backward under GPipe,
    the activations' (``rows / (dp · fsdp) / n_micro`` rows) bytes sent
    down and their gradients up. With ``cfg.remat`` a layer's forward
    runs again in the backward."""
    tp, ep, pp, dp, fsdp, sp = (axes.get(a, 1) for a in
                                ("tp", "ep", "pp", "dp", "fsdp", "sp"))
    elem = torch.tensor([], dtype=cfg.dtype).element_size()
    L, D, E, K = cfg.n_layers // pp, cfg.d_model, cfg.n_experts, cfg.moe_top_k
    M = n_micro if sched else 1
    B = rows // (dp * fsdp)
    mbr = B // M
    t = seq // sp
    first, last = stage == 0, stage == pp - 1
    fwd = 2 if cfg.remat else 1
    out = {k: {"calls": 0, "bytes": 0} for k in ttp.KINDS}

    def add(kind, calls, nbytes):
        out[kind]["calls"] += calls
        out[kind]["bytes"] += calls * nbytes

    act = mbr * t * D * elem
    layers = L * M
    if tp > 1:
        if first:
            add("tp", 1, B * t * D * elem)
        add("tp", layers * (fwd + 1), act)
        if cfg.moe is None:
            add("tp", layers * (fwd + 1), act)
        if cfg.n_kv_heads % tp:
            add("tp", 2 * layers, D * cfg.n_kv_heads * cfg.head_dim * elem)
        if last:
            heads = M if sched == "1f1b" else 1
            add("tp", heads, B // heads * t * D * elem)
            add("tp", 3 * heads, B // heads * t * 4)
    if sp > 1:
        heads = mbr * t * (cfg.n_heads // tp) * cfg.head_dim * elem
        if cfg.sp_attention in ("ring", "ring_flash"):
            add("sp_p2p", (sp - 1) * layers * (fwd + 1), 2 * heads)
        elif cfg.sp_attention == "ulysses":
            add("sp_a2a", layers * (fwd + 1), 3 * heads)
            add("sp_a2a", layers * (fwd + 1), heads)
    island = (cfg.moe is not None and ep > 1
              and cfg.moe_dispatch == "island"
              and cfg.moe_compression not in (None, "none"))
    if cfg.moe is not None and island:
        if tp > 1:
            raise ValueError("moe_pp_counts: the island's formula is for tp 1")
        b = mbr // ep
        C = math.ceil(K * seq * cfg.moe_capacity_factor / E)
        add("moe", layers * fwd * 2, E * 4)
        add("moe", layers * fwd, b * t * D * elem)
        if sp > 1:
            add("moe", layers * fwd, b * E * 4)
        add("moe", layers, b * t * D * elem)
        add("moe", layers, D * E * 4)
        add("moe_a2a", layers * (fwd + 1) * 2, E * b * C * D * elem)
    elif cfg.moe is not None:
        kind = "moe" if ep > 1 else "tp"
        if tp * ep > 1:
            add(kind, layers * (fwd + 1), act)
            add(kind, layers, mbr * t * K * 4)
        if dp * fsdp * sp > 1:
            add("moe", layers * fwd * 2, E * 4)
        if sp > 1:
            add("moe", layers * fwd, mbr * E * 4)
    if sched:
        n, s = pp, stage
        ticks = range(M + 2 * n - 1) if sched == "1f1b" else range(M + n - 1)
        for tick in ticks:
            if sched == "gpipe":
                busy = ((s < n - 1 and 0 <= tick - s < M)
                        or (s > 0 and 0 <= tick - s + 1 < M))
                add("pp_p2p", 2 * busy, 0)
            else:
                busy = ((s < n - 1 and 0 <= tick - s < M)
                        or (s > 0 and 0 <= tick - s + 1 < M)
                        or (s > 0 and 0 <= tick - (2 * n - 1 - s) < M)
                        or (s < n - 1 and 0 <= tick - (2 * n - 2 - s) < M))
                add("pp_p2p", busy, 0)
        out["pp_p2p"]["bytes"] = M * act * ((s < n - 1) + (s > 0))
    return out


def flash_launches_pp(cfg, axes, sched=None, n_micro=1, sp_rank=0) -> int:
    """Flash kernel launches a step on a rank of phase 13's and phase
    15's plans: for ``"flash"`` one a layer of its stage for each
    (micro)batch; for ``"ring_flash"`` on sp rank ``sp_rank``, one for
    each chunk at or before the rank's own (the causal ring's
    ``sp_rank + 1``) a layer and (micro)batch."""
    per = cfg.n_layers // axes.get("pp", 1) * (n_micro if sched else 1)
    if cfg.sp_attention == "flash":
        return per
    if cfg.sp_attention == "ring_flash":
        return per * (sp_rank + 1 if axes.get("sp", 1) > 1 else 1)
    return 0


def phase_moe(cfg, seed, batch, seq, warmup, steps, device):
    """Phase 13 on one card: the MoE configuration (:func:`moe_config`)
    through ``make_train_step``, ``warmup + steps`` AdamW steps; flash
    launches zeroed just before and read just after. Prints the step,
    tokens/s, MFU on the active parameters, peak memory, each layer's
    dropped share of (token, choice) claims (``moe_routing_stats`` on a
    forward before the steps and one after, recorded into the ``"moe"``
    metrics series) and the losses. Then the same steps again through
    the kernel (whose losses show how far the step is deterministic) and
    through plain ``"local"`` attention. Holds: every loss finite and
    falling; the first loss (the same parameters) within 1e-2 of plain
    attention's; the trained parameters' loss through the kernel within
    1e-2 of theirs through plain attention, as phase 5 holds the slice.
    (The later losses of the two runs part further: routing is
    discontinuous, and AdamW's first steps move each weight by about
    ``lr`` whatever its gradient's size; they are printed.) Returns the
    losses."""
    from horovod_tpu_torch.metrics import _exporters
    from horovod_tpu_torch.models import moe as tmoe

    n_all, n_act = active_params(cfg)
    log(f"  MoE config: d_model={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"layers={cfg.n_layers} experts={cfg.n_experts} top-"
        f"{cfg.moe_top_k} capacity factor {cfg.moe_capacity_factor} "
        f"{cfg.dtype} B={batch} T={seq}: {n_all:,} parameters, {n_act:,} "
        f"active a token")

    def routing(params, tokens, c):
        """Each layer's routing stats on one forward of ``tokens``."""
        stats, real = [], tmoe.moe_ffn

        def record(x, lp, cfg, mesh=None):
            stats.append(tmoe.moe_routing_stats(x, lp["router"], cfg))
            return real(x, lp, cfg, mesh)

        tmoe.moe_ffn = record
        try:
            with torch.no_grad():
                ttr.forward(params, tokens[:, :-1], c)
        finally:
            tmoe.moe_ffn = real
        return stats

    def run(c, read):
        gen = torch.Generator(device).manual_seed(seed)
        init_state, step = ttr.make_train_step(c, device=device)
        state = init_state(gen)
        tokens = torch.randint(0, c.vocab_size, (batch, seq + 1),
                               generator=gen, device=device)
        before = routing(state["params"], tokens, c) if read else []
        torch.cuda.synchronize()
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
        peak = torch.cuda.max_memory_allocated()
        after, cross = [], None
        if read:
            after = routing(state["params"], tokens, c)
            with torch.no_grad():
                cross = [ttr.lm_loss(state["params"], {"tokens": tokens},
                                     dataclasses.replace(c, sp_attention=a)
                                     ).item() for a in ("flash", "local")]
        del state
        torch.cuda.empty_cache()
        return losses, times, launches, peak, before, after, cross

    losses, times, launches, peak, before, after, cross = run(cfg, True)
    timed = times[warmup:]
    step_s = statistics.median(timed)
    tok_s = batch * seq / step_s
    mfu = 6 * n_act * tok_s / H100_BF16_FLOPS
    want = cfg.n_layers * (warmup + steps)
    for s in before + after:
        tmoe.record_moe_stats(s)
    frag = _exporters["moe"]() if "moe" in _exporters else ""

    def share(stats):
        return [round(s["moe_dispatch_dropped_token_frac"], 5) for s in stats]

    log(f"  losses: {[round(x, 5) for x in losses]}")
    log(f"  step {1e3 * step_s:.1f} ms (median of {steps}; min "
        f"{1e3 * min(timed):.1f}, max {1e3 * max(timed):.1f}), "
        f"{tok_s:.1f} tokens/s, MFU on the active parameters "
        f"{100 * mfu:.2f}% (6 * {n_act} * tokens/s / 989e12), peak memory "
        f"{peak / 2**30:.2f} GiB; flash_fwd launches {launches} (want "
        f"{want})")
    log(f"  dropped share of (token, choice) claims by layer: before the "
        f"steps {share(before)}, after {share(after)}")
    log("  moe metrics series: " + " | ".join(frag.strip().splitlines()[1::2]))
    again = run(cfg, False)[0]
    local = run(dataclasses.replace(cfg, sp_attention="local"), False)[0]

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    first = abs(losses[0] - local[0]) / abs(local[0])
    trained = abs(cross[0] - cross[1]) / abs(cross[1])
    log(f"  the same steps through the kernel again: "
        f"{[round(x, 5) for x in again]} (max relative diff "
        f"{rel(again, losses):.2e}); through plain attention: "
        f"{[round(x, 5) for x in local]} (max relative diff "
        f"{rel(local, losses):.2e})")
    log(f"  first loss through the kernel vs plain attention: relative "
        f"diff {first:.2e} (tol 1e-2); the trained parameters' loss "
        f"through the kernel {cross[0]:.6f} vs plain attention "
        f"{cross[1]:.6f}: relative diff {trained:.2e} (tol 1e-2)")
    log(json.dumps({"moe": {
        "n_layers": cfg.n_layers, "n_experts": cfg.n_experts,
        "batch": batch, "seq": seq, "n_params": n_all, "n_active": n_act,
        "step_ms_median": 1e3 * step_s, "step_ms": [1e3 * x for x in timed],
        "tokens_per_s": tok_s, "mfu_6N_active": mfu, "peak_mem_bytes": peak,
        "losses": losses, "again_losses": again, "local_losses": local,
        "trained_loss_flash_local": cross,
        "dropped_frac_before": share(before),
        "dropped_frac_after": share(after),
        "flash_fwd_launches": launches}}))
    ok = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
          and launches == want and first <= 1e-2 and trained <= 1e-2
          and len(before) == len(after) == cfg.n_layers)
    if not ok:
        raise AssertionError(
            "phase 13 (one card) failed: losses must be finite and falling, "
            "the first loss and the trained parameters' loss within 1e-2 of "
            f"plain attention's, flash_fwd must launch {want} times (got "
            f"{launches}), and every layer's routing must be read")
    return losses


MOE_DIMS = dict(batch=4, seq=2048, warmup=3, steps=5)
#: Phase 13 on four cards: (name, mesh axes, sp_attention, global rows,
#: sequence, schedule, n_micro, config, MoE dispatch), each held against
#: a one-card "flash" run of its configuration and batch.
MOE_PP_PLANS = (("F", {"ep": 4}, "flash", 4, 2048, None, 1, "moe", "gspmd"),
                ("G", {"ep": 4}, "flash", 4, 2048, None, 1, "moe", "island"),
                ("H", {"ep": 2, "tp": 2}, "flash", 4, 2048, None, 1, "moe",
                 "gspmd"),
                ("I", {"pp": 4}, "flash", 4, 2048, "gpipe", 4, "slice",
                 None),
                ("J", {"pp": 4}, "flash", 4, 2048, "1f1b", 4, "slice", None),
                ("K", {"pp": 2, "ep": 2}, "flash", 4, 2048, "gpipe", 4,
                 "moe", "gspmd"))
#: On two cards.
MOE_PP_PLANS_2 = (("F2", {"ep": 2}, "flash", 4, 2048, None, 1, "moe",
                   "gspmd"),
                  ("I2", {"pp": 2}, "flash", 4, 2048, "gpipe", 4, "slice",
                   None))
#: Phase 13's first loss (the same parameters as the one-card run's)
#: within this share of it: six times the bf16 forward's own spread at
#: full width (one card, kernel against plain attention: 1.59e-4). Later
#: losses of an MoE plan are printed, not held: routing is
#: discontinuous and AdamW's first steps move each weight by about lr
#: whatever its gradient's size, so two runs that differ in bf16
#: rounding part (5.6e-2 by step 8 on one card between the kernel and
#: plain attention); the trained parameters are held instead, through
#: the plan and through one card, within ``TP_LOSS_RTOL``. Dense plans
#: keep every loss within ``TP_LOSS_RTOL``.
FIRST_LOSS_RTOL = 1e-3
#: (G)'s bound on the island's int8 layer output against the GSPMD
#: path's: max |y_island - y_gspmd| within this share of max |y_gspmd|,
#: the int8 band ``tests/test_moe.py`` holds JAX's island to.
ISLAND_INT8_BAND = 4e-2


def plan_config(cfg, kind, impl, dispatch):
    """A plan's configuration: the slice's (``cfg``) or the MoE one,
    with its attention and MoE dispatch (the island with int8)."""
    c = moe_config(cfg) if kind == "moe" else cfg
    c = dataclasses.replace(c, sp_attention=impl)
    if dispatch == "island":
        return dataclasses.replace(c, moe_dispatch="island",
                                   moe_compression="int8")
    return dataclasses.replace(c, moe_dispatch=dispatch)


def island_band(cfg, seed, mesh, device, rows, seq):
    """(G)'s and (U)'s layer check: one MoE layer at full width on a
    ``[rows, seq, D]`` input (the plan's batch; each rank its block of
    rows over dp x fsdp and its chunk of every row over sp), through the
    GSPMD path and the int8 island over the ep group, from the same
    weights (each rank its experts); and the island again with every
    rank's dispatch slab for ep rank 1 zeroed, the control. Returns
    ``(reading, control, gspmd ms, island ms)``."""
    from horovod_tpu_torch.models import moe as tmoe
    from horovod_tpu_torch.parallel.mesh import axis_index, mesh_axis_size

    gen = torch.Generator(device).manual_seed(seed + 13)
    full = tmoe.init_moe_params(gen, 1, cfg.d_model, cfg.d_ff, cfg.moe,
                                cfg.dtype, device)
    e = cfg.n_experts // mesh_axis_size(mesh, "ep")
    r = axis_index(mesh, "ep")
    lp = {k: (v[0] if k == "router" else v[0, r * e:(r + 1) * e].clone())
          for k, v in full.items()}
    del full
    x = torch.randn((rows, seq, cfg.d_model), generator=gen,
                    device=device).to(cfg.dtype)
    blocks = mesh_axis_size(mesh, "dp") * mesh_axis_size(mesh, "fsdp")
    blk = (axis_index(mesh, "dp") * mesh_axis_size(mesh, "fsdp")
           + axis_index(mesh, "fsdp"))
    sp, s = mesh_axis_size(mesh, "sp"), axis_index(mesh, "sp")
    b, t = rows // blocks, seq // sp
    x = x[blk * b:(blk + 1) * b, s * t:(s + 1) * t].contiguous()

    def gspmd():
        return tmoe.moe_ffn(x, lp, cfg.moe, mesh)[0]

    def island():
        return tmoe.moe_ffn_island(x, lp, cfg.moe, mesh, codec="int8")[0]

    real = tmoe.quantized_alltoall
    calls = [0]

    def zero_dispatch_to_rank_1(x, *a, **kw):
        calls[0] += 1
        if calls[0] % 2 == 1:                  # the dispatch hop
            x = x.clone()
            x[1] = 0
        return real(x, *a, **kw)

    with torch.no_grad():
        yg, yi = gspmd().float(), island().float()
        scale = yg.abs().max().item()
        reading = (yi - yg).abs().max().item() / scale
        tmoe.quantized_alltoall = zero_dispatch_to_rank_1
        try:
            control = (island().float() - yg).abs().max().item() / scale
        finally:
            tmoe.quantized_alltoall = real
        g_ms = cuda_ms(gspmd, iters=3, warmup=1) if x.is_cuda else 0.0
        i_ms = cuda_ms(island, iters=3, warmup=1) if x.is_cuda else 0.0
    return reading, control, g_ms, i_ms


def one_card_loss(params, tokens, cfg, axes, sched, n_micro):
    """``lm_loss`` of the full ``params`` on one card (no mesh), for a
    plan of phase 13 or 15 (with the kernel whole, ``"flash"``, for a
    ``"ring_flash"`` plan). An MoE pipeline's loss is the mean over its
    microbatches, each with its own aux (a statistic per microbatch in a
    pipeline): microbatch ``m`` is every dp rank's ``m``-th block of
    rows, so it is evaluated so here."""
    c = dataclasses.replace(cfg, moe_dispatch="gspmd")
    if c.sp_attention == "ring_flash":
        c = dataclasses.replace(c, sp_attention="flash")
    with torch.no_grad():
        if not (sched and cfg.moe is not None):
            return ttr.lm_loss(params, {"tokens": tokens}, c).item()
        dp = axes.get("dp", 1)
        per = tokens.shape[0] // dp
        mb = per // n_micro
        return statistics.mean(ttr.lm_loss(params, {"tokens": torch.cat([
            tokens[d * per + m * mb:d * per + (m + 1) * mb]
            for d in range(dp)])}, c).item() for m in range(n_micro))


def _digest_groups(state, cfg, mesh):
    """``{kind: [(key coordinates, leaf digests)] of every rank}``: the
    ranks that share a key must hold the same shard of that kind's
    leaves (top: tp; layer: pp, tp; expert: pp, tp, ep; and fsdp for
    every kind, whose leaves but the norms and the router are
    fsdp-sharded)."""
    from horovod_tpu_torch.parallel.mesh import axis_index

    keys = {"top": ("tp", "fsdp"), "layer": ("pp", "tp", "fsdp"),
            "expert": ("pp", "tp", "ep", "fsdp")}
    by_kind = {}
    for name, p in ttr.named_param_leaves(state["params"]):
        by_kind.setdefault(ttr.leaf_kind(name), []).append(p)
    mine = {kind: (tuple(axis_index(mesh, a) for a in keys[kind]),
                   tensor_digest(ps)) for kind, ps in by_kind.items()}
    return allgather_object(mine)


def phase_moe_pp(cfg, seed, name, axes, impl, rows, seq, sched, n_micro,
                 kind, dispatch, warmup, steps, device, ref_losses):
    """A plan of phase 13 or 15 on this rank: the plan's configuration
    (:func:`plan_config`) through ``make_train_step`` (ep, tp x ep,
    the fsdp step on ep x fsdp, ep x sp) or the pp steps (also on pp x
    sp and pp x fsdp), on a global ``rows x seq`` batch; flash launches and
    the model collectives' counters zeroed just before the steps and
    read just after; then one more step on the trained parameters and
    their loss through one card (rank 0, the gathered tree); checks
    (:data:`FIRST_LOSS_RTOL`); rank 0 prints."""
    from horovod_tpu_torch.parallel import pipeline as tpl
    from horovod_tpu_torch.parallel.mesh import axis_index, build_mesh

    cfg = plan_config(cfg, kind, impl, dispatch)
    mesh = build_mesh(**axes)
    n, rank = mesh.size(), dist.get_rank()
    stage = axis_index(mesh, "pp")
    say = log if rank == 0 else (lambda *a: None)
    cuda = device.type == "cuda"
    gen = torch.Generator(device).manual_seed(seed)
    if sched is None:
        init_state, step = ttr.make_train_step(cfg, device=device, mesh=mesh)
    else:
        make = (tpl.make_pp_train_step if sched == "gpipe"
                else tpl.make_pp_train_step_1f1b)
        init_state, step = make(cfg, mesh, n_micro, device=device)
    state = init_state(gen)
    tokens = torch.randint(0, cfg.vocab_size, (rows, seq + 1),
                           generator=gen, device=device)
    local = {"tokens": ttr.shard_batch(tokens, mesh)}
    n_all, n_act = active_params(cfg)
    first_ref = ref_losses[0]
    if sched and cfg.moe is not None:
        # The one-card first loss with the pipeline's microbatches: the
        # same initial draws on rank 0.
        first_ref = None
        if rank == 0:
            first_ref = one_card_loss(
                ttr.init_params(cfg, torch.Generator(device).manual_seed(
                    seed), device), tokens, cfg, axes, sched, n_micro)
        first_ref = allgather_object(first_ref)[0]
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    tfa.flash_fwd_cuda.launches = 0
    ttp.reset_counters(timing=cuda)
    losses, times, coll = [], [], []
    for _ in range(warmup + steps):
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, loss = step(state, local)
        losses.append(loss.item())
        if cuda:
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
        coll.append(ttp.collective_ms(clear=True))
    launches = tfa.flash_fwd_cuda.launches
    counters = {k: dict(v) for k, v in ttp.counters.items()}
    ttp.reset_counters()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    total = warmup + steps
    want_counts = {k: {kk: total * vv for kk, vv in v.items()} for k, v in
                   moe_pp_counts(cfg, axes, rows, seq, sched, n_micro,
                                 stage).items()}
    want_launches = (total * flash_launches_pp(cfg, axes, sched, n_micro,
                                               axis_index(mesh, "sp"))
                     if cuda else 0)
    counts_ok = allgather_object(counters == want_counts
                                 and launches == want_launches)
    groups = _digest_groups(state, cfg, mesh)
    replicas_equal = all(
        d == e for k in groups[0] for (a, d) in (g[k] for g in groups)
        for (b, e) in (g[k] for g in groups) if a == b)
    gathered = ttr.gather_params(state, cfg, mesh)
    full = allgather_object(param_digest(gathered))
    peaks = allgather_object(peak)
    # The trained parameters through one card's forward (the gathered
    # tree shares the unsplit leaves, so before anything updates them)
    # and through one more step of the plan (its loss is taken before
    # the update).
    one = (one_card_loss(gathered, tokens, cfg, axes, sched, n_micro)
           if rank == 0 else None)
    del gathered
    one = allgather_object(one)[0]
    trained = step(state, local)[1].item()
    timed = times[warmup:]
    step_s = statistics.median(timed)
    tok_gpu = rows * seq / step_s / n
    mfu = 6 * n_act * tok_gpu / H100_BF16_FLOPS
    coll_ms = {k: statistics.mean(c[k] for c in coll[warmup:])
               for k in ttp.KINDS}
    coll_all = allgather_object((stage, coll_ms))
    band = None
    if dispatch == "island":
        del state
        band = island_band(cfg, seed, mesh, device, rows, seq)
    diff = max(abs(a - b) for a, b in zip(losses, ref_losses))
    first = abs(losses[0] - first_ref) / abs(first_ref)
    at_trained = abs(trained - one) / abs(one)
    ok_losses = (all(math.isfinite(x) for x in losses)
                 and losses[-1] < losses[0] and first <= FIRST_LOSS_RTOL
                 and at_trained <= TP_LOSS_RTOL
                 and (cfg.moe is not None
                      or all(abs(a - b) <= TP_LOSS_RTOL * abs(b)
                             for a, b in zip(losses, ref_losses))))
    tag = (f"  ({name}) {axes} {impl}"
           + (f" {dispatch}" if cfg.moe is not None else "")
           + (f" {sched} n_micro={n_micro}" if sched else "")
           + f" B={rows} T={seq}")
    say(f"{tag}: losses {[round(x, 5) for x in losses]}; one-card flash "
        f"{[round(x, 5) for x in ref_losses]}; max |diff| {diff:.5f} "
        f"({'printed' if cfg.moe is not None else f'rtol {TP_LOSS_RTOL}'}); "
        f"first loss {losses[0]:.6f} against one card's {first_ref:.6f}: "
        f"relative diff {first:.2e} (tol {FIRST_LOSS_RTOL}); the "
        f"trained parameters' loss through the plan {trained:.6f} and "
        f"through one card {one:.6f}: relative diff {at_trained:.2e} (tol "
        f"{TP_LOSS_RTOL})")
    say(f"{tag}: step {1e3 * step_s:.1f} ms (median of {steps}; min "
        f"{1e3 * min(timed):.1f}, max {1e3 * max(timed):.1f}), "
        f"{tok_gpu:.1f} tokens/s/GPU, MFU {100 * mfu:.2f}% (6 * {n_act} "
        f"active params * global tokens/s / {n} GPUs / 989e12), peak "
        f"memory per rank {[round(x / 2**30, 2) for x in peaks]} GiB")
    say(f"{tag}: rank 0 flash_fwd launches {launches} (want "
        f"{want_launches}), model collectives {counters} (want "
        f"{want_counts}); every rank's counts equal the formula: "
        f"{all(counts_ok)}; collective ms a step (CUDA events, mean of "
        f"{steps}) per rank (stage, ms) "
        f"{[(s, {k: round(v, 3) for k, v in c.items() if v}) for s, c in coll_all]}"
        f"; replicated shards' digests equal: {replicas_equal}; gathered "
        f"digests equal on {len(full)} ranks: "
        f"{all(d == full[0] for d in full)}")
    if sched:
        M, S = n_micro, axes["pp"]
        ticks = M + S - 1 if sched == "gpipe" else M + 2 * S - 1
        say(f"{tag}: each rank's (stage, ms) a step in its hops (waiting "
            f"for its neighbours: the bubble, and the transfers) "
            f"{[(st, round(c['pp_p2p'], 3)) for st, c in coll_all]}; the "
            f"schedule's idle share per stage {(ticks - M) / ticks:.3f} "
            f"({ticks} ticks, {M} with work each way)")
    ok_band = True
    if band is not None:
        reading, control, g_ms, i_ms = band
        ok_band = reading < ISLAND_INT8_BAND < control
        say(f"{tag}: one layer at full width, int8 island against GSPMD: "
            f"max |dy| / max |y| {reading:.3e} (bound {ISLAND_INT8_BAND}); "
            f"control with ep rank 1's dispatch slabs zeroed {control:.3e} "
            f"(must exceed the bound); layer forward ms GSPMD {g_ms:.3f}, "
            f"island {i_ms:.3f}")
    say(json.dumps({"moe_pp": {
        "name": name, "axes": axes, "impl": impl, "dispatch": dispatch,
        "sched": sched, "n_micro": n_micro, "rows": rows, "seq": seq,
        "world": n, "step_ms_median": 1e3 * step_s,
        "step_ms": [1e3 * x for x in timed], "tokens_per_s_per_gpu": tok_gpu,
        "mfu_6N_active": mfu, "n_active": n_act, "peak_mem_bytes": peaks,
        "losses": losses, "ref_losses": ref_losses,
        "trained_loss_plan_one_card": [trained, one],
        "flash_fwd_launches_rank0": launches, "counters_rank0": counters,
        "collective_ms": coll_all, "island_band": band}}))
    if not (ok_losses and all(counts_ok) and replicas_equal and ok_band
            and all(d == full[0] for d in full)):
        raise AssertionError(
            f"plan ({name}) failed: losses must be finite and falling, "
            f"the first within {FIRST_LOSS_RTOL} of the one-card run's, the "
            f"trained parameters' within {TP_LOSS_RTOL} of one card's, and "
            f"(dense) every loss within {TP_LOSS_RTOL}; flash launches "
            "and collective counts must equal the formula on every rank; "
            "replicated shards and gathered parameters must agree; the "
            "island's int8 output must be within its band and the control "
            "outside it")
    if band is None:
        del state
    if cuda:
        torch.cuda.empty_cache()


def moe_references(cfg, seed, plans, device, dims=TP_DIMS):
    """Phase 13's one-card references, ``{(config, rows, seq): losses}``:
    each configuration and batch of ``plans`` run alone on rank ``i %
    n``'s card with ``"flash"`` (:func:`one_card_losses`), in parallel,
    and every rank receives them all."""
    shapes = sorted({(p[7], p[3], p[4]) for p in plans})
    rank, n = dist.get_rank(), dist.get_world_size()
    mine = {}
    for i, (kind, rows, seq) in enumerate(shapes):
        if i % n == rank:
            c = moe_config(cfg) if kind == "moe" else cfg
            mine[(kind, rows, seq)] = one_card_losses(c, seed, rows, seq,
                                                      device, **dims)
    return {k: v for part in allgather_object(mine) for k, v in part.items()}


def moe_world(rank, n, port, cfg, seed, device=None, plans=MOE_PP_PLANS,
              dims=TP_DIMS):
    """Phase 13's (or phase 15's, ``plans=COMPOSE_PLANS``) runs as rank
    ``rank`` of ``n`` (one process a card): the one-card references
    (:func:`moe_references`), then each plan.
    ``device="cpu"``, a small config and small plans rehearse it on
    gloo."""
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    device = init_process_group(device, timeout=TP_TIMEOUT)
    try:
        t0 = time.perf_counter()
        refs = moe_references(cfg, seed, plans, device, dims)
        if rank == 0:
            log(f"  one-card references {sorted(refs)} in "
                f"{time.perf_counter() - t0:.1f} s")
        for plan in plans:
            name, axes, impl, rows, seq, sched, n_micro, kind, disp = plan
            t0 = time.perf_counter()
            phase_moe_pp(cfg, seed, name, axes, impl, rows, seq, sched,
                         n_micro, kind, disp, **dims, device=device,
                         ref_losses=refs[(kind, rows, seq)])
            if rank == 0:
                log(f"  ({name}) in {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()


def run_phase13(cfg, seed, cards):
    """Phase 13 on ``cards`` cards (four: plans F-K; two: ep=2 and
    pp=2), one process a card."""
    plans = MOE_PP_PLANS if cards >= 4 else MOE_PP_PLANS_2
    log(f"phase 13: MoE over ep and the pipeline over pp, on NCCL ({cards} "
        f"cards; the one-card flash references first, each on its own "
        f"card)")
    gc.collect()
    mp.spawn(moe_world, args=(cards, free_port(), cfg, seed, None, plans),
             nprocs=cards, join=True)


# ---------------------------------------------------------------------------
# Phase 15: the sp and fsdp compositions of pp and ep, and Adasum
# ---------------------------------------------------------------------------

#: Phase 15 on four cards, in :data:`MOE_PP_PLANS`' form and held as its
#: plans are: pp x sp on both schedules with the flash kernel in every
#: stage's ring, pp x fsdp, and the MoE configuration on ep x fsdp and
#: ep x sp.
COMPOSE_PLANS = (("L", {"pp": 2, "sp": 2}, "ring_flash", 2, 4096, "gpipe",
                  2, "slice", None),
                 ("M", {"pp": 2, "sp": 2}, "ring_flash", 2, 4096, "1f1b",
                  2, "slice", None),
                 ("N", {"pp": 2, "fsdp": 2}, "flash", 4, 2048, "gpipe", 2,
                  "slice", None),
                 ("O", {"ep": 2, "fsdp": 2}, "flash", 4, 2048, None, 1,
                  "moe", "gspmd"),
                 ("P", {"ep": 2, "sp": 2}, "ring_flash", 2, 4096, None, 1,
                  "moe", "gspmd"))
#: (Q)'s tensors, made from the seed on every rank: one f32 tensor, and
#: a group of three bf16 ones (one fused response, a coefficient set
#: each).
ADASUM_TENSORS = ((("f32", torch.float32, ((4096, 4096),)),
                   ("bf16 group", torch.bfloat16,
                    ((4096, 4096), (4096, 1024), (14336,)))))
#: (Q)'s bound on the executor's Adasum against its f64 twin: f32 within
#: 1e-5 of the twin's largest value (f32 accumulation over two rounds),
#: bf16 within two bf16 ulps of each value (the result is rounded to
#: bf16 once) plus that share.
ADASUM_F32_RTOL = 1e-5
ADASUM_DIMS = dict(batch=4, seq=2048, warmup=3, steps=5)


def adasum_twin(vectors, lengths):
    """The reference's ``_adasum_tree`` in f64 numpy: ``vectors`` (one
    flat array a rank) zero-padded to a power of two, folded in
    consecutive pairs, each fold with one set of coefficients a segment
    (``lengths``)."""
    import numpy as np

    m = 1 << max(0, (len(vectors) - 1).bit_length())
    vals = [np.asarray(v, np.float64) for v in vectors]
    vals += [np.zeros_like(vals[0])] * (m - len(vals))
    offs = np.concatenate([[0], np.cumsum(lengths)])
    while len(vals) > 1:
        nxt = []
        for a, b in zip(vals[0::2], vals[1::2]):
            out = np.empty_like(a)
            for lo, hi in zip(offs[:-1], offs[1:]):
                sa, sb = a[lo:hi], b[lo:hi]
                dot, na, nb = sa @ sb, sa @ sa, sb @ sb
                ac = 1.0 - dot / (2.0 * na) if na > 0 else 1.0
                bc = 1.0 - dot / (2.0 * nb) if nb > 0 else 1.0
                out[lo:hi] = ac * sa + bc * sb
            nxt.append(out)
        vals = nxt
    return vals[0]


def phase_adasum_ops(seed, device, tensors=ADASUM_TENSORS):
    """(Q) on this rank of the eager runtime's world: ``hvd.allreduce``
    and ``hvd.grouped_allreduce`` with ``op=Adasum`` on the card's
    tensors (:data:`ADASUM_TENSORS`, every rank's drawn on every rank
    from the seed), on the NCCL executor; every rank's result's digest
    equal, and rank 0's equal to :func:`adasum_twin` of every rank's
    inputs. Rank 0 prints. ``device="cpu"`` (gloo) and small
    ``tensors`` rehearse it."""
    import numpy as np

    n, rank = hvd.size(), hvd.rank()
    say = log if rank == 0 else (lambda *a: None)
    ok = True
    for name, dtype, shapes in tensors:
        every = []
        for r in range(n):
            gen = torch.Generator(device).manual_seed(seed + 1500 + r)
            every.append([torch.randn(sh, generator=gen, device=device)
                          .to(dtype) for sh in shapes])
        mine = every[rank]
        t0 = time.perf_counter()
        if len(mine) == 1:
            got = [hvd.allreduce(mine[0], op=hvd.Adasum,
                                 name=f"phase15.{name}")]
        else:
            got = hvd.grouped_allreduce(mine, op=hvd.Adasum,
                                        name=f"phase15.{name}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        digests = allgather_object(tensor_digest(got))
        same = all(d == digests[0] for d in digests)
        lengths = [x.numel() for x in mine]
        flat = torch.cat([g.float().reshape(-1) for g in got]).cpu().numpy()
        twin = adasum_twin([torch.cat([x.float().reshape(-1) for x in xs])
                            .cpu().numpy() for xs in every], lengths)
        err = np.abs(flat - twin)
        scale = np.abs(twin).max()
        if dtype == torch.float32:
            good = err.max() <= ADASUM_F32_RTOL * scale
            bound = f"{ADASUM_F32_RTOL} x max|twin| = " \
                    f"{ADASUM_F32_RTOL * scale:.3e}"
        else:
            ulp = np.where(np.abs(twin) > 0, 2.0 ** (np.floor(np.log2(
                np.abs(twin) + (twin == 0))) - 7), 0)
            good = bool(np.all(err <= 2 * ulp + ADASUM_F32_RTOL * scale))
            bound = "two bf16 ulps of each value + 1e-5 x max|twin|"
        ok = ok and same and bool(good)
        say(f"  (Q) Adasum {name} {[tuple(sh) for sh in shapes]} on "
            f"{n} ranks (executor, "
            f"{dist.get_backend(get_runtime().executor.group)}): max "
            f"|result - f64 twin| "
            f"{err.max():.3e} (bound {bound}), max|twin| {scale:.3e}; "
            f"digests equal on every rank: {same}; first call's wall "
            f"time {wall_ms:.1f} ms")
        del every, mine, got
    if not ok:
        raise AssertionError("phase 15 (Q) failed: every rank must hold "
                             "the same Adasum result, within its bound of "
                             "the f64 twin of the reference's tree")


def phase_adasum_step(cfg, seed, batch, seq, warmup, steps, ref_losses,
                      same_batch):
    """(R) on this rank of the eager runtime's world: phase 5's
    configuration through the hook ``DistributedOptimizer(op=Adasum)``
    over AdamW, ``warmup + steps`` steps; with ``same_batch`` every
    rank runs the one-card run's batch (``ref_losses``' draws; Adasum
    of equal gradients is that gradient, so the losses must equal the
    one-card run's within ``TP_LOSS_RTOL``), else each rank its own
    rows of a ``batch x n`` batch (every loss finite and falling). Flash
    launches zeroed just before the steps and read just after. Then,
    on the last step's gradients, the Adasum reduction's ms beside
    phase 6's packed Average allreduce of the same gradient set. Rank
    0 prints."""
    n, rank, device = hvd.size(), hvd.rank(), hvd.device()
    cuda = device.type == "cuda"
    say = log if rank == 0 else (lambda *a: None)
    gen = torch.Generator(device).manual_seed(seed)
    params = ttr.init_params(cfg, gen, device)
    rows = batch if same_batch else batch * n
    tokens = torch.randint(0, cfg.vocab_size, (rows, seq + 1),
                           generator=gen, device=device)
    r0 = 0 if same_batch else rank * batch
    local = {"tokens": tokens[r0:r0 + batch]}
    named = ttr.named_param_leaves(params)
    for _, p in named:
        p.requires_grad_(True)
    hvd.broadcast_parameters(named, root_rank=0)
    leaves = [p for _, p in named]
    opt = hvd.DistributedOptimizer(ttr.default_optimizer(leaves),
                                   named_parameters=named, op=hvd.Adasum)
    n_params = sum(p.numel() for p in leaves)
    grad_bytes = sum(p.numel() * p.element_size() for p in leaves)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    tfa.flash_fwd_cuda.launches = 0
    losses, times = [], []
    for _ in range(warmup + steps):
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = ttr.lm_loss(params, local, cfg)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if cuda:
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    launches = tfa.flash_fwd_cuda.launches
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    want_launches = cfg.n_layers * (warmup + steps) if cuda else 0
    every = allgather_object(losses)
    peaks = allgather_object(peak)
    digests = allgather_object(param_digest(params))
    timed = times[warmup:]
    step_s = statistics.median(timed)
    tok_s = batch * seq / step_s
    mfu = 6 * n_params * tok_s / H100_BF16_FLOPS
    mode = ("the one-card batch on every rank" if same_batch
            else "each rank its own rows")
    diff = (max(abs(a - b) / abs(b) for ls in every
                for a, b in zip(ls, ref_losses)) if same_batch else None)
    ok = (all(math.isfinite(x) and ls[-1] < ls[0] for ls in every
              for x in ls)
          and launches == want_launches
          and all(d == digests[0] for d in digests)
          and (not same_batch or diff <= TP_LOSS_RTOL))
    say(f"  (R) dp={n} hook DistributedOptimizer(op=Adasum), {mode}: "
        f"losses rank 0 {[round(x, 5) for x in losses]}"
        + (f"; one card {[round(x, 5) for x in ref_losses]}; max relative "
           f"diff over ranks {diff:.2e} (tol {TP_LOSS_RTOL})"
           if same_batch else "")
        + f"; step {1e3 * step_s:.1f} ms (median of {steps}; min "
        f"{1e3 * min(timed):.1f}, max {1e3 * max(timed):.1f}), "
        f"{tok_s:.1f} tokens/s/GPU, MFU {100 * mfu:.2f}% (6 * {n_params} "
        f"params * tokens/s / 989e12), peak memory per rank "
        f"{[round(x / 2**30, 2) for x in peaks]} GiB; rank 0 flash_fwd "
        f"launches {launches} (want {want_launches}); "
        f"parameter digests equal on {n} ranks: "
        f"{all(d == digests[0] for d in digests)}")
    timing = None
    if cuda and not same_batch:
        grads = [p.grad for p in leaves]
        adasum_ms = cuda_ms(lambda: hvd.grouped_allreduce(
            grads, op=hvd.Adasum, name="phase15.adasum"), iters=3, warmup=1)
        eager_avg_ms = cuda_ms(lambda: hvd.grouped_allreduce(
            grads, name="phase15.average"), iters=3, warmup=1)
        packed_ms = cuda_ms(lambda: collectives.grouped_allreduce(
            grads, Average), iters=3, warmup=1)
        timing = {"adasum_eager_ms": adasum_ms,
                  "average_eager_ms": eager_avg_ms,
                  "packed_average_ms": packed_ms, "grad_bytes": grad_bytes}
        say(f"  (R) one reduction of every gradient ({grad_bytes} bytes, "
            f"mean of 3 after 1, CUDA events): Adasum on the eager "
            f"executor (hvd.grouped_allreduce(op=Adasum)) {adasum_ms:.3f} "
            f"ms; Average on it {eager_avg_ms:.3f} ms; phase 6's packed "
            f"collectives.grouped_allreduce(Average) {packed_ms:.3f} ms; "
            f"Adasum / packed {adasum_ms / packed_ms:.2f}")
    say(json.dumps({"adasum_step": {
        "world": n, "same_batch": same_batch, "batch_per_rank": batch,
        "seq": seq, "step_ms_median": 1e3 * step_s,
        "step_ms": [1e3 * x for x in timed], "tokens_per_s_per_gpu": tok_s,
        "mfu_6N": mfu, "peak_mem_bytes": peaks, "losses": every,
        "ref_losses": ref_losses if same_batch else None,
        "flash_fwd_launches": launches, "timing": timing}}))
    del opt, params, leaves, named
    if cuda:
        torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(
            "phase 15 (R) failed: every loss finite and falling, the "
            "flash kernel once a layer a step, the parameters equal on "
            f"every rank and (same batch) the losses within {TP_LOSS_RTOL} "
            "of the one-card run's")


def adasum_world(rank, n, port, ctrl_port, cfg, seed, device=None,
                 dims=ADASUM_DIMS, tensors=ADASUM_TENSORS):
    """Phase 15's (Q) and (R) as rank ``rank`` of ``n`` (one process a
    card), on the eager runtime's own world: rank 0 first runs the
    one-card reference of (R)'s same-batch run (no mesh, no
    collective). ``device="cpu"``, a small config and small ``dims``
    and ``tensors`` rehearse it on gloo."""
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(n), HOROVOD_CROSS_RANK="0",
                      HOROVOD_CROSS_SIZE="1", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port),
                      HOROVOD_CONTROLLER_ADDR=f"127.0.0.1:{ctrl_port}")
    hvd.init(device)
    try:
        device = hvd.device()
        phase_adasum_ops(seed, device, tensors)
        ref = (one_card_losses(cfg, seed, dims["batch"], dims["seq"], device,
                               dims["warmup"], dims["steps"])
               if rank == 0 else None)
        ref = allgather_object(ref)[0]
        for same in (True, False):
            phase_adasum_step(cfg, seed, **dims, ref_losses=ref,
                              same_batch=same)
    finally:
        hvd.shutdown()


def run_phase15(cfg, seed, cards):
    """Phase 15 on ``cards`` (four) cards, one process a card: the
    compositions (:data:`COMPOSE_PLANS`, through :func:`moe_world`),
    then Adasum (:func:`adasum_world`)."""
    log(f"phase 15: the sp and fsdp compositions of pp and ep, and "
        f"Adasum, on NCCL ({cards} cards; the one-card flash references "
        f"first, each on its own card)")
    gc.collect()
    mp.spawn(moe_world, args=(cards, free_port(), cfg, seed, None,
                              COMPOSE_PLANS),
             nprocs=cards, join=True)
    basics.build_native()
    mp.spawn(adasum_world, args=(cards, free_port(), free_port(), cfg, seed),
             nprocs=cards, join=True)


# ---------------------------------------------------------------------------
# Phase 14: the serving engine
# ---------------------------------------------------------------------------

#: Phase 14's engines and traces: ``ServeEngine`` limits (max batch 8,
#: prompts up to 512 tokens, 64 new, 16-token KV blocks), the mixed trace
#: (``make_trace``: 16 requests, prompts of 64-512 tokens, 16-64 new),
#: the chunked engine's ``prefill_chunk``, the shared-prefix trace's
#: system prompt, and the speculative pair (a 2-layer draft and an
#: 8-layer target at the config's widths, ``spec_k`` 4).
SERVE_DIMS = dict(n_requests=16, min_prompt=64, max_prompt=512, min_new=16,
                  max_new=64, max_batch=8, block_size=16, chunk=128,
                  prefix_len=256, prefix_requests=32, draft_layers=2,
                  target_layers=8, spec_k=4)
#: The constructed pair agrees at every position; the draft proposes
#: through ``decode`` and the target checks through ``verify``, whose
#: bf16 products differ in shape, so a near-tie may still flip.
SPEC_ACCEPT_FLOOR = 0.9
#: An engine's programs, by attribute (a draft's are wrapped apart).
_SERVE_PROGRAMS = (("_prefill_fn", "prefill"),
                   ("_resume_fn", "prefill_resume"),
                   ("_decode_fn", "decode"), ("_verify_fn", "verify"),
                   ("_inject_fn", "inject"))


def count_program_launches(engines):
    """Wrap the programs of ``engines`` (and of their drafts) so that
    each call adds to ``tally[name] = [calls, flash launches]``: the
    flash launches the call itself made. Returns the tally."""
    tally = {}

    def wrap(obj, attr, name):
        fn = getattr(obj, attr)

        def counted(*args, **kw):
            before = tfa.flash_fwd_cuda.launches
            out = fn(*args, **kw)
            t = tally.setdefault(name, [0, 0])
            t[0] += 1
            t[1] += tfa.flash_fwd_cuda.launches - before
            return out

        setattr(obj, attr, counted)

    for eng in engines:
        for attr, name in _SERVE_PROGRAMS:
            wrap(eng, attr, name)
        if eng._spec is not None:
            wrap(eng._spec, "_resume_fn", "draft_prefill_resume")
            wrap(eng._spec, "_decode_fn", "draft_decode")
    return tally


def launches_ok(tally, n_layers, cuda=True):
    """The flash kernel ran ``n_layers`` times in each monolithic prefill
    and in no other program."""
    per = n_layers if cuda else 0
    return all(launches == (calls * per if name == "prefill" else 0)
               for name, (calls, launches) in tally.items())


def teacher_gap_tol(n_layers, logit_absmax):
    """How far below the full-context forward's largest logit a served
    token's logit may lie where it is not the argmax. The kernel's own
    bound (``kernel_tolerance``) on a bf16 attention output is one bf16
    ulp, 2^-7 relative (plus 2^-9 · max|v|, below that ulp at unit v);
    each layer's attention differs by up to that between the served
    path (flash prefill, then paged f32-softmax decode) and the forward
    (flash throughout), and n_layers such errors of independent sign
    move the final hidden state, and each logit, by about sqrt(n_layers)
    of them: 2^-7 · sqrt(n_layers) · max|logit|."""
    return 2.0 ** -7 * math.sqrt(n_layers) * logit_absmax


def teacher_forced(params, cfg, trace, streams):
    """Hold every served stream to the full-context port ``forward``
    over prompt + stream (one forward a request, every generated
    position read from it): at each position the stream's token is the
    argmax, or its logit lies within :func:`teacher_gap_tol` of the
    largest. Returns (positions, argmax agreements, worst gap, worst
    gap / tol, ok)."""
    n = agree = 0
    worst, worst_share, ok = 0.0, 0.0, True
    with torch.no_grad():
        for (prompt, _), got in zip(trace, streams):
            dev = params["embed"].device
            toks = torch.tensor([prompt + got[:-1]], device=dev)
            logits = ttr.forward(params, toks, cfg)[0, len(prompt) - 1:]
            logits = logits.float()
            want = torch.tensor(got, device=dev)
            gap = logits.max(-1).values - logits.gather(
                -1, want[:, None])[:, 0]
            tol = teacher_gap_tol(cfg.n_layers,
                                  logits.abs().max().item())
            n += len(got)
            agree += int((logits.argmax(-1) == want).sum())
            g = gap.max().item()
            worst = max(worst, g)
            worst_share = max(worst_share, g / tol)
            ok = ok and g <= tol
    return n, agree, worst, worst_share, ok


def _serve_cfg(dims, **kw):
    return sengine.ServeConfig(
        max_batch=dims["max_batch"], block_size=dims["block_size"],
        max_prompt=dims["max_prompt"], max_new_tokens=dims["max_new"], **kw)


def _pass_summary(snap):
    keys = ("tokens_per_sec_wall", "wall_s", "tokens_total",
            "p50_first_token_ms", "p99_first_token_ms", "p50_per_token_ms",
            "p99_per_token_ms", "decode_steps", "prefill_steps",
            "batch_occupancy", "prefix_cache_hit_rate",
            "spec_accept_rate", "spec_rounds")
    return {k: snap[k] for k in keys if k in snap}


def phase_serve(cfg, seed, device, dims=None):
    """Phase 14: the serving engine at ``cfg`` (one model shared by
    every engine): ``make_trace`` through continuous, static and chunked
    engines, the shared-prefix trace with the prefix cache on and off,
    and a speculative pair; flash launches zeroed just before the
    engines run and read just after, per program. Holds: the kernel ran
    n_layers times per monolithic prefill and in no other program;
    every stream passes the teacher-forced check; the cache-on run hits;
    the pair's accept rate is at least ``SPEC_ACCEPT_FLOOR``; every
    pool's ``data_ptr`` is unchanged (the programs wrote in place).
    Prints tokens/s, first-token and per-token tails per scheduler, the
    decode step against its weight-read floor, the prefill ms per
    bucket, and peak memory. Returns the summary."""
    dims = SERVE_DIMS if dims is None else dims
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = ttr.init_params(cfg, torch.Generator(device).manual_seed(seed),
                             device=device)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in ttr.param_leaves(params))
    if cuda:
        torch.cuda.synchronize()
    log(f"  model: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}: {weight_bytes / 1e9:.3f} GB of weights in "
        f"{time.perf_counter() - t0:.1f} s")
    trace = sbench.make_trace(
        dims["n_requests"], seed=seed, min_prompt=dims["min_prompt"],
        max_prompt=dims["max_prompt"], min_new=dims["min_new"],
        max_new=dims["max_new"], vocab=cfg.vocab_size)
    engines = {
        "continuous": _serve_cfg(dims, prefix_caching=False),
        "static": _serve_cfg(dims, prefix_caching=False,
                             scheduling="static"),
        "chunked": _serve_cfg(dims, prefix_caching=False,
                              prefill_chunk=dims["chunk"]),
        "prefix_on": _serve_cfg(dims, prefix_caching=True),
        "prefix_off": _serve_cfg(dims, prefix_caching=False)}
    engines = {k: sengine.ServeEngine(cfg, params, c, device=device)
               for k, c in engines.items()}
    # The mesh code path on a world of one process: its streams must be
    # the meshless engine's, bitwise.
    own_world = not dist.is_initialized()
    if own_world:
        init_process_group(device)
    mesh1 = build_mesh(tp=1)
    engines["mesh_tp1"] = sengine.ServeEngine(
        cfg, ttr.shard_params(params, cfg, mesh1, serving=True),
        _serve_cfg(dims, prefix_caching=False), mesh=mesh1, device=device)
    pools = {k: (e.cache.k.data_ptr(), e.cache.v.data_ptr())
             for k, e in engines.items()}
    # Warm the programs (cuBLAS, the kernel's first launch) on a short
    # request outside the measured passes.
    engines["continuous"].generate([trace[0][0][:dims["block_size"]]], 2)
    tally = count_program_launches(engines.values())
    tfa.flash_fwd_cuda.launches = 0
    snaps = {}
    for name in ("continuous", "mesh_tp1", "static", "chunked"):
        snaps[name] = sbench._run_trace(engines[name], trace)
        if name == "continuous":
            events = list(engines[name].metrics._events)
    mesh_equal = (snaps["mesh_tp1"]["_tokens"]
                  == snaps["continuous"]["_tokens"])
    prefix_trace = sbench.make_shared_prefix_trace(
        dims["prefix_requests"], seed=seed, prefix_len=dims["prefix_len"],
        max_new=min(8, dims["max_new"]), vocab=cfg.vocab_size)
    for name in ("prefix_on", "prefix_off"):
        snaps[name] = sbench._run_trace(engines[name], prefix_trace)
    launches = tfa.flash_fwd_cuda.launches
    if cuda:
        torch.cuda.synchronize()
    main_tally = {k: list(v) for k, v in tally.items()}

    # The speculative pair: a fresh window over its engines.
    draft_cfg = dataclasses.replace(cfg, n_layers=dims["draft_layers"])
    target_cfg, target = make_draft_target_params(
        draft_cfg, dims["target_layers"], seed=seed, device=device)
    spec = {"plain": sengine.ServeEngine(target_cfg, target,
                                         _serve_cfg(dims), device=device),
            "spec": sengine.ServeEngine(target_cfg, target, _serve_cfg(
                dims, draft=DraftConfig(draft_cfg, seed=seed),
                spec_k=dims["spec_k"]), device=device)}
    pools.update({f"pair_{k}": (e.cache.k.data_ptr(), e.cache.v.data_ptr())
                  for k, e in spec.items()})
    pools["pair_draft"] = (spec["spec"]._spec.cache.k.data_ptr(),
                           spec["spec"]._spec.cache.v.data_ptr())
    spec["plain"].generate([trace[0][0][:dims["block_size"]]], 2)
    spec["spec"].generate([trace[0][0][:dims["block_size"]]], 2)
    spec_tally = count_program_launches(spec.values())
    tfa.flash_fwd_cuda.launches = 0
    for name, eng in spec.items():
        snaps[f"pair_{name}"] = sbench._run_trace(eng, trace)
    spec_launches = tfa.flash_fwd_cuda.launches
    if cuda:
        torch.cuda.synchronize()

    in_place = all(
        (e.cache.k.data_ptr(), e.cache.v.data_ptr()) == pools[k]
        for k, e in engines.items()) and all(
        (e.cache.k.data_ptr(), e.cache.v.data_ptr()) == pools[f"pair_{k}"]
        for k, e in spec.items()) and (
        spec["spec"]._spec.cache.k.data_ptr(),
        spec["spec"]._spec.cache.v.data_ptr()) == pools["pair_draft"]

    # The teacher-forced check of every served stream.
    checks = {}
    for name in ("continuous", "static", "chunked"):
        checks[name] = teacher_forced(params, cfg, trace,
                                      snaps[name]["_tokens"])
    for name in ("prefix_on", "prefix_off"):
        checks[name] = teacher_forced(params, cfg, prefix_trace,
                                      snaps[name]["_tokens"])
    for name in ("pair_plain", "pair_spec"):
        checks[name] = teacher_forced(target, target_cfg, trace,
                                      snaps[name]["_tokens"])
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    # Decode steps and monolithic prefills of the continuous pass.
    buckets = engines["continuous"]._prefill_buckets
    by_bucket, full_steps = {}, []
    for e in events:
        if e["name"] == "serve:prefill" and e["args"]["offset"] == 0:
            b = sengine.pick_bucket(e["args"]["n_tokens"], buckets)
            by_bucket.setdefault(b, []).append(e["dur"] / 1e3)
        if (e["name"] == "serve:decode"
                and e["args"]["n_active"] == dims["max_batch"]):
            full_steps.append(e["dur"] / 1e3)
    floor_ms = weight_bytes / H100_BYTES_PER_S * 1e3
    cont = snaps["continuous"]
    step_ms = statistics.median(full_steps) if full_steps else float("nan")

    for name, snap in snaps.items():
        if name == "mesh_tp1":
            log(f"  mesh_tp1 (ServeEngine(mesh=build_mesh(tp=1)), a world "
                f"of one process): {snap['tokens_total']} tokens in "
                f"{snap['wall_s']:.3f} s = {snap['tokens_per_sec_wall']:.1f} "
                f"tokens/s; streams bitwise the meshless continuous "
                f"engine's: {mesh_equal}")
            continue
        n, agree, worst, share, ok = checks[name]
        log(f"  {name}: {snap['tokens_total']} tokens in "
            f"{snap['wall_s']:.3f} s = {snap['tokens_per_sec_wall']:.1f} "
            f"tokens/s; first token p50 {snap['p50_first_token_ms']} / p99 "
            f"{snap['p99_first_token_ms']} ms; per token p50 "
            f"{snap['p50_per_token_ms']} / p99 {snap['p99_per_token_ms']} "
            f"ms; {snap['decode_steps'] + snap['spec_rounds']} decode "
            f"steps or rounds, occupancy {snap['batch_occupancy']}; "
            f"teacher-forced: {agree}/{n} argmax, worst gap {worst:.4f} "
            f"({share:.2f} of its tolerance) {'ok' if ok else 'FAIL'}")
    on, off = snaps["prefix_on"], snaps["prefix_off"]
    log(f"  prefix cache: hit rate {on['prefix_cache_hit_rate']} "
        f"({on['prefix_block_hits']} block hits); streams equal to the "
        f"cache-off run's: {on['_tokens'] == off['_tokens']}")
    accept = snaps["pair_spec"]["spec_accept_rate"]
    spec_x = (snaps["pair_spec"]["tokens_per_sec_wall"]
              / snaps["pair_plain"]["tokens_per_sec_wall"])
    log(f"  speculative ({dims['draft_layers']}-layer draft, "
        f"{dims['target_layers']}-layer target, k={dims['spec_k']}): accept "
        f"rate {accept} (floor {SPEC_ACCEPT_FLOOR}), {spec_x:.3f}x plain "
        f"decode's tokens/s; streams equal to plain decode's: "
        f"{snaps['pair_spec']['_tokens'] == snaps['pair_plain']['_tokens']}")
    log(f"  decode step at batch {dims['max_batch']}: median {step_ms:.3f} ms "
        f"over {len(full_steps)} steps (min "
        f"{min(full_steps, default=float('nan')):.3f}) against a "
        f"{floor_ms:.3f} ms weight-read floor ({weight_bytes} bytes / "
        f"3.35e12 B/s): {step_ms / floor_ms:.2f}x the floor")
    log("  monolithic prefill ms by bucket (continuous pass, wall clock "
        "to the first token): " + ", ".join(
            f"{b}: {statistics.median(v):.3f} (n={len(v)})"
            for b, v in sorted(by_bucket.items())))
    log(f"  flash_fwd launches: {launches} (main model) and {spec_launches} "
        f"(pair); per program [calls, launches]: {main_tally}, pair "
        f"{spec_tally}; pools written in place: {in_place}; peak memory "
        f"{peak / 2**30:.2f} GiB")
    summary = {"serve": {
        "n_layers": cfg.n_layers, "weight_bytes": weight_bytes,
        "passes": {k: _pass_summary(v) for k, v in snaps.items()},
        "teacher_forced": {k: list(v) for k, v in checks.items()},
        "decode_step_ms_median_full_batch": step_ms,
        "decode_step_floor_ms": floor_ms,
        "prefill_ms_by_bucket": {b: statistics.median(v)
                                 for b, v in sorted(by_bucket.items())},
        "flash_fwd_launches": launches, "pair_flash_fwd_launches":
            spec_launches, "programs": main_tally,
        "pair_programs": spec_tally, "peak_mem_bytes": peak,
        "mesh_tp1_streams_equal": mesh_equal}}
    log(json.dumps(summary))
    ok = (mesh_equal and launches_ok(main_tally, cfg.n_layers, cuda)
          and launches_ok(spec_tally, target_cfg.n_layers, cuda)
          and launches == sum(v[1] for v in main_tally.values())
          and (not cuda or main_tally["prefill"][1] > 0)
          and all(c[4] for c in checks.values())
          and snaps["prefix_on"]["prefix_cache_hit_rate"] > 0
          and snaps["prefix_on"]["prefix_block_hits"] > 0
          and accept >= SPEC_ACCEPT_FLOOR and in_place)
    del engines, spec, params, target
    if own_world:
        dist.destroy_process_group()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(
            "phase 14 failed: the flash kernel must launch n_layers times "
            "per monolithic prefill and in no other program, every stream "
            "must pass the teacher-forced check, the world-1 mesh engine's "
            "streams must be the meshless engine's, the prefix cache must "
            f"hit, the pair's accept rate must reach {SPEC_ACCEPT_FLOOR}, "
            "and the pools must be written in place")
    return summary


# ---------------------------------------------------------------------------
# Phase 17: serving on a tp/ep mesh, and the MoE island on fsdp and sp
# ---------------------------------------------------------------------------

#: Phase 17's serving plans on four cards, one process a card: (name,
#: mesh axes, model). "dense" is phase 14's Llama-3-8B at 32 layers; "moe"
#: is phase 13's MoE configuration in f32 at capacity factor 4
#: (:func:`serve_moe_config`). (S) runs phase 14's trace through the
#: continuous, chunked and cache-on engines and the speculative pair;
#: the others the continuous engine.
SERVE_MESH_PLANS = (("S", {"tp": 4}, "dense"),
                    ("T", {"ep": 4}, "moe"),
                    ("T2", {"ep": 2, "tp": 2}, "moe"),
                    ("V", {"dp": 2, "tp": 2}, "dense"))
#: The tp sizes phase 17's plans serve at (phase 3 checks the prefill
#: kernel at each rank's heads), and phase 14's world of one; and those
#: of its f32 MoE model.
SERVE_TP = (1, 2, 4)
SERVE_MOE_TP = (1, 2)
#: (U): the int8 island in training on phase 15 (O)'s and (P)'s meshes
#: and batches, through phase 13's machinery (``phase_moe_pp``).
ISLAND_PLANS = (("U1", {"ep": 2, "fsdp": 2}, "flash", 4, 2048, None, 1,
                 "moe", "island"),
                ("U2", {"ep": 2, "sp": 2}, "ring_flash", 2, 4096, None, 1,
                 "moe", "island"))


def serve_moe_config(cfg):
    """Phase 17's served MoE model: phase 13's configuration in f32 with
    the capacity factor that never drops a claim (E / top_k). Routing is
    discontinuous: a decode step routes each token alone, so only a
    model whose capacity never binds agrees with the full-context
    forward (``tests/test_serve.py``'s MoE model is built so), and in
    bf16 the served path's attention (paged, and the kernel's rounding
    of P) and the forward's differ by an ulp, which flips the router's
    choice wherever two experts' probabilities lie within it (phase 17
    in bf16 missed the teacher-forced bound by 20.8x at one position of
    713); in f32 they differ at f32 rounding, as the reference holds its
    served MoE streams in f32."""
    c = moe_config(cfg)
    return dataclasses.replace(c, moe_capacity_factor=c.n_experts
                               / c.moe_top_k, dtype=torch.float32)


def serve_counts(cfg, axes, rows, tokens=1):
    """``{kind: {"calls", "bytes"}}`` of one serving program's model
    collectives on a rank of an ``axes`` mesh (dp, tp, ep), for ``rows``
    rows of ``tokens`` tokens (a decode step: the batch bucket and 1),
    beside :func:`tp_sp_counts`: with tp, the embedding island's Sum
    (where tp divides the vocabulary; else the table is whole and moves
    nothing), the attention output's Sum a layer and the dense FFN's
    (``d_model`` activations in cfg.dtype), and the argmax's all-gather
    of one (value, index) f64 pair a row (where lm_head is split); the
    MoE layer's output Sum over tp x ep a layer (``"moe"`` where ep >
    1). Nothing moves over dp, and the MoE routing statistics are not
    gathered (serving drops the aux term)."""
    tp, ep = axes.get("tp", 1), axes.get("ep", 1)
    elem = torch.tensor([], dtype=cfg.dtype).element_size()
    act = rows * tokens * cfg.d_model * elem
    out = {k: {"calls": 0, "bytes": 0} for k in ttp.KINDS}

    def add(kind, calls, nbytes):
        out[kind]["calls"] += calls
        out[kind]["bytes"] += calls * nbytes

    vocab_split = tp > 1 and cfg.vocab_size % tp == 0
    if vocab_split:
        add("tp", 1, act)
        add("tp", 1, rows * 2 * 8)
    if tp > 1:
        add("tp", cfg.n_layers, act)
    if cfg.moe is None and tp > 1:
        add("tp", cfg.n_layers, act)
    if cfg.moe is not None and tp * ep > 1:
        add("moe" if ep > 1 else "tp", cfg.n_layers, act)
    return out


def tally_decode_collectives(engines):
    """Wrap the decode program of ``engines`` so that each call appends
    ``(batch rows, {kind: {"calls", "bytes"}}, {kind: ms})`` to the
    returned list: the model collectives that call issued, counted and
    timed (CUDA events) by :mod:`horovod_tpu_torch.parallel.
    tensor_parallel`."""
    calls = []

    def wrap(eng):
        fn = eng._decode_fn

        def counted(params, kc, vc, tokens, positions, tables):
            ttp.reset_counters(timing=kc.is_cuda)
            out = fn(params, kc, vc, tokens, positions, tables)
            calls.append((len(tokens),
                          {k: dict(v) for k, v in ttp.counters.items()},
                          ttp.collective_ms() if kc.is_cuda else {}))
            return out

        eng._decode_fn = counted

    for eng in engines:
        wrap(eng)
    return calls


def phase_serve_mesh(cfg, seed, name, axes, full, device, dims, pair=False):
    """A serving plan of phase 17 on this rank: ``full`` (the model's
    whole parameters, equal on every rank) sharded over
    ``build_mesh(**axes)`` and served by the plan's engines on phase 14's
    trace, every rank submitting the same requests; (S) also the
    shared-prefix trace with the cache on, the chunked engine and, with
    ``pair``, phase 14's speculative pair on the same mesh. Flash
    launches per program and each decode step's model collectives are
    counted while the engines run. Holds: the tokens equal on every
    rank; every stream passes the teacher-forced check against the
    one-card ``forward`` of ``full``; n_layers flash launches per
    monolithic prefill and none elsewhere; each decode step's collective
    calls and bytes equal :func:`serve_counts`; each pool's
    ``data_ptr`` unchanged. Rank 0 prints tokens/s, the first-token and
    per-token tails, the decode step against the per-rank weight-read
    floor, the collectives' ms a decode step and peak memory per
    rank."""
    mesh = build_mesh(**axes)
    rank = dist.get_rank()
    say = log if rank == 0 else (lambda *a: None)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    params = ttr.shard_params(full, cfg, mesh, serving=True)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in ttr.param_leaves(params))
    trace = sbench.make_trace(
        dims["n_requests"], seed=seed, min_prompt=dims["min_prompt"],
        max_prompt=dims["max_prompt"], min_new=dims["min_new"],
        max_new=dims["max_new"], vocab=cfg.vocab_size)
    prefix_trace = sbench.make_shared_prefix_trace(
        dims["prefix_requests"], seed=seed, prefix_len=dims["prefix_len"],
        max_new=min(8, dims["max_new"]), vocab=cfg.vocab_size)
    runs = {"continuous": (_serve_cfg(dims, prefix_caching=False), trace)}
    if pair:
        runs["chunked"] = (_serve_cfg(dims, prefix_caching=False,
                                      prefill_chunk=dims["chunk"]), trace)
        runs["prefix_on"] = (_serve_cfg(dims, prefix_caching=True),
                             prefix_trace)
    engines = {k: sengine.ServeEngine(cfg, params, c, mesh=mesh,
                                      device=device)
               for k, (c, _) in runs.items()}
    models = {k: (cfg, full) for k in runs}
    if pair:
        draft_cfg = dataclasses.replace(cfg, n_layers=dims["draft_layers"])
        target_cfg, target = make_draft_target_params(
            draft_cfg, dims["target_layers"], seed=seed, device=device)
        engines["pair_spec"] = sengine.ServeEngine(
            target_cfg, ttr.shard_params(target, target_cfg, mesh,
                                         serving=True),
            _serve_cfg(dims, draft=DraftConfig(draft_cfg, seed=seed),
                       spec_k=dims["spec_k"]), mesh=mesh, device=device)
        runs["pair_spec"] = (None, trace)
        models["pair_spec"] = (target_cfg, target)
    pools = {k: [(p.k.data_ptr(), p.v.data_ptr()) for p in
                 [e.cache] + ([e._spec.cache] if e._spec else [])]
             for k, e in engines.items()}
    for eng in engines.values():
        eng.generate([trace[0][0][:dims["block_size"]]], 2)
    tallies = {k: count_program_launches([e]) for k, e in engines.items()}
    steps = tally_decode_collectives(engines.values())
    tfa.flash_fwd_cuda.launches = 0
    snaps = {}
    for k, eng in engines.items():
        snaps[k] = sbench._run_trace(eng, runs[k][1])
        if k == "continuous":
            events = list(eng.metrics._events)
    launches = tfa.flash_fwd_cuda.launches
    ttp.reset_counters()
    if cuda:
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    in_place = all(
        [(p.k.data_ptr(), p.v.data_ptr()) for p in
         [e.cache] + ([e._spec.cache] if e._spec else [])] == pools[k]
        for k, e in engines.items())
    streams = {k: v["_tokens"] for k, v in snaps.items()}
    every = allgather_object(streams)
    equal = all(o == streams for o in every)
    checks = {k: teacher_forced(models[k][1], models[k][0], runs[k][1],
                                streams[k]) for k in engines}
    counts_ok = bool(steps) and all(c == serve_counts(cfg, axes, b)
                                    for b, c, _ in steps)
    launch_ok = (launches == sum(t[1] for v in tallies.values()
                                 for t in v.values())
                 and all(launches_ok(tallies[k], models[k][0].n_layers, cuda)
                         for k in engines)
                 and (not cuda or tallies["continuous"]["prefill"][1] > 0))
    full_steps = [e["dur"] / 1e3 for e in events
                  if e["name"] == "serve:decode"
                  and e["args"]["n_active"] == dims["max_batch"]]
    step_ms = statistics.median(full_steps) if full_steps else float("nan")
    floor_ms = weight_bytes / H100_BYTES_PER_S * 1e3
    coll = {}
    for _, _, ms in steps:
        for k, v in ms.items():
            coll.setdefault(k, []).append(v)
    coll = {k: statistics.mean(v) for k, v in coll.items() if any(v)}
    peaks = allgather_object(peak)
    oks = allgather_object((equal, all(c[4] for c in checks.values()),
                            counts_ok, launch_ok, in_place))
    tag = f"  ({name}) {axes} {'MoE' if cfg.moe is not None else 'dense'}"
    for k, snap in snaps.items():
        n, agree, worst, share, ok = checks[k]
        say(f"{tag} {k}: {snap['tokens_total']} tokens in "
            f"{snap['wall_s']:.3f} s = {snap['tokens_per_sec_wall']:.1f} "
            f"tokens/s; first token p50 {snap['p50_first_token_ms']} / p99 "
            f"{snap['p99_first_token_ms']} ms; per token p50 "
            f"{snap['p50_per_token_ms']} / p99 {snap['p99_per_token_ms']} "
            f"ms; teacher-forced: {agree}/{n} argmax, worst gap "
            f"{worst:.4f} ({share:.2f} of its tolerance) "
            f"{'ok' if ok else 'FAIL'}"
            + (f"; accept rate {snap['spec_accept_rate']}"
               if k == "pair_spec" else "")
            + (f"; prefix hit rate {snap['prefix_cache_hit_rate']}"
               if k == "prefix_on" else ""))
    say(f"{tag}: decode step at batch {dims['max_batch']}: median "
        f"{step_ms:.3f} ms over {len(full_steps)} steps against a "
        f"{floor_ms:.3f} ms per-rank weight-read floor ({weight_bytes} "
        f"bytes / 3.35e12 B/s): {step_ms / floor_ms:.2f}x the floor; model "
        f"collectives a decode step (mean ms, CUDA events, {len(steps)} "
        f"steps) {({k: round(v, 4) for k, v in coll.items()})}; every "
        f"step's calls and bytes equal serve_counts: {counts_ok} (batch "
        f"{dims['max_batch']}: {serve_counts(cfg, axes, dims['max_batch'])})")
    say(f"{tag}: flash_fwd launches {launches}; per engine and program "
        f"[calls, launches] {tallies}; tokens equal on every rank: "
        f"{[o[0] for o in oks]}; pools written in place: {in_place}; peak "
        f"memory per rank {[round(x / 2**30, 2) for x in peaks]} GiB")
    summary = {"serve_mesh": {
        "name": name, "axes": axes, "n_layers": cfg.n_layers,
        "moe": cfg.moe is not None, "weight_bytes_rank": weight_bytes,
        "passes": {k: _pass_summary(v) for k, v in snaps.items()},
        "teacher_forced": {k: list(v) for k, v in checks.items()},
        "decode_step_ms_median_full_batch": step_ms,
        "decode_step_floor_ms_rank": floor_ms,
        "decode_collective_ms": coll, "flash_fwd_launches": launches,
        "programs": tallies, "peak_mem_bytes": peaks,
        "checks_per_rank": oks}}
    say(json.dumps(summary))
    del engines, params
    if pair:
        del target
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if not all(all(o) for o in oks):
        raise AssertionError(
            f"plan ({name}) failed: the tokens must be equal on every rank, "
            "every stream must pass the teacher-forced check, each decode "
            "step's collectives must equal serve_counts, the flash kernel "
            "must launch n_layers times per monolithic prefill and nowhere "
            "else, and the pools must be written in place")
    return summary


def serve_mesh_world(rank, n, port, seed, device=None, dims=None,
                     plans=SERVE_MESH_PLANS, island_plans=ISLAND_PLANS,
                     cfgs=None):
    """Phase 17 as rank ``rank`` of ``n`` (one process a card): each
    model's whole parameters drawn from the seed and broadcast from rank
    0, its serving plans (:func:`phase_serve_mesh`), then the island
    plans through phase 13's machinery (the one-card references first).
    ``cfgs`` = (dense, MoE, training slice) configurations (default:
    Llama-3-8B at 32 layers, :func:`serve_moe_config` of it, phase 5's
    slice); ``device="cpu"`` with small ones rehearses it on gloo."""
    from horovod_tpu_torch.binding import broadcast_parameters

    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    device = init_process_group(device, timeout=TP_TIMEOUT)
    dims = SERVE_DIMS if dims is None else dims
    if cfgs is None:
        dense = dataclasses.replace(ttr.TransformerConfig.llama3_8b(),
                                    sp_attention="flash", remat=False)
        slice_cfg = dataclasses.replace(dense, n_layers=4)
        cfgs = (dense, serve_moe_config(slice_cfg), slice_cfg)
    try:
        for kind, cfg in (("dense", cfgs[0]), ("moe", cfgs[1])):
            t0 = time.perf_counter()
            full = ttr.init_params(
                cfg, torch.Generator(device).manual_seed(seed), device)
            broadcast_parameters(full, 0, None)
            for name, axes, model in plans:
                if model != kind:
                    continue
                t1 = time.perf_counter()
                phase_serve_mesh(cfg, seed, name, axes, full, device, dims,
                                 pair=name == "S")
                if rank == 0:
                    log(f"  ({name}) in {time.perf_counter() - t1:.1f} s")
            del full
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            if rank == 0:
                log(f"  {kind} plans in {time.perf_counter() - t0:.1f} s")
        if island_plans:
            refs = moe_references(cfgs[2], seed, island_plans, device)
            for plan in island_plans:
                name, axes, impl, rows, seq, sched, n_micro, kind, disp = plan
                t0 = time.perf_counter()
                phase_moe_pp(cfgs[2], seed, name, axes, impl, rows, seq,
                             sched, n_micro, kind, disp, **TP_DIMS,
                             device=device,
                             ref_losses=refs[(kind, rows, seq)])
                if rank == 0:
                    log(f"  ({name}) in {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()


def run_phase17(seed, cards):
    """Phase 17 on ``cards`` (four) cards, one process a card."""
    log(f"phase 17: serving on a tp/ep mesh (Llama-3-8B at 32 layers on "
        f"tp=4 and dp=2 x tp=2, the MoE configuration on ep=4 and ep=2 x "
        f"tp=2) and the int8 MoE island on ep x fsdp and ep x sp, on NCCL "
        f"({cards} cards)")
    gc.collect()
    mp.spawn(serve_mesh_world, args=(cards, free_port(), seed),
             nprocs=cards, join=True)


# ---------------------------------------------------------------------------
# Phase 18: the serving fleet (router, RPC plane, worker processes, direct
# KV migration, trace merge)
# ---------------------------------------------------------------------------

#: Phase 18's trace and engines: ``make_multi_tenant_trace`` with
#: ``n_requests`` requests of ``n_tenants`` tenants, each tenant's
#: ``prefix_len``-token system prompt plus a 2-8-token suffix, ``new``
#: new tokens a request; every replica max batch 8, 16-token blocks. The
#: SIGKILL lands after ``kill_after`` router steps.
FLEET_DIMS = dict(n_requests=24, n_tenants=4, prefix_len=256, min_suffix=2,
                  max_suffix=8, new=16, max_batch=8, block_size=16,
                  kill_after=3)


def fleet_trace(cfg, seed, dims):
    return sbench.make_multi_tenant_trace(
        dims["n_requests"], seed=seed, n_tenants=dims["n_tenants"],
        prefix_len=dims["prefix_len"], min_suffix=dims["min_suffix"],
        max_suffix=dims["max_suffix"], min_new=dims["new"],
        max_new=dims["new"], vocab=cfg.vocab_size)


def fleet_serve_cfg(dims, trace, **kw):
    """A replica's engine: room for a full batch of worst-case
    reservations plus every tenant prefix and each request's tail in the
    prefix cache (the fleet isolates placement, not eviction)."""
    bs, new = dims["block_size"], dims["new"]
    max_prompt = max(len(p) for p, _ in trace)
    per_seq = -(-(-(-max_prompt // bs) * bs + new) // bs)
    n_blocks = (dims["max_batch"] * per_seq
                + dims["n_tenants"] * (dims["prefix_len"] // bs)
                + len(trace) + 1)
    return sengine.ServeConfig(max_batch=dims["max_batch"],
                               max_queue=len(trace), block_size=bs,
                               max_prompt=max_prompt, max_new_tokens=new,
                               n_blocks=n_blocks, **kw)


def _worker_stats(router):
    """instance -> the worker's (flash launches, peak card bytes), or
    None for an in-process replica."""
    return {r.instance: (dict(r.engine.device_stats)
                         if r.remote and r.engine.device_stats else None)
            for r in router._replicas}


def fleet_pass(name, cfg, trace, sc, *, params=None, workers=None,
               kill=None, kill_after=3, mesh=None, clock=time.perf_counter,
               deadlines=None, **rc):
    """One cold fleet over ``trace``: in-process replicas over ``params``
    (their programs' flash launches tallied per replica), and the worker
    processes ``workers`` (their launches and peak memory read from their
    beats, their monolithic prefills from their trace spans; a ``None``
    among them is an in-process replica). ``kill`` (a worker handle) is
    SIGKILLed after ``kill_after`` router steps. With ``mesh`` every
    rank of it runs this pass alike, ``params`` this rank's shards (and
    beside it a worker is mesh rank 0's handle, a ``MirrorHandle`` on
    every other rank). ``deadlines`` (seconds after the first submission on
    the router's clock, or None, a request) makes those requests
    expirable. Returns the pass's record; ``_streams`` the token streams
    in trace order, ``_log`` the placement log, ``_status`` the
    results' statuses."""
    from horovod_tpu_torch.serve.router import RouterConfig, ServeRouter

    rc = dict(rc)
    router = ServeRouter(cfg, params, RouterConfig(
        n_replicas=rc.pop("n_replicas", 2), max_queue=len(trace), **rc),
        sc, workers=workers, mesh=mesh, clock=clock)
    local = [r.engine for r in router._replicas if not r.remote]
    tallies = {r.instance: count_program_launches([r.engine])
               for r in router._replicas if not r.remote}
    pools = [(e.cache.k.data_ptr(), e.cache.v.data_ptr()) for e in local]
    before = _worker_stats(router)
    deadlines = deadlines or [None] * len(trace)
    srpc.LockstepConn.broadcasts = 0
    tfa.flash_fwd_cuda.launches = 0
    t0 = time.perf_counter()
    base = router.now()
    rids = [router.submit(p, n, deadline=None if d is None else base + d)
            for (p, n), d in zip(trace, deadlines)]
    steps = 0
    while router.pending:
        router.step()
        steps += 1
        if kill is not None and steps == kill_after:
            kill.kill()
    wall = time.perf_counter() - t0
    launches = tfa.flash_fwd_cuda.launches
    mirror_broadcasts = srpc.LockstepConn.broadcasts
    res = [router.result(r) for r in rids]
    snap = router.metrics.snapshot()
    after = _worker_stats(router)
    workers_rec = {}
    for r in router._replicas:
        if not r.remote:
            continue
        events = r.engine.export_trace()["events"]
        mono = sum(1 for e in events if e["name"] == "serve:prefill"
                   and e["args"]["offset"] == 0)
        workers_rec[r.instance] = {
            "flash_launches": (after[r.instance]["flash_launches"]
                               - before[r.instance]["flash_launches"]),
            "monolithic_prefills": mono,
            "peak_mem_bytes": after[r.instance]["peak_mem_bytes"]}
    tokens = sum(len(x.tokens) for x in res if x is not None)
    statuses = [x.status if x is not None else None for x in res]
    rec = {
        "name": name, "seconds": wall, "steps": steps,
        "tokens": tokens, "tokens_per_sec": tokens / wall,
        "p50_first_token_ms": snap["p50_first_token_ms"],
        "p99_first_token_ms": snap["p99_first_token_ms"],
        "p50_per_token_ms": snap["p50_per_token_ms"],
        "p99_per_token_ms": snap["p99_per_token_ms"],
        "prefix_hit_rate": snap["prefix_cache_hit_rate"],
        "handoffs": snap["handoffs"],
        "direct_migrations": snap["direct_migrations_total"],
        "migration_bytes": snap["migration_bytes_total"],
        "p50_migration_ms": snap["p50_migration_ms"],
        "worker_deaths": snap["worker_deaths"],
        "requeued": snap["requeued_total"],
        "mirror_broadcasts_per_step": mirror_broadcasts / max(steps, 1),
        "expired": statuses.count("expired"),
        "resolved_once": (len(res) == len(rids)
                          and all(x is not None and (
                              x.status == "ok" or (d is not None
                                                   and x.status == "expired"))
                                  for x, d in zip(res, deadlines))
                          and len({x.rid for x in res}) == len(rids)),
        "pools_in_place": pools == [(e.cache.k.data_ptr(),
                                     e.cache.v.data_ptr())
                                    for e in local],
        "programs": {k: {p: list(v) for p, v in t.items()}
                     for k, t in tallies.items()},
        "router_flash_launches": launches,
        "workers": workers_rec,
        "router_peak_mem_bytes": (torch.cuda.max_memory_allocated()
                                  if torch.cuda.is_available() else 0),
        "_streams": [x.tokens if x is not None else [] for x in res],
        "_log": list(router.placement_log),
        "_status": statuses,
        "_router": router,
    }
    return rec


def warm_up(cfg, trace, sc, seed, n_layers, cuda, checks, params=None,
            workers=None):
    """A short round-robin pass that gives fresh replicas (in this
    process over ``params``, or the worker processes ``workers``) their
    first prefills and decode steps (cuBLAS handles, the kernel's first
    launch) before the measured passes; it is held as they are (every
    request once, the kernel's launches)."""
    n = len(workers) if workers else 2
    name = "warm-up" + (" (workers)" if workers else "")
    rec = fleet_pass(name, cfg, trace[:2 * n], sc, params=params,
                     workers=workers, n_replicas=n,
                     placement="round_robin", seed=seed)
    rec.pop("_router")
    _log_pass(rec)
    checks[f"{name} resolved"] = rec["resolved_once"]
    checks[f"{name} launches"] = fleet_launches_ok(rec, n_layers, cuda)


def fleet_launches_ok(rec, n_layers, cuda):
    """The flash kernel ran ``n_layers`` times in each monolithic prefill
    and in no other program: per program for in-process replicas, as
    launches == n_layers x monolithic prefills for a worker process."""
    ok = all(launches_ok(t, n_layers, cuda)
             for t in rec["programs"].values())
    per = n_layers if cuda else 0
    ok = ok and all(w["flash_launches"] == per * w["monolithic_prefills"]
                    for w in rec["workers"].values())
    if cuda:
        ok = ok and (sum(t.get("prefill", [0, 0])[1]
                         for t in rec["programs"].values())
                     + sum(w["flash_launches"]
                           for w in rec["workers"].values())) > 0
    return ok


def _log_pass(rec):
    mib = 2 ** 30
    log(f"  {rec['name']}: {rec['tokens']} tokens in {rec['seconds']:.3f} s "
        f"= {rec['tokens_per_sec']:.1f} tokens/s; first token p50 "
        f"{rec['p50_first_token_ms']} / p99 {rec['p99_first_token_ms']} ms; "
        f"per token p50 {rec['p50_per_token_ms']} / p99 "
        f"{rec['p99_per_token_ms']} ms; prefix hit rate "
        f"{rec['prefix_hit_rate']}; handoffs {rec['handoffs']} (direct "
        f"{rec['direct_migrations']}, {rec['migration_bytes']} bytes, p50 "
        f"{rec['p50_migration_ms']} ms); deaths {rec['worker_deaths']}, "
        f"requeued {rec['requeued']}; every request resolved once: "
        f"{rec['resolved_once']}; {rec['steps']} router steps")
    if rec["mirror_broadcasts_per_step"]:
        log(f"    mirror broadcasts a router step: "
            f"{rec['mirror_broadcasts_per_step']:.2f}")
    for inst, t in rec["programs"].items():
        log(f"    replica {inst} (in-process) [calls, flash launches] by "
            f"program: {t}")
    for inst, w in rec["workers"].items():
        log(f"    replica {inst} (worker process): flash launches "
            f"{w['flash_launches']} over {w['monolithic_prefills']} "
            f"monolithic prefills; peak memory "
            f"{w['peak_mem_bytes'] / mib:.2f} GiB")
    log(f"    router process peak memory "
        f"{rec['router_peak_mem_bytes'] / mib:.2f} GiB")


def _summary(rec):
    return {k: v for k, v in rec.items() if not k.startswith("_")}


def hold_bitwise(name, got, want, params, cfg, trace):
    """``got`` against ``want`` stream by stream, bitwise. Where one parts,
    print the request and the step, and hold it to the teacher-forced
    check. Returns (bitwise, every parted stream passes)."""
    parted = [(i, next((s for s, (a, b) in enumerate(zip(g, w)) if a != b),
                       min(len(g), len(w))))
              for i, (g, w) in enumerate(zip(got, want)) if g != w]
    equal = not parted and len(got) == len(want)
    log(f"  {name}: {len(got) - len(parted)}/{len(got)} streams bitwise "
        f"equal")
    ok = True
    if parted:
        idx = [i for i, _ in parted]
        check = teacher_forced(params, cfg, [trace[i] for i in idx],
                               [got[i] for i in idx])
        ok = check[4]
        for i, step in parted:
            log(f"    request {i} parts at generated step {step}: "
                f"{got[i][step:step + 4]} against {want[i][step:step + 4]}")
        log(f"    parted streams teacher-forced: {check[1]}/{check[0]} "
            f"argmax, worst gap {check[2]:.4f} ({check[3]:.2f} of its "
            f"tolerance) {'ok' if ok else 'FAIL'}")
    return equal, ok


def _teacher(name, params, cfg, trace, streams):
    if not all(streams):
        log(f"  {name}: a request has no stream FAIL")
        return False
    n, agree, worst, share, ok = teacher_forced(params, cfg, trace, streams)
    log(f"  {name} teacher-forced: {agree}/{n} argmax, worst gap "
        f"{worst:.4f} ({share:.2f} of its tolerance) "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def world1_mesh_pass(name, cfg, trace, sc, params, device, **kw):
    """:func:`fleet_pass` through ``ServeRouter(mesh=build_mesh(tp=1))``
    on a world of this one process (brought up for the pass where there
    is none): the mesh router's code path on one card, ``params`` the
    whole weights."""
    own_world = not dist.is_initialized()
    if own_world:
        init_process_group(device)
    try:
        mesh1 = build_mesh(tp=1)
        shards = ttr.shard_params(params, cfg, mesh1, serving=True)
        rec = fleet_pass(name, cfg, trace, sc, params=shards, mesh=mesh1,
                         **kw)
        rec.pop("_router")
    finally:
        if own_world:
            dist.destroy_process_group()
    return rec


def phase_fleet(cfg, seed, device, dims=None):
    """Phase 18 on one device: (W1) two in-process replicas sharing one
    set of weights, cache-affinity and random placement, each a cold
    fleet; (W2) a split fleet (one prefill, one decode replica) with the
    prefix cache off against one cache-off engine; (W3) two worker
    processes (``python -m horovod_tpu_torch.serve.worker``) on the same
    device, each building the model from ``seed``: the affinity fleet
    against (W1)'s, the split fleet with direct and with relayed
    migration, a SIGKILL mid-trace, and the fleet trace merged with its
    critical path; (W4) (W1)'s affinity fleet through
    ``ServeRouter(mesh=)`` on a world-1 mesh, bitwise (W1)'s; (W5) that
    mesh router with one in-process replica beside one of (W3)'s
    workers, bitwise (W1)'s too. Returns the summary, the flash launches
    of the phase outside (W4) and (W5), and theirs ({"W4": n, "W5":
    n})."""
    from horovod_tpu_torch.serve import trace_merge
    from horovod_tpu_torch.serve.rpc import spawn_worker

    dims = FLEET_DIMS if dims is None else dims
    cuda = device.type == "cuda"
    t_phase = time.perf_counter()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        log(f"  card memory at the start: "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    params = ttr.init_params(cfg, torch.Generator(device).manual_seed(seed),
                             device=device)
    if cuda:
        # The peak from the serving on, past the weights' f32 draw.
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    trace = fleet_trace(cfg, seed, dims)
    sc_on = fleet_serve_cfg(dims, trace)
    sc_off = fleet_serve_cfg(dims, trace, prefix_caching=False)
    n_layers = cfg.n_layers
    checks, passes, launches = {}, {}, 0
    # Warm the programs (cuBLAS, the kernel) outside the measured passes.
    warm_up(cfg, trace, sc_on, seed, n_layers, cuda, checks, params=params)

    # (W1) in-process, affinity against random.
    t0 = time.perf_counter()
    for placement in ("affinity", "random"):
        rec = fleet_pass(f"W1 {placement}", cfg, trace, sc_on, params=params,
                         placement=placement, seed=seed)
        rec.pop("_router")
        passes[rec["name"]] = rec
        launches += rec["router_flash_launches"]
        _log_pass(rec)
        checks[f"W1 {placement} launches"] = fleet_launches_ok(rec, n_layers,
                                                               cuda)
        checks[f"W1 {placement} resolved"] = rec["resolved_once"]
        checks[f"W1 {placement} teacher"] = _teacher(
            rec["name"], params, cfg, trace, rec["_streams"])
    w1 = passes["W1 affinity"]
    checks["W1 affinity hits more"] = (
        w1["prefix_hit_rate"] > passes["W1 random"]["prefix_hit_rate"])
    log(f"  W1: affinity hit rate {w1['prefix_hit_rate']} against random's "
        f"{passes['W1 random']['prefix_hit_rate']}; "
        f"{time.perf_counter() - t0:.1f} s")

    # (W4) (W1)'s affinity fleet through ServeRouter(mesh=) on a world of
    # this one process: the mesh router's code path, whose streams and
    # placement log must be (W1)'s, bitwise.
    t0 = time.perf_counter()
    rec = world1_mesh_pass("W4 mesh affinity", cfg, trace, sc_on, params,
                           device, placement="affinity", seed=seed)
    passes[rec["name"]] = rec
    mesh_launches = rec["router_flash_launches"]
    _log_pass(rec)
    checks["W4 launches"] = fleet_launches_ok(rec, n_layers, cuda)
    checks["W4 resolved"] = rec["resolved_once"]
    checks["W4 pools in place"] = rec["pools_in_place"]
    checks["W4 streams bitwise W1"] = rec["_streams"] == w1["_streams"]
    checks["W4 placement log W1"] = rec["_log"] == w1["_log"]
    log(f"  W4: streams bitwise (W1) affinity's: "
        f"{checks['W4 streams bitwise W1']}; placement log (W1)'s: "
        f"{checks['W4 placement log W1']} ({len(rec['_log'])} decisions); "
        f"{time.perf_counter() - t0:.1f} s")

    # (W2) the split fleet, cache off, against one cache-off engine.
    t0 = time.perf_counter()
    single = sengine.ServeEngine(cfg, params, sc_off, device=device)
    ref_off = sbench._run_trace(single, trace)["_tokens"]
    del single
    rec = fleet_pass("W2 split", cfg, trace, sc_off, params=params,
                     n_prefill=1, seed=seed)
    rec.pop("_router")
    passes[rec["name"]] = rec
    launches += rec["router_flash_launches"]
    _log_pass(rec)
    w2 = rec
    checks["W2 launches"] = fleet_launches_ok(rec, n_layers, cuda)
    checks["W2 handed off once"] = (rec["handoffs"] == len(trace)
                                    and rec["resolved_once"])
    eq, ok = hold_bitwise("W2 split against one cache-off engine",
                          rec["_streams"], ref_off, params, cfg, trace)
    checks["W2 against one engine"] = ok
    passes["W2 split"]["bitwise_one_engine"] = eq
    checks["W2 teacher"] = _teacher("W2 split", params, cfg, trace,
                                    rec["_streams"])
    log(f"  W2: {time.perf_counter() - t0:.1f} s")

    # (W3) two worker processes on this device. This process's weights
    # go first (the workers hold 2 x 16 GB on the card); they are drawn
    # again for the checks once the workers are down.
    del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        log(f"  card memory before the workers: "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    t0 = time.perf_counter()
    env = None if cuda else {"OMP_NUM_THREADS": "1"}
    workers = [spawn_worker(device=str(device), env=env)
               for _ in range(2)]
    log(f"  W3: two workers spawned in {time.perf_counter() - t0:.1f} s")
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    try:
        warm_up(cfg, trace, sc_on, seed, n_layers, cuda, checks,
                workers=workers)
        rec = fleet_pass("W3 affinity", cfg, trace, sc_on, workers=workers,
                         placement="affinity", seed=seed)
        router = rec.pop("_router")
        paths = router.export_fleet_trace(trace_dir)
        passes[rec["name"]] = rec
        _log_pass(rec)
        merged = trace_merge.merge(trace_merge.discover(trace_dir))
        evs = merged["traceEvents"]
        tids = trace_merge.trace_ids(evs)
        row = trace_merge.critical_path(evs, tids[len(tids) // 2])
        total = sum(row["breakdown_us"].values())
        checks["W3 critical path"] = (len(paths) == 3
                                      and len(tids) == len(trace)
                                      and abs(total - row["e2e_us"]) <= 1.0
                                      and row["breakdown_us"]["prefill"] > 0)
        log(f"  W3 fleet trace: {len(paths)} files, {len(evs)} events, "
            f"{len(tids)} traced requests; request {row['rid']}'s critical "
            f"path (us): {row['breakdown_us']}, sum {total:.1f} against "
            f"its router:e2e {row['e2e_us']}")
        for mode in ("auto", "off"):
            name = f"W3 split {'direct' if mode == 'auto' else 'relayed'}"
            rec = fleet_pass(name, cfg, trace, sc_off, workers=workers,
                             n_prefill=1, direct_migration=mode, seed=seed)
            rec.pop("_router")
            passes[name] = rec
            _log_pass(rec)
            checks[f"{name} moved all"] = (
                rec["handoffs"] == len(trace)
                and rec["direct_migrations"] == (len(trace) if mode == "auto"
                                                 else 0))
        # (W5) (W4)'s world-1 mesh router with one in-process replica
        # beside worker 0: the weights drawn again here (the checks below
        # read them too) beside the two workers'.
        params = ttr.init_params(
            cfg, torch.Generator(device).manual_seed(seed), device=device)
        if cuda:
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        rec = world1_mesh_pass("W5 mesh + worker affinity", cfg, trace,
                               sc_on, params, device,
                               workers=[None, workers[0]],
                               placement="affinity", seed=seed)
        passes[rec["name"]] = rec
        _log_pass(rec)
        log(f"  W5: {time.perf_counter() - t1:.1f} s")
        rec = fleet_pass("W3 SIGKILL", cfg, trace, sc_on, workers=workers,
                         placement="affinity", seed=seed, kill=workers[1],
                         kill_after=dims["kill_after"])
        router = rec.pop("_router")
        passes[rec["name"]] = rec
        _log_pass(rec)
        checks["W3 SIGKILL one death"] = rec["worker_deaths"] == 1
        router.close()
    finally:
        for w in workers:
            w.kill()
    log(f"  W3: {time.perf_counter() - t0:.1f} s with the workers")
    w3 = [k for k in passes if k.startswith("W3")]
    for name in w3:
        rec = passes[name]
        launches += sum(w["flash_launches"] for w in rec["workers"].values())
        checks[f"{name} launches"] = fleet_launches_ok(rec, n_layers, cuda)
        checks[f"{name} resolved"] = rec["resolved_once"]

    w5 = passes["W5 mesh + worker affinity"]
    w5_launches = (w5["router_flash_launches"]
                   + sum(w["flash_launches"] for w in w5["workers"].values()))
    checks["W5 launches"] = fleet_launches_ok(w5, n_layers, cuda)
    checks["W5 resolved"] = w5["resolved_once"]
    checks["W5 pools in place"] = w5["pools_in_place"]
    checks["W5 streams bitwise W1"] = w5["_streams"] == w1["_streams"]
    checks["W5 placement log W1"] = w5["_log"] == w1["_log"]
    log(f"  W5: streams bitwise (W1) affinity's: "
        f"{checks['W5 streams bitwise W1']}; placement log (W1)'s: "
        f"{checks['W5 placement log W1']}; flash launches {w5_launches}")

    # The checks that read the weights (drawn again before (W5)).
    d, r = passes["W3 split direct"], passes["W3 split relayed"]
    for name, got, want in (
            ("W3 affinity against W1 affinity",
             passes["W3 affinity"]["_streams"], w1["_streams"]),
            ("W3 split direct against relayed", d["_streams"],
             r["_streams"]),
            ("W3 split direct against W2 split", d["_streams"],
             w2["_streams"])):
        eq, ok = hold_bitwise(name, got, want, params, cfg, trace)
        checks[name] = ok
        passes[name.split(" against")[0]].setdefault("bitwise", {})[
            name.split("against ")[1]] = eq
    checks["W3 SIGKILL teacher"] = _teacher(
        "W3 SIGKILL survivors' streams", params, cfg, trace,
        passes["W3 SIGKILL"]["_streams"])
    del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    summary = {"fleet": {
        "n_layers": n_layers, "seconds": seconds,
        "passes": {k: _summary(v) for k, v in passes.items()},
        "checks": checks, "flash_fwd_launches": launches}}
    log(json.dumps(summary))
    log(f"  phase 18 in {seconds:.1f} s")
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"phase 18 failed: {bad}")
    return summary, launches, {"W4": mesh_launches, "W5": w5_launches}


def phase_fleet_cards(cfg, seed, cards, dims=None, device_kind="cuda"):
    """Phase 18 (X) on ``cards`` cards: one worker process a card, each
    building the model from ``seed`` on its card, the router in this
    process: the unified fleet with affinity and with random placement,
    a split fleet of ``cards // 2`` prefill and ``cards // 2`` decode
    replicas moving pages between cards over direct and over relayed
    migration, then the split fleet again with a decode worker SIGKILLed
    mid-trace. Every stream is held to the teacher-forced check on one
    card once the fleet is down. Returns the summary."""
    from horovod_tpu_torch.serve.rpc import spawn_worker

    dims = FLEET_DIMS if dims is None else dims
    cuda = device_kind == "cuda"
    t_phase = time.perf_counter()
    trace = fleet_trace(cfg, seed, dims)
    sc_on = fleet_serve_cfg(dims, trace)
    sc_off = fleet_serve_cfg(dims, trace, prefix_caching=False)
    env = None if cuda else {"OMP_NUM_THREADS": "1"}
    workers = [spawn_worker(device=f"cuda:{i}" if cuda else "cpu", env=env)
               for i in range(cards)]
    n_pre = cards // 2
    passes, checks = {}, {}
    try:
        warm_up(cfg, trace, sc_on, seed, cfg.n_layers, cuda, checks,
                workers=workers)
        for placement in ("affinity", "random"):
            rec = fleet_pass(f"X {placement}", cfg, trace, sc_on,
                             workers=workers, n_replicas=cards,
                             placement=placement, seed=seed)
            rec.pop("_router")
            passes[rec["name"]] = rec
            _log_pass(rec)
        for mode in ("auto", "off"):
            name = f"X split {'direct' if mode == 'auto' else 'relayed'}"
            rec = fleet_pass(name, cfg, trace, sc_off, workers=workers,
                             n_replicas=cards, n_prefill=n_pre,
                             direct_migration=mode, seed=seed)
            rec.pop("_router")
            passes[name] = rec
            _log_pass(rec)
            checks[f"{name} moved all"] = (
                rec["handoffs"] == len(trace)
                and rec["direct_migrations"] == (len(trace) if mode == "auto"
                                                 else 0))
        # The SIGKILL: the last decode worker, mid-trace.
        rec = fleet_pass("X split SIGKILL decode", cfg, trace, sc_off,
                         workers=workers, n_replicas=cards, n_prefill=n_pre,
                         direct_migration="auto", seed=seed,
                         kill=workers[-1], kill_after=dims["kill_after"])
        router = rec.pop("_router")
        passes[rec["name"]] = rec
        _log_pass(rec)
        checks["X SIGKILL resolved once"] = (rec["resolved_once"]
                                             and rec["worker_deaths"] == 1)
        router.close()
    finally:
        for w in workers:
            w.kill()
    for name, rec in passes.items():
        checks[f"{name} resolved"] = rec["resolved_once"]
        checks[f"{name} launches"] = fleet_launches_ok(rec, cfg.n_layers,
                                                       cuda)
    checks["X affinity hits more"] = (
        passes["X affinity"]["prefix_hit_rate"]
        > passes["X random"]["prefix_hit_rate"])
    d, r = passes["X split direct"], passes["X split relayed"]
    log(f"  X migration: direct {d['migration_bytes']} bytes, p50 "
        f"{d['p50_migration_ms']} ms; relayed {r['migration_bytes']} bytes, "
        f"p50 {r['p50_migration_ms']} ms")
    # The teacher-forced check on one card, with the fleet down.
    device = torch.device("cuda", 0) if cuda else torch.device("cpu")
    params = ttr.init_params(cfg, torch.Generator(device).manual_seed(seed),
                             device=device)
    eq, ok = hold_bitwise("X split direct against relayed", d["_streams"],
                          r["_streams"], params, cfg, trace)
    checks["X direct against relayed"] = ok
    d["bitwise_relayed"] = eq
    for name, rec in passes.items():
        checks[f"{name} teacher"] = _teacher(name, params, cfg, trace,
                                             rec["_streams"])
    del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    summary = {"fleet_cards": {
        "cards": cards, "seconds": seconds,
        "passes": {k: _summary(v) for k, v in passes.items()},
        "checks": checks}}
    log(json.dumps(summary))
    log(f"  phase 18 (X) in {seconds:.1f} s")
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"phase 18 (X) failed: {bad}")
    return summary


# ---------------------------------------------------------------------------
# Phase 19: the fleet on a mesh (ServeRouter(mesh=), every rank running the
# router in lockstep)
# ---------------------------------------------------------------------------

#: Phase 19's passes on four cards, one process a card, each a cold fleet
#: of two in-process replicas on phase 18's trace: (name, mesh axes,
#: model, router knobs, prefix cache on, the one-card pass whose
#: placement log it must equal, skewed clocks). "dense" is Llama-3-8B at
#: 32 layers, "moe" phase 17's served MoE configuration.
#: ``RouterConfig.rpc_timeout`` of phase 19's passes with a worker: under
#: the world's collective timeout (``TP_TIMEOUT``), for the other ranks
#: wait in a broadcast while rank 0 waits on the worker.
WORKER_RPC_S = 120.0


class RouterMeshPass(NamedTuple):
    """One pass of phase 19: its name, mesh axes, model ("dense" or
    "moe"), router knobs, whether the prefix cache is on, the one-card
    reference it is held to (or None), the skewed clocks, the layout of
    a fleet with a worker ("mw": replica 0 on the mesh, replica 1 the
    worker; "wm" the other way; None: both on the mesh) and whether the
    worker is SIGKILLed mid-trace."""

    name: str
    axes: dict
    kind: str
    knobs: dict
    cache: bool
    ref: Optional[str]
    skew: bool = False
    workers: Optional[str] = None
    kill: bool = False


ROUTER_MESH_PASSES = (
    RouterMeshPass("Y1 affinity", {"tp": 4}, "dense",
                   dict(placement="affinity"), True, "W1 affinity"),
    RouterMeshPass("Y1 random", {"tp": 4}, "dense",
                   dict(placement="random"), True, "W1 random"),
    RouterMeshPass("Y2 split", {"tp": 4}, "dense", dict(n_prefill=1), False,
                   "W2 split"),
    RouterMeshPass("Y1 skewed", {"tp": 4}, "dense",
                   dict(placement="affinity"), True, None, skew=True),
    RouterMeshPass("Y5 mesh + worker", {"tp": 4}, "dense",
                   dict(placement="affinity", rpc_timeout=WORKER_RPC_S),
                   True, "W1 affinity", workers="mw"),
    RouterMeshPass("Y6 split mesh -> worker", {"tp": 4}, "dense",
                   dict(n_prefill=1, rpc_timeout=WORKER_RPC_S), False,
                   "W2 split", workers="mw"),
    RouterMeshPass("Y6 split worker -> mesh", {"tp": 4}, "dense",
                   dict(n_prefill=1, rpc_timeout=WORKER_RPC_S), False,
                   "W2 split", workers="wm"),
    RouterMeshPass("Y7 SIGKILL", {"tp": 4}, "dense",
                   dict(placement="affinity", rpc_timeout=WORKER_RPC_S),
                   True, None, workers="mw", kill=True),
    RouterMeshPass("Y3 affinity", {"dp": 2, "tp": 2}, "dense",
                   dict(placement="affinity"), True, None),
    RouterMeshPass("Y4 affinity", {"ep": 4}, "moe",
                   dict(placement="affinity"), True, None),
)
#: The skewed pass: rank r's clock reads ``perf_counter() + ROUTER_SKEW_S
#: * r``, and every third request has a deadline, the k-th of them
#: ``ROUTER_DEADLINE_STEP_S * k`` after the first submission (on rank 0's
#: clock, which the router broadcasts): the first expires at once.
ROUTER_SKEW_S = 50.0
ROUTER_DEADLINE_STEP_S = 0.25


def skewed_deadlines(n):
    return [ROUTER_DEADLINE_STEP_S * (i // 3) if i % 3 == 0 else None
            for i in range(n)]


def router_mesh_pass(p, cfg, trace, sc, full, params, mesh, seed, ref=None,
                     worker=None, kill_after=3):
    """Pass ``p`` (a :class:`RouterMeshPass`) of phase 19 on this rank:
    the fleet over ``mesh`` (this rank's ``params`` shards of ``full``),
    every rank alike; beside it, for a pass with a worker, ``worker``
    (mesh rank 0's handle, a ``MirrorHandle`` elsewhere). Returns (the
    pass's record, its checks, each held on every rank): streams,
    placement log and statuses equal on every rank; the placement log of
    ``ref`` (the one-card router's (log, streams) on the same trace), if
    given; every request resolved once; n_layers flash launches per
    monolithic prefill per replica, the worker's included, and none
    elsewhere; every pool's ``data_ptr`` unchanged; every served stream
    teacher-forced against the one-card ``forward`` of ``full``; a split
    fleet handing every request off once, and with a worker counting its
    whole pages; the skewed pass expiring some requests and serving
    others; a SIGKILLed worker's work requeued."""
    from horovod_tpu_torch.serve import migrate

    rank = dist.get_rank()
    device = param_device(params)
    cuda = device.type == "cuda"
    clock, deadlines = time.perf_counter, None
    if p.skew:
        def clock():
            return time.perf_counter() + ROUTER_SKEW_S * rank

        deadlines = skewed_deadlines(len(trace))
    workers = None
    if p.workers:
        workers = [worker if c == "w" else None for c in p.workers]
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    rec = fleet_pass(p.name, cfg, trace, sc, params=params, mesh=mesh,
                     clock=clock, deadlines=deadlines, seed=seed,
                     workers=workers, kill=worker if p.kill else None,
                     kill_after=kill_after, **p.knobs)
    rec.pop("_router")
    view = (rec["_streams"], rec["_log"], rec["_status"])
    every = allgather_object(view)
    served = [i for i, st in enumerate(rec["_status"]) if st == "ok"]
    teacher = teacher_forced(full, cfg, [trace[i] for i in served],
                             [rec["_streams"][i] for i in served])
    rec["teacher_forced"] = list(teacher)
    launches = sum(t[1] for v in rec["programs"].values()
                   for t in v.values())
    checks = {
        "equal on every rank": all(o == view for o in every),
        "resolved once": rec["resolved_once"],
        "launches": (fleet_launches_ok(rec, cfg.n_layers, cuda)
                     and rec["router_flash_launches"] == launches),
        "pools in place": rec["pools_in_place"],
        "teacher-forced": bool(served) and teacher[4],
    }
    if ref is not None:
        checks["placement log one card's"] = rec["_log"] == ref[0]
    if p.knobs.get("n_prefill"):
        checks["handed off once"] = rec["handoffs"] == len(trace)
        if p.workers:
            # A move to or from the worker counts its whole pages (what
            # crosses its wire), on every rank.
            bs = sc.block_size
            checks["whole pages counted"] = rec["migration_bytes"] == (
                sum(-(-len(q) // bs) for q, _ in trace)
                * migrate.page_nbytes(cfg, bs))
    elif p.workers and ref is not None:
        # The worker (replica "1") serves the requests the one-card
        # router's replica 1 served: its weights are the world's draw.
        placed = {rid: inst for rid, inst, m, _ in rec["_log"] if m >= 0}
        mine = [i for i in range(len(trace)) if placed.get(i) == "1"]
        rec["worker_streams_bitwise_one_card"] = (
            f"{sum(rec['_streams'][i] == ref[1][i] for i in mine)}"
            f"/{len(mine)}")
    if p.skew:
        checks["some expired, some served"] = (
            0 < rec["expired"] < len(trace))
    if p.kill:
        checks["one death, its work requeued"] = (
            rec["worker_deaths"] == 1 and rec["requeued"] >= 1)
    every_checks = allgather_object(checks)
    rec["peak_mem_bytes_per_rank"] = allgather_object(
        rec["router_peak_mem_bytes"])
    rec["migration_bytes_per_rank"] = allgather_object(
        rec["migration_bytes"])
    return rec, {k: all(c[k] for c in every_checks) for k in checks}


def param_device(params):
    return ttr.param_leaves(params)[0].device


def router_mesh_world(rank, n, port, seed, device=None, dims=None,
                      passes=ROUTER_MESH_PASSES, cfgs=None):
    """Phase 19 as rank ``rank`` of ``n`` (one process a card): each
    model's whole parameters drawn from the seed and broadcast from rank
    0; the one-card references (a meshless router over the whole
    parameters on this rank's card, on the same trace); then each pass of
    ``passes`` (:func:`router_mesh_pass`) through ``ServeRouter(mesh=)``
    on this rank's shards, a short round-robin pass first warming each
    mesh. The passes with a worker share one worker process, which rank
    0 spawns on the last card (``spawn_worker``; on the CPU, a CPU
    worker) at the first of them, building the model from the seed, and
    every other rank mirrors. ``cfgs`` = {"dense": ..., "moe": ...}
    (default: Llama-3-8B at 32 layers and :func:`serve_moe_config` of its
    4-layer slice); ``device="cpu"`` with small ones rehearses it on
    gloo."""
    from horovod_tpu_torch.binding import broadcast_parameters

    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    device = init_process_group(device, timeout=TP_TIMEOUT)
    dims = FLEET_DIMS if dims is None else dims
    if cfgs is None:
        dense = dataclasses.replace(ttr.TransformerConfig.llama3_8b(),
                                    sp_attention="flash", remat=False)
        cfgs = {"dense": dense, "moe": serve_moe_config(
            dataclasses.replace(dense, n_layers=4))}
    cuda = device.type == "cuda"
    say = log if rank == 0 else (lambda *a: None)
    card = card_line() if cuda else "cpu"
    t_phase = time.perf_counter()
    recs, checks = {}, {}
    worker = None
    try:
        for kind in ("dense", "moe"):
            mine = [p for p in passes if p.kind == kind]
            if not mine:
                continue
            cfg = cfgs[kind]
            t0 = time.perf_counter()
            full = ttr.init_params(
                cfg, torch.Generator(device).manual_seed(seed), device)
            broadcast_parameters(full, 0, None)
            trace = fleet_trace(cfg, seed, dims)
            scs = {True: fleet_serve_cfg(dims, trace),
                   False: fleet_serve_cfg(dims, trace, prefix_caching=False)}
            refs = {}
            for p in mine:
                if p.ref is not None and p.ref not in refs:
                    rec = fleet_pass(p.ref, cfg, trace, scs[p.cache],
                                     params=full, seed=seed, **p.knobs)
                    rec.pop("_router")
                    refs[p.ref] = (rec["_log"], rec["_streams"])
            say(f"  {kind}: parameters and one-card references "
                f"({sorted(refs)}) in {time.perf_counter() - t0:.1f} s")
            at = None
            for p in mine:
                if p.axes != at:
                    params = None
                    gc.collect()
                    mesh = build_mesh(**p.axes)
                    params = ttr.shard_params(full, cfg, mesh, serving=True)
                    warm = fleet_pass(f"warm-up {p.axes}", cfg, trace[:4],
                                      scs[True], params=params, mesh=mesh,
                                      placement="round_robin", seed=seed)
                    warm.pop("_router")
                    checks[f"warm-up {p.axes} resolved"] = (
                        warm["resolved_once"])
                    at = p.axes
                if p.workers and worker is None:
                    t1 = time.perf_counter()
                    worker = srpc.MirrorHandle()
                    if rank == 0:
                        worker = srpc.spawn_worker(
                            device=f"cuda:{n - 1}" if cuda else "cpu",
                            env=None if cuda else {"OMP_NUM_THREADS": "1"})
                    warm = fleet_pass("warm-up with the worker", cfg,
                                      trace[:4], scs[True], params=params,
                                      mesh=mesh, workers=[None, worker],
                                      placement="round_robin", seed=seed)
                    warm.pop("_router")
                    checks["warm-up with the worker resolved"] = (
                        warm["resolved_once"])
                    say(f"  a worker process spawned on "
                        f"{f'cuda:{n - 1}' if cuda else 'the CPU'} and "
                        f"warmed up in {time.perf_counter() - t1:.1f} s")
                t1 = time.perf_counter()
                rec, c = router_mesh_pass(
                    p, cfg, trace, scs[p.cache], full, params, mesh, seed,
                    ref=refs.get(p.ref), worker=worker,
                    kill_after=dims["kill_after"])
                if p.kill:
                    worker = None
                rec["axes"] = p.axes
                recs[p.name] = rec
                for k, v in c.items():
                    checks[f"{p.name} {k}"] = v
                mib = 2 ** 30
                n_t, agree, worst, share, _ = rec["teacher_forced"]
                say(f"  ({p.name}) {p.axes} {kind}: {rec['tokens']} tokens "
                    f"in {rec['seconds']:.3f} s = "
                    f"{rec['tokens_per_sec']:.1f} tokens/s; first token p50 "
                    f"{rec['p50_first_token_ms']} / p99 "
                    f"{rec['p99_first_token_ms']} ms; per token p50 "
                    f"{rec['p50_per_token_ms']} / p99 "
                    f"{rec['p99_per_token_ms']} ms; prefix hit rate "
                    f"{rec['prefix_hit_rate']}; handoffs {rec['handoffs']}, "
                    f"bytes per rank {rec['migration_bytes_per_rank']} ("
                    f"{rec['migration_bytes'] // max(rec['handoffs'], 1)} "
                    f"a move), p50 {rec['p50_migration_ms']} ms; expired "
                    f"{rec['expired']}; deaths {rec['worker_deaths']}, "
                    f"requeued {rec['requeued']}; {rec['steps']} router "
                    f"steps, mirror broadcasts a step "
                    f"{rec['mirror_broadcasts_per_step']:.2f}; flash "
                    f"launches {rec['router_flash_launches']} here"
                    + "".join(f", {w['flash_launches']} in worker {i} over "
                              f"{w['monolithic_prefills']} monolithic "
                              f"prefills (peak "
                              f"{w['peak_mem_bytes'] / mib:.2f} GiB)"
                              for i, w in rec["workers"].items())
                    + f"; teacher-forced {agree}/{n_t} argmax, worst gap "
                    f"{worst:.4f} ({share:.2f} of its tolerance); peak "
                    f"memory per rank "
                    f"{[round(x / mib, 2) for x in rec['peak_mem_bytes_per_rank']]}"
                    f" GiB; {card}")
                if "worker_streams_bitwise_one_card" in rec:
                    say(f"    the worker's streams bitwise the one-card "
                        f"router's: {rec['worker_streams_bitwise_one_card']}")
                say(f"    checks: {c}; "
                    f"{time.perf_counter() - t1:.1f} s")
            del full, params
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        seconds = time.perf_counter() - t_phase
        summary = {"router_mesh": {
            "cards": n, "card": card, "seconds": seconds,
            "passes": {k: _summary(v) for k, v in recs.items()},
            "checks": checks}}
        say(json.dumps(summary))
        say(f"  phase 19 in {seconds:.1f} s ({card})")
        bad = [k for k, v in checks.items() if not v]
        if bad:
            raise AssertionError(f"phase 19 failed: {bad}")
    finally:
        if worker is not None:
            worker.kill()
        dist.destroy_process_group()
    return summary


def run_phase19(seed, cards):
    """Phase 19 on ``cards`` (four) cards, one process a card."""
    log(f"phase 19: the fleet on a mesh (ServeRouter(mesh=), every rank "
        f"running the router in lockstep): Llama-3-8B at 32 layers on tp=4 "
        f"(affinity, random, a split fleet, skewed clocks; beside a worker "
        f"process on card {cards - 1}: affinity, splits both ways, a "
        f"SIGKILL) and dp=2 x tp=2, the MoE configuration on ep=4, on NCCL "
        f"({cards} cards)")
    gc.collect()
    mp.spawn(router_mesh_world, args=(cards, free_port(), seed),
             nprocs=cards, join=True)


# ---------------------------------------------------------------------------
# Phase 16: the callbacks on the slice, the estimators' per-rank tasks,
# the bench's host-bus and elastic-chaos arms
# ---------------------------------------------------------------------------

#: Phase 16 (a): 3 "epochs" of 2 steps on phase 5's batch, AdamW from
#: ``CB_BASE_LR`` warmed up over ``warmup_epochs`` towards ``warmup_size``
#: times it (so the warm-up moves at a world of 1).
CB_DIMS = dict(batch=4, seq=2048, epochs=3, steps=2, warmup_epochs=3,
               warmup_size=4)
CB_BASE_LR = 3e-4


def phase_callbacks(cfg, seed, batch, seq, epochs, steps, warmup_epochs,
                    warmup_size, slice_ms=None):
    """Phase 16 (a) on this rank of the eager runtime's world
    (``hvd.init()`` has run): the slice's train step (data parallel over
    the world when it has more than one rank) driven by the callbacks.
    Each rank draws its own parameters (seed + rank);
    ``BroadcastParametersCallback`` makes them rank 0's at train begin,
    ``MetricAverageCallback`` averages each epoch's metrics,
    ``LearningRateWarmupCallback`` sets AdamW's learning rate and
    ``BestModelCheckpoint`` (rank 0) saves the parameters with
    ``torch.save``. Checks: the parameters bitwise equal on every rank
    after the broadcast and at the end, the averages equal to the mean
    of the ranks' values, the learning rate equal to ``warmup_schedule``,
    every loss finite and falling, flash launched n_layers times a step,
    and the reloaded checkpoint bitwise equal to the live parameters with
    the same loss on the next batch. Returns the flash launches."""
    import shutil

    from horovod_tpu_torch import callbacks as cbs

    n, rank, device = hvd.size(), hvd.rank(), hvd.device()
    cuda = device.type == "cuda"
    say = log if rank == 0 else (lambda *a: None)
    mesh = data_parallel_mesh() if n > 1 else None
    held = torch.cuda.memory_allocated(device) if cuda else 0
    say(f"  world: {n} process(es) on {device}; B={batch} rows a rank, "
        f"T={seq}; {epochs} epochs of {steps} steps; {held / 2**30:.2f} "
        f"GiB allocated before the phase")
    params = ttr.init_params(
        cfg, torch.Generator(device).manual_seed(seed + rank), device)
    before = allgather_object(param_digest(params))
    cbs.BroadcastParametersCallback(params).on_train_begin()
    after = allgather_object(param_digest(params))
    if not all(d == after[0] for d in after) or (
            n > 1 and all(d == before[0] for d in before)):
        raise AssertionError("BroadcastParametersCallback: the ranks' "
                             "parameters must differ before it and be "
                             "rank 0's after it")

    def adamw(leaves):
        return torch.optim.AdamW(leaves, lr=CB_BASE_LR, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=0.01)

    init_state, step = ttr.make_train_step(cfg, device, adamw, mesh=mesh)
    state = init_state(params=params)
    gen = torch.Generator(device).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (2, batch * n, seq + 1),
                           generator=gen, device=device)
    local, nxt = ({"tokens": t[rank * batch:(rank + 1) * batch]}
                  for t in tokens)
    schedule = cbs.warmup_schedule(CB_BASE_LR, warmup_steps=warmup_epochs,
                                   size=warmup_size)
    warm = cbs.LearningRateWarmupCallback(
        CB_BASE_LR, warmup_epochs, set_lr=state["opt"], size=warmup_size)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    path = os.path.join(ckpt_dir, "best.pt")
    writes = []

    def save(p, tree):
        t0 = time.perf_counter()
        torch.save(tree, p)
        writes.append((time.perf_counter() - t0, os.path.getsize(p)))

    best = cbs.BestModelCheckpoint(path, monitor="loss", save_fn=save)
    average = cbs.MetricAverageCallback()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    tfa.flash_fwd_cuda.launches = 0
    losses, times, lrs = [], [], []
    try:
        for epoch in range(epochs):
            for _ in range(steps):
                if cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, loss = step(state, local)
                losses.append(loss.item())
                if cuda:
                    torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            mine = {"loss": statistics.fmean(losses[-steps:]),
                    "rank": float(rank)}
            metrics = dict(mine)
            average.on_epoch_end(epoch, metrics)
            ranks = allgather_object(mine)
            for k in mine:
                want = statistics.fmean(m[k] for m in ranks)
                if abs(metrics[k] - want) > 1e-12 * max(1.0, abs(want)):
                    raise AssertionError(
                        f"MetricAverageCallback: {k} {metrics[k]} is not "
                        f"the ranks' mean {want}")
            warm.on_epoch_end(epoch, metrics)
            lr = state["opt"].param_groups[0]["lr"]
            lrs.append(lr)
            if (abs(lr - schedule(epoch + 1)) > 1e-12 * lr
                    or metrics["lr"] != lr):
                raise AssertionError(
                    f"epoch {epoch}: learning rate {lr}, want "
                    f"warmup_schedule at step {epoch + 1} = "
                    f"{schedule(epoch + 1)}")
            best.on_epoch_end(epoch, metrics, state=state["params"])
        launches = tfa.flash_fwd_cuda.launches
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        final = allgather_object(param_digest(state["params"]))
        ckpt = None
        if rank == 0:
            t0 = time.perf_counter()
            loaded = torch.load(path, map_location=device, weights_only=True)
            read_s = time.perf_counter() - t0
            same = all(torch.equal(a, b) for a, b in zip(
                ttr.param_leaves(loaded), ttr.param_leaves(state["params"])))
            with torch.no_grad():
                live_loss = ttr.lm_loss(state["params"], nxt, cfg).item()
                loaded_loss = ttr.lm_loss(loaded, nxt, cfg).item()
            ckpt = (same, live_loss, loaded_loss, read_s)
            del loaded
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    timed = times[steps:]
    step_s = statistics.median(timed)
    want = cfg.n_layers * epochs * steps if cuda else 0
    say(f"  losses: {[round(x, 5) for x in losses]}")
    say(f"  learning rates after each epoch: {lrs} (warmup_schedule "
        f"at steps 1-{epochs}: {[schedule(e + 1) for e in range(epochs)]})")
    say(f"  step times (s): {[round(x, 4) for x in times]}")
    ratio = "" if slice_ms is None else (
        f" ({1e3 * step_s / slice_ms:.4f} x phase 5's {slice_ms:.1f} ms)")
    say(f"  step {1e3 * step_s:.1f} ms (median of the last {len(timed)})"
        f"{ratio}, peak memory {peak / 2**30:.2f} GiB; flash_fwd launches "
        f"{launches} (want {want}); parameter digests equal on {n} "
        f"rank(s) after the broadcast and at the end: "
        f"{all(d == final[0] for d in final)}")
    if rank == 0:
        same, live_loss, loaded_loss, read_s = ckpt
        log(f"  checkpoint: {len(writes)} write(s) of {writes[-1][1]:,} "
            f"bytes, {[round(1e3 * s, 1) for s, _ in writes]} ms each "
            f"(torch.save into {tempfile.gettempdir()}); read back in "
            f"{1e3 * read_s:.1f} ms, bitwise equal to the live parameters: "
            f"{same}; next batch's loss live {live_loss!r} vs reloaded "
            f"{loaded_loss!r}")
        log(json.dumps({"callbacks": {
            "world": n, "batch_per_rank": batch, "seq": seq,
            "step_ms_median": 1e3 * step_s,
            "step_ms": [1e3 * x for x in timed],
            "slice_step_ms": slice_ms, "losses": losses, "lrs": lrs,
            "flash_fwd_launches": launches, "peak_mem_bytes": peak,
            "ckpt_write_ms": [1e3 * s for s, _ in writes],
            "ckpt_bytes": writes[-1][1], "ckpt_read_ms": 1e3 * read_s}}))
        if not (same and live_loss == loaded_loss
                and writes[-1][1] > 0 and len(writes) == epochs):
            raise AssertionError(
                "BestModelCheckpoint: a write each improving epoch, read "
                "back bitwise equal, with the live parameters' loss")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and launches == want and all(d == final[0] for d in final)):
        raise AssertionError(
            "the callbacks' slice: losses must be finite and falling, "
            f"flash_fwd must launch {want} times (got {launches}), and the "
            "parameters must agree on every rank")
    return launches


def callbacks_world(rank, n, port, ctrl_port, cfg, seed, slice_ms,
                    device=None, dims=CB_DIMS):
    """Phase 16 (a) as rank ``rank`` of ``n`` (one process per card) on
    the eager runtime's world. ``device="cpu"`` and smaller ``dims``
    rehearse it on gloo."""
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(n), HOROVOD_CROSS_RANK="0",
                      HOROVOD_CROSS_SIZE="1", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port),
                      HOROVOD_CONTROLLER_ADDR=f"127.0.0.1:{ctrl_port}")
    hvd.init(device)
    try:
        return phase_callbacks(cfg, seed, **dims, slice_ms=slice_ms)
    finally:
        hvd.shutdown()


def run_phase16a(cfg, seed, slice_ms, cards=1):
    """Phase 16 (a): one process per card; a world of 1 in this
    process, which returns its flash launches."""
    log(f"phase 16 (a): the callbacks drive the slice's train step "
        f"({cards} card(s), one process each)")
    args = (cards, free_port(), free_port(), cfg, seed, slice_ms)
    if cards == 1:
        return callbacks_world(0, *args)
    mp.spawn(callbacks_world, args=args, nprocs=cards, join=True)
    return None


#: Phase 16 (b): the estimators' data and model.
EST_DIMS = dict(rows=65536, features=256, hidden=4096, epochs=2,
                batch=1024, lr=1e-4)
EST_PREDICT_RTOL = 1e-4


def est_init(generator, features=256, hidden=4096):
    """The functional MLP's parameters (``FunctionalEstimator``'s
    ``init_fn``): ``features -> hidden -> hidden -> 1``."""
    def dense(i, o):
        return torch.randn((i, o), generator=generator) * i ** -0.5

    return {"w0": dense(features, hidden), "b0": torch.zeros(hidden),
            "w1": dense(hidden, hidden), "b1": torch.zeros(hidden),
            "w2": dense(hidden, 1), "b2": torch.zeros(1)}


def est_apply(params, x):
    h = torch.relu(x @ params["w0"] + params["b0"])
    h = torch.relu(h @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def est_rows(seed, rows, features):
    """``rows`` of ``features`` normal features and one label from a
    fixed random teacher, f32, from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, features), generator=gen)
    teacher = torch.randn((features, 1), generator=gen) * features ** -0.5
    y = torch.tanh(x @ teacher) + 0.05 * torch.randn((rows, 1), generator=gen)
    return torch.cat([x, y], dim=1).numpy()


def phase_estimators(seed, rows, features, hidden, epochs, batch, lr,
                     device=None):
    """Phase 16 (b): ``TorchEstimator``'s and ``FunctionalEstimator``'s
    per-rank tasks at a world of 1 on ``device`` (the card by default),
    over shards staged with ``Store.write_shard`` (pickle format) in a
    temporary directory, called as a Spark barrier task calls them.
    Checks: the parameters lived on the device, the loss falls, and each
    model's ``predict`` there is within ``EST_PREDICT_RTOL`` of the same
    parameters on the CPU."""
    import functools
    import shutil

    from horovod_tpu_torch.spark import (FunctionalEstimator,
                                         FunctionalModel, Store,
                                         TorchEstimator, TorchModel)
    from horovod_tpu_torch.spark.estimator import Staged

    data = est_rows(seed, rows, features)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        store = Store(tmp, shard_format="pickle")
        store.write_shard("part.0.c0", data)
        store.write_array("part.0.meta", {"rows": rows, "chunks": 1,
                                          "cols": features + 1})
        staged = Staged([[0]], rows)
        cols = dict(feature_cols=[f"x{i}" for i in range(features)],
                    label_cols=["y"], store=store, num_proc=1,
                    epochs=epochs, batch_size=batch, device=device)
        adam = functools.partial(torch.optim.Adam, lr=lr)
        mlp = torch.nn.Sequential(
            torch.nn.Linear(features, hidden), torch.nn.ReLU(),
            torch.nn.Linear(hidden, hidden), torch.nn.ReLU(),
            torch.nn.Linear(hidden, 1))
        ests = {
            "TorchEstimator": TorchEstimator(
                model=mlp, optimizer=adam, loss=F.mse_loss, **cols),
            "FunctionalEstimator": FunctionalEstimator(
                init_fn=functools.partial(est_init, features=features,
                                          hidden=hidden),
                apply_fn=est_apply, loss=F.mse_loss, optimizer=adam,
                seed=seed, **cols)}
        x = data[:4096, :features]
        for name, est in ests.items():
            task = est.train_task(store, staged)
            t0 = time.perf_counter()
            state, history = task()
            epoch_ms = 1e3 * (time.perf_counter() - t0) / epochs
            if name == "TorchEstimator":
                model = TorchModel(model=mlp, state=state,
                                   feature_cols=cols["feature_cols"],
                                   label_cols=["y"])
            else:
                model = FunctionalModel(apply_fn=est_apply, params=state,
                                        feature_cols=cols["feature_cols"],
                                        label_cols=["y"])
            here = model.predict(x, device=device)
            cpu = model.predict(x, device="cpu")
            rel = float(abs(here - cpu).max() / abs(cpu).max())
            losses = [m["train_loss"] for m in history]
            log(f"  {name}: {rows} rows x {features} features, MLP "
                f"{features}-{hidden}-{hidden}-1 f32, {epochs} epochs at "
                f"batch {batch}: {epoch_ms:.1f} ms an epoch (task set-up "
                f"included); train loss by epoch {losses}; parameters on "
                f"{task.devices}; predict on the device vs the CPU: max rel "
                f"{rel:.2e} (tol {EST_PREDICT_RTOL:.0e})")
            log(json.dumps({"estimator": {
                "name": name, "epoch_ms": epoch_ms, "losses": losses,
                "devices": task.devices, "predict_rel": rel}}))
            want = resolve_device(device).type
            if not (task.devices == [want] and losses[-1] < losses[0]
                    and all(math.isfinite(v) for v in losses)
                    and rel <= EST_PREDICT_RTOL):
                raise AssertionError(
                    f"{name}'s task: parameters must stay on {want}, the "
                    f"loss must fall, and predict must agree with the CPU")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


HOST_ARMS_BUDGET_S = 120.0


def phase_host_arms(budget_s=HOST_ARMS_BUDGET_S):
    """Phase 16 (c): the bench's host-bus arm (np=4 on the native host
    plane) and elastic-chaos arm (a kill and a grow on the port's
    elastic driver, host plane), once each, sharing ``budget_s``; their
    keys printed. Either failing fails the phase."""
    t0 = time.perf_counter()
    bus = bench._bus_bandwidth(timeout=budget_s)
    if bus is None:
        raise AssertionError("the host-bus arm failed")
    keys = bench.bus_keys(bus)
    left = budget_s - (time.perf_counter() - t0)
    chaos = bench._elastic_extra(left, cap_secs=left) if left > 0 else None
    if chaos is None:
        raise AssertionError("the elastic-chaos arm failed (or ran out of "
                             f"its {budget_s:.0f} s budget)")
    keys.update(chaos)
    log(f"  host arms in {time.perf_counter() - t0:.1f} s (budget "
        f"{budget_s:.0f} s)")
    log("  " + json.dumps({"host_arms": keys}))
    return keys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dp-only", action="store_true",
                    help="run phases 1, 6, 7, 8, 10, 12, 13, 15, 16, 17, "
                         "18 and 19 only, "
                         "on two or more cards: the multi-card check of "
                         "the data-parallel path, the eager plane, the "
                         "ResNet arm, the tp/sp step (tp=2 and sp=2 on "
                         "two cards; on four or more, runs A-D of "
                         "TP_PLANS, phase 11's planes and phase 9's "
                         "four-card scenario), the ep/pp steps "
                         "(MOE_PP_PLANS F-K on four cards; ep=2 and pp=2 "
                         "on two) and, on four, their sp and fsdp "
                         "compositions and Adasum (COMPOSE_PLANS L-P, "
                         "then Q-R); then the dry run over NCCL and the "
                         "callbacks' slice at dp over the cards (up to 4), "
                         "and on four, serving on tp/ep meshes and the "
                         "MoE island on ep x fsdp and ep x sp (phase 17), "
                         "the serving fleet, one worker a card "
                         "(phase 18 (X)), and the fleet on a mesh, every "
                         "rank running the router (phase 19)")
    ap.add_argument("--phase9-dir", default=None,
                    help="where phase 9's jobs write their events and "
                         "logs (default: a new temporary directory)")
    worker = ap.add_argument_group(
        "worker mode (a process of a phase 9 job; the launcher starts it)")
    worker.add_argument("--worker", choices=["static", "elastic"])
    worker.add_argument("--out")
    worker.add_argument("--hosts-file")
    worker.add_argument("--steps", type=int, default=8)
    worker.add_argument("--rows", type=int, default=4,
                        help="rows of the global batch")
    worker.add_argument("--seq", type=int, default=2048)
    worker.add_argument("--device", default=None,
                        help="cpu rehearses the worker on gloo")
    worker.add_argument("--tiny", action="store_true",
                        help="the tiny f32 config instead of the slice")
    worker.add_argument("--reset-at", type=int, nargs="*", default=[])
    worker.add_argument("--die-step", type=int, default=-1)
    worker.add_argument("--kill-ident", default="")
    worker.add_argument("--kill-step", type=int, default=-1)
    worker.add_argument("--shrink-to", type=int, default=0)
    worker.add_argument("--grow-after", type=int, default=0)
    worker.add_argument("--grow-to", type=int, default=0)
    args = ap.parse_args(argv)
    if args.worker:
        train_worker(args)
        return 0

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    if args.dp_only and torch.cuda.device_count() < 2:
        print("chip_smoke: --dp-only needs two or more cards",
              file=sys.stderr)
        return 1

    started = time.perf_counter()

    def stamp():
        log(f"  [{time.perf_counter() - started:.1f} s since the start]")

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
    phase9_dir = args.phase9_dir or tempfile.mkdtemp(prefix="chip_smoke_")
    if args.dp_only:
        run_dp(cfg, args.seed, slice_losses=None)
        torch.cuda.empty_cache()
        stamp()
        run_eager(cfg, args.seed, slice_losses=None)
        torch.cuda.empty_cache()
        stamp()
        run_resnet(args.seed, cards=torch.cuda.device_count())
        stamp()
        if torch.cuda.device_count() >= 4:
            run_phase11(cfg, args.seed, None, cards=4)
            stamp()
            run_phase9_four_cards(phase9_dir)
            stamp()
        run_phase12(cfg, args.seed, min(torch.cuda.device_count(), 4))
        stamp()
        run_phase13(cfg, args.seed, min(torch.cuda.device_count(), 4))
        stamp()
        if torch.cuda.device_count() >= 4:
            run_phase15(cfg, args.seed, 4)
            stamp()
        cards = min(torch.cuda.device_count(), 4)
        log(f"phase 16: graft_entry.dryrun_multichip({cards}) over NCCL")
        graft_entry.dryrun_multichip(cards)
        stamp()
        run_phase16a(cfg, args.seed, None, cards)
        stamp()
        if torch.cuda.device_count() >= 4:
            run_phase17(args.seed, 4)
            stamp()
            log("phase 18 (X): the serving fleet on four cards, one worker "
                "process a card (Llama-3-8B at full depth on each)")
            phase_fleet_cards(dataclasses.replace(
                ttr.TransformerConfig.llama3_8b(), sp_attention="flash",
                remat=False), args.seed, 4)
            stamp()
            run_phase19(args.seed, 4)
            stamp()
        print(card_line(), flush=True)
        return 0

    log("phase 2: build")
    phase_build()
    stamp()

    log("phase 3: kernels vs plain versions")
    entry = phase_kernels(args.seed, cfg)
    torch.cuda.empty_cache()
    stamp()

    log("phase 4: model check (kernel path vs plain attention)")
    phase_model_check(args.seed, torch.device("cuda"))
    torch.cuda.empty_cache()

    log("phase 5: the slice (train step, Llama-3-8B widths, 4 layers)")
    entry["launches"], slice_losses, slice_ms = phase_slice(
        cfg, args.seed, batch=4, seq=2048, warmup=3, steps=5,
        device=torch.device("cuda"))
    torch.cuda.empty_cache()
    stamp()

    run_dp(cfg, args.seed, slice_losses)
    torch.cuda.empty_cache()
    stamp()

    run_eager(cfg, args.seed, slice_losses)
    torch.cuda.empty_cache()
    stamp()

    run_phase9(phase9_dir, slice_losses)
    torch.cuda.empty_cache()
    stamp()

    run_resnet(args.seed)
    stamp()

    run_phase11(cfg, args.seed, slice_losses)
    stamp()

    log("phase 12: ring_flash's chunk merge on one card")
    phase_ring_merge(args.seed)
    torch.cuda.empty_cache()
    stamp()

    log("phase 13: MoE on one card (Llama-3-8B widths, 8 experts top-2, "
        "2 layers)")
    phase_moe(moe_config(cfg), args.seed, **MOE_DIMS,
              device=torch.device("cuda"))
    torch.cuda.empty_cache()
    stamp()

    log("phase 14: serving (Llama-3-8B at full depth, paged KV, "
        "continuous / static / chunked, prefix cache, speculative)")
    serve_cfg = dataclasses.replace(ttr.TransformerConfig.llama3_8b(),
                                    sp_attention="flash", remat=False)
    serve = phase_serve(serve_cfg, args.seed, torch.device("cuda"))["serve"]
    stamp()

    log("phase 18: the serving fleet (Llama-3-8B at full depth: two "
        "in-process replicas, a split fleet, two worker processes with "
        "direct and relayed migration, a SIGKILL and the trace merge)")
    _, fleet_launches, fleet_mesh_launches = phase_fleet(
        serve_cfg, args.seed, torch.device("cuda"))
    entry["paths"] = {
        "phase 5 slice": entry["launches"],
        "phase 14 serving": (serve["flash_fwd_launches"]
                             + serve["pair_flash_fwd_launches"]),
        "phase 18 fleet": fleet_launches,
        "phase 18 (W4) fleet on a world-1 mesh": fleet_mesh_launches["W4"],
        "phase 18 (W5) world-1 mesh fleet with a worker process":
            fleet_mesh_launches["W5"]}
    stamp()

    launches = run_phase16a(cfg, args.seed, slice_ms)
    log(f"  flash_fwd launches in phase 16 (a): {launches}")
    torch.cuda.empty_cache()
    stamp()
    log("phase 16 (b): the estimators' per-rank tasks on the card")
    phase_estimators(args.seed, **EST_DIMS)
    torch.cuda.empty_cache()
    stamp()
    log("phase 16 (c): the bench's host-bus and elastic-chaos arms")
    phase_host_arms()
    stamp()

    torch.cuda.synchronize()
    print(json.dumps({"kernels": [entry]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
