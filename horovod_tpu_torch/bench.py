"""Decoder-LM training throughput of the port — the JAX-free twin of
the transformer arms of the repository's ``bench.py``
(``_transformer_worker``).

Run one process per GPU, with the launcher's environment
(``HOROVOD_RANK``/``HOROVOD_SIZE``/``HOROVOD_LOCAL_RANK`` and
``MASTER_ADDR``/``MASTER_PORT``; a single process needs none of them):

    python -m horovod_tpu_torch.bench

Every process runs the same two arms through the data-parallel
``make_train_step`` (bf16, flash attention, no remat) at 8 rows of 1024
tokens per GPU, 3 warm-up and 20 timed steps:

* ``transformer_std``: vocab 8192, d_model 2048, 8 layers, 16/8 heads,
  d_ff 8192;
* ``transformer``: d_model 4096, 4 layers, 32/8 heads, d_ff 16384.

Rank 0 prints the card's ``nvidia-smi`` name and power limit, then
``TFEXTRA {json}`` after each arm with ``bench.py``'s keys:
``<arm>_tokens_per_sec_per_chip`` (tokens per second per GPU) and
``<arm>_mfu_pct`` (6·params·tokens/s over the card's dense bf16 peak;
left out on a card whose peak is not known).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
import torch.distributed as dist

from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                  make_train_step,
                                                  param_leaves, shard_batch)
from horovod_tpu_torch.parallel.mesh import (data_parallel_mesh,
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


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(
        argv)
    device = init_process_group()
    try:
        run(data_parallel_mesh(), device)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
