"""Where the time of one port train step goes, on one NVIDIA GPU.

Runs the slice chip_smoke.py runs (Llama-3-8B widths, 4 layers, bf16,
B=4, T=2048, flash attention) for a few warm-up steps, then traces one
step with ``torch.profiler`` and prints:

- the step's host-clock time, the device's busy time (the union of
  kernel intervals) and its idle share;
- device time by kernel family (the flash kernel, matrix products,
  elementwise, reductions, optimizer, copies, other);
- the top PyTorch operators by self device time, by input shape.

    python3 profile_torch_step.py [--seed 0] [--trace PATH]

``--trace`` also writes the chrome trace to PATH.
"""

import argparse
import dataclasses
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from horovod_tpu_torch.models import transformer as ttr

LAYERS, BATCH, SEQ, WARMUP = 4, 4, 2048, 3   # chip_smoke.py's slice

FAMILIES = (   # first match wins; matched against the lowered kernel name
    ("flash_fwd (hand-written)", ("flash_fwd",)),
    ("matmul (cuBLAS/CUTLASS)", ("gemm", "cutlass", "xmma", "cublas",
                                 "nvjet", "sm90_", "sm80_", "wgmma")),
    ("optimizer (foreach/fused)", ("multi_tensor", "foreach", "adam")),
    ("softmax / log_softmax", ("softmax",)),
    ("reduction", ("reduce", "sum", "norm")),
    ("index / gather / scatter", ("index", "gather", "scatter", "embedding")),
    ("copy / cast", ("copy", "cast", "convert")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", help="write the chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 1

    cfg = dataclasses.replace(ttr.TransformerConfig.llama3_8b(),
                              n_layers=LAYERS, sp_attention="flash",
                              remat=False)
    gen = torch.Generator("cuda").manual_seed(args.seed)
    init_state, step = ttr.make_train_step(cfg)
    state = init_state(gen)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (BATCH, SEQ + 1),
                                     generator=gen, device="cuda")}
    for _ in range(WARMUP):
        state, loss = step(state, batch)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    print(f"card: {torch.cuda.get_device_name(0)}; config: llama3_8b widths, "
          f"{LAYERS} layers, bf16, B={BATCH} T={SEQ}; "
          f"loss {loss.item():.4f}")

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_total = sum(e.device_time_total for e in kernels)
    if not kernels or dev_total == 0:
        print("device time: not measured (the profiler recorded no "
              "kernels)")
        return 1
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy = busy_us(intervals)
    print(f"step wall {wall_us / 1e3:.3f} ms (host clock, profiler on); "
          f"device busy {busy / 1e3:.3f} ms; idle share "
          f"{100 * (1 - busy / wall_us):.2f}%; kernels {len(kernels)}")

    by_fam = {}
    for e in kernels:
        f = family(e.name)
        ms, n = by_fam.get(f, (0.0, 0))
        by_fam[f] = (ms + e.device_time_total / 1e3, n + 1)
    print("device time by kernel family:")
    for f, (ms, n) in sorted(by_fam.items(), key=lambda kv: -kv[1][0]):
        print(f"  {f:32s} {ms:10.3f} ms {100 * ms * 1e3 / dev_total:6.2f}% "
              f"({n} launches)")

    print("top PyTorch operators by self device time (input shapes):")
    # "Command Buffer Full" marks host waits on a full launch queue (the
    # host running ahead of the device), not device work.
    rows = [e for e in prof.key_averages(group_by_input_shape=True)
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.key != "Command Buffer Full"
            and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:30]:
        shapes = str(e.input_shapes)[:90]
        print(f"  {e.key[:34]:34s} {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<4d} {shapes}")

    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(args.trace)
        print(f"trace: {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
