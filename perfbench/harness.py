"""The benchmark's run: one cell, one seed, one window.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout. A cell on one chip runs in
this process; a cell on more starts one worker process a card
(``perfbench/worker.py``) and gathers their reports. Each rank:

1. brings up the program's world (the cell's driver), makes the
   weights and the token batches from the seed on its card, hands the
   weights to the program;
2. runs the checked steps through the same call the window times (the
   first reads of the program's optimizer state, and each leaf's change
   against the weights made again), then the cell's extra warm-up
   steps: set-up ends here (``setup_s``, from the start of the
   process);
3. times whole steps, each ended by a device synchronisation, until the
   window's ``--seconds`` have passed (rank 0 decides, every rank stops
   at the same step): the tokens of the steps that ended inside the
   window over the time to the end of the last of them;
4. with ``--trace 1``, profiles a few more whole steps;
5. reads the memory peak, frees the program's state and runs the
   reference (``perfbench/reference``) on the checked steps' inputs.

The last line of standard output is the result; the numbers compared,
each beside its limit, are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import faulthandler
import gc
import itertools
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import types
from typing import Dict, List, Optional

from perfbench import compare
from perfbench.cell import HERE, Cell, driver_module, load_cell, metric_reader

#: Top-level module names that no process of a run may hold.
BANNED = ("jax", "jaxlib", "flax", "horovod_tpu")
TRACE_STEPS = 2
RUN_TIMEOUT = 330.0


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# One rank
# ---------------------------------------------------------------------------

def _change_norms(named, spec, seed, device) -> Dict[str, float]:
    """Each leaf's norm of its change since the seed's weights, made
    again one leaf at a time."""
    from perfbench import weights
    from perfbench.norms import diff_norm
    out = {}
    for (name, p), (name0, p0) in zip(named,
                                      weights.iter_leaves(spec, seed, device)):
        assert name == name0, (name, name0)
        out[name] = diff_norm(p, p0)
        del p0
    return out


def _ranks_differ(named, world: int) -> int:
    """Leaves of this rank that differ from rank 0's (the world's
    default group)."""
    import torch
    import torch.distributed as dist
    if world == 1:
        return 0
    bad = 0
    for _, p in named:
        buf = p.detach() if dist.get_rank() == 0 else torch.empty_like(p)
        dist.broadcast(buf, src=0)
        bad += int(not torch.equal(buf, p.detach()))
        del buf
    return bad


def _average(world: int):
    """The reference's mean over the data-parallel ranks (the world's
    default group; plain ``torch.distributed``)."""
    import torch.distributed as dist

    def average(loss, grads):
        loss = loss.reshape(1).clone()
        dist.all_reduce(loss)
        for g in grads:
            dist.all_reduce(g)
            g.div_(world)
        return float(loss) / world, grads

    return average if world > 1 else None


def program_steps(prog, stream, first: int, n: int, read: bool):
    """``n`` steps from batch ``first``; with ``read`` the first step's
    gradient norms from the optimizer's state. Returns the losses (still
    on the device) and the gradient norms."""
    losses, grad = [], {}
    for i in range(n):
        losses.append(prog.step(stream.batch(first + i)))
        if i == 0 and read:
            grad = {name: prog.first_grad_norm(p) for name, p in prog.named}
    return losses, grad


def reference_readings(cell: Cell, seed: int, batches, device, world: int,
                       rank: int, prec=None, exchange: bool = True):
    """The reference trained from the seed's weights on ``batches``
    (this rank's rows of each checked step), its gradients averaged over
    the ranks unless ``exchange`` is off: rank 0's readings."""
    from perfbench import weights
    from perfbench.reference import model as ref
    named = list(weights.iter_leaves(cell.spec, seed, device))
    avg = _average(world) if exchange else None
    out = ref.train(named, batches, cell.spec, prec or ref.F32, avg)
    out["change"] = (_change_norms(named, cell.spec, seed, device)
                     if rank == 0 else {})
    del named
    return out


def free_device(device) -> None:
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def rank_main(cell: Cell, seed: int, seconds: float, trace: bool, rank: int,
              world: int, device, ports, t_start: float) -> Dict[str, object]:
    """One rank of a run (module docstring): its report."""
    import torch
    import torch.distributed as dist
    from perfbench import trace as tracing
    from perfbench import weights
    from perfbench.traffic import TokenStream

    marks = [("start", t_start), ("imports", time.monotonic())]
    drv = driver_module(cell)
    cuda = device.type == "cuda"
    if cuda:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    drv.init_world(rank, world, device, ports)
    gloo = dist.new_group(backend="gloo") if world > 1 else None
    marks.append(("world", time.monotonic()))
    spec, traffic = cell.spec, cell.traffic
    params = weights.make_params(spec, seed, device)
    stream = TokenStream(traffic, spec.vocab_size, seed, rank, device)
    prog = drv.Program(spec, params, device)
    sync()
    marks.append(("weights_and_program", time.monotonic()))
    checked = traffic.checked_steps
    losses, grad = program_steps(prog, stream, 0, checked, rank == 0)
    sync()
    losses = [float(x) for x in losses]
    marks.append(("checked_steps", time.monotonic()))
    change = _change_norms(prog.named, spec, seed, device) if rank == 0 else {}
    marks.append(("change_read", time.monotonic()))
    program_steps(prog, stream, checked, cell.warmup_steps, False)
    sync()
    if gloo is not None:
        dist.barrier(group=gloo)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    first = len(prog.exposed)
    i = checked + cell.warmup_steps
    t_first = time.monotonic()
    marks.append(("warmup_steps", t_first))
    t0 = time.perf_counter()
    steps, t_last = 0, t0
    while True:
        prog.step(stream.batch(i))
        i += 1
        sync()
        t = time.perf_counter()
        # A step that ends past the window is not counted, unless it is
        # the first (a step longer than the window is timed alone).
        stop = torch.tensor([int(t - t0 > seconds and steps > 0)])
        if gloo is not None:
            dist.broadcast(stop, src=0, group=gloo)
        if stop.item():
            break
        steps, t_last = steps + 1, t
    window_s = t_last - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    exposed = (prog.exposed_ms(range(first, first + steps))
               if hasattr(prog, "exposed_ms") else None)
    report = {"rank": rank, "steps": steps, "window_s": window_s,
              "t_first": t_first, "peak_bytes": peak, "losses": losses,
              "setup_parts": {b[0]: b[1] - a[1]
                              for a, b in zip(marks, marks[1:])},
              "grad": grad, "change": change,
              "exposed_ms": (None if not exposed
                             else sum(exposed) / len(exposed)),
              "trace": None}
    if trace:
        needs = {}
        for m in cell.per_layer:
            needs.update(metric_reader(cell, m["name"]).NEEDS)
        following = itertools.count(i)
        calls = {k: v for k, (kind, v) in needs.items() if kind == "calls"}
        tr = tracing.profile_steps(
            lambda: prog.step(stream.batch(next(following))), TRACE_STEPS,
            sync, device, calls)
        report["trace"] = tracing.summarize(tr, needs, TRACE_STEPS)
        del tr
    report["differ"] = _ranks_differ(prog.named, world)
    batches = [stream.batch(k).clone() for k in range(checked)]
    prog.close()
    del prog, params, stream
    free_device(device)
    report["reference"] = reference_readings(cell, seed, batches, device,
                                             world, rank)
    del batches
    free_device(device)
    drv.shutdown()
    report["banned"] = banned_modules()
    return report


# ---------------------------------------------------------------------------
# The run: ranks, their reports, the result
# ---------------------------------------------------------------------------

def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
    deadline = time.monotonic() + 15
    for p in procs:
        try:
            p.wait(max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()


def spawn_ranks(cell: Cell, argv_tail: List[str], device_type: str,
                t_start: float, timeout: Optional[float] = None,
                extra_env: Optional[Dict[str, str]] = None) -> List[dict]:
    """One worker process a card, each running ``worker.py`` with
    ``argv_tail``; their reports, in rank order. A worker that fails
    ends the others and raises."""
    world = cell.chips
    timeout = RUN_TIMEOUT if timeout is None else timeout
    tmp = tempfile.mkdtemp(prefix="perfbench.")
    ports = f"{free_port()},{free_port()}"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "MASTER_", "OMPI_", "PMI_"))}
    env["PERFBENCH_ROOT"] = str(cell.root)
    env.update(extra_env or {})
    procs = []
    try:
        for r in range(world):
            cmd = [sys.executable, str(HERE / "worker.py"), *argv_tail,
                   "--rank", str(r), "--world", str(world), "--ports", ports,
                   "--device", device_type, "--t-start", repr(t_start),
                   "--timeout", repr(timeout - 10),
                   "--report", os.path.join(tmp, f"rank{r}.json")]
            procs.append(subprocess.Popen(cmd, env=env,
                                          start_new_session=True))
        deadline = time.monotonic() + timeout
        pending = list(procs)
        while pending:
            for p in list(pending):
                if p.poll() is not None:
                    pending.remove(p)
                    if p.returncode != 0:
                        raise RuntimeError(f"a worker exited with "
                                           f"{p.returncode}")
            if time.monotonic() > deadline:
                raise RuntimeError("workers did not end in time")
            time.sleep(0.05)
        reports = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                reports.append(json.load(f))
        return reports
    finally:
        _kill(procs)
        shutil.rmtree(tmp, ignore_errors=True)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def end_to_end(name: str, cell: Cell, reports, t_start: float) -> float:
    r0 = reports[0]
    if name == "train_tokens_per_s":
        return (r0["steps"] * cell.traffic.rows_per_gpu * cell.traffic.seq
                / r0["window_s"])
    if name == "peak_mem_gib":
        return max(r["peak_bytes"] for r in reports) / 2 ** 30
    if name == "setup_s":
        return max(r["t_first"] for r in reports) - t_start
    raise KeyError(f"no end-to-end metric {name!r} in this harness")


def result(cell: Cell, trace: bool, reports, t_start: float,
           device_kind: str, card: str) -> Dict[str, object]:
    """The result line of a run from its ranks' reports."""
    from perfbench.peaks import peaks
    r0 = reports[0]
    world = len(reports)
    prog = {"loss": [sum(r["losses"][i] for r in reports) / world
                     for i in range(len(r0["losses"]))],
            "grad": r0["grad"], "change": r0["change"]}
    numbers = compare.gaps(prog, r0["reference"])
    if world > 1:
        numbers["ranks_differ"] = float(sum(r["differ"] for r in reports))
    correct, checks = compare.judge(numbers, cell.limits)
    if not trace:
        metrics = {m["name"]: {"value": end_to_end(m["name"], cell, reports,
                                                   t_start),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    else:
        run = types.SimpleNamespace(
            spec=cell.spec, traffic=cell.traffic, world=world,
            tokens_per_s=end_to_end("train_tokens_per_s", cell, reports,
                                    t_start),
            peaks=peaks(device_kind), trace=r0["trace"],
            traces=[r["trace"] for r in reports],
            exposed_ms=[r["exposed_ms"] for r in reports])
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(cell, m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if device_kind != "cpu" else "cpu",
              "kind": device_kind, "count": world,
              "memory_peak_bytes": max(r["peak_bytes"] for r in reports)}
    out = {"correct": correct, "attempted": len(numbers),
           "failed": sum(1 for c in checks.values()
                         if not (c["limit"] is not None
                                 and c["value"] <= c["limit"])),
           "metrics": metrics, "device": device}
    if trace:
        traces = [r["trace"] for r in reports]
        device["busy_s"] = sum(t["busy_s"] for t in traces) / world
        device["window_s"] = sum(t["span_s"] for t in traces) / world
        out["breakdown"] = r0["trace"]["breakdown"]
        out["layer_s_per_step"] = r0["trace"]["layers"]
    out["card"] = card
    out["window"] = {"steps": r0["steps"], "seconds": r0["window_s"]}
    out["setup_parts_s"] = r0["setup_parts"]
    out["loss_gap_steps"] = compare.loss_gaps(prog, r0["reference"])
    out["checks"] = checks
    return out


def emit(out: Dict[str, object]) -> None:
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, argv_tail: Optional[List[str]] = None,
             extra_env: Optional[Dict[str, str]] = None):
    """The reports of every rank of a run of ``cell`` on ``device``."""
    if cell.chips == 1:
        return [rank_main(cell, seed, seconds, trace, 0, 1, device, None,
                          t_start)]
    tail = argv_tail or ["--workload", cell.name, "--seed", str(seed),
                         "--seconds", repr(seconds), "--trace",
                         str(int(trace))]
    return spawn_ranks(cell, tail, device.type, t_start,
                       extra_env=extra_env)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.monotonic() if t_start is None else t_start
    # A run that outlives its limit prints where each thread is, and ends.
    faulthandler.dump_traceback_later(RUN_TIMEOUT + 20, exit=True)
    args = parser().parse_args(argv)
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: cell {cell.name} needs {cell.chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    reports = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda"), t_start)
    found = sorted(set(banned_modules()).union(
        *(r["banned"] for r in reports)))
    if found:
        print(f"perfbench: modules that no run may load were loaded: "
              f"{found}", file=sys.stderr)
        return 3
    kind = torch.cuda.get_device_name(0)
    emit(result(cell, bool(args.trace), reports, t_start, kind, card_line()))
    return 0
