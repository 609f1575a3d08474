"""The readings the correctness limits are set from, at a cell's own
sizes on the chip: ``python3 perfbench/calibrate.py --workload <cell>
--seeds 1,2,... [--control-seeds ...] [--fault-seeds ...] [--out
FILE]``.

For every seed the program's checked steps (the cell's driver, as a run
makes them) and the reference's; for the control seeds the control (the
reference computed in float8, :data:`perfbench.reference.model.FP8`)
put in the program's place; for the fault seeds the faults
planted in the reference put in the program's place: half of each
rank's rows left out (the mean over the rest), and, where ranks train
together, the exchange between them left out. Two faults need no run:
a step that returns its state unchanged reads 1 on ``grad_gap`` and
``change_gap`` (no first moment, no change), and a loss altered by 1 %
where the step produces it reads the program's ``loss_gap`` moved by
that 1 %. Prints one JSON object: each kind's numbers by seed."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import compare  # noqa: E402
from perfbench.cell import load_cell  # noqa: E402


def rank_calibrate(cell, plan, rank, world, device, ports):
    """One rank's readings of every seed of ``plan``."""
    import torch
    import torch.distributed as dist
    from perfbench import harness, weights
    from perfbench.cell import driver_module
    from perfbench.reference import model as ref
    from perfbench.traffic import TokenStream

    drv = driver_module(cell)
    cuda = device.type == "cuda"
    if cuda:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    drv.init_world(rank, world, device, ports)
    if world > 1:
        dist.new_group(backend="gloo")
    spec, traffic = cell.spec, cell.traffic
    n = traffic.checked_steps
    out = {}
    for seed in plan["seeds"]:
        rec = {}
        params = weights.make_params(spec, seed, device)
        stream = TokenStream(traffic, spec.vocab_size, seed, rank, device)
        prog = drv.Program(spec, params, device)
        t = time.perf_counter()
        losses, grad = harness.program_steps(prog, stream, 0, n, rank == 0)
        rec["program"] = {
            "loss": [float(x) for x in losses], "grad": grad,
            "change": (harness._change_norms(prog.named, spec, seed, device)
                       if rank == 0 else {})}
        rec["program_s"] = time.perf_counter() - t
        batches = [stream.batch(k).clone() for k in range(n)]
        prog.close()
        del prog, params, stream
        harness.free_device(device)
        t = time.perf_counter()
        rec["reference"] = harness.reference_readings(
            cell, seed, batches, device, world, rank)
        rec["reference_s"] = time.perf_counter() - t
        if seed in plan.get("control_seeds", ()):
            rec["control"] = harness.reference_readings(
                cell, seed, batches, device, world, rank, prec=ref.FP8)
        if seed in plan.get("fault_seeds", ()):
            half = [b[:max(1, b.shape[0] // 2)] for b in batches]
            rec["half_batch"] = harness.reference_readings(
                cell, seed, half, device, world, rank)
            if world > 1:
                rec["no_exchange"] = harness.reference_readings(
                    cell, seed, batches, device, world, rank, exchange=False)
        harness.free_device(device)
        out[str(seed)] = rec
    drv.shutdown()
    return {"rank": rank, "seeds": out, "banned": harness.banned_modules()}


def got_loss(reports, seed):
    """The program's losses of ``seed``, the mean over the ranks."""
    per = [r["seeds"][seed]["program"]["loss"] for r in reports]
    return [sum(x) / len(per) for x in zip(*per)]


def summarize(reports):
    """Each kind's compared numbers by seed against the reference: rank
    0's readings, the program's losses the mean over the ranks (the
    reference's runs average theirs already; with the exchange left out
    each rank's own)."""
    world = len(reports)
    table = {}
    for seed, rec0 in reports[0]["seeds"].items():
        ref = rec0["reference"]
        for kind in ("program", "control", "half_batch", "no_exchange"):
            if kind not in rec0:
                continue
            got = dict(rec0[kind])
            if kind == "program":   # the reference's readings are global
                got["loss"] = [sum(r["seeds"][seed][kind]["loss"][i]
                                   for r in reports) / world
                               for i in range(len(got["loss"]))]
            table.setdefault(kind, {})[seed] = compare.gaps(got, ref)
            if kind in ("program", "control"):
                table.setdefault(f"{kind}_detail", {})[seed] = {
                    "loss": compare.loss_gaps(got, ref),
                    "grad": compare.leaf_gaps(got["grad"], ref["grad"],
                                              sorted(ref["grad"])),
                    "change": compare.leaf_gaps(got["change"], ref["change"],
                                                compare.moved(ref))}
            if kind == "program":
                altered = dict(got, loss=[x * 1.01 for x in got["loss"]])
                table.setdefault("loss_altered", {})[seed] = \
                    compare.gaps(altered, ref)
        table.setdefault("readings", {})[seed] = {
            "loss": got_loss(reports, seed), "reference_loss": ref["loss"],
            "reference_grad": ref["grad"], "reference_change": ref["change"]}
        table.setdefault("seconds", {})[seed] = {
            "program_s": rec0["program_s"], "reference_s": rec0["reference_s"]}
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from perfbench import harness

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    plan = {"seeds": ints(args.seeds), "control_seeds": ints(args.control_seeds),
            "fault_seeds": ints(args.fault_seeds)}
    cell = load_cell(args.workload, os.environ.get("PERFBENCH_ROOT"))
    device = torch.device(args.device)
    t0 = time.monotonic()
    if cell.chips == 1:
        reports = [rank_calibrate(cell, plan, 0, 1, device, None)]
    else:
        reports = harness.spawn_ranks(
            cell, ["--workload", cell.name, "--seed", "0", "--seconds", "0",
                   "--calibrate", json.dumps(plan)],
            device.type, t0, timeout=3000)
    table = summarize(reports)
    table["card"] = harness.card_line() if device.type == "cuda" else "cpu"
    table["banned"] = sorted(set().union(*(r["banned"] for r in reports)))
    text = json.dumps(table, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
