"""One rank of a run on several cards, started by
:func:`perfbench.harness.spawn_ranks`; writes its report as JSON."""

import faulthandler
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    from perfbench.harness import parser
    ap = parser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--ports", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--t-start", type=float, required=True)
    ap.add_argument("--report", required=True)
    ap.add_argument("--calibrate", default=None,
                    help="JSON of perfbench.calibrate's plan instead of a run")
    ap.add_argument("--timeout", type=float, required=True)
    args = ap.parse_args(argv)
    # A rank that outlives its run prints where each thread is, and ends.
    faulthandler.dump_traceback_later(args.timeout, exit=True)
    import torch
    from perfbench.cell import load_cell
    cell = load_cell(args.workload, os.environ.get("PERFBENCH_ROOT"))
    ports = [int(p) for p in args.ports.split(",")]
    device = torch.device(args.device)
    fault = os.environ.get("PERFBENCH_FAULT")
    if fault:
        from perfbench.tests import faults
        faults.plant(fault)
    if args.calibrate:
        from perfbench.calibrate import rank_calibrate
        report = rank_calibrate(cell, json.loads(args.calibrate), args.rank,
                                args.world, device, ports)
    else:
        from perfbench.harness import rank_main
        report = rank_main(cell, args.seed, args.seconds, bool(args.trace),
                           args.rank, args.world, device, ports, args.t_start)
    with open(args.report + ".tmp", "w") as f:
        json.dump(report, f)
    os.replace(args.report + ".tmp", args.report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
