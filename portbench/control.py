"""The readings the limits of `correct` are set from, at a cell's own
size, in one process:

    python3 portbench/control.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault <name>] [--seconds 1] \
        [--out <file.jsonl>]

For each seed it makes a run of the cell (a short window: one call or a
few steps) and prints the numbers it compares with the reference; for
each control seed also the control's: the reference put in the program's
place one precision lower (TF32 for the configurations' float32), which
has to come out as not correct. With --fault the program runs with a
fault of portbench/faults.py planted under the timed path, and its
readings are the fault's. A track cell's control seeds also read the
faults planted in the reference put in the program's place (a fit whose
state never moves, a fit over half of the frames). Last it prints, per
number, the largest reading of the program (the lower reading, or the
fault's) and the smallest of the control and of each planted fault. The benchmark's own runs never
run the control or a fault.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import faults, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS), default=None)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    workload, _ = harness.cell_files(args.workload)
    why_not = harness.cuda_ready(workload.get("chips", 1))
    if why_not:
        print(f"portbench control: {why_not}", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    lower, upper = {}, {}
    out = open(args.out, "a") if args.out else None
    try:
        for seed in seeds:
            with (faults.FAULTS[args.fault]() if args.fault
                  else contextlib.nullcontext()):
                line = harness.run_cell(args.workload, seed, args.seconds,
                                        False, control=seed in controls)
            row = {"seed": seed, "fault": args.fault,
                   "correct": line["correct"],
                   "metrics": line["metrics"], "checks": line["checks"],
                   "control": line.get("control"),
                   "faults": line.get("faults"),
                   "detail": line.get("detail")}
            for k, (v, _) in line["checks"].items():
                lower[k] = max(lower.get(k, v), v)
            for k, v in (line.get("control") or {}).items():
                upper[k] = min(upper.get(k, v), v)
            for fault, found in (line.get("faults") or {}).items():
                for k, v in found.items():
                    key = f"{k} ({fault})"
                    upper[key] = min(upper.get(key, v), v)
            print("control row: " + json.dumps(row), flush=True)
            if out:
                out.write(json.dumps(row) + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    print("control summary: " + json.dumps({"lower": lower,
                                            "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
