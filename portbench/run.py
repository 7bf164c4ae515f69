"""Benchmark of vistracker_tpu_torch, the PyTorch + CUDA port, on NVIDIA
cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

One run is one process: it makes the cell's inputs and weights from the
seed, warms up every shape the cell uses, measures for --seconds, checks
what the timed path produced against the plain reference under
portbench/reference/, and prints as the last line of standard output one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer metrics, from BENCHMARK.json),
device, breakdown (--trace 1) and, last, checks: each compared number
beside its limit, also printed as the last lines of standard error.

Exits non-zero without a result where no card is usable, where the cell
needs more cards than torch sees, or where jax, jaxlib, flax or
vistracker_tpu was loaded. Caches (the kernels' nvcc builds in
build/kernels/, Triton's) stay inside the checkout.
"""
from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(harness.ROOT, "build", sub)
    workload, _ = harness.cell_files(args.workload)
    why_not = harness.cuda_ready(workload.get("chips", 1))
    if why_not:
        print(f"portbench: {why_not}", file=sys.stderr)
        return 2
    line = harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), start=START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, (value, limit) in line["checks"].items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
