"""The program's own spans and step counters (vistracker_tpu_torch's
utils/trace.py) against the profiler's device events: where the device
sits idle, by stage, phase and part of a step.

    python3 portbench/program_spans.py --workload track.f32 --seed <n> \
        --seconds 40 [--program-trace 0|1] [--out <json>]

runs one `--trace 1` run of a track cell through harness.run_cell, with
the program's recording open over each call of the window (not over the
warm-up), and prints the run's result line and then one JSON line:
`by_span` (for each selector below: the union of its spans in seconds,
the device-busy seconds inside that union, the device operations that
start inside it), the four shares this yields (stage6_idle_pct,
stage6_ops_per_step, stage1_idle_pct, harvest_idle_pct), the window's
idle seconds by stage and by leaf span (a span's own time, its
children's left out), the program's adam_steps against the driver's
tally of the fits' loss traces, the 10 longest idle gaps named by the
innermost span (the program's or the benchmark's), and the seconds the
read took. With --program-trace 0 the recording stays closed (the
profiler still runs): the cost of recording is the difference.

Nothing in the benchmark's own command reaches this file: it patches
harness.Context.window, harness.read_trace and the program's
run_real_track for its own process only.
"""
from __future__ import annotations

import argparse
import contextlib
import fnmatch
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness  # noqa: E402

# the spans each share reads, as fnmatch patterns over span paths
SELECT = {
    "stage6_step": "track/stage6[ab]/joint.phase:*/step",
    "stage1_step": "track/stage1/smplt.phase:*/step",
    "harvest": "track/stage4_harvest",
}
OUTSIDE = "(outside the program's spans)"


def merged(intervals) -> np.ndarray:
    """(n, 2) int64 [start, end) intervals -> their union, sorted and
    disjoint."""
    a = np.asarray(intervals, np.int64).reshape(-1, 2)
    if not len(a):
        return a
    a = a[np.argsort(a[:, 0], kind="stable")]
    reach = np.maximum.accumulate(a[:, 1])
    new = np.ones(len(a), bool)
    new[1:] = a[1:, 0] > reach[:-1]
    idx = np.flatnonzero(new)
    ends = np.append(reach[idx[1:] - 1], reach[-1])
    return np.stack([a[idx, 0], ends], 1)


def busy_before(busy: np.ndarray, t) -> np.ndarray:
    """Device-busy ns before each time in t, for a union `busy`."""
    t = np.asarray(t, np.int64)
    if not len(busy):
        return np.zeros(t.shape, np.int64)
    cum = np.concatenate([[0], np.cumsum(busy[:, 1] - busy[:, 0])])
    k = np.searchsorted(busy[:, 0], t, side="right")
    part = np.where(k > 0, np.minimum(t, busy[np.maximum(k - 1, 0), 1])
                    - busy[np.maximum(k - 1, 0), 0], 0)
    return cum[np.maximum(k - 1, 0)] * (k > 0) + part


def by_span(dev: np.ndarray, spans: list, select: dict = SELECT) -> dict:
    """dev: (n, 2) device operations [start, end) in ns; spans: (path,
    start, end). For each selector: span_s (the union of the matching
    spans), busy_s (the device busy inside it), ops (device operations
    starting inside it)."""
    busy = merged(dev)
    starts = np.sort(np.asarray(dev, np.int64).reshape(-1, 2)[:, 0])
    out = {}
    for key, pattern in select.items():
        u = merged([(a, b) for p, a, b in spans
                    if fnmatch.fnmatchcase(p, pattern)])
        if not len(u):
            continue
        inside = busy_before(busy, u[:, 1]) - busy_before(busy, u[:, 0])
        lo = np.searchsorted(starts, u[:, 0], side="left")
        hi = np.searchsorted(starts, u[:, 1], side="left")
        out[key] = {"span_s": float((u[:, 1] - u[:, 0]).sum()) / 1e9,
                    "busy_s": float(inside.sum()) / 1e9,
                    "ops": int((hi - lo).sum())}
    return out


def self_segments(spans: list) -> list:
    """(path, start, end) spans, properly nested -> (path, start, end)
    segments of each span's own time, children's time left out."""
    out, stack = [], []
    for path, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        cur = a
        while stack and stack[-1][2] <= a:
            p, c, e = stack.pop()
            out.append((p, c, e))
            if stack:
                stack[-1][1] = e
        if stack:
            out.append((stack[-1][0], stack[-1][1], a))
        stack.append([path, cur, b])
    while stack:
        p, c, e = stack.pop()
        out.append((p, c, e))
        if stack:
            stack[-1][1] = e
    return [s for s in out if s[2] > s[1]]


def idle_by(dev: np.ndarray, spans: list, window_idle_s: float) -> dict:
    """The window's idle seconds by leaf span (its own time) and by
    stage (the path's second name), and those outside every span."""
    busy = merged(dev)
    segs = self_segments(spans)
    leaf, stage = {}, {}
    if segs:
        a = np.array([s[1] for s in segs], np.int64)
        b = np.array([s[2] for s in segs], np.int64)
        idle = (b - a) - (busy_before(busy, b) - busy_before(busy, a))
        for (p, _, _), i in zip(segs, idle.tolist()):
            leaf[p] = leaf.get(p, 0) + i
            name = p.split("/")[1] if "/" in p else p
            stage[name] = stage.get(name, 0) + i
    inside = sum(leaf.values()) / 1e9
    stage[OUTSIDE] = window_idle_s - inside
    return {"leaf": {k: v / 1e9 for k, v in sorted(
                leaf.items(), key=lambda kv: -kv[1])},
            "stage": {k: (v / 1e9 if k != OUTSIDE else v)
                      for k, v in sorted(stage.items(),
                                         key=lambda kv: -kv[1])}}


def steps_under(counters: dict, prefix: str) -> int:
    return sum(c.get("adam_steps", 0) for p, c in counters.items()
               if p.startswith(prefix))


def shares(by: dict, counters: dict) -> dict:
    """The four per-layer shares from by_span and the counters."""
    out = {}

    def idle(key):
        s = by.get(key)
        return None if not s else 100.0 * (1.0 - s["busy_s"] / s["span_s"])
    out["stage6_idle_pct"] = idle("stage6_step")
    out["stage1_idle_pct"] = idle("stage1_step")
    out["harvest_idle_pct"] = idle("harvest")
    n6 = steps_under(counters, "track/stage6a/") \
        + steps_under(counters, "track/stage6b/")
    out["stage6_ops_per_step"] = (by["stage6_step"]["ops"] / n6
                                  if n6 and "stage6_step" in by else None)
    return out


def device_intervals(prof, kind: str = "CUDA") -> np.ndarray:
    """The profiler's operations on devices of `kind` as (n, 2) ns
    [start, end) intervals (CPU: the host's, for the tests)."""
    from torch.autograd import DeviceType
    want = getattr(DeviceType, kind)
    return np.array([(e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == want], np.int64).reshape(-1, 2)


def traced_run(cell: str, seed: int, seconds: float, program: bool,
               device: str = "cuda", **run_kw) -> tuple:
    """One --trace 1 run of a track cell with the program's recording
    over the window's calls: (result line, extras)."""
    from vistracker_tpu_torch.cli import real_track
    from vistracker_tpu_torch.utils import trace

    box = {"ctx": None, "recs": [], "extra": {}}
    window0, read0 = harness.Context.window, harness.read_trace
    track0 = real_track.run_real_track

    @contextlib.contextmanager
    def window(self):
        box["ctx"] = self
        with window0(self):
            yield

    def run_real_track(*a, **k):
        ctx = box["ctx"]
        if not (program and ctx is not None and ctx.record.get("tracing")):
            return track0(*a, **k)
        with trace.recording() as rec:
            out = track0(*a, **k)
        box["recs"].append(rec)
        return out

    def read_trace(prof, window_s, spans=()):
        program_spans = [(s.path, s.start_ns, s.end_ns)
                         for r in box["recs"] for s in r.spans]
        res = read0(prof, window_s, list(spans) + program_spans)
        t0 = time.perf_counter()
        dev = device_intervals(prof)
        t1 = time.perf_counter()
        by = by_span(dev, program_spans)
        idle = idle_by(dev, program_spans, window_s - res["busy_s"])
        box["extra"].update(by_span=by, idle_by=idle, read_s={
            "device_events": t1 - t0,
            "by_span_and_idle": time.perf_counter() - t1})
        return res

    harness.Context.window = window
    harness.read_trace = read_trace
    real_track.run_real_track = run_real_track
    try:
        line = harness.run_cell(cell, seed, seconds, True, device=device,
                                **run_kw)
    finally:
        harness.Context.window = window0
        harness.read_trace = read0
        real_track.run_real_track = track0
    rec, extra = box["ctx"].record, box["extra"]
    counters = {}
    for r in box["recs"]:
        for path, c in r.counters.items():
            per = counters.setdefault(path, {})
            for k, v in c.items():
                per[k] = per.get(k, 0) + v
    program_steps = {
        "stage1_steps": steps_under(counters, "track/stage1/"),
        "refit_steps": steps_under(counters, "track/stage2/"),
        "stage6a_steps": steps_under(counters, "track/stage6a/"),
        "stage6b_steps": steps_under(counters, "track/stage6b/")}
    extra.update(
        shares=shares(extra.get("by_span", {}), counters),
        program_counters=counters, program_steps=program_steps,
        tally={k: rec.get(k) for k in program_steps},
        idle_gaps=line.get("breakdown", {}).get("idle_gaps"),
        stage_seconds=rec.get("stage_seconds"),
        stage6_ms_per_step=line["metrics"].get("stage6_ms_per_step"),
        call_seconds=rec.get("call_seconds"),
        program_spans=sum(len(r.raw_spans) for r in box["recs"]))
    return line, extra


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--program-trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None,
                    help="also write the extras (with every leaf) here")
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(harness.ROOT, "build", sub)
    why_not = harness.cuda_ready(1)
    if why_not:
        print(f"portbench: {why_not}", file=sys.stderr)
        return 2
    line, extra = traced_run(args.workload, args.seed, args.seconds,
                             bool(args.program_trace))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(extra, f, indent=1)
    brief = dict(extra, idle_by=dict(
        extra.get("idle_by", {}),
        leaf=dict(list(extra.get("idle_by", {}).get("leaf", {}).items())
                  [:25])))
    brief.pop("program_counters", None)
    print(json.dumps(line), flush=True)
    print(json.dumps(brief), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
