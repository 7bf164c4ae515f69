"""The benchmark's machinery, shared by every cell.

A cell is found by its name: portbench/workloads/<cell>.json names its
driver (portbench/drivers/<driver>.py), its configuration
(portbench/configs/<config>.json) and its traffic parameters. The metrics
a run reports are those BENCHMARK.json gives the cell, each read by
portbench/metrics/<metric>.py from the run's record. Adding a cell, a
configuration or a metric adds files; nothing here names one.

A driver's run(ctx) makes the inputs from the seed, warms up, measures
for ctx.seconds (inside ctx.window(), which also profiles the device
with --trace 1 and takes the peak memory), checks what the timed path
produced against the plain reference, and returns the record the metric
readers read: {"window_s", "units", "setup_s", "peak_bytes", "found"
(the numbers it compared), "trace", ...}; the checks are built from the
cell's limits, so a number the run found nothing for fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
WORK = os.path.join(ROOT, "build", "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "vistracker_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The module at `path`, loaded once under `name`."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def cell_files(cell: str) -> tuple:
    """(workload, config) dicts of a cell, found by name."""
    workload = load_json(BENCH, "workloads", f"{cell}.json")
    config = load_json(BENCH, "configs", f"{workload['config']}.json")
    return workload, config


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries of BENCHMARK.json that this cell reports: its
    end-to-end metrics, or with trace its per-layer metrics."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in names)]


def read_metric(name: str, record: dict):
    """portbench/metrics/<name>.py's read(record): a number, or None
    where it finds nothing to read."""
    mod = load_module(os.path.join(BENCH, "metrics", f"{name}.py"),
                      "portbench_metric_" + name.replace(".", "_"))
    return mod.read(record)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's files, the run's arguments, the
    device, and the window it measures in."""

    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    start: float                       # process start, host clock
    work: str = ""                     # scratch directory of the cell
    control: bool = False              # also read the control (control.py)
    record: dict = dataclasses.field(default_factory=dict)
    spans: list = dataclasses.field(default_factory=list)

    def span(self, name: str, fn):
        """fn wrapped to record (name, start, end) in wall-clock ns, the
        profiler's clock, while the window is traced: the names of the
        idle gaps in the breakdown."""
        def wrapped(*a, **k):
            if not self.record.get("tracing"):
                return fn(*a, **k)
            t0 = time.time_ns()
            try:
                return fn(*a, **k)
            finally:
                self.spans.append((name, t0, time.time_ns()))
        return wrapped

    @contextlib.contextmanager
    def window(self):
        """The measured window: synchronised at both ends, the device's
        peak memory taken over it (reset_peak_memory_stats calls inside
        fold into it), and with trace the profiler around it. Sets
        record's setup_s, window_s, peak_bytes and trace."""
        import torch
        cuda = self.device.startswith("cuda")
        peak = PeakMemory() if cuda else contextlib.nullcontext()
        prof = profiler(cuda) if self.trace else contextlib.nullcontext()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.record["setup_s"] = t0 - self.start
        self.record["tracing"] = self.trace
        with peak, prof as p:
            yield
            if cuda:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
        self.record["tracing"] = False
        self.record["window_s"] = t1 - t0
        self.record["peak_bytes"] = peak.value if cuda else 0
        if self.trace and p is not None:
            t2 = time.perf_counter()
            self.record["trace"] = read_trace(p, t1 - t0, self.spans)
            print(f"portbench: trace stopped and read in "
                  f"{time.perf_counter() - t1:.3f} s (read "
                  f"{time.perf_counter() - t2:.3f} s)", flush=True)


class PeakMemory:
    """torch.cuda.max_memory_allocated over a window whose code resets
    the peak: each reset first folds the peak so far into `value`."""

    def __enter__(self):
        import torch
        self.value = 0
        self._reset = torch.cuda.reset_peak_memory_stats
        torch.cuda.reset_peak_memory_stats()

        def reset(*a, **k):
            self.value = max(self.value, torch.cuda.max_memory_allocated())
            return self._reset(*a, **k)
        torch.cuda.reset_peak_memory_stats = reset
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.reset_peak_memory_stats = self._reset
        self.value = max(self.value, torch.cuda.max_memory_allocated())


def profiler(cuda: bool):
    """The device's activity alone on a card (host operations are not
    recorded: they would slow every launch of the launch-bound stages);
    the host's on the CPU, for the tests."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU])


def _union(spans) -> tuple:
    """Sorted (start, end) spans -> (covered length, gaps [(len, start)])."""
    busy, gaps, cur_s, cur_e = 0, [], None, None
    for s, e in spans:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def gap_name(at: int, spans: list) -> str:
    """The innermost benchmark span (the latest to start) running at
    wall-clock ns `at`: what the host was doing."""
    inside = [(t0, name) for name, t0, t1 in spans if t0 <= at <= t1]
    return max(inside)[1] if inside else "(outside the benchmark's spans)"


def read_trace(prof, window_s: float, spans: list = ()) -> dict:
    """From the profiler's device events: busy_s (their union),
    window_s, device ops by total seconds (top 10), and the 10 longest
    idle gaps between device operations, each named by the benchmark
    span the host was in at the gap's middle."""
    from torch.autograd import DeviceType
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    busy, gaps = _union(sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                               for e in dev))
    by_name: dict = {}
    for e in dev:
        by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps.sort(reverse=True)
    return {"busy_s": busy / 1e9, "window_s": window_s,
            "device_ops": [[n, t / 1e9] for n, t in top],
            "idle_gaps": [[gap_name(at + g // 2, spans), g / 1e9]
                          for g, at in gaps[:10]],
            "device_ops_by_name": {n: t / 1e9 for n, t in by_name.items()}}


def checks(limits: dict, found: dict) -> dict:
    """{number: [reading, limit]} for every number the cell's limits
    name; one the run found nothing to read for reads NaN."""
    return {k: [float(found.get(k, math.nan)), float(lim)]
            for k, lim in limits.items()}


def correct(checks: dict) -> bool:
    """Every compared number within its limit (<=); NaN fails, and so
    does a run that compares nothing."""
    return bool(checks) and all(math.isfinite(v) and v <= lim
                                for v, lim in checks.values())


def cuda_ready(chips: int) -> str | None:
    """None where the process may run on `chips` cards, else why not."""
    import torch
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} cards, torch sees "
                f"{torch.cuda.device_count()}")
    return None


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", start: float | None = None,
             workload: dict | None = None, config: dict | None = None,
             bench: dict | None = None, control: bool = False) -> dict:
    """Drive one run of a cell and return its result line (a dict);
    `workload`, `config` and `bench` replace the files (the tests run
    small cells on the CPU); with control the line also holds the
    control's readings under "control"."""
    import torch
    start = time.perf_counter() if start is None else start
    wl, cfg = cell_files(cell) if workload is None else (workload, config)
    bench = bench if bench is not None else load_json(ROOT, "BENCHMARK.json")
    ctx = Context(cell, wl, cfg, seed, seconds, trace, device, start,
                  work=os.path.join(WORK, cell), control=control)
    os.makedirs(ctx.work, exist_ok=True)
    driver = load_module(os.path.join(BENCH, "drivers",
                                      f"{wl['driver']}.py"),
                         "portbench_driver_" + wl["driver"])
    driver.run(ctx)
    rec = ctx.record
    rec["checks"] = checks(wl["limits"], rec["found"])
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        value = read_metric(m["name"], rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = device.startswith("cuda")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": wl.get("chips", 1),
           "memory_peak_bytes": int(rec.get("peak_bytes", 0))}
    if trace and "trace" in rec:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
    line = {"correct": correct(rec["checks"]),
            "attempted": rec["units"], "failed": rec.get("failed", 0),
            "metrics": metrics, "device": dev}
    if trace and "trace" in rec:
        line["breakdown"] = {k: rec["trace"][k]
                             for k in ("device_ops", "idle_gaps")}
    if control:
        line["control"] = rec["control"]
        line["faults"] = rec.get("faults")
        line["detail"] = rec.get("detail")
    line["checks"] = rec["checks"]
    return line
