"""The port's tracer: named spans and step counters inside `track`, on
the clock of the profiler's device events, kept in memory.

    from vistracker_tpu_torch.utils import trace
    with trace.recording() as rec:
        run_real_track(args)
    rec.spans      # [Span(path, name, start_ns, end_ns, parent, attrs)]
    rec.counters   # {span path: {counter: int}}
    rec.export_chrome("track_trace.json")

In the code:

    with trace.span("encode.slice", {"frame": f0}):
        ...
    trace.count("adam_steps")          # into the innermost span
    trace.close("stage3", t0_ns, t1_ns)  # a span over time already run

Both ends of a span are `time.time_ns()`, nanoseconds of the wall-clock
epoch: the clock of torch.profiler's events (their `start_ns()`), so a
span says what the host was doing while the device sat idle, and no
second clock or conversion is needed.

Off unless a `recording()` is open. Off, `span` returns the one shared
no-op context manager `NO_SPAN` and `count` and `close` return at once:
the step loops allocate nothing for tracing and never synchronise the
device. On, each span is kept as (name, start, end, attributes) and each
count as (name, time, n). A span's parent is found afterwards, as the
innermost span whose interval encloses it, so a span may be closed after
its children: the stage spans of cli/real_track.py are, since its `lap`
charges an interval that has already run. A span's path joins the names
from the outermost span down, e.g.
`track/stage6b/joint.phase:sil/step/backward`; a counter is keyed by the
path of the span it was counted in. Spans of one thread: the tracer
keeps no per-thread state, so record from the thread that runs `track`.

`Recording.export_chrome` writes Chrome trace-event JSON (Perfetto,
chrome://tracing): spans as complete ("X") events, each count as a
counter ("C") event of its path's running total, `ts` and `dur` in
microseconds since `base_ns` (0: the epoch). torch.profiler's Chrome
files count `ts` from the `baseTimeNanoseconds` they state, and this
file states its own base under the same key: pass the profiler file's
base to put both on one time axis.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time


class _NoSpan:
    """The span returned while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


@dataclasses.dataclass(frozen=True)
class Span:
    path: str
    name: str
    start_ns: int
    end_ns: int
    parent: str | None   # the enclosing span's path; None at the root
    attrs: dict


class _OpenSpan:
    __slots__ = ("raw", "name", "attrs", "t0")

    def __init__(self, raw: list, name: str, attrs):
        self.raw, self.name, self.attrs = raw, name, attrs

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.raw.append((self.name, self.t0, time.time_ns(), self.attrs))
        return False


class Recording:
    """The spans and counts of one `recording()` extent."""

    def __init__(self):
        self.raw_spans = []    # (name, start_ns, end_ns, attrs or None)
        self.raw_counts = []   # (name, time_ns, n)
        self.thread = threading.get_native_id()

    def _resolve(self) -> tuple:
        """(spans in start order, counts [(time_ns, path, name, n)] in
        time order). One sweep in start order with a stack of the spans
        that enclose the current one; among spans of equal extent the one
        recorded later (closed last) is the outer one."""
        raw = self.raw_spans
        order = sorted(range(len(raw)),
                       key=lambda i: (raw[i][1], -raw[i][2], -i))
        counts = sorted(self.raw_counts, key=lambda c: c[1])
        spans, resolved, stack, c = [], [], [], 0

        def enclosing(t_end):
            while stack and stack[-1][1] < t_end:
                stack.pop()
            return stack[-1][0] if stack else None

        def take_counts(until):
            nonlocal c
            while c < len(counts) and counts[c][1] < until:
                name, t, n = counts[c]
                parent = enclosing(t)
                resolved.append((t, parent or "", name, n))
                c += 1

        for i in order:
            name, t0, t1, attrs = raw[i]
            take_counts(t0)
            parent = enclosing(t1)
            path = name if parent is None else f"{parent}/{name}"
            spans.append(Span(path, name, t0, t1, parent, attrs or {}))
            stack.append((path, t1))
        take_counts(float("inf"))
        return spans, resolved

    @property
    def spans(self) -> list:
        return self._resolve()[0]

    @property
    def counters(self) -> dict:
        out = {}
        for _, path, name, n in self._resolve()[1]:
            per = out.setdefault(path, {})
            per[name] = per.get(name, 0) + n
        return out

    def export_chrome(self, path: str, base_ns: int = 0):
        """Write the recording as Chrome trace-event JSON to `path`."""
        spans, counts = self._resolve()
        pid, tid = os.getpid(), self.thread
        events = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                   "args": {"name": "vistracker spans"}}]
        for s in spans:
            events.append({"name": s.name, "ph": "X", "cat": "vistracker",
                           "ts": (s.start_ns - base_ns) / 1e3,
                           "dur": (s.end_ns - s.start_ns) / 1e3,
                           "pid": pid, "tid": tid,
                           "args": {"path": s.path, "parent": s.parent,
                                    **s.attrs}})
        totals = {}
        for t, at, name, n in counts:
            key = (at, name)
            totals[key] = totals.get(key, 0) + n
            events.append({"name": name, "ph": "C", "ts": (t - base_ns) / 1e3,
                           "pid": pid, "args": {at or "/": totals[key]}})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "baseTimeNanoseconds": base_ns}, f)


_active: Recording | None = None


def enabled() -> bool:
    return _active is not None


def span(name: str, attrs: dict | None = None):
    """A context manager recording `name` over its block, or NO_SPAN
    while nothing records. `attrs`: a few small JSON values."""
    rec = _active
    if rec is None:
        return NO_SPAN
    return _OpenSpan(rec.raw_spans, name, attrs)


def close(name: str, start_ns: int, end_ns: int | None = None,
          attrs: dict | None = None):
    """Record `name` over [start_ns, end_ns (now)], time already run."""
    rec = _active
    if rec is not None:
        rec.raw_spans.append((name, start_ns,
                              time.time_ns() if end_ns is None else end_ns,
                              attrs))


def count(name: str, n: int = 1):
    """Add n to the counter `name` of the innermost span now open."""
    rec = _active
    if rec is not None:
        rec.raw_counts.append((name, time.time_ns(), n))


@contextlib.contextmanager
def recording():
    """Turn tracing on over the block; yields its Recording."""
    global _active
    if _active is not None:
        raise RuntimeError("a trace recording is already open")
    rec = _active = Recording()
    try:
        yield rec
    finally:
        _active = None


@contextlib.contextmanager
def to_file(path: str | None):
    """Record the block and write its Chrome trace to `path` (nothing
    when path is None). Under a process group of more than one rank each
    rank writes <stem>.rank<r>.json instead."""
    if not path:
        yield None
        return
    with recording() as rec:
        yield rec
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        stem, ext = os.path.splitext(path)
        path = f"{stem}.rank{dist.get_rank()}{ext or '.json'}"
    rec.export_chrome(path)
