"""portbench/program_spans.py: the program's spans against device
intervals (by hand, and a CPU profile's operations), and a traced run of
the tiny track cell with the program's recording over its window."""
from __future__ import annotations

import time

import numpy as np
import pytest

from portbench import program_spans as ps
from portbench.tests import cells


def test_union_and_busy_before():
    u = ps.merged([(5, 9), (0, 3), (2, 4), (9, 10), (20, 30)])
    assert u.tolist() == [[0, 4], [5, 10], [20, 30]]
    assert ps.busy_before(u, [0, 2, 4, 7, 15, 25, 40]).tolist() == \
        [0, 2, 4, 6, 9, 14, 19]
    assert ps.busy_before(ps.merged([]), [5]).tolist() == [0]


def test_by_span_by_hand():
    dev = np.array([(0, 10), (12, 14), (30, 40), (35, 38), (60, 70)])
    spans = [("track/stage6a/joint.phase:betas/step", 5, 20),
             ("track/stage6b/joint.phase:sil/step", 25, 45),
             ("track/stage6b/joint.phase:sil/step/forward", 26, 30),
             ("track/stage1/smplt.phase:all/step", 50, 65)]
    by = ps.by_span(dev, spans)
    assert by["stage6_step"] == {"span_s": 35e-9, "busy_s": 17e-9, "ops": 3}
    assert by["stage1_step"] == {"span_s": 15e-9, "busy_s": 5e-9, "ops": 1}
    assert "harvest" not in by


def test_own_time_and_idle_by_stage_and_leaf():
    spans = [("track", 0, 100), ("track/stage1", 0, 40),
             ("track/stage1/smplt.phase:all", 10, 30),
             ("track/stage1/smplt.phase:all/step", 12, 20),
             ("track/stage6b", 40, 100)]
    segs = ps.self_segments(spans)
    own = {}
    for p, a, b in segs:
        own[p] = own.get(p, 0) + b - a
    assert own == {"track/stage1": 20, "track/stage1/smplt.phase:all": 12,
                   "track/stage1/smplt.phase:all/step": 8,
                   "track/stage6b": 60}
    dev = np.array([(14, 18), (50, 100)])
    idle = ps.idle_by(dev, spans, window_idle_s=60e-9)
    assert idle["leaf"] == {"track/stage1": 20e-9,
                            "track/stage1/smplt.phase:all": 12e-9,
                            "track/stage6b": 10e-9,
                            "track/stage1/smplt.phase:all/step": 4e-9}
    assert idle["stage"]["stage1"] == pytest.approx(36e-9)
    assert idle["stage"][ps.OUTSIDE] == pytest.approx(14e-9)


def test_shares_read_a_number_or_none():
    by = {"stage6_step": {"span_s": 2.0, "busy_s": 0.5, "ops": 3000},
          "harvest": {"span_s": 1.0, "busy_s": 0.6, "ops": 10}}
    counters = {"track/stage6a/joint.phase:betas": {"adam_steps": 10},
                "track/stage6b/joint.phase:joint": {"adam_steps": 20},
                "track/stage1/smplt.phase:all": {"adam_steps": 7}}
    out = ps.shares(by, counters)
    assert out == {"stage6_idle_pct": 75.0, "stage1_idle_pct": None,
                   "harvest_idle_pct": pytest.approx(40.0),
                   "stage6_ops_per_step": 100.0}
    assert ps.shares({}, {}) == dict.fromkeys(out)


def test_by_span_on_a_cpu_profile():
    """The host's operations of a CPU profile stand in for the device's:
    a span around a sleep is idle, a span around torch work is not."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vistracker_tpu_torch.utils import trace
    x = torch.ones(256, 256)
    with trace.recording() as rec, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("work"):
            for _ in range(20):
                x = torch.mm(x, x).clamp_(max=1.0)
        with trace.span("sleep"):
            time.sleep(0.03)
    dev = ps.device_intervals(prof, "CPU")
    spans = [(s.path, s.start_ns, s.end_ns) for s in rec.spans]
    by = ps.by_span(dev, spans, {"work": "work", "sleep": "sleep"})
    assert by["sleep"]["span_s"] >= 0.03 and by["sleep"]["ops"] == 0
    assert by["sleep"]["busy_s"] < 0.1 * by["sleep"]["span_s"]
    assert by["work"]["ops"] >= 40
    assert by["work"]["busy_s"] > 0.5 * by["work"]["span_s"]
    assert ps.device_intervals(prof).shape == (0, 2)


@pytest.mark.parametrize("program", [True, False])
def test_traced_run_of_the_tiny_track(program, tmp_path, monkeypatch):
    # a scratch folder of its own: the other tests' runs of the cell, in
    # other xdist workers, write the cell's sequence in the shared one
    monkeypatch.setattr(ps.harness, "WORK", str(tmp_path))
    wl, cfg = cells.tiny("track.f32")
    line, extra = ps.traced_run("track.f32", 2 ** 31 + 11, 0.5, program,
                                device="cpu", workload=wl, config=cfg)
    assert line["correct"]
    if not program:
        assert extra["program_spans"] == 0 and extra["by_span"] == {}
        assert set(extra["shares"].values()) == {None}
        return
    assert extra["program_steps"] == extra["tally"]
    assert all(v > 0 for v in extra["tally"].values())
    assert set(extra["by_span"]) == set(ps.SELECT)
    leaves = extra["idle_by"]["leaf"]
    assert any(p.endswith("/step/backward") for p in leaves)
    assert extra["shares"]["stage6_ops_per_step"] == 0.0
