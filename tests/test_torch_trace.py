"""The port's tracer (vistracker_tpu_torch/utils/trace.py): off by
default, span paths and parents found by the intervals that enclose
them, counters, the Chrome export, its clock against torch.profiler's,
and a tiny whole `track` on the CPU with tracing on and off."""
import functools
import json
import os
import time

import numpy as np
import pytest
import torch

from vistracker_tpu_torch.utils import trace

torch.set_num_threads(1)


def test_off_by_default_records_nothing():
    assert not trace.enabled()
    assert trace.span("step") is trace.NO_SPAN
    assert trace.span("frame", {"frame": 3}) is trace.NO_SPAN
    with trace.span("step") as s:
        trace.count("adam_steps")
        trace.close("stage1", time.time_ns())
    assert s is trace.NO_SPAN
    with trace.recording() as rec:
        assert trace.enabled()
    assert not trace.enabled()
    assert rec.spans == [] and rec.counters == {}


def test_one_recording_at_a_time():
    with trace.recording():
        with pytest.raises(RuntimeError, match="already open"):
            with trace.recording():
                pass
    assert not trace.enabled()


def _nested_recording():
    """A stage span closed after its children, as run_real_track's `lap`
    closes them, nested spans and counters in several spans."""
    with trace.recording() as rec:
        t_track = time.time_ns()
        t0 = time.time_ns()
        for _ in range(2):
            with trace.span("joint.phase:obj", {"chunk": 0}):
                for _ in range(3):
                    with trace.span("step"):
                        with trace.span("forward"):
                            pass
                        with trace.span("backward"):
                            pass
                    trace.count("adam_steps")
        trace.count("calls", 5)
        t1 = time.time_ns()
        trace.close("stage6b", t0, t1)
        with trace.span("save"):
            pass
        trace.close("track", t_track)
    return rec


def test_nested_spans_paths_parents_and_counters():
    rec = _nested_recording()
    by_path = {}
    for s in rec.spans:
        by_path.setdefault(s.path, []).append(s)
    assert {p: len(v) for p, v in by_path.items()} == {
        "track": 1, "track/stage6b": 1, "track/stage6b/joint.phase:obj": 2,
        "track/stage6b/joint.phase:obj/step": 6,
        "track/stage6b/joint.phase:obj/step/forward": 6,
        "track/stage6b/joint.phase:obj/step/backward": 6, "track/save": 1}
    for s in rec.spans:
        assert s.parent == (None if s.path == "track"
                            else s.path.rsplit("/", 1)[0])
        assert s.start_ns <= s.end_ns
    assert by_path["track/stage6b/joint.phase:obj"][0].attrs == {"chunk": 0}
    assert rec.counters == {
        "track/stage6b/joint.phase:obj": {"adam_steps": 6},
        "track/stage6b": {"calls": 5}}


def test_chrome_export_parses_and_every_span_has_its_parent(tmp_path):
    rec = _nested_recording()
    path = tmp_path / "t.json"
    base = rec.spans[0].start_ns - 1000
    rec.export_chrome(str(path), base_ns=base)
    doc = json.loads(path.read_text())
    assert doc["baseTimeNanoseconds"] == base
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == len(rec.spans)
    paths = {e["args"]["path"] for e in xs}
    for e in xs:
        parent = e["args"]["parent"]
        assert parent is None or parent in paths
        assert e["ts"] >= 1.0 and e["dur"] >= 0
    track = next(e for e in xs if e["args"]["path"] == "track")
    for e in xs:
        assert track["ts"] <= e["ts"] <= e["ts"] + e["dur"] \
            <= track["ts"] + track["dur"] + 1e-3
    cs = [e for e in doc["traceEvents"] if e["ph"] == "C"]
    last = {}
    for e in sorted(cs, key=lambda e: e["ts"]):
        last.update({(e["name"], k): v for k, v in e["args"].items()})
    assert last == {("adam_steps", "track/stage6b/joint.phase:obj"): 6,
                    ("calls", "track/stage6b"): 5}


def test_spans_share_the_profiler_clock():
    """A host sleep between two torch ops, inside a span: the profiler's
    gap between the ops is the span, within 5 ms at each end, and the
    benchmark harness names the gap by the span's path."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.harness import gap_name
    x = torch.ones(64)
    with trace.recording() as rec, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        y = torch.add(x, 1.0)
        with trace.span("outer"):
            with trace.span("sleep"):
                time.sleep(0.05)
        torch.mul(y, 2.0)
    ev = {e.name(): e for e in prof.profiler.kineto_results.events()}
    gap0 = ev["aten::add"].start_ns() + ev["aten::add"].duration_ns()
    gap1 = ev["aten::mul"].start_ns()
    s = next(s for s in rec.spans if s.name == "sleep")
    assert s.path == "outer/sleep"
    assert abs(gap0 - s.start_ns) < 5e6 and abs(gap1 - s.end_ns) < 5e6
    assert gap0 <= s.start_ns + 1e5 and s.end_ns <= gap1 + 1e5
    spans = [(s.path, s.start_ns, s.end_ns) for s in rec.spans]
    assert gap_name((gap0 + gap1) // 2, spans) == "outer/sleep"


@pytest.mark.cuda
def test_spans_share_the_device_clock(tmp_path):
    """On the card: a span around a torch.cuda._sleep kernel and the
    profiler's record of that kernel lie on one time axis (the kernel
    starts after the span opens and ends before the span's synchronize
    returns, each within 5 ms), and so do the two Chrome files, each
    rebased by the baseTimeNanoseconds it states."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            trace.recording() as rec:
        with trace.span("sleep"):
            torch.cuda._sleep(50_000_000)
            torch.cuda.synchronize()
    k = max((e for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA),
            key=lambda e: e.duration_ns())
    s, = rec.spans
    k0, k1 = k.start_ns(), k.start_ns() + k.duration_ns()
    print(f"sleep kernel {k.name()} {k.duration_ns() / 1e6:.3f} ms: starts "
          f"{(k0 - s.start_ns) / 1e3:.1f} us after the span opens, ends "
          f"{(s.end_ns - k1) / 1e3:.1f} us before it closes")
    assert 0 < k0 - s.start_ns < 5e6 and 0 < s.end_ns - k1 < 5e6
    prof.export_chrome_trace(str(tmp_path / "profiler.json"))
    rec.export_chrome(str(tmp_path / "spans.json"))
    epoch_us = []
    for name, pick in (("profiler.json", lambda e: e.get("cat") == "kernel"
                        and e["name"] == k.name()),
                       ("spans.json", lambda e: e["ph"] == "X")):
        doc = json.loads((tmp_path / name).read_text())
        e = max((e for e in doc["traceEvents"] if pick(e)),
                key=lambda e: e["dur"])
        epoch_us.append(e["ts"] + doc.get("baseTimeNanoseconds", 0) / 1e3)
    print(f"files: kernel ts - span ts = {epoch_us[0] - epoch_us[1]:.1f} us")
    assert 0 < epoch_us[0] - epoch_us[1] < 5e3


# ---------------------------------------------------------------------------
# a tiny whole `track` on the CPU
# ---------------------------------------------------------------------------

T, CHUNK = 4, 4
SHORT_FIT = dict(global_iters=1, max_iters=2)
SHORT_JOINT = dict(iter_betas=1, iter_pose=1, iter_kpts=1, smpl_max_iter=1,
                   iter_obj=1, iter_sil=1, joint_max_iter=1, sil_size=32,
                   sil_sigma=2.0 / 32, steps_per_iter=2)
GEN_KW = dict(num_points=32, filter_val=10.0)
SMALL_FUNNEL = ((256, 128, 2), (128, 64, 2))


@pytest.fixture(scope="module")
def tiny_track(tmp_path_factory):
    """The tiny CPU `track` run twice, tracing off then on: (the two
    summaries, the packs, the recording, the phase trace lengths the
    fits returned in the traced run)."""
    from test_torch_track import _fixture

    import vistracker_tpu_torch.fit.generator as gen
    import vistracker_tpu_torch.fit.joint as joint
    import vistracker_tpu_torch.fit.smplt as smplt
    from vistracker_tpu_torch.cli.main import build_parser
    from vistracker_tpu_torch.cli.real_track import run_real_track
    from vistracker_tpu_torch.cli.synthetic import box_mesh
    from vistracker_tpu_torch.data.packed import load_packed
    from vistracker_tpu_torch.utils.mesh import save_ply

    tmp = tmp_path_factory.mktemp("tiny_track")
    seq, assets, smpl_pkl = _fixture(tmp, np.random.RandomState(0), T=T)
    obj_root = str(tmp / "objects")
    os.makedirs(os.path.join(obj_root, "boxsmall"))
    save_ply(os.path.join(obj_root, "boxsmall", "boxsmall.ply"), *box_mesh())
    mp = pytest.MonkeyPatch()
    phases = []

    def keep(fn, n_of):
        def call(*a, **k):
            out = fn(*a, **k)
            if trace.enabled():
                phases.append((k.get("phase", a[-1]), n_of(out)))
            return out
        return call
    try:
        mp.setattr(smplt, "SMPLTFitConfig", functools.partial(
            smplt.SMPLTFitConfig, **SHORT_FIT))
        mp.setattr(joint, "JointFitConfig", functools.partial(
            joint.JointFitConfig, **SHORT_JOINT))
        mp.setattr(gen, "GeneratorConfig", functools.partial(
            gen.GeneratorConfig, **GEN_KW))
        mp.setattr(gen, "FUNNEL_DEFAULT", SMALL_FUNNEL)
        mp.setattr(smplt, "_phase", keep(smplt._phase, lambda o: len(o[1])))
        mp.setattr(joint, "_adam_phase",
                   keep(joint._adam_phase, lambda o: int(o[1].shape[0])))
        summaries, packs = [], []
        for on in (False, True):
            args = build_parser().parse_args([
                "track", "--seq", seq, "--smpl-model", smpl_pkl,
                "--assets", assets, "--objects-root", obj_root,
                "--sifnet-ckpt", "random", "--infiller-ckpt", "random",
                "--smoothnet-smpl-ckpt", "random",
                "--smoothnet-objrot-ckpt", "random", "--tiny-nets",
                "--chunk-size", str(CHUNK), "--net-size", "32",
                "--crop-size", "96", "--device", "cpu", "--redo",
                "--out", str(tmp / f"out{int(on)}")])
            if on:
                with trace.recording() as rec:
                    summaries.append(run_real_track(args))
            else:
                summaries.append(run_real_track(args))
            packs.append(load_packed(summaries[-1]["packed"]))
    finally:
        mp.undo()
    return summaries, packs, rec, phases


def test_tiny_track_traced_equals_untraced(tiny_track):
    _, (off, on), _, _ = tiny_track
    assert set(off) == set(on)
    for k, v in off.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(on[k], v, err_msg=k)
        else:
            assert on[k] == v, k


def test_tiny_track_stage_spans_are_the_stage_seconds(tiny_track):
    (_, summary), _, rec, _ = tiny_track
    spans = rec.spans
    assert [s.path for s in spans if s.parent is None] == ["track"]
    totals = {}
    for s in spans:
        if s.parent == "track" and s.name in summary["stage_seconds"]:
            totals[s.name] = totals.get(s.name, 0.0) \
                + (s.end_ns - s.start_ns) / 1e9
    ran = {k for k, v in summary["stage_seconds"].items() if v > 0}
    assert ran == set(totals) and {"stage1", "stage2", "stage6a",
                                   "stage6b"} <= ran
    for stage, secs in summary["stage_seconds"].items():
        assert abs(totals.get(stage, 0.0) - secs) < 1e-3, stage
    paths = {s.path for s in spans}
    for want in ("track/setup/models", "track/setup/object",
                 "track/stage1/frame_inputs",
                 "track/stage1/smplt.phase:global/step/forward",
                 "track/stage1/smplt.phase:all/step/adam",
                 "track/stage2/smooth", "track/stage2/smplt.phase:all/step",
                 "track/stage3/render", "track/stage3/readback",
                 "track/stage3/lbs", "track/inputs/frame/read",
                 "track/inputs/frame/crop",
                 "track/stage4_encode/encode.slice",
                 "track/stage4_harvest/harvest.round/draw",
                 "track/stage6a/joint.phase:betas/step/backward",
                 "track/stage6a/joint.phase:pose/step/adam",
                 "track/stage5/smooth", "track/stage5/infill",
                 "track/stage6b/sil_refs", "track/stage6b/contact_plans",
                 "track/stage6b/joint.phase:obj/step",
                 "track/stage6b/joint.phase:sil/step/backward",
                 "track/stage6b/joint.phase:joint/step/forward",
                 "track/pack/save"):
        assert want in paths, want


def test_tiny_track_adam_steps_are_the_loss_traces(tiny_track):
    """Each phase's adam_steps counters add up to the steps of the loss
    traces its phases returned, and the draw spans to draw_seconds."""
    (_, summary), _, rec, phases = tiny_track
    want = {}
    for phase, n in phases:
        want[phase] = want.get(phase, 0) + n
    assert set(want) == {"global", "all", "betas", "pose", "obj", "sil",
                         "joint"}
    got = {}
    for path, cnt in rec.counters.items():
        phase = path.rsplit(":", 1)[1]
        got[phase] = got.get(phase, 0) + cnt["adam_steps"]
        assert set(cnt) == {"adam_steps"}
    assert got == want
    draws = sum(s.end_ns - s.start_ns for s in rec.spans if s.name == "draw")
    assert abs(draws / 1e9 - summary["draw_seconds"]) < 1e-6


def test_track_trace_out_writes_the_chrome_file(tmp_path):
    """`track --trace-out` records the call and writes its spans."""
    from vistracker_tpu_torch.cli.main import main
    out = tmp_path / "trace.json"
    main(["track", "--synthetic", "--frames", "4", "--device", "cpu",
          "--out", str(tmp_path / "run"), "--trace-out", str(out)])
    assert not trace.enabled()
    events = json.loads(out.read_text())["traceEvents"]
    paths = {e["args"]["path"] for e in events if e["ph"] == "X"}
    assert "smplt.phase:global/step/backward" in paths
    assert any(p.startswith("joint.phase:joint/step") for p in paths)
    assert any(e["ph"] == "C" and e["name"] == "adam_steps" for e in events)
