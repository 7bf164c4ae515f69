"""scripts/run_fixture_eval_torch.py and the scripts that read its run
folders (prewarm_sample_cache_torch, diagnose_fixture_torch,
ablate_stage6_terms_torch, select_seed_by_val_torch, b_ladder_torch)
against the JAX scripts, on the CPU, at the JAX runner test's toy sizes:
--frames 2 --raster 64 --net-size 64 --crop-size 256 --chunk-size 2
--sif-epochs 1 --sif-samples 64.

Both packages read one fixture folder, written by the port's generate
phase. Tolerances: triplane masks, sample sets, SmoothNet windows and the
track command line equal; training images within 1e-6; one SIF-Net
gather step's loss within 1e-4 relative; the eval report within 1e-4
relative (1e-3 for the chamfer entries: the float32 expansion at camera
distance, ROADMAP Queue 3 finding (g); a std within that share of its
mean); the diagnostics within 1e-4; the
ablation's term rows within 1e-3 of each term's largest entry. The whole
`track` is not rerun here: tests/test_torch_track.py holds it to JAX."""
import argparse
import importlib.util
import json
import os
import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
TOY = ["--frames", "2", "--raster", "64", "--net-size", "64",
       "--crop-size", "256", "--chunk-size", "2", "--sif-epochs", "1",
       "--sif-samples", "64"]
CHAMF_REL = 1e-3


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, SCRIPTS)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(SCRIPTS)
    return mod


rf = _script("run_fixture_eval_torch")
jrf = _script("run_fixture_eval")


def _args(out, jax_side=False, **over):
    """The toy arguments of either script, from its own parser."""
    mod = jrf if jax_side else rf
    argv = [*TOY, "--out", str(out),
            "--results", os.path.join(str(out), "res.json"),
            "--heldout-results", os.path.join(str(out), "res_ho.json")]
    args = mod.build_parser().parse_args(
        argv + (["--cpu"] if jax_side else ["--device", "cpu"]))
    for k, v in over.items():
        assert hasattr(args, k), k
        setattr(args, k, v)
    return args


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run folder holding the fixture (the port's generate phase) and a
    recon pack of it: the GT moved (rotations as matrices, the object 4 cm
    off, the body 1 cm off) with neural fields."""
    from scipy.spatial.transform import Rotation
    from vistracker_tpu_torch.data.packed import load_packed, save_packed
    root = tmp_path_factory.mktemp("fixture_run")
    rf.run_phase(_args(root, phase="generate"))
    m = np.load(root / "fixture_meta.npz")
    fx = {k: m[k] for k in m.files}
    gt = load_packed(str(fx["gt_pack"]))
    rng = np.random.RandomState(3)
    T = len(gt["poses"])
    rot = Rotation.from_rotvec(np.asarray(gt["obj_angles"])).as_matrix()
    wobble = Rotation.from_rotvec(rng.randn(T, 3) * 0.2).as_matrix()
    recon = dict(
        gt, poses=np.asarray(gt["poses"]) + rng.randn(T, 156).astype(
            np.float32) * 0.02,
        trans=np.asarray(gt["trans"]) + 0.01,
        obj_angles=(wobble @ rot).transpose(0, 2, 1).astype(np.float32),
        obj_trans=np.asarray(gt["obj_trans"]) + 0.04,
        obj_scales=np.ones(T, np.float32),
        neural_pca=np.stack([np.linalg.qr(rng.randn(3, 3))[0]
                             for _ in range(T)]).astype(np.float32),
        neural_trans=rng.randn(T, 3).astype(np.float32) * 0.2,
        neural_visibility=np.array([0.9, 0.3], np.float32)[:T],
        recon_exist=np.ones(T, bool))
    save_packed(str(root / "recon" / "recon_fixture"
                    / f"{fx['seq_name']}_k1.pkl"), recon)
    return root


@pytest.fixture(scope="module")
def fx(run_dir):
    m = np.load(run_dir / "fixture_meta.npz")
    out = {k: m[k] for k in m.files}
    out.update({k: str(out[k]) for k in ("seq_dir", "gt_pack", "model_pkl",
                                          "objects_root", "seq_name")})
    return out


@pytest.fixture(scope="module")
def frames(run_dir, fx):
    """The port's training frames and the part labels."""
    from vistracker_tpu_torch.core.landmarks import (load_landmarks,
                                                     load_part_labels,
                                                     part_labels_array)
    from vistracker_tpu_torch.core.smpl import load_smpl_pkl
    assets = str(run_dir / "data" / "assets")
    model = load_smpl_pkl(fx["model_pkl"])
    fr, _, _ = rf.build_training_frames(fx, model, load_landmarks(assets),
                                        256, 64, "cpu")
    labels = np.asarray(part_labels_array(
        load_part_labels(assets), num_verts=model.v_template.shape[0]))
    return fr, labels


# ---------------------------------------------------------------------------
# plumbing
# ---------------------------------------------------------------------------

def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices,
                     type(a).__name__) for a in parser._actions}


def test_parser_has_every_jax_option_with_its_default():
    mine, theirs = _options(rf.build_parser()), _options(jrf.build_parser())
    assert set(theirs) - {"cpu", "sil_backend"} == set(mine) - {"device"}
    for dest in set(mine) - {"device"}:
        assert mine[dest] == theirs[dest], dest
    assert mine["device"][:2] == (("--device",), "cuda")
    assert rf.PHASES == jrf.PHASES
    assert rf.HELDOUT_PHASES == jrf.HELDOUT_PHASES


@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_default_results_are_the_ports_own(preset):
    args = rf.default_results(rf.build_parser().parse_args(
        ["--net-preset", preset]))
    suf = "" if preset == "tiny" else "_small"
    assert args.results == f"results/fixture_eval_torch{suf}.json"
    assert args.heldout_results == \
        f"results/fixture_eval_torch_heldout{suf}.json"
    for path in (args.results, args.heldout_results):
        assert re.fullmatch(r"results/fixture_eval_torch[\w]*\.json", path)


def test_forwarded_args_roundtrip_every_option(tmp_path):
    args = _args(tmp_path, recon_tag="xs", collision=True, ocent=0.25,
                 fast_gen=True, train_seqs=3, object_shape="lbox")
    back = rf.build_parser().parse_args(rf.forwarded_args(args))
    for k, v in vars(args).items():
        if k in ("phase", "single_process"):
            continue
        assert getattr(back, k) == v, k


@pytest.mark.parametrize("over", [
    dict(recon_tag="b7"), dict(recon_tag="coll", collision=True),
    dict(ocent=0.25), dict(fast_gen=True)],
    ids=["recon-tag", "collision", "ocent", "fast-gen"])
def test_track_phase_builds_the_jax_command_line(run_dir, monkeypatch, over):
    """The track phase's `track` arguments, parsed by each package's
    command line, agree on every option both have; the port adds --device
    and the recon folder carries the tag."""
    import vistracker_tpu.cli.real_track as jrt
    import vistracker_tpu_torch.cli.real_track as trt
    got = {}
    monkeypatch.setattr(trt, "run_real_track",
                        lambda targs: got.update(port=vars(targs)))
    monkeypatch.setattr(jrt, "run_real_track",
                        lambda targs: got.update(jax=vars(targs)))
    rf.run_phase(_args(run_dir, phase="track", **over))
    jrf.run_phase(_args(run_dir, jax_side=True, phase="track", **over))
    port, jax_ = got["port"], got["jax"]
    tag = over.get("recon_tag")
    assert port["out"] == os.path.join(str(run_dir), "recon" + (
        f"_{tag}" if tag else ""))
    assert port["device"] == "cpu"
    assert port["collision"] is bool(over.get("collision", False))
    assert port["fast_gen"] is bool(over.get("fast_gen", False))
    assert port["ocent"] == pytest.approx(over.get("ocent", 0.0))
    shared = (set(port) & set(jax_)) - {"device"}
    assert {"out", "seq", "sifnet_ckpt", "segment_iters", "robust_centers",
            "chunk_size", "net_size", "crop_size", "save_name"} <= shared
    for k in shared:
        assert port[k] == jax_[k], k


# ---------------------------------------------------------------------------
# training inputs
# ---------------------------------------------------------------------------

def test_build_training_frames_matches_jax(run_dir, fx, frames):
    from vistracker_tpu.core.landmarks import load_landmarks
    from vistracker_tpu.core.smpl import load_smpl_pkl
    jfr, jv, jf = jrf.build_training_frames(
        fx, load_smpl_pkl(fx["model_pkl"]),
        load_landmarks(str(run_dir / "data" / "assets")), 256, 64)
    mine = frames[0]
    assert len(mine) == len(jfr) == 2
    for a, b in zip(mine, jfr):
        assert set(a) == set(b)
        assert a["image"].shape == b["image"].shape == (64, 64, 8)
        np.testing.assert_array_equal(a["image"][..., 5:],
                                      b["image"][..., 5:])
        np.testing.assert_allclose(a["image"][..., :5], b["image"][..., :5],
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(a["crop_center"], b["crop_center"])
        for k in ("body_center", "smpl_verts", "obj_verts"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5,
                                       err_msg=k)
        for k in ("smpl_faces", "obj_faces"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a["visibility"] == b["visibility"]


def test_sample_cache_is_jaxs_and_reads_both_ways(frames, tmp_path):
    """build_sample_set on the same frames: the same file names and the
    same arrays bit for bit; each package then reads the other's folder
    without rebuilding."""
    fr, labels = frames
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    assert os.path.basename(rf.sample_cache_dir("x", 64, 0.15)) == \
        os.path.basename(jrf.sample_cache_dir("x", 64, 0.15))
    for d in (mine, theirs):
        d.mkdir()
    keys = [(0, 0), (1, 5)]
    for i, slot in keys:
        a = rf.build_sample_set(fr, labels, i, slot, 64, 0.15, str(mine))
        b = jrf.build_sample_set(fr, labels, i, slot, 64, 0.15, str(theirs))
        assert set(a) == set(b) and "images" not in a
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs)) == [
        "f0000_p0.npz", "f0001_p5.npz"]
    stamps = {p: os.stat(p).st_mtime_ns for d in (mine, theirs)
              for p in (str(d / f) for f in os.listdir(d))}
    for i, slot in keys:
        a = rf.build_sample_set(None, None, i, slot, 64, 0.15, str(theirs))
        b = jrf.build_sample_set(None, None, i, slot, 64, 0.15, str(mine))
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert stamps == {p: os.stat(p).st_mtime_ns for p in stamps}


def test_prewarm_builds_the_trainers_files(run_dir, frames, tmp_path):
    """prewarm_sample_cache_torch.py's frames are the trainer's without
    the image (its CPU skinning within 1e-5), and the sets it writes are
    what build_sample_set gives on those frames."""
    pw = _script("prewarm_sample_cache_torch")
    out = tmp_path / "run"
    out.mkdir()
    shutil.copy(run_dir / "fixture_meta.npz", out / "fixture_meta.npz")
    res = pw.main(["--out", str(out), "--sif-samples", "64",
                   "--grid-ratio", "0.15", "--pool", "2"])
    assert (res["built"], res["skipped"]) == (4, 0)
    pframes, plabels = pw.sample_frames(pw.training_metas(str(out)))
    fr, labels = frames
    np.testing.assert_array_equal(plabels, labels)
    for a, b in zip(pframes, fr):
        np.testing.assert_array_equal(a["crop_center"], b["crop_center"])
        for k in ("body_center", "smpl_verts", "obj_verts"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5)
    ref = rf.build_sample_set(pframes, plabels, 1, 1, 64, 0.15,
                              str(tmp_path))
    with np.load(out / "sample_cache_s64_g0.15" / "f0001_p1.npz") as z:
        for k in ref:
            np.testing.assert_array_equal(z[k], ref[k], err_msg=k)
    assert pw.main(["--out", str(out), "--sif-samples", "64",
                    "--grid-ratio", "0.15", "--pool", "2"])["built"] == 0


def test_sifnet_gather_step_matches_jax(frames):
    """One step of the harness's SIF-Net (the tiny preset with remat, the
    df clamp at 1.0) on a batch that carries frame indices, the images
    gathered from the stack held on the device: the port's loss within
    1e-4 relative of the JAX step's from the same weights (a port init
    carried into flax by the JAX package's models/torch_import.py and back
    by models/weights.py); the validation loss of the same forward equal
    to it. The JAX step runs without remat, which changes no value."""
    from vistracker_tpu.core.camera import PerspectiveCamera as JCam
    from vistracker_tpu.fit.train import TrainConfig as JTC
    from vistracker_tpu.fit.train import TrainState as JState
    from vistracker_tpu.fit.train import make_optimizer as jopt
    from vistracker_tpu.fit.train import make_train_step as jstep
    from vistracker_tpu.models import torch_import as ti
    from vistracker_tpu.models.sifnet import SIFNet as JNet
    from vistracker_tpu.models.sifnet import sifnet_preset as jpreset
    from vistracker_tpu_torch.core.camera import PerspectiveCamera
    from vistracker_tpu_torch.fit.train import TrainConfig, init_train_state
    from vistracker_tpu_torch.models.sifnet import SIFNet, sifnet_preset
    from vistracker_tpu_torch.models.weights import (
        init_random_, sifnet_state_dict_from_flax)

    fr, labels = frames
    ex = [dict(_example(fr, labels, i), frame_idx=np.int32(i))
          for i in (1, 0)]
    batch = {k: np.stack([e[k] for e in ex]) for k in ex[0]}
    images = np.stack([f["image"] for f in fr])

    cfg = sifnet_preset("tiny", crop_size=256, remat=True)
    net = init_random_(SIFNet(cfg, PerspectiveCamera(crop_size=256)),
                       torch.Generator().manual_seed(0))
    jcfg = jpreset("tiny", crop_size=256)
    variables = jax.tree.map(jnp.asarray, ti.sifnet_params(
        {k: v.numpy() for k, v in net.state_dict().items()}, jcfg))
    net.load_state_dict(sifnet_state_dict_from_flax(
        jax.tree.map(np.asarray, variables), cfg))
    jtc = JTC(max_dist=1.0)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "frame_idx"}
    jb["images"] = jnp.asarray(images)[batch["frame_idx"]]
    jstate = JState(params=variables, opt_state=jopt(jtc).init(variables),
                    step=jnp.zeros((), jnp.int32))
    _, jloss, _ = jstep(JNet(jcfg, JCam(crop_size=256)), jtc)(jstate, jb)

    tc = TrainConfig(max_dist=1.0)
    step, val_loss = rf.make_gather_step(net, tc, torch.as_tensor(images))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    state = init_train_state(net, tc)
    with torch.no_grad():
        before = float(val_loss(state, tb))
    state, loss, _ = step(state, tb)
    assert state.step == 1
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(before, float(loss), rtol=1e-6)


def _example(fr, labels, i):
    """Frame i's sample set (slot 0) without writing a cache file."""
    from vistracker_tpu_torch.data.datasets import sifnet_example
    built = sifnet_example(fr[i], labels, num_samples=64, grid_ratio=0.15,
                           rng=np.random.RandomState(i * 7919 + 13))
    return {k: v for k, v in built.items() if k != "images"}


def _jax_windows(fxs, W=64):
    """The JAX script's SmoothNet windows (run_fixture_eval.py:263-282)."""
    from vistracker_tpu.core.rotations import (axis_angle_to_rot6d,
                                               rotmat_to_rot6d)
    from vistracker_tpu.fit.smoothing import smplh_to_smpl_pose
    from vistracker_tpu.ops.window_ops import pad_to_window, seq_to_windows
    feats, rots = [], []
    for fx in fxs:
        T = len(fx["poses"])
        p72 = smplh_to_smpl_pose(fx["poses"])
        rot6d = np.asarray(axis_angle_to_rot6d(
            jnp.asarray(p72.reshape(-1, 3)))).reshape(T, 144)
        feats.append(np.concatenate([rot6d, fx["betas"], fx["trans"]],
                                    1).astype(np.float32))
        rots.append(np.asarray(rotmat_to_rot6d(
            jnp.asarray(fx["rot_gt"]))).astype(np.float32))

    def windows(seqs):
        ws = []
        for s in seqs:
            padded, _ = pad_to_window(s, W)
            w = np.asarray(seq_to_windows(jnp.asarray(padded), W, 1))
            ws.append(w.transpose(0, 2, 1))
        return np.concatenate(ws, 0)
    return windows(feats), windows(rots)


def test_smoothnet_windows_and_infiller_clips_match_jax(fx):
    """Windows over the fixture and a 75-frame sequence (12 windows that
    stop at its boundary); the infiller's tiled sequences."""
    from scipy.spatial.transform import Rotation
    rng = np.random.RandomState(5)
    T = 75
    long = dict(poses=(rng.randn(T, 156) * 0.3).astype(np.float32),
                betas=np.tile(rng.randn(1, 10), (T, 1)).astype(np.float32),
                trans=rng.randn(T, 3).astype(np.float32),
                rot_gt=Rotation.random(T, random_state=5).as_matrix()
                .astype(np.float32))
    fxs = [fx, long]
    mine, theirs = rf.smoothnet_windows(fxs), _jax_windows(fxs)
    for a, b in zip(mine, theirs):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert mine[0].shape == (1 + 12, 157, 64) and mine[1].shape[1] == 6
    seqs = rf.infiller_sequences(fxs, 180)
    assert [len(s["poses"]) for s in seqs] == [220, 225]
    np.testing.assert_array_equal(seqs[1]["obj_rot_real"][150],
                                  long["rot_gt"][0])


# ---------------------------------------------------------------------------
# the scripts that read a run folder
# ---------------------------------------------------------------------------

@pytest.fixture
def few_samples(monkeypatch):
    """Both evaluators with 500 chamfer samples a surface."""
    from vistracker_tpu.eval import evaluator as jev
    from vistracker_tpu_torch.eval import evaluator as tev
    for mod in (jev, tev):
        orig = mod.chamfer_error
        monkeypatch.setattr(mod, "chamfer_error",
                            lambda *a, _o=orig, **k: _o(*a[:4], 500, **k))


def _assert_json_close(got, want, rel, path="", scale=None):
    """Nested reports equal up to rel (CHAMF_REL for the chamfer entries);
    a std within the same share of its mean, since a std of nearly equal
    per-frame errors is their small difference."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_json_close(got[k], want[k], rel, f"{path}/{k}",
                               want.get("mean"))
    elif isinstance(want, float):
        tol = CHAMF_REL if "_chamf" in path else rel
        atol = tol * abs(scale) if path.endswith("/std") else 1e-9
        np.testing.assert_allclose(got, want, rtol=tol, atol=atol,
                                   err_msg=path)
    elif path != "/note":
        assert got == want, path


def test_eval_phase_report_matches_jax(run_dir, few_samples, capsys):
    ta = _args(run_dir, phase="eval")
    ja = _args(run_dir, jax_side=True, phase="eval",
               results=os.path.join(str(run_dir), "res_jax.json"))
    rf.run_phase(ta)
    jrf.run_phase(ja)
    with open(ta.results) as f:
        got = json.load(f)
    with open(ja.results) as f:
        want = json.load(f)
    assert set(got) == {"frames", "net_preset", "train_seqs", "note",
                        "W1_chore_protocol", "W300_video_protocol"}
    assert got["W1_chore_protocol"]["smpl_v2v"]["mean"] > 0
    _assert_json_close(got, want, 1e-4)


def test_diagnose_matches_jax(run_dir, monkeypatch):
    """diagnose_fixture_torch.py's report (returned and written to
    diagnostics_torch.json, beside the JAX script's diagnostics.json)
    within 1e-4 of the JAX script's on the same run folder."""
    dg, jdg = _script("diagnose_fixture_torch"), _script("diagnose_fixture")
    got = dg.main(["--run", str(run_dir), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["diagnose_fixture.py", "--run",
                                      str(run_dir), "--cpu"])
    jdg.main()
    with open(run_dir / "diagnostics.json") as f:
        want = json.load(f)
    with open(run_dir / "diagnostics_torch.json") as f:
        written = json.load(f)
    assert set(got) == set(want) == set(written) == {
        "neural_center_m", "pred_vis_corr", "rot_init_deg", "rot_final_deg",
        "t_final_m", "smpl_v2v_cm"}
    for k, v in want.items():
        for sub, x in (v.items() if isinstance(v, dict) else [(None, v)]):
            mine = [r[k] if sub is None else r[k][sub]
                    for r in (got, written)]
            if x is None:
                assert mine == [None, None], (k, sub)
            else:
                np.testing.assert_allclose(mine, [x, x], rtol=1e-4,
                                           atol=1e-4, err_msg=f"{k} {sub}")


def _checkpoints(run_dir, root):
    """Two copies of the run folder sharing one set of weights: a JAX one
    with orbax checkpoints and a port one with torch checkpoints. Each net
    (the tiny SIF-Net at crop 256, the object-rotation SmoothNet, HVOP-Net)
    is a port init carried into flax by the JAX package's
    models/torch_import.py and back by models/weights.py."""
    from vistracker_tpu.fit.trainer_loop import CheckpointIO
    from vistracker_tpu.models import torch_import as ti
    from vistracker_tpu.models.sifnet import sifnet_preset as jpreset
    from vistracker_tpu_torch.core.camera import PerspectiveCamera
    from vistracker_tpu_torch.models import weights
    from vistracker_tpu_torch.models.infiller import (ConditionalMInfiller,
                                                      InfillerConfig)
    from vistracker_tpu_torch.models.sifnet import SIFNet, sifnet_preset
    from vistracker_tpu_torch.models.smoothnet import SmoothNet

    runs = {}
    for side in ("jax", "port"):
        d = root / side
        shutil.copytree(run_dir / "recon", d / "recon")
        shutil.copy(run_dir / "fixture_meta.npz", d / "fixture_meta.npz")
        runs[side] = d
    g = torch.Generator().manual_seed(5)
    cfg = sifnet_preset("tiny", crop_size=256)
    nets = {
        "sifnet": (SIFNet(cfg, PerspectiveCamera(crop_size=256)),
                   lambda sd: ti.sifnet_params(sd, jpreset("tiny",
                                                           crop_size=256)),
                   lambda p: weights.sifnet_state_dict_from_flax(p, cfg)),
        "sn_rot": (SmoothNet(window_size=64, output_size=64),
                   ti.smoothnet_params, weights.smoothnet_state_dict_from_flax),
        "infiller": (ConditionalMInfiller(InfillerConfig()),
                     lambda sd: ti.infiller_params(sd, InfillerConfig()),
                     weights.infiller_state_dict_from_flax)}
    for name, (net, to_flax, to_port) in nets.items():
        sd = {k: v.numpy() for k, v in
              weights.init_random_(net, g).state_dict().items()}
        flax = to_flax(sd)
        ck = runs["port"] / name / "checkpoints"
        ck.mkdir(parents=True)
        torch.save({"model_state_dict": to_port(flax), "step": 1,
                    "epoch": 39}, ck / "checkpoint_0h:0m:1s_1.0.tar")
        CheckpointIO(str(runs["jax"] / name)).save(1, {"params": flax})
    return runs


def test_ablate_term_rows_match_jax(run_dir, tmp_path, monkeypatch):
    """Both ablation scripts on the 2-frame run folder with the same
    weights and 64^2 silhouettes: the same terms; each term's row
    (pull_all, pull_vis, pull_occ, value) at the init and the final point
    within 1e-3 of the row's largest entry, the NET row within the sum of
    its terms' allowances. The object term's pull is the loosest: -5.876
    against JAX's -5.900 at init while its value agrees to 2e-6 relative
    (the two packages' SIF-Net features differ by up to 1e-4,
    tests/test_torch_sifnet.py, and the object term's gradient passes
    through the df clamp and the bilinear cells of the untrained net)."""
    import functools
    from vistracker_tpu.fit import joint as jjoint
    from vistracker_tpu_torch.fit import joint as tjoint
    for mod in (jjoint, tjoint):  # 64^2 silhouettes in both
        monkeypatch.setattr(mod, "JointFitConfig", functools.partial(
            mod.JointFitConfig, sil_size=64))
    runs = _checkpoints(run_dir, tmp_path)
    common = ["--net-preset", "tiny", "--chunk-size", "2", "--net-size",
              "64", "--crop-size", "256"]
    ab, jab = (_script("ablate_stage6_terms_torch"),
               _script("ablate_stage6_terms"))
    got = ab.main(["--run", str(runs["port"]), *common, "--device", "cpu",
                   "--out", str(tmp_path / "port.json")])
    monkeypatch.setattr(sys, "argv", [
        "ablate_stage6_terms.py", "--run", str(runs["jax"]), *common,
        "--cpu", "--out", str(tmp_path / "jax.json")])
    jab.main()
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    # no temporal term in a chunk of 2 frames (both packages need 4)
    terms = {"contact", "mask", "object", "ocent", "NET"}
    for point in ("init", "final"):
        assert set(got[point]) == set(want[point]) == terms, point
        scale = {t: max(abs(v) for v in row.values()
                        if v is not None and np.isfinite(v))
                 for t, row in want[point].items()}
        # NET sums the terms but ocent (off at --ocent 0): within the sum
        # of their allowances
        scale["NET"] = sum(scale[t] for t in terms - {"NET", "ocent"})
        for term, row in want[point].items():
            for k, v in row.items():
                if v is None or not np.isfinite(v):
                    # no frame of the kind (the JAX script's NET row
                    # writes the mean of none, NaN; the port None)
                    assert got[point][term][k] is None, (point, term, k)
                else:
                    assert abs(got[point][term][k] - v) <= \
                        1e-3 * scale[term], (point, term, k,
                                             got[point][term][k], v)


def test_select_seed_probe_scores_a_checkpoint(run_dir, tmp_path,
                                              monkeypatch):
    """select_seed_by_val_torch.py on a tiny torch checkpoint (a small
    funnel harvest): it writes its validation fixture (motion seed 2),
    reports a finite center error and merges its probe into --out-json,
    replacing an earlier probe of the same checkpoint."""
    from test_torch_track import SMALL_FUNNEL
    from vistracker_tpu_torch.fit import generator
    monkeypatch.setattr(generator, "FUNNEL_DEFAULT", SMALL_FUNNEL)
    ss = _script("select_seed_by_val_torch")
    runs = _checkpoints(run_dir, tmp_path)
    ckpt = str(runs["port"] / "sifnet")
    with open(tmp_path / "probes.json", "w") as f:
        json.dump({"note": "n", "probes": [{"ckpt": ckpt, "step": -5},
                                           {"ckpt": "other"}]}, f)
    rep = ss.main(["--out", str(tmp_path / "val"), "--ckpt", ckpt,
                   "--net-preset", "tiny", "--frames", "2", "--raster",
                   "64", "--net-size", "64", "--crop-size", "256",
                   "--batch", "2", "--device", "cpu",
                   "--out-json", str(tmp_path / "probes.json")])
    assert (rep["step"], rep["frames"], rep["val_motion_seed"]) == (1, 2, 2)
    assert np.isfinite(rep["center_m"]) and rep["center_m"] > 0
    assert os.path.isfile(tmp_path / "val" / "fixture_val_meta.npz")
    with open(tmp_path / "probes.json") as f:   # vis_corr is NaN here:
        got = json.dumps(json.load(f), sort_keys=True)  # GT occlusion
    assert got == json.dumps({"note": "n", "probes": [  # is constant
        {"ckpt": "other"}, rep]}, sort_keys=True)


def test_b_ladder_drives_track_and_eval_phases(tmp_path, monkeypatch):
    """b_ladder_torch.py with the phase processes faked: for each chunk
    size the runner's track then eval phase with the size's recon tag,
    its device and the run's extra options; the table from the eval
    report and the track summary; a size already measured is skipped."""
    bl = _script("b_ladder_torch")
    calls = []

    def fake_run(cmd):
        opts = dict(zip(cmd[2::2], cmd[3::2]))
        calls.append((cmd[cmd.index("--phase") + 1], opts))
        tag = opts["--recon-tag"]
        if calls[-1][0] == "track":
            d = tmp_path / "out" / f"recon_{tag}" / "recon_fixture"
            d.mkdir(parents=True)
            with open(d / "seq_k1_track.json", "w") as f:
                json.dump({"fps": 2.5}, f)
        else:
            rows = {k: {"mean": float(len(tag)), "std": 0.0} for k in (
                "smpl_v2v", "obj_v2v", "smpl_chamf", "obj_chamf")}
            with open(opts["--results"], "w") as f:
                json.dump({"W1_chore_protocol": rows}, f)
        return argparse.Namespace(returncode=0)

    monkeypatch.setattr(bl.subprocess, "run", fake_run)
    results = str(tmp_path / "ladder.json")
    argv = ["--out", str(tmp_path / "out"), "--net-preset", "tiny",
            "--sizes", "2,12", "--results", results, "--device", "cpu",
            "--extra", "--frames", "2"]
    rep = bl.main(argv)
    assert [c[0] for c in calls] == ["track", "eval"] * 2
    for phase, opts in calls:
        assert opts["--device"] == "cpu" and opts["--frames"] == "2"
        assert opts["--recon-tag"] == f"b{opts['--chunk-size']}"
    assert rep["ladder"]["12"]["obj_v2v_cm"] == 3.0
    assert rep["ladder"]["2"]["fps_tracked"] == 2.5
    with open(results) as f:
        assert json.load(f) == rep
    calls.clear()
    bl.main(argv)
    assert calls == []
