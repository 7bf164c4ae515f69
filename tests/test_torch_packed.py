"""The port's packed files (data/packed.py) and its `evaluate`, `unpack`,
`pack` and `rename-masks` subcommands (cli/main.py) against the JAX
package: packs written by the JAX package (joblib) read by the port, the
per-frame round trips, and the evaluation JSON of both command lines on
the same files in split, single-sequence and frame-folder modes."""
import argparse
import json
import os
import pickle

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from vistracker_tpu.cli.main import build_parser as jax_parser
from vistracker_tpu.cli.main import main as jax_main
from vistracker_tpu.data import packed as jax_packed
from vistracker_tpu_torch.cli.main import build_parser
from vistracker_tpu_torch.cli.main import main as port_main
from vistracker_tpu_torch.data import packed
from vistracker_tpu_torch.eval import evaluator
from vistracker_tpu_torch.utils.mesh import save_ply

from test_real_track import _make_fake_smplh_pkl

torch.set_num_threads(1)

# evaluation JSON, relative. v2v and acceleration: float64 numpy on LBS
# verts that agree to float32 rounding.
REL = 1e-4
# The chamfers: the same samples, but the scene sits 2.2-2.3 m from the
# origin, as in a camera frame, so |x|^2 + |y|^2 - 2 x.y cancels values
# near 10 m^2 whose float32 ulp is 9.5e-7 m^2; the packages round in
# different orders (JAX's matmul, the port's fixed order), which moves a
# (3 mm)^2 nearest distance by a few percent. Over 500 samples a frame's
# chamfer then differs by up to 1.8e-4 of itself (measured; the object's
# 12-face box is the worst), its mean and spread over frames by less.
CHAMF_REL = 1e-3
# the command lines sample 10,000 surface points a chamfer; both packages
# take this many here, to keep the CPU time down
SAMPLES = 500


def _mixed_pack(rng, T=5):
    return dict(poses=rng.randn(T, 156).astype(np.float32),
                trans=rng.randn(T, 3),                      # float64
                recon_exist=rng.rand(T) < 0.7,              # bool
                part_ids=rng.randint(0, 14, (T, 7)),        # int64
                small_ints=np.arange(T, dtype=np.int32),
                obj_angles=np.asfortranarray(rng.randn(3, 3)),
                frames=[f"t{i:04d}.000" for i in range(T)],
                gender="female", obj_scale=1.25)


def _assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert isinstance(got[k], np.ndarray), k
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v)
        else:
            assert type(got[k]) is type(v) and got[k] == v, k


def test_load_packed_reads_jax_joblib_packs(rng, tmp_path):
    """The JAX package's save_packed writes with joblib, whose numpy arrays
    follow their wrapper as raw bytes: pickle.load fails on such a file
    ("invalid load key"); the port's load_packed returns the same dict."""
    want = _mixed_pack(rng)
    path = str(tmp_path / "jax.pkl")
    jax_packed.save_packed(path, want)
    with open(path, "rb") as f, pytest.raises(pickle.UnpicklingError):
        pickle.load(f)
    _assert_same(packed.load_packed(path), want)
    rec = jax_packed.PackedRecon(
        poses=want["poses"], betas=np.zeros((5, 10), np.float32),
        trans=want["trans"], obj_angles=np.tile(np.eye(3), (5, 1, 1)),
        obj_trans=np.ones((5, 3)), obj_scales=np.ones(5),
        frames=want["frames"], recon_exist=want["recon_exist"])
    jax_packed.save_packed(path, rec)
    got = packed.load_packed_recon(path)
    ref = jax_packed.load_packed_recon(path)
    for f in ("poses", "betas", "trans", "obj_angles", "obj_trans",
              "obj_scales", "recon_exist"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    assert got.frames == ref.frames and got.gender == ref.gender
    assert got.num_frames == 5


@pytest.mark.parametrize("compress", ["zlib", "gzip", "bz2", "xz", "lzma"])
def test_compressed_joblib_is_refused_by_name(rng, tmp_path, compress):
    import joblib
    path = str(tmp_path / "c.pkl")
    joblib.dump(_mixed_pack(rng), path, compress=(compress, 3))
    with pytest.raises(ValueError, match=f"{compress}-compressed"):
        packed.load_packed(path)


def test_port_packs_are_plain_pickles(rng, tmp_path):
    """The port writes protocol-4 pickles, which its own reader, pickle and
    the JAX package's joblib reader all read."""
    want = _mixed_pack(rng)
    path = str(tmp_path / "sub" / "port.pkl")
    packed.save_packed(path, want)
    _assert_same(packed.load_packed(path), want)
    _assert_same(jax_packed.load_packed(path), want)
    with open(path, "rb") as f:
        _assert_same(pickle.load(f), want)
    assert packed.RECON_KEYS == jax_packed.RECON_KEYS


def test_frame_files_round_trip_like_jax(rng, tmp_path):
    """unpack_to_frames writes the files the JAX function writes (and skips
    frames already written); pack_from_frames gathers the same dict,
    dummy-filling a frame without files."""
    T = 4
    src = dict(poses=rng.randn(T, 156).astype(np.float32),
               betas=rng.randn(T, 10).astype(np.float32),
               trans=rng.randn(T, 3).astype(np.float32),
               obj_angles=Rotation.from_rotvec(rng.randn(T, 3)).as_matrix()
               .astype(np.float32),
               obj_trans=rng.randn(T, 3).astype(np.float32),
               obj_scales=rng.rand(T) + 0.5,
               frames=[f"t{i:04d}.000" for i in range(T)])
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    written = packed.unpack_to_frames(src, port_dir, "fit", kid=2)
    assert written == src["frames"]
    jax_packed.unpack_to_frames(src, jax_dir, "fit", kid=2)
    assert packed.unpack_to_frames(src, port_dir, "fit", kid=2) == []
    for frame in src["frames"]:
        for kind in ("smplfit", "objfit"):
            name = os.path.join(frame, f"k2.{kind}_fit.pkl")
            with open(os.path.join(port_dir, name), "rb") as f:
                a = pickle.load(f)
            with open(os.path.join(jax_dir, name), "rb") as f:
                b = pickle.load(f)
            _assert_same(a, b)
    os.remove(os.path.join(port_dir, "t0002.000", "k2.objfit_fit.pkl"))
    os.remove(os.path.join(jax_dir, "t0002.000", "k2.objfit_fit.pkl"))
    got = packed.pack_from_frames(port_dir, src["frames"], "fit", kid=2)
    want = jax_packed.pack_from_frames(jax_dir, src["frames"], "fit", kid=2)
    _assert_same(got, want)
    assert got["recon_exist"].tolist() == [True, True, False, True]
    np.testing.assert_array_equal(got["poses"][[0, 1, 3]],
                                  src["poses"][[0, 1, 3]])


def test_object_verts_like_jax(rng):
    temp = rng.randn(20, 3).astype(np.float32)
    rots = Rotation.from_rotvec(rng.randn(4, 3)).as_matrix()
    trans, scales = rng.randn(4, 3), rng.rand(4) + 0.5
    np.testing.assert_array_equal(
        packed.recon_obj_verts(temp, rots, trans, scales),
        jax_packed.recon_obj_verts(temp, rots, trans, scales))
    aa = rng.randn(4, 3)
    np.testing.assert_array_equal(packed.gt_obj_verts(temp, aa, trans),
                                  jax_packed.gt_obj_verts(temp, aa, trans))


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

def _box():
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], np.float32) * [0.2, 0.1, 0.05]
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                  [1, 5, 7], [1, 7, 3]], np.int32)
    return v + 0.3, f  # off-centre: the single-sequence mode centres it


def _write_packs(tmp_path, rng, seq, T=9, holes=(2, 6)):
    """A GT pack (axis-angle obj_angles) and a recon pack with deviations
    and recon_exist holes, both written by the JAX package (joblib)."""
    poses = (rng.randn(T, 156) * 0.1).astype(np.float32)
    betas = (rng.randn(T, 10) * 0.3).astype(np.float32)
    trans = (np.tile([[0, 0, 2.2]], (T, 1))
             + rng.randn(T, 3) * 0.05).astype(np.float32)
    rotvec = (rng.randn(T, 3) * 0.3).astype(np.float32)
    obj_trans = (np.tile([[0.2, 0, 2.3]], (T, 1))
                 + rng.randn(T, 3) * 0.05).astype(np.float32)
    gt_dir, rec_dir = tmp_path / "gt", tmp_path / "recon_out" / "recon_tr"
    jax_packed.save_packed(str(gt_dir / f"{seq}_GT-packed.pkl"), dict(
        poses=poses, betas=betas, trans=trans, obj_angles=rotvec,
        obj_trans=obj_trans, obj_scales=np.ones(T),
        frames=[f"t{i:04d}.000" for i in range(T)], gender="male"))
    rots = Rotation.from_rotvec(rotvec + rng.randn(T, 3) * 0.05).as_matrix()
    exist = np.ones(T, bool)
    exist[list(holes)] = False
    jax_packed.save_packed(str(rec_dir / f"{seq}_k1.pkl"), dict(
        poses=poses + (rng.randn(T, 156) * 0.02).astype(np.float32),
        betas=betas, trans=trans + 0.01,
        obj_angles=rots.transpose(0, 2, 1).astype(np.float32),
        obj_trans=obj_trans + (rng.randn(T, 3) * 0.01).astype(np.float32),
        obj_scales=np.ones(T), recon_exist=exist,
        frames=[f"t{i:04d}.000" for i in range(T)], gender="male"))
    return str(gt_dir), str(tmp_path / "recon_out")


def _last_line(capsys):
    return capsys.readouterr().out.strip().splitlines()[-1]


def _assert_json_close(got, want, path=""):
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            if k != "time":
                _assert_json_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, float):
        rel = CHAMF_REL if "_chamf" in path else REL
        np.testing.assert_allclose(got, want, rtol=rel, atol=1e-9,
                                   err_msg=path)
    else:
        assert got == want, path


@pytest.fixture
def few_samples(monkeypatch):
    """Both evaluators with SAMPLES chamfer samples a surface."""
    from vistracker_tpu.eval import evaluator as jax_evaluator
    for mod in (jax_evaluator, evaluator):
        orig = mod.chamfer_error
        monkeypatch.setattr(
            mod, "chamfer_error",
            lambda *a, _orig=orig, **k: _orig(*a[:4], SAMPLES, **k))


def _evaluate_both(tmp_path, capsys, args):
    jax_main(["evaluate", *args, "--out", str(tmp_path / "res_jax"),
              "--cpu"])
    with open(_last_line(capsys)) as f:
        want = json.load(f)
    port_main(["evaluate", *args, "--out", str(tmp_path / "res_port"),
               "--device", "cpu"])
    with open(_last_line(capsys)) as f:
        got = json.load(f)
    _assert_json_close(got, want)
    return got


def test_evaluate_split_mode_matches_jax(tmp_path, rng, capsys, few_samples):
    smpl = str(tmp_path / "SMPLH_male.pkl")
    _make_fake_smplh_pkl(smpl, rng)
    objects = tmp_path / "objects"
    seqs = ["Date01_Sub01_boxsmall", "Date02_Sub02_chairwood"]
    for seq in seqs:
        obj = seq.split("_")[2]
        os.makedirs(objects / obj)
        save_ply(str(objects / obj / f"{obj}.ply"), *_box())
        gt_root, recon_root = _write_packs(tmp_path, rng, seq)
    split = tmp_path / "split.json"
    split.write_text(json.dumps({"seqs": seqs}))
    got = _evaluate_both(tmp_path, capsys, [
        "--split", str(split), "--save-name", "tr", "--recon-root",
        recon_root, "--gt-root", gt_root, "--objects-root", str(objects),
        "--smpl-model", smpl, "--window", "4", "--angles"])
    assert set(got["separate"]) == set(seqs)
    assert got["total"] == 14 and "boxsmall" in got and "chairwood" in got
    assert 0 < got["smpl_v2v"]["mean"] < 20 and 0 < got["rot_error"]["mean"]


def test_evaluate_single_sequence_with_angles_matches_jax(tmp_path, rng,
                                                          capsys,
                                                          few_samples):
    seq = "Date03_Sub03_boxsmall"
    smpl = str(tmp_path / "SMPLH_male.pkl")
    _make_fake_smplh_pkl(smpl, rng)
    save_ply(str(tmp_path / "box.ply"), *_box())
    gt_root, recon_root = _write_packs(tmp_path, rng, seq, T=7, holes=(0,))
    got = _evaluate_both(tmp_path, capsys, [
        "--recon", os.path.join(recon_root, "recon_tr", f"{seq}_k1.pkl"),
        "--gt", os.path.join(gt_root, f"{seq}_GT-packed.pkl"),
        "--template", str(tmp_path / "box.ply"), "--smpl-model", smpl,
        "--window", "3", "--angles", "--smpl-only"])
    assert got["total"] == 6 and f"{seq}_k1" in got["rot_error_separate"]


def test_evaluate_frame_folder_mode_matches_jax(tmp_path, rng, capsys,
                                                few_samples):
    seq = "Date04_Sub04_boxsmall"
    smpl = str(tmp_path / "SMPLH_male.pkl")
    _make_fake_smplh_pkl(smpl, rng)
    save_ply(str(tmp_path / "box.ply"), *_box())
    gt_root, recon_root = _write_packs(tmp_path, rng, seq, T=6, holes=())
    seq_dir = tmp_path / seq
    seq_dir.mkdir()
    (seq_dir / "info.json").write_text(json.dumps({"gender": "male",
                                                   "cat": "boxsmall"}))
    rec = packed.load_packed(os.path.join(recon_root, "recon_tr",
                                          f"{seq}_k1.pkl"))
    packed.unpack_to_frames(rec, str(seq_dir), "tr")
    os.remove(seq_dir / "t0004.000" / "k1.smplfit_tr.pkl")  # a missing fit
    got = _evaluate_both(tmp_path, capsys, [
        "--recon-seq", str(seq_dir), "--save-name", "tr", "--gt",
        os.path.join(gt_root, f"{seq}_GT-packed.pkl"), "--template",
        str(tmp_path / "box.ply"), "--smpl-model", smpl, "--window", "4"])
    assert got["total"] == 5


def test_unpack_and_pack_commands(tmp_path, rng, capsys):
    """`unpack` then `pack` through the port's command line give back the
    pack, as the JAX command line does on a copy."""
    seq = "Date05_Sub05_boxsmall"
    _, recon_root = _write_packs(tmp_path, rng, seq, T=4, holes=())
    recon = os.path.join(recon_root, "recon_tr", f"{seq}_k1.pkl")
    for side, run in (("port", port_main), ("jax", jax_main)):
        seq_dir = tmp_path / side / seq
        seq_dir.mkdir(parents=True)
        (seq_dir / "info.json").write_text(json.dumps({"gender": "female",
                                                       "cat": "boxsmall"}))
        run(["unpack", "--packed", recon, "--seq", str(seq_dir),
             "--save-name", "tr"])
        assert "unpacked 4 frames" in _last_line(capsys)
        run(["pack", "--seq", str(seq_dir), "--out",
             str(tmp_path / side / "re.pkl"), "--save-name", "tr"])
        assert "4 with recon" in _last_line(capsys)
    got = packed.load_packed(str(tmp_path / "port" / "re.pkl"))
    want = jax_packed.load_packed(str(tmp_path / "jax" / "re.pkl"))
    _assert_same(got, want)
    assert got["gender"] == "female"
    np.testing.assert_array_equal(got["obj_angles"],
                                  packed.load_packed(recon)["obj_angles"])


def test_rename_masks_like_jax(tmp_path, capsys):
    """Flat t<frame>-k<kid>.*.png files move into frame folders, files whose
    destination exists stay: the same tree as the JAX command leaves."""
    trees = {}
    for side, run in (("port", port_main), ("jax", jax_main)):
        seq = tmp_path / side / "Date09_Sub99_boxsmall"
        (seq / "t0003.000").mkdir(parents=True)
        masks = tmp_path / side / "masks" / seq.name
        masks.mkdir(parents=True)
        for frame in ("t0003.000", "t0004.000"):
            for kind in ("person_mask", "obj_rend_mask"):
                (masks / f"{frame}-k1.{kind}.png").write_bytes(b"png")
        (masks / "README.png").write_bytes(b"x")  # not t*: left alone
        (seq / "t0003.000" / "k1.person_mask.png").write_bytes(b"old")
        run(["rename-masks", "--seq", str(seq), "--mask-path",
             str(tmp_path / side / "masks")])
        assert _last_line(capsys) == "moved 3 mask files (1 already present)"
        trees[side] = sorted(
            (os.path.relpath(os.path.join(d, f), tmp_path / side),
             open(os.path.join(d, f), "rb").read())
            for d, _, files in os.walk(tmp_path / side) for f in files)
    assert trees["port"] == trees["jax"]


def _subcommand_defaults(parser, cmd):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {a.dest: a.default for a in sub.choices[cmd]._actions}


@pytest.mark.parametrize("cmd", ["evaluate", "unpack", "pack",
                                 "rename-masks"])
def test_flags_match_the_jax_command_line(cmd):
    """The same flags with the same defaults; the JAX --cpu is --device
    (default cuda) in the port."""
    port = _subcommand_defaults(build_parser(), cmd)
    ref = _subcommand_defaults(jax_parser(), cmd)
    if cmd == "evaluate":
        assert port.pop("device") == "cuda" and ref.pop("cpu") is False
    assert port == ref


def test_evaluate_defaults_to_cuda_and_raises_without_gpu(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_main(["evaluate", "--recon", "r.pkl", "--gt", "g.pkl",
                   "--template", "t.ply", "--smpl-model", "s.pkl",
                   "--out", str(tmp_path)])

