"""The port's offline training data (data/offline.py) and the
`boundary-sample` / `train-sifnet --offline-data` command lines against
the JAX package on the same files and seeds: the npz files are equal
array for array (the same draws, the same BVH), offline examples and
test crops agree within 1e-4 on the images (the port resizes without
PIL) and exactly on the points and labels, and the port reads an npz set
and its frames with PIL blocked."""
import glob
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_offline_data import _box, _write_frame_images
from vistracker_tpu.data import offline as JO
from vistracker_tpu_torch.data import offline as TO

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


def _npz_kwargs(rng, rgb_file, sample_num=400):
    sv, sf = _box([0.0, 0.0, 2.2], 0.4)
    ov, of = _box([0.5, 0.0, 2.4], 0.15)
    return dict(smpl_verts=sv, smpl_faces=sf, obj_verts=ov, obj_faces=of,
                part_labels=(np.arange(len(sv)) % 14).astype(np.uint8),
                body_center=np.array([0.0, 0.0, 2.2]),
                body_kpts=rng.rand(25, 3).astype(np.float32),
                image_file=rgb_file, sample_num=sample_num)


def _load(path):
    d = np.load(path, allow_pickle=True)
    return {k: (d[k].item() if d[k].dtype == object and d[k].ndim == 0
                and isinstance(d[k].item(), dict) else d[k])
            for k in d.files}


def _assert_npz_equal(a, b, atol=0.0):
    """Equal keys, dtypes and integer arrays; float arrays within atol."""
    assert set(a) == set(b)
    for k in b:
        pairs = ([(a[k][s], b[k][s], f"{k} {s}") for s in b[k]]
                 if isinstance(b[k], dict) else [(a[k], b[k], k)])
        if isinstance(b[k], dict):
            assert set(a[k]) == set(b[k]), k
        for x, y, msg in pairs:
            assert x.dtype == y.dtype, msg
            if x.dtype.kind == "f":
                np.testing.assert_allclose(x, y, rtol=0, atol=atol,
                                           err_msg=msg)
            else:
                np.testing.assert_array_equal(x, y, err_msg=msg)


@pytest.fixture
def frame_npz(tmp_path, rng):
    """One frame's images and its boundary npz (+ _flip) written by the
    JAX package."""
    rgb_file = _write_frame_images(str(tmp_path / "t0000.000"), rng)
    kw = _npz_kwargs(rng, rgb_file)
    out = str(tmp_path / "frame_0000.npz")
    JO.save_boundary_npz(out, rng=np.random.RandomState(1),
                         add_neighbours=True, **kw)
    JO.save_boundary_npz(out.replace(".npz", "_flip.npz"), flip=True,
                         rng=np.random.RandomState(1), add_neighbours=True,
                         **kw)
    return out, rgb_file, kw


@pytest.mark.parametrize("flip, neighbours", [(False, False), (True, True)])
def test_save_boundary_npz_matches(tmp_path, rng, flip, neighbours):
    rgb_file = _write_frame_images(str(tmp_path / "t0000.000"), rng)
    kw = _npz_kwargs(rng, rgb_file)
    paths = []
    for pkg, name in ((TO, "port"), (JO, "jax")):
        paths.append(pkg.save_boundary_npz(
            str(tmp_path / f"{name}.npz"), flip=flip,
            add_neighbours=neighbours, rng=np.random.RandomState(5), **kw))
    a, b = _load(paths[0]), _load(paths[1])
    _assert_npz_equal(a, b)
    assert ("neighbours_h" in a) == neighbours
    # every bucket has at least half the total (get_sample_num's floor)
    for s in (0.08, 0.02, 0.003):
        n = max(int({0.08: 0.01, 0.02: 0.49, 0.003: 0.5}[s] * 400), 200)
        assert a["points"][f"sigma{s}"].shape == (n + int(n / 16.0), 3)


@pytest.mark.parametrize("flip, triplane", [(False, False), (True, True)])
def test_offline_example_matches(frame_npz, flip, triplane):
    from PIL import Image
    out, rgb_file, _ = frame_npz
    if triplane:
        tri = (np.random.RandomState(2).rand(24, 24, 3) * 255).astype(
            np.uint8)
        Image.fromarray(tri).save(
            rgb_file.replace(".color.jpg", ".smpl_triplane.png"))
    kw = dict(total_samples=200, crop_size=48, net_size=24, flip=flip,
              load_triplane=triplane)
    ex = TO.offline_example(out, rng=np.random.RandomState(3), **kw)
    ref = JO.offline_example(out, rng=np.random.RandomState(3), **kw)
    assert set(ex) == set(ref)
    assert ex["images"].shape == (24, 24, 8 if triplane else 5)
    np.testing.assert_allclose(ex["images"], ref["images"], atol=1e-4)
    for k in ref:
        if k != "images":
            assert ex[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(ex[k], ref[k], err_msg=k)


@pytest.mark.parametrize("mean_center", [False, True])
def test_prepare_test_crop_matches(tmp_path, rng, mean_center):
    import jax.numpy as jnp
    from test_offline_data import _fake_landmarks
    from vistracker_tpu.core.camera import PerspectiveCamera as JCam
    from vistracker_tpu.utils.mesh import save_ply
    from vistracker_tpu_torch.core.camera import PerspectiveCamera as TCam
    from vistracker_tpu_torch.core.landmarks import BodyLandmarks

    fd = str(tmp_path / "t0000.000")
    rgb_file = _write_frame_images(fd, rng, H=120, W=160)
    kpts = np.stack([40 + rng.rand(25) * 12, 40 + rng.rand(25) * 12,
                     np.ones(25)], -1)
    with open(rgb_file.replace(".color.jpg", ".color.json"), "w") as f:
        json.dump(dict(body_joints=kpts.reshape(-1).tolist()), f)
    mv, mf = _box([0.0, 0.1, 2.2], np.array([0.3, 0.8, 0.2]))
    save_ply(rgb_file.replace(".color.jpg", ".mocap.ply"), mv, mf)
    jl = _fake_landmarks(len(mv), rng)
    tl = BodyLandmarks(*(torch.as_tensor(np.array(x)) for x in
                         (jl.body25, jl.face, jl.hand)))
    kw = dict(crop_size=1200, net_size=32, use_mean_center=mean_center)
    ref = JO.prepare_test_crop(rgb_file, jl, JCam(crop_size=1200), **kw)
    info_file = rgb_file.replace(".color.jpg", ".crop_info.pkl")
    with open(info_file, "rb") as f:
        info_ref = pickle.load(f)
    os.remove(info_file)
    out = TO.prepare_test_crop(rgb_file, tl, TCam(crop_size=1200), **kw)
    with open(info_file, "rb") as f:
        info = pickle.load(f)
    np.testing.assert_allclose(out["images"], ref["images"], atol=1e-4)
    for k in ("crop_center", "old_crop_center", "resize_scale"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    np.testing.assert_allclose(out["crop_scale"], ref["crop_scale"],
                               rtol=1e-6)
    assert set(info) == set(info_ref)
    for k in info_ref:
        np.testing.assert_allclose(info[k], info_ref[k], rtol=1e-6,
                                   err_msg=k)


@pytest.fixture(scope="module")
def sampled_sequence(tmp_path_factory):
    """The fake BEHAVE sequence of tests/test_real_track.py with a GT pack,
    run through both packages' `boundary-sample --flip` (the port on the
    CPU)."""
    from test_real_track import (_make_fake_assets, _make_fake_sequence,
                                 _make_fake_smplh_pkl)
    from vistracker_tpu.cli.main import build_parser as jparser
    from vistracker_tpu.cli.main import run_boundary_sample as jrun
    from vistracker_tpu.cli.synthetic import box_mesh
    from vistracker_tpu.data.packed import save_packed
    from vistracker_tpu.utils.mesh import save_ply
    from vistracker_tpu_torch.cli.main import main

    root = tmp_path_factory.mktemp("offline_seq")
    rng = np.random.RandomState(0)
    T = 3
    seq = str(root / "Date09_Sub99_boxsmall")
    _make_fake_sequence(seq, rng, T=T)
    assets = str(root / "assets")
    _make_fake_assets(assets, rng)
    smpl_pkl = str(root / "SMPLH_male.pkl")
    _make_fake_smplh_pkl(smpl_pkl, rng)
    obj_root = str(root / "objects")
    os.makedirs(os.path.join(obj_root, "boxsmall"))
    bv, bf = box_mesh()
    save_ply(os.path.join(obj_root, "boxsmall", "boxsmall.ply"), bv, bf)
    gt_pack = str(root / "gt.pkl")
    save_packed(gt_pack, dict(
        poses=(rng.randn(T, 156) * 0.1).astype(np.float32),
        betas=np.zeros((T, 10), np.float32),
        trans=np.tile([[0.0, 0.0, 2.2]], (T, 1)).astype(np.float32),
        obj_angles=(rng.randn(T, 3) * 0.3).astype(np.float32),
        obj_trans=np.tile([[0.1, 0.0, 2.3]], (T, 1)).astype(np.float32),
        obj_scales=np.ones(T, np.float32), gender="male",
        frames=[f"t{i:04d}.000" for i in range(T)]))
    common = ["boundary-sample", "--seq", seq, "--gt-pack", gt_pack,
              "--smpl-model", smpl_pkl, "--assets", assets,
              "--objects-root", obj_root, "--samples", "200", "--flip"]
    dirs = {"port": str(root / "port"), "jax": str(root / "jax")}
    jrun(jparser().parse_args(common + ["--out", dirs["jax"]]))
    port_args = common + ["--out", dirs["port"], "--device", "cpu"]
    main(port_args)
    return dict(dirs=dirs, seq=seq, port_args=port_args, T=T)


def test_boundary_sample_cli_matches_jax(sampled_sequence, capsys):
    """The same files; the same arrays, the float ones within 2e-6 (1 ppm
    of values up to 2.3 m): the two packages' LBS and keypoint regressor
    sum in other orders, a few ulp that the surface samples carry."""
    from vistracker_tpu_torch.cli.main import main
    dirs = sampled_sequence["dirs"]
    names = sorted(os.listdir(dirs["port"]))
    assert names == sorted(os.listdir(dirs["jax"]))
    assert len(names) == 2 * sampled_sequence["T"]
    for n in names:
        _assert_npz_equal(_load(os.path.join(dirs["port"], n)),
                          _load(os.path.join(dirs["jax"], n)), atol=2e-6)
    # resume: a second run writes nothing
    stamps = {n: os.path.getmtime(os.path.join(dirs["port"], n))
              for n in names}
    capsys.readouterr()
    main(sampled_sequence["port_args"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["written"] == 0 and res["frames"] == sampled_sequence["T"]
    assert stamps == {n: os.path.getmtime(os.path.join(dirs["port"], n))
                      for n in names}


def test_train_sifnet_offline_cli(sampled_sequence, tmp_path):
    """`train-sifnet --offline-data` at tiny sizes, the 5-channel chore
    variant with random flips, on the port's npz set."""
    from vistracker_tpu_torch.cli.main import main
    from vistracker_tpu_torch.models.weights import find_checkpoint
    out = str(tmp_path / "exp")
    main(["train-sifnet", "--offline-data", sampled_sequence["dirs"]["port"],
          "--out", out, "--epochs", "1", "--batch-size", "2",
          "--image-size", "24", "--crop-size", "48", "--samples", "96",
          "--variant", "chore", "--random-flip", "--device", "cpu"])
    ck = torch.load(find_checkpoint(out), weights_only=False)
    assert ck["step"] == 1 and "visib_predictor.0.weight" not in \
        ck["model_state_dict"]
    assert ck["model_state_dict"]["center_predictor.6.weight"].shape[0] == 6
    recs = [json.loads(l) for l in open(os.path.join(out, "metrics.jsonl"))]
    assert np.isfinite(recs[-1]["val_loss"])


def test_npz_set_reads_without_pil(sampled_sequence):
    """The npz set and its frames are read with PIL blocked, as on the
    card machine."""
    code = (
        "import sys, glob; sys.modules['PIL'] = None\n"
        "import numpy as np\n"
        "from vistracker_tpu_torch.data.offline import offline_example\n"
        "from vistracker_tpu_torch.data.behave import FrameDataReader\n"
        f"files = sorted(glob.glob({sampled_sequence['dirs']['port']!r}"
        " + '/*_k1.npz'))\n"
        "for i, f in enumerate(files):\n"
        "    for flip in (False, True):\n"
        "        ex = offline_example(f, total_samples=96, crop_size=48,\n"
        "                             net_size=24, flip=flip,\n"
        "                             rng=np.random.RandomState(i))\n"
        "        assert ex['images'].shape == (24, 24, 5)\n"
        "        assert np.isfinite(ex['images']).all()\n"
        f"r = FrameDataReader({sampled_sequence['seq']!r})\n"
        "for i in range(len(r)):\n"
        "    r.get_color(i, 1); r.get_mask(i, 1, 'obj')\n"
        "print(len(files), len(r))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split() == [str(sampled_sequence["T"])] * 2


@pytest.mark.parametrize("config_in_info", [True, False])
def test_kinect_transforms_and_seq_info_match(tmp_path, rng,
                                              config_in_info):
    """KinectCalib / KinectTransform equal to the JAX package's (the
    calibration folder named by info.json, or <seq>/config; a kinect
    without config.json left out), and SeqInfo's kids and beta_init."""
    from scipy.spatial.transform import Rotation
    from vistracker_tpu.data import behave as JB
    from vistracker_tpu_torch.data import behave as TB
    seq = tmp_path / "Date01_Sub01_box"
    cfg_dir = seq / "config"
    for kid in range(3):  # kinect 3 of the info has no config.json
        d = cfg_dir / str(kid)
        d.mkdir(parents=True)
        with open(d / "config.json", "w") as f:
            json.dump(dict(rotation=Rotation.from_rotvec(
                rng.randn(3)).as_matrix().reshape(-1).tolist(),
                translation=rng.randn(3).tolist()), f)
    info = dict(cat="box", gender="male", kinects=[0, 1, 2, 3],
                config=str(cfg_dir) if config_in_info else None,
                beta=[0.1] * 10)
    with open(seq / "info.json", "w") as f:
        json.dump(info, f)
    pts = rng.randn(10, 3)
    kt, kj = TB.KinectTransform(str(seq)), JB.KinectTransform(str(seq))
    assert sorted(kt.calibs) == sorted(kj.calibs) == [0, 1, 2]
    for kid in kt.calibs:
        np.testing.assert_array_equal(kt.world2local(pts, kid),
                                      kj.world2local(pts, kid))
        np.testing.assert_array_equal(kt.local2world(pts, kid),
                                      kj.local2world(pts, kid))
        np.testing.assert_allclose(
            kt.local2world(kt.world2local(pts, kid), kid), pts, atol=1e-10)
    reader = TB.FrameDataReader(str(seq))
    assert reader.seq_info.kids == [0, 1, 2, 3]
    assert reader.seq_info.beta_init() == JB.SeqInfo(str(seq)).beta_init()
    (seq / "t0000.000").mkdir()
    assert reader.__class__(str(seq)).get_color_file(0, 2) == \
        JB.FrameDataReader(str(seq)).get_color_file(0, 2)
