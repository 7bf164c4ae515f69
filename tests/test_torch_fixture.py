"""The port's fixture generator (vistracker_tpu_torch/data/fixture.py) and
its rasterizer (render/viz.py:render_shaded) against the JAX package's,
at T = 2 and raster 64 as tests/test_fixture.py runs JAX's, plus the F1
pin: FrameDataReader reads frame folders with PIL blocked, getting what
PIL reads."""
import json
import os
import pickle
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX_KW = {"default": {}, "heldout-lbox": dict(motion_seed=1,
                                              object_shape="lbox")}


@pytest.fixture(scope="module", params=list(FIX_KW))
def fixtures(request, tmp_path_factory):
    """Both packages' fixture sequences from the same arguments."""
    from vistracker_tpu.data.fixture import generate_fixture_sequence as jgen
    from vistracker_tpu_torch.data.fixture import \
        generate_fixture_sequence as tgen

    root = tmp_path_factory.mktemp(f"fixture-{request.param}")
    kw = dict(T=2, raster=64, **FIX_KW[request.param])
    fj = jgen(str(root / "jax"), **kw)
    timings = {}
    ft = tgen(str(root / "port"), device="cpu", timings=timings, **kw)
    return root, fj, ft, timings


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_model_assets_and_template_equal_jax(fixtures):
    """numpy and scipy with the same RandomState draws: the same files."""
    root, fj, ft, _ = fixtures
    for rel in ("SMPLH_male.pkl", "assets/body25_regressor.pkl",
                "assets/face_regressor.pkl", "assets/hand_regressor.pkl",
                "assets/smpl_parts_dense.pkl", "assets/priors/body_prior.pkl",
                "assets/priors/lh_prior.pkl", "assets/priors/rh_prior.pkl",
                "objects/boxmedium/boxmedium.ply"):
        a, b = _bytes(root / "jax" / rel), _bytes(root / "port" / rel)
        if a != b:     # pickles may differ in framing only: compare content
            ja, pb = pickle.loads(a), pickle.loads(b)
            ja = ja.todense() if hasattr(ja, "todense") else ja
            pb = pb.todense() if hasattr(pb, "todense") else pb
            if isinstance(ja, dict):
                assert ja.keys() == pb.keys(), rel
                for k in ja:
                    np.testing.assert_array_equal(np.asarray(ja[k]),
                                                  np.asarray(pb[k]), rel)
            else:
                np.testing.assert_array_equal(np.asarray(ja), np.asarray(pb))
    md = pickle.loads(_bytes(root / "port" / "SMPLH_male.pkl"))
    assert md["v_template"].shape == (6890, 3) and len(md["f"]) == 11500


def test_gt_pack_keypoints_and_mocap_match_jax(fixtures):
    """The GT pack and the mocap JSON are exact; the keypoint JSON passes
    through LBS on the device, so it is held to 1e-6 relative (float32
    skinning, ~1e-4 px at 2048 px)."""
    import joblib
    from vistracker_tpu_torch.data.packed import load_packed

    _, fj, ft, _ = fixtures
    gj, gt = joblib.load(fj["gt_pack"]), load_packed(ft["gt_pack"])
    assert set(gj) == set(gt) and gj["frames"] == gt["frames"]
    for k in ("poses", "betas", "trans", "obj_angles", "obj_trans",
              "obj_scales", "occ_ratios"):
        np.testing.assert_array_equal(np.asarray(gt[k]), np.asarray(gj[k]), k)
    assert ft["seq_name"] == fj["seq_name"]
    for fr in gj["frames"]:
        for name, rtol in (("k1.color.json", 1e-6), ("k1.mocap.json", 0)):
            with open(os.path.join(fj["seq_dir"], fr, name)) as f:
                a = json.load(f)
            with open(os.path.join(ft["seq_dir"], fr, name)) as f:
                b = json.load(f)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_allclose(b[k], a[k], rtol=rtol, atol=0,
                                           err_msg=f"{fr} {name} {k}")
    with open(os.path.join(fj["seq_dir"], "info.json")) as f, \
            open(os.path.join(ft["seq_dir"], "info.json")) as g:
        assert json.load(f) == json.load(g)


def test_frames_decode_equal_to_jax(fixtures):
    """PNG masks decode equal; the JPEG colour (PIL's default encode in
    both) decodes within 1 level."""
    from vistracker_tpu_torch.data.imageio import read_l, read_rgb

    _, fj, ft, timings = fixtures
    assert set(timings) >= {"render", "encode", "write"}
    for fr in sorted(d for d in os.listdir(fj["seq_dir"]) if d[0] == "t"):
        dj, dt = (os.path.join(f["seq_dir"], fr) for f in (fj, ft))
        for n in ("k1.person_mask.png", "k1.obj_rend_mask.png"):
            ref = np.asarray(Image.open(os.path.join(dj, n)).convert("L"))
            assert ref.any()
            np.testing.assert_array_equal(read_l(os.path.join(dt, n)), ref)
        ref = np.asarray(Image.open(os.path.join(dj, "k1.color.jpg")))
        got = read_rgb(os.path.join(dt, "k1.color.jpg"))
        assert got.shape == ref.shape == (1536, 2048, 3)
        assert np.abs(got.astype(int) - ref).max() <= 1


def _margins(v2d, faces, size, pix):
    """|min over a face's 3 orientation-corrected edge functions| at the
    given flat pixel indices, least over faces: how close the pixel sits
    to a coverage boundary."""
    from vistracker_tpu_torch.ops.rasterizer import _edge_coeffs, pixel_grid
    coeffs, _, orient, _ = _edge_coeffs(v2d, faces)
    g = torch.as_tensor(pixel_grid(size))[:, pix]
    e = torch.einsum("fij,jp->fip", coeffs * orient[:, None, None], g)
    return e.amin(1).abs().amin(0)


def test_render_frame_masks_match_jax(fixtures):
    """_render_frame fed the same vertices: the same raster masks, shades
    and depths; a flipped pixel would have to sit within 1e-6 of an
    edge."""
    from vistracker_tpu.core.camera import PerspectiveCamera as JCam
    from vistracker_tpu.data.fixture import _render_frame as jframe
    from vistracker_tpu.render.viz import render_shaded as jrs
    from vistracker_tpu_torch.core.camera import PerspectiveCamera
    from vistracker_tpu_torch.core.smpl import lbs_forward, load_smpl_pkl
    from vistracker_tpu_torch.data.fixture import _render_frame
    from vistracker_tpu_torch.render.viz import render_shaded
    from vistracker_tpu_torch.utils.mesh import load_ply

    _, _, ft, _ = fixtures
    model = load_smpl_pkl(ft["model_pkl"])
    verts = lbs_forward(model, torch.as_tensor(ft["poses"][:1]),
                        torch.as_tensor(ft["betas"][:1]),
                        torch.as_tensor(ft["trans"][:1]))[0][0]
    tv, tf = load_ply(os.path.join(ft["objects_root"], "boxmedium",
                                   "boxmedium.ply"))
    ov = (tv @ ft["rot_gt"][0].T + ft["obj_trans_gt"][0]).astype(np.float32)
    raster, cam = 64, PerspectiveCamera(crop_size=1200)
    flips = []
    for v, f in ((verts, model.faces), (torch.as_tensor(ov), tf)):
        ndc = 2.0 * cam.project_screen(v[None])[0] / cam.width - 1.0
        s, z = render_shaded(ndc, v[:, 2], v, torch.as_tensor(f), raster)
        js, jz = jrs(jnp.asarray(ndc.numpy()), jnp.asarray(v[:, 2].numpy()),
                     jnp.asarray(v.numpy()), jnp.asarray(f), raster,
                     chunk=2048)
        js, jz = np.asarray(js), np.asarray(jz)
        flip = np.flatnonzero((z.numpy() < 1e8).ravel() != (jz < 1e8).ravel())
        if len(flip):
            m = _margins(ndc, torch.as_tensor(f).long(), raster, flip)
            flips += list(zip(flip.tolist(), m.tolist()))
        both = (z.numpy() < 1e8) & (jz < 1e8)
        # depths ~2.4 m: 1e-5 relative is 24 um. The edge functions are
        # rounded in another order than XLA's dot (a few ulp), and the
        # barycentric weights e / area of the humanoid's small faces carry
        # that up to 6e-6 relative (measured 1.4e-5 m)
        np.testing.assert_allclose(z.numpy()[both], jz[both], rtol=1e-5)
        np.testing.assert_allclose(s.numpy()[both], js[both], atol=1e-6)
    print("flipped raster pixels (index, edge margin):", flips)
    assert all(m < 1e-6 for _, m in flips), flips
    rgb, pm, om, occ = _render_frame(cam, verts, torch.as_tensor(
        model.faces).long(), torch.as_tensor(ov), torch.as_tensor(tf).long(),
        raster)
    jrgb, jpm, jom, jocc = jframe(JCam(crop_size=1200), verts.numpy(),
                                  model.faces, ov, tf, raster)
    if not flips:
        np.testing.assert_array_equal(pm, jpm)
        np.testing.assert_array_equal(om, jom)
        assert occ == jocc
    assert np.abs(rgb.astype(int) - jrgb).max() <= 1


def _square(cx, z, half=0.4):
    v = np.asarray([[cx - half, -half], [cx + half, -half],
                    [cx + half, half], [cx - half, half]], np.float32)
    f = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    v3 = np.concatenate([v, np.full((4, 1), z, np.float32)], -1)
    return v, np.full((4,), z, np.float32), v3, f


@pytest.mark.parametrize("chunk", [1, 3, 128])
def test_render_shaded_occlusion_matches_jax(chunk):
    """tests/test_viz.py's occlusion case: shade within 1e-6, z within
    1e-5, whatever the chunk."""
    from vistracker_tpu.render.viz import render_shaded as jrs
    from vistracker_tpu_torch.render.viz import render_shaded

    v_a, z_a, v3_a, f = _square(-0.2, 1.0)
    v_b, z_b, v3_b, _ = _square(0.2, 2.0)
    v2 = np.concatenate([v_a, v_b])
    d = np.concatenate([z_a, z_b])
    v3 = np.concatenate([v3_a, v3_b])
    faces = np.concatenate([f, f + 4])
    js, jz = jrs(jnp.asarray(v2), jnp.asarray(d), jnp.asarray(v3),
                 jnp.asarray(faces), 64)
    s, z = render_shaded(torch.as_tensor(v2), torch.as_tensor(d),
                         torch.as_tensor(v3), torch.as_tensor(faces), 64,
                         chunk=chunk)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-5)
    mid = 32
    assert abs(float(z[mid, mid]) - 1.0) < 1e-3 and float(z[0, 0]) > 1e8


_READ_WITHOUT_PIL = """
import sys
sys.modules["PIL"] = None
import numpy as np
from vistracker_tpu_torch.data.behave import FrameDataReader
out = {}
for tag, seq in zip(sys.argv[2::2], sys.argv[3::2]):
    r = FrameDataReader(seq)
    for i in range(len(r)):
        out[f"{tag}/{i}/color"] = r.get_color(i, 1)
        for cat in ("person", "obj"):
            out[f"{tag}/{i}/{cat}"] = r.get_mask(i, 1, cat)
assert not [m for m, mod in sys.modules.items()
            if mod is not None and m.split(".")[0] in ("PIL", "jax")]
np.savez(sys.argv[1], **out)
"""


def test_reader_reads_frames_without_pil(fixtures, tmp_path):
    """F1: in a process where PIL cannot be imported, FrameDataReader reads
    the JAX fixture's folder (written by PIL), the port's, and one with
    grey-JPEG masks under the reader's fallback names, and gets exactly
    what PIL's Image.open(...).convert() reads."""
    _, fj, ft, _ = fixtures
    grey = str(tmp_path / "Date09_Sub99_boxmedium")
    shutil.copytree(ft["seq_dir"], grey)
    for fr in (d for d in os.listdir(grey) if d[0] == "t"):
        for png, jpg in (("person_mask.png", "person_mask.jpg"),
                         ("obj_rend_mask.png", "obj_mask.jpg")):
            p = os.path.join(grey, fr, f"k1.{png}")
            Image.open(p).convert("L").save(os.path.join(grey, fr,
                                                         f"k1.{jpg}"))
            os.remove(p)
    seqs = {"jax": fj["seq_dir"], "port": ft["seq_dir"], "grey": grey}
    npz = str(tmp_path / "read.npz")
    res = subprocess.run(
        [sys.executable, "-c", _READ_WITHOUT_PIL, npz,
         *[x for kv in seqs.items() for x in kv]],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    got = np.load(npz)
    names = {"person": ("k1.person_mask.png", "k1.person_mask.jpg"),
             "obj": ("k1.obj_rend_mask.png", "k1.obj_mask.jpg")}
    for tag, seq in seqs.items():
        frames = sorted(d for d in os.listdir(seq) if d[0] == "t")
        for i, fr in enumerate(frames):
            fd = os.path.join(seq, fr)
            ref = np.asarray(Image.open(os.path.join(fd, "k1.color.jpg"))
                             .convert("RGB"))
            np.testing.assert_array_equal(got[f"{tag}/{i}/color"], ref)
            for cat, cands in names.items():
                p = next(os.path.join(fd, n) for n in cands
                         if os.path.isfile(os.path.join(fd, n)))
                ref = np.asarray(Image.open(p).convert("L")) > 127
                np.testing.assert_array_equal(got[f"{tag}/{i}/{cat}"], ref)
