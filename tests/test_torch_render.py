"""The port's rendering and diagnostics (render/viz.py, data/gif.py,
ops/marching.py, the per-frame triplane render and the `render`
subcommand) against the JAX package's, on the same numpy inputs.

Tolerances: a rendered image may differ from JAX's in at most 0.1% of
its pixels -- z-buffer ties, where two surfaces lie at one depth within
float32 rounding and either may win -- and every other pixel agrees
within 1e-5. Meshes, masks, marching-tetrahedra output and the geometry
helpers are equal. The GIF writer decodes frames of at most 256 colours
to their own pixels; frames with more are quantized by its own median
cut, held here to the error it measured on these frames."""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vistracker_tpu.core.camera import PerspectiveCamera as JCam
from vistracker_tpu.render import viz as jviz
from vistracker_tpu_torch.core.camera import PerspectiveCamera as TCam
from vistracker_tpu_torch.render import viz as tviz

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the median cut's error per channel on the >256-colour test frames
# (gradient and noise, below), as measured: worst 38, mean 10.4 on noise
# (PIL's own median cut: 66 and 11.8), worst 14, mean 3.6 on gradients
GIF_WORST, GIF_MEAN = 40, 10.5


def assert_images_agree(a, b, tol=1e-5, share=1e-3):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    bad = (np.abs(a - b) > tol).any(-1)
    assert bad.mean() <= share, (bad.sum(), bad.size)


def _scene():
    """Two overlapping spheres and a checkerboard patch at 2-2.6 m:
    [(verts, faces, color)], numpy."""
    s1 = jviz.sphere_mesh((0.0, 0.05, 2.3), 0.25, lat=14, lon=20)
    s2 = jviz.sphere_mesh((0.18, -0.05, 2.2), 0.15, lat=10, lon=12)
    gv, fw, _ = jviz.checkerboard_ground((0.0, 0.2, 2.4), 1.0, 4)
    return [(s1[0], s1[1], (0.4, 0.6, 0.9)), (s2[0], s2[1], (0.9, 0.4, 0.4)),
            (gv, fw, (0.8, 0.8, 0.8))]


def test_render_meshes_perspective_matches_jax():
    meshes = _scene()
    cc = np.asarray(JCam().project_screen(jnp.asarray(
        meshes[0][0].mean(0, keepdims=True))[None]))[0, 0]
    for size in (64, 96):
        ref = jviz.render_meshes_perspective(meshes, JCam(crop_size=400), cc,
                                             size)
        out = tviz.render_meshes_perspective(meshes, TCam(crop_size=400), cc,
                                             size)
        assert (out > 0).any(-1).mean() > 0.2
        assert_images_agree(out, ref)


def test_render_top_view_matches_jax():
    meshes = _scene()
    ref = jviz.render_top_view(meshes, JCam(crop_size=600), size=80)
    out = tviz.render_top_view(meshes, TCam(crop_size=600), size=80)
    assert (out > 0).any(-1).mean() > 0.2
    assert_images_agree(out, ref)


def test_geometry_helpers_match_jax(rng):
    """checkerboard_ground, sphere_mesh, look_at, side_by_side,
    contact_spheres and the part colours, equal."""
    for tiles in (4, 10):
        for a, b in zip(tviz.checkerboard_ground(tiles=tiles),
                        jviz.checkerboard_ground(tiles=tiles)):
            np.testing.assert_array_equal(a, b)
    for args in (((0, 0, 0), 0.1), ((0.3, -0.2, 2.0), 0.08, 8, 10)):
        for a, b in zip(tviz.sphere_mesh(*args), jviz.sphere_mesh(*args)):
            np.testing.assert_array_equal(a, b)
    for eye, at in (((0.0, -1.8, 2.3), (0.0, 0.0, 2.2)),
                    ((1.0, -0.5, 0.0), (0.2, 0.3, 2.5))):
        for a, b in zip(tviz.look_at(eye, at), jviz.look_at(eye, at)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tviz.PART_COLORS, jviz.PART_COLORS)
    f = rng.rand(2, 8, 8, 3).astype(np.float32)
    np.testing.assert_array_equal(tviz.side_by_side(f, f[::-1]),
                                  jviz.side_by_side(f, f[::-1]))
    sv = rng.randn(300, 3).astype(np.float32)
    labels = rng.randint(0, 14, 300)
    ov = np.concatenate([sv[::7] + 0.01, sv + 5.0]).astype(np.float32)
    got = tviz.contact_spheres(sv, labels, ov)
    want = jviz.contact_spheres(sv, labels, ov)
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert tviz.contact_spheres(sv, labels, ov + 100.0) == []


def test_triplane_masks_match_jax_and_the_batch(rng):
    """triplane_ndc and render_triplane_masks equal the JAX package's and,
    frame by frame, render_triplane_masks_batch (the K1 path; its plain
    version on the CPU), bit for bit."""
    from vistracker_tpu.ops import rasterizer as jr
    from vistracker_tpu_torch.ops import rasterizer as tr
    B, V, size = 3, 30, 64
    verts = (rng.randn(B, V, 3) * 0.3 + [0, 0.3, 2.4]).astype(np.float32)
    faces = rng.randint(0, V, (25, 3)).astype(np.int32)
    bc = verts.mean(1)
    tf = torch.from_numpy(faces).long()
    batch = tr.render_triplane_masks_batch(torch.from_numpy(verts), tf,
                                           torch.from_numpy(bc), size)
    for i in range(B):
        ndc = tr.triplane_ndc(torch.from_numpy(verts[i]),
                              torch.from_numpy(bc[i]))
        np.testing.assert_array_equal(ndc.numpy(), np.asarray(
            jr.triplane_ndc(jnp.asarray(verts[i]), jnp.asarray(bc[i]))))
        m = tr.render_triplane_masks(torch.from_numpy(verts[i]), tf,
                                     torch.from_numpy(bc[i]), size)
        assert m.shape == (size, size, 3) and m.sum() > 100
        np.testing.assert_array_equal(m.numpy(), np.asarray(
            jr.render_triplane_masks(jnp.asarray(verts[i]),
                                     jnp.asarray(faces), jnp.asarray(bc[i]),
                                     size)))
        np.testing.assert_array_equal(m.numpy(), batch[i].numpy())


def _sphere_grid(R=40, r=0.6):
    lin = np.linspace(-1, 1, R)
    gx, gy, gz = np.meshgrid(lin, lin, lin, indexing="ij")
    return np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - r


@pytest.mark.parametrize("grid", ["sphere", "empty", "noise"])
def test_marching_tets_matches_jax(grid, rng):
    from vistracker_tpu.ops.marching import marching_tets as jm
    from vistracker_tpu_torch.ops.marching import marching_tets as tm
    vals = {"sphere": _sphere_grid(), "empty": np.ones((8, 8, 8)),
            "noise": rng.randn(12, 10, 9)}[grid]
    for level in (0.0, 0.1):
        tv, tf = tm(vals, level, (-1, -0.5, 0), (1, 0.5, 2))
        jv, jf = jm(vals, level, (-1, -0.5, 0), (1, 0.5, 2))
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)
        assert tv.dtype == np.float32 and tf.dtype == np.int32
        assert (len(tf) > 0) == (grid != "empty")


def test_udf_to_mesh_matches_jax_with_a_torch_query():
    """udf_to_mesh equals JAX's; a query_fn that returns its distances as
    a torch tensor (as a network on the card would) gives the same
    mesh."""
    from vistracker_tpu.ops.marching import udf_to_mesh as jm
    from vistracker_tpu_torch.ops.marching import udf_to_mesh as tm

    def udf(p):
        return np.abs(np.linalg.norm(p, axis=-1) - 0.6)

    def udf_torch(p):
        return torch.from_numpy(udf(p)).requires_grad_(True)

    jv, jf = jm(udf, resolution=28, level=0.03, batch=5000)
    for q in (udf, udf_torch):
        tv, tf = tm(q, resolution=28, level=0.03, batch=5000)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)
    assert len(jf) > 500


# ---------------------------------------------------------------------------
# GIF and mp4
# ---------------------------------------------------------------------------

def _frames():
    """float frames in [0, 1]: 3 of at most 256 colours (the third equal
    to the second: merged into one with twice the duration, as PIL
    does), then 2 of more (a gradient, noise)."""
    rng = np.random.RandomState(3)
    pal = rng.rand(200, 3).astype(np.float32)
    few = [pal[rng.randint(0, 200, (48, 80))] for _ in range(2)]
    y, x = np.mgrid[0:48, 0:80]
    grad = np.stack([x / 80.0, y / 48.0, (x + y) / 128.0], -1)
    return np.stack([*few, few[1], grad,
                     rng.rand(48, 80, 3)]).astype(np.float32)


def _decode(path):
    from PIL import Image
    im = Image.open(path)
    frames, durations = [], []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB")))
        durations.append(im.info.get("duration"))
    return np.stack(frames), im.size, durations, im.info.get("loop")


def test_gif_writer_without_pil_against_jax(tmp_path):
    frames = _frames()
    np.save(tmp_path / "frames.npy", frames)
    mine = str(tmp_path / "port.gif")
    code = ("import sys, numpy as np; sys.modules['PIL'] = None; "
            "from vistracker_tpu_torch.render.viz import save_video; "
            f"save_video(np.load({str(tmp_path / 'frames.npy')!r}), "
            f"{mine!r}, fps=15); "
            "assert not [m for m in sys.modules if m.startswith('PIL.')]")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    theirs = jviz.save_video(frames, str(tmp_path / "jax.gif"), fps=15)
    got, gsize, gdur, gloop = _decode(mine)
    want, wsize, wdur, wloop = _decode(theirs)
    assert (len(got), gsize, gdur, gloop) == (len(want), wsize, wdur, wloop)
    assert len(got) == 4 and gdur == [60, 130, 60, 60] and gloop == 0
    u8 = (np.clip(frames, 0, 1) * 255).astype(np.uint8)[[0, 1, 3, 4]]
    for i in (0, 1):           # at most 256 colours: exact
        np.testing.assert_array_equal(got[i], u8[i])
        np.testing.assert_array_equal(got[i], want[i])
    for i in (2, 3):           # more: the median cut's stated error
        err = np.abs(got[i].astype(int) - u8[i].astype(int))
        print("GIF median cut, frame", i, "worst", err.max(), "mean",
              err.mean(), "PIL's", np.abs(want[i].astype(int)
                                          - u8[i].astype(int)).mean())
        assert err.max() <= GIF_WORST and err.mean() <= GIF_MEAN


def test_gif_median_cut_error_on_large_frames(tmp_path):
    """The stated bound on 256x512 gradient and noise frames, and exact
    decoding of a 256-colour noise frame, whose LZW stream fills the
    4096-entry table and clears it many times."""
    from PIL import Image
    from vistracker_tpu_torch.data.gif import quantize, save_gif
    rng = np.random.RandomState(0)
    y, x = np.mgrid[0:256, 0:512]
    grad = np.stack([x / 2, y, (x + y) / 3], -1).astype(np.uint8)
    noise = rng.randint(0, 256, (256, 512, 3)).astype(np.uint8)
    few = rng.randint(0, 256, (256, 3)).astype(np.uint8)[
        rng.randint(0, 256, (256, 512))]
    for frame in (grad, noise, few):
        idx, pal = quantize(frame)
        err = np.abs(pal[idx].astype(int) - frame.astype(int))
        assert err.max() <= GIF_WORST and err.mean() <= GIF_MEAN
        if len(np.unique(frame.reshape(-1, 3), axis=0)) <= 256:
            assert err.max() == 0
    path = str(tmp_path / "big.gif")
    save_gif([few, noise], path, 100)
    im = Image.open(path)
    np.testing.assert_array_equal(np.asarray(im.convert("RGB")), few)
    im.seek(1)
    err = np.abs(np.asarray(im.convert("RGB")).astype(int) - noise)
    assert err.max() <= GIF_WORST and err.mean() <= GIF_MEAN


def test_mp4_written_without_cv2_by_save_video_and_render(packs, tmp_path):
    """With cv2 blocked (sys.modules["cv2"] = None, as on the machine with
    the card) save_video and `render` write .mp4 files through
    data/mp4.py; cv2, which this image has, reads them back: 3 frames of
    64 x 64, and render's 2 frames of 64 x 128 (GT | recon) and its top
    view. tests/test_torch_mp4.py holds the pixels."""
    import cv2
    fx = packs["fx"]
    np.save(tmp_path / "frames.npy",
            np.random.RandomState(1).rand(3, 64, 64, 3).astype(np.float32))
    a, b = str(tmp_path / "a.mp4"), str(tmp_path / "r" / "b.mp4")
    argv = ["render", "--recon", packs["recon"], "--recon2", packs["contact"],
            "--template", packs["template"], "--smpl-model", fx["model_pkl"],
            "--top", "--size", "64", "--out", b, "--device", "cpu"]
    code = ("import sys, numpy as np; sys.modules['cv2'] = None\n"
            "from vistracker_tpu_torch.render.viz import save_video\n"
            "from vistracker_tpu_torch.cli.main import main\n"
            f"print(save_video(np.load({str(tmp_path / 'frames.npy')!r}), "
            f"{a!r}, fps=5))\n"
            f"main({json.dumps(argv)})\n"
            "assert not [m for m in sys.modules if m.startswith('cv2.')]\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    for path, want in ((a, (3, 64, 64)), (b, (2, 64, 128)),
                       (str(tmp_path / "r" / "b_top.mp4"), (2, 64, 128))):
        cap = cv2.VideoCapture(path)
        assert cap.isOpened(), path
        got = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
               int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
               int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)))
        n_read = 0
        while cap.read()[0]:
            n_read += 1
        cap.release()
        assert got == want and n_read == want[0], (path, got, n_read)


# ---------------------------------------------------------------------------
# the `render` subcommand
# ---------------------------------------------------------------------------

def _parser_options(parser, cmd):
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    return {a.dest: (tuple(a.option_strings), a.default, a.required)
            for a in sub.choices[cmd]._actions if a.dest != "help"}


def test_render_flags_match_the_jax_parser():
    """The same flags, defaults and required flags; the JAX --cpu is the
    port's --device (cuda unless asked)."""
    from vistracker_tpu.cli.main import build_parser as jp
    from vistracker_tpu_torch.cli.main import build_parser as tp
    j, t = _parser_options(jp(), "render"), _parser_options(tp(), "render")
    assert j.pop("cpu")[1] is False and t.pop("device")[1] == "cuda"
    assert t == j


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """The port's fixture (2 frames) and three packs of it: its GT pack,
    a recon pack (rotation matrices, a moved object, one frame scaled)
    and the GT pack with the object moved into contact."""
    import chip_smoke
    from vistracker_tpu_torch.data.fixture import generate_fixture_sequence
    from vistracker_tpu_torch.data.packed import load_packed, save_packed
    from scipy.spatial.transform import Rotation

    root = tmp_path_factory.mktemp("render")
    fx = generate_fixture_sequence(str(root / "fx"), T=2, raster=64,
                                   device="cpu")
    template = os.path.join(fx["objects_root"], "boxmedium",
                            "boxmedium.ply")
    gt = load_packed(fx["gt_pack"])
    rot = Rotation.from_rotvec(np.asarray(gt["obj_angles"])).as_matrix()
    recon = str(root / "recon.pkl")
    save_packed(recon, {**gt, "obj_angles": rot.transpose(0, 2, 1)
                        .astype(np.float32),
                        "obj_trans": np.asarray(gt["obj_trans"]) + 0.05,
                        "obj_scales": np.array([1.0, 1.2], np.float32)})
    contact = chip_smoke.pack_in_contact(fx["gt_pack"], fx["model_pkl"],
                                         template, str(root / "contact.pkl"))
    return dict(fx=fx, template=template, recon=recon, contact=contact,
                root=root)


def _keep_videos(mp, viz):
    """Record the frames each save_video call gets."""
    kept, real = [], viz.save_video

    def save(frames, path, fps=15):
        kept.append(np.asarray(frames))
        return real(frames, path, fps)
    mp.setattr(viz, "save_video", save)
    return kept


def test_render_cli_matches_jax(packs, monkeypatch):
    """`render --recon <recon> --recon2 <GT moved into contact> --top
    --contact-spheres` of both packages on the CPU: the same files; the
    rendered frames (front and top, each GT | recon side by side) under
    the image tolerance, contact spheres drawn on the contact side; the
    decoded GIFs of the same size, frame count, duration and loop, and
    close (the two median cuts differ: mean error within 2 x the stated
    mean)."""
    from vistracker_tpu.cli import main as jcli
    from vistracker_tpu_torch.cli import main as tcli
    fx, root = packs["fx"], packs["root"]
    drawn = []
    real_cs = tviz.contact_spheres
    monkeypatch.setattr(tviz, "contact_spheres", lambda *a, **k: (
        drawn.append(len(real_cs(*a, **k))) or real_cs(*a, **k)))
    common = ["render", "--recon", packs["recon"], "--recon2",
              packs["contact"], "--template", packs["template"],
              "--smpl-model", fx["model_pkl"], "--top", "--contact-spheres",
              "--assets", fx["assets_root"], "--size", "64"]
    jkept, tkept = _keep_videos(monkeypatch, jviz), _keep_videos(
        monkeypatch, tviz)
    jcli.run_render(jcli.build_parser().parse_args(
        [*common, "--cpu", "--out", str(root / "jax" / "sbs.gif")]))
    outs = tcli.run_render(tcli.build_parser().parse_args(
        [*common, "--device", "cpu", "--out", str(root / "port" / "sbs.gif")]))
    assert [os.path.basename(p) for p in outs] == ["sbs.gif", "sbs_top.gif"]
    assert max(drawn) > 0
    assert len(jkept) == len(tkept) == 2
    for j, t in zip(jkept, tkept):
        assert t.shape == j.shape == (2, 64, 128, 3)
        for a, b in zip(t, j):
            assert_images_agree(a, b)
    for name in ("sbs.gif", "sbs_top.gif"):
        got = _decode(str(root / "port" / name))
        want = _decode(str(root / "jax" / name))
        assert got[1:] == want[1:] and got[0].shape == want[0].shape
        err = np.abs(got[0].astype(int) - want[0].astype(int))
        assert err.mean() <= 2 * GIF_MEAN, err.mean()


def test_render_cli_writes_gifs_without_pil(packs, tmp_path):
    """The port's `render` in a fresh interpreter with PIL blocked: both
    GIFs written, 2 frames of 64 x 128 each."""
    import chip_smoke
    fx = packs["fx"]
    out = str(tmp_path / "sbs.gif")
    code = ("import sys; sys.modules['PIL'] = None; "
            "from vistracker_tpu_torch.cli.main import main; "
            f"main({json.dumps(['render', '--recon', packs['recon'], '--template', packs['template'], '--smpl-model', fx['model_pkl'], '--top', '--size', '64', '--out', out, '--device', 'cpu'])})")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    for path in (out, str(tmp_path / "sbs_top.gif")):
        size, images, loop = chip_smoke.gif_frames(path)
        assert size == (64, 64) and images == [(64, 64)] * 2 and loop == 0
