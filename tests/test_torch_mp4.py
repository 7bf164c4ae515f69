"""The port's .mp4 writer (data/mp4.py, csrc/mp4_host.cpp) against cv2.

The files are written in a subprocess with cv2 blocked
(sys.modules["cv2"] = None), as on the machine with the card, and read
back here with cv2, which this image has: the frame count, size and fps
are the written ones, the fourcc is that of the JAX package's
save_video (cv2's `mp4v` writer) on the same frames, and every decoded
frame is at least 35 dB PSNR from its uint8 source. The frames are
smooth colour gradients (shaded surfaces) with a darker disc of the same
hue, an edge sharp in luma. A sharp edge between two hues is bounded by
the 4:2:0 chroma itself (31.9 dB for a grey disc on these gradients
through cv2's own RGB -> I420 -> RGB, 33.3 dB through this writer, 32.1
dB through cv2's writer), so such frames would measure the format, not
the writer. Both packages' `render --out
x.mp4` on the 2-frame fixture decode to frames at least 30 dB from each
other (the JAX writer quantizes more coarsely)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import chip_smoke  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PSNR_SOURCE = 35.0   # decoded frame against its uint8 source
PSNR_PACKAGES = 30.0  # the port's render against the JAX package's


def _frames(T, H, W, seed=0):
    """(T, H, W, 3) float frames in [0, 1]: moving colour gradients and a
    moving disc darker than them, of the same hue."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    out = []
    for t in range(T):
        a, b = rng.rand(2) * 6
        img = np.stack([0.5 + 0.35 * np.sin(x / W * 3 + a + t),
                        0.5 + 0.35 * np.cos(y / H * 3 + b),
                        (x + y + 5 * t) / (H + W + 5 * T)], -1)
        disc = (x - W / 2 - 3 * t) ** 2 + (y - H / 2) ** 2 < (min(H, W) / 4) ** 2
        img[disc] *= 0.35 + 0.1 * t     # darker, the same hue
        out.append(img)
    return np.clip(np.stack(out), 0, 1).astype(np.float32)


def _decode(path):
    cap = cv2.VideoCapture(path)
    assert cap.isOpened(), path
    meta = dict(count=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
                width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                fps=cap.get(cv2.CAP_PROP_FPS),
                fourcc=int(cap.get(cv2.CAP_PROP_FOURCC)))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[:, :, ::-1])
    cap.release()
    return np.stack(frames), meta


def _write_without_cv2(code: str):
    res = subprocess.run(
        [sys.executable, "-c", "import sys; sys.modules['cv2'] = None\n"
         + code + "\nassert 'cv2' not in [m.split('.')[0] for m in "
         "sys.modules if sys.modules[m] is not None]"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


@pytest.mark.parametrize("T, H, W", [(3, 64, 64), (2, 50, 70), (1, 64, 64)],
                         ids=["64x64", "50x70", "one-frame"])
def test_save_video_mp4_decodes_with_cv2(tmp_path, T, H, W):
    from vistracker_tpu.render import viz as jviz
    frames = _frames(T, H, W)
    np.save(tmp_path / "frames.npy", frames)
    mine = str(tmp_path / "port.mp4")
    _write_without_cv2(
        "import numpy as np\n"
        "from vistracker_tpu_torch.render.viz import save_video\n"
        f"save_video(np.load({str(tmp_path / 'frames.npy')!r}), {mine!r}, "
        "fps=12)")
    theirs = jviz.save_video(frames, str(tmp_path / "jax.mp4"), fps=12)
    got, meta = _decode(mine)
    _, jmeta = _decode(theirs)
    assert meta == dict(count=T, width=W, height=H, fps=12.0,
                        fourcc=jmeta["fourcc"])
    assert len(got) == T
    u8 = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    psnrs = [chip_smoke.psnr(g, s) for g, s in zip(got, u8)]
    print("PSNR against the source", psnrs)
    assert min(psnrs) >= PSNR_SOURCE, psnrs
    walk = chip_smoke.mp4_walk(mine)
    assert walk["top"] == ["ftyp", "moov", "mdat"]
    assert (walk["width"], walk["height"], walk["fps"]) == (W, H, 12.0)
    assert walk["dsi"][:4] == b"\x00\x00\x01\xb0"   # VOS start code
    assert len(walk["sizes"]) == T
    assert walk["starts"] == [b"\x00\x00\x01\xb6"] * T  # each an I-VOP


def test_long_clip_at_seconds_boundaries(tmp_path):
    """40 frames at 7 fps cross 5 one-second boundaries (the VOP's
    modulo_time_base) and sizes that are not whole macroblocks: every
    frame decodes, in order."""
    from vistracker_tpu_torch.data.mp4 import write_mp4
    frames = (_frames(40, 40, 56, seed=1) * 255).astype(np.uint8)
    path = write_mp4(frames, str(tmp_path / "long.mp4"), 7)
    got, meta = _decode(path)
    assert (meta["count"], meta["fps"], len(got)) == (40, 7.0, 40)
    psnrs = [chip_smoke.psnr(g, s) for g, s in zip(got, frames)]
    assert min(psnrs) >= PSNR_SOURCE, psnrs
    # the frames come back in their order: each is nearest its own source
    err = [[np.abs(g.astype(int) - s).mean() for s in frames] for g in got]
    assert list(np.argmin(err, 1)) == list(range(40))


def test_refusals_are_named(tmp_path, monkeypatch):
    from vistracker_tpu_torch.data import mp4
    ok = np.zeros((8, 8, 3), np.uint8)
    path = str(tmp_path / "x.mp4")
    cases = [
        (lambda: mp4.write_mp4([], path, 15), "zero frames"),
        (lambda: mp4.write_mp4(np.zeros((0, 8, 8, 3), np.uint8), path, 15),
         "zero frames"),
        (lambda: mp4.write_mp4([ok, np.zeros((8, 9, 3), np.uint8)], path,
                               15), "frames of different sizes"),
        (lambda: mp4.write_mp4([np.zeros((8, 8), np.uint8)], path, 15),
         "not (H, W, 3) RGB"),
        (lambda: mp4.write_mp4([np.zeros((1, 8192, 3), np.uint8)], path, 15),
         "frame side outside 1..8191"),
        (lambda: mp4.write_mp4([ok], path, 0), "fps outside 1..65535"),
        (lambda: mp4.write_mp4([ok], path, 65536), "fps outside 1..65535"),
        (lambda: mp4.write_mp4([ok], path, 7.5), "fps that is not whole"),
    ]
    for call, name in cases:
        with pytest.raises(ValueError, match="write_mp4 refuses"
                           ) as e:
            call()
        assert name in str(e.value), (name, str(e.value))
    # 4 GiB: the limit lowered to a size these frames exceed
    monkeypatch.setattr(mp4, "MAX_FILE_BYTES", 2000)
    with pytest.raises(ValueError, match="4 GiB or more"):
        mp4.write_mp4((_frames(3, 64, 64) * 255).astype(np.uint8), path, 15)
    assert not os.path.exists(path)


def test_render_mp4_of_both_packages(tmp_path):
    """`render --out x.mp4 --top` of both packages on the 2-frame fixture
    (the port's in a subprocess with cv2 blocked): the same frame counts
    and sizes, decoded frames at least 30 dB from each other."""
    from vistracker_tpu.cli import main as jcli
    from vistracker_tpu_torch.data.fixture import generate_fixture_sequence
    fx = generate_fixture_sequence(str(tmp_path / "fx"), T=2, raster=64,
                                   device="cpu")
    template = os.path.join(fx["objects_root"], "boxmedium", "boxmedium.ply")
    common = ["render", "--recon", fx["gt_pack"], "--template", template,
              "--smpl-model", fx["model_pkl"], "--top", "--size", "64"]
    jcli.run_render(jcli.build_parser().parse_args(
        [*common, "--cpu", "--out", str(tmp_path / "jax" / "v.mp4")]))
    _write_without_cv2(
        "from vistracker_tpu_torch.cli.main import main\n"
        f"main({json.dumps([*common, '--device', 'cpu', '--out', str(tmp_path / 'port' / 'v.mp4')])})")
    for name in ("v.mp4", "v_top.mp4"):
        got, meta = _decode(str(tmp_path / "port" / name))
        want, jmeta = _decode(str(tmp_path / "jax" / name))
        assert meta == jmeta and meta["count"] == 2
        assert (meta["width"], meta["height"]) == (64, 64)
        psnrs = [chip_smoke.psnr(g, w) for g, w in zip(got, want)]
        print(name, "port vs JAX", psnrs)
        assert min(psnrs) >= PSNR_PACKAGES, psnrs
