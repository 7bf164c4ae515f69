"""Mesh visualization: z-buffered flat-shaded rendering, side-by-side
videos, the top view with a checkerboard ground and contact spheres.

Port of vistracker_tpu/render/viz.py. `render_shaded` is the rasterizer
(the fixture generator, data/fixture.py, draws its frames with it too):
per-face edge functions, barycentric depth interpolation and a running
min-depth / argmin reduction over face chunks, in PyTorch on the device
of its inputs. Within a chunk the first argmin wins and across chunks the
comparison is a strict <, so the lowest face index wins every tie and the
result does not depend on the chunk. `render_meshes_perspective` and
`render_top_view` composite several meshes through it on a device of the
caller's choosing. `save_video` writes a GIF through data/gif.py (no
PIL) or, for `.mp4`, through cv2, imported only there; without cv2 an
`.mp4` is refused by name (ROADMAP.md, Queue 1 item 8).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.rasterizer import _edge_coeffs, pixel_grid

_FAR = 1e9
# faces per chunk: a (chunk, 3, size^2) float32 tensor is 402 MB at a 512
# raster, and the step holds a few of them
CHUNK = 128


def _cross2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def render_shaded(v2d: torch.Tensor, depth: torch.Tensor,
                  verts3d: torch.Tensor, faces: torch.Tensor,
                  size: int = 256, chunk: int = CHUNK):
    """v2d (V, 2) NDC vertices, depth (V,) per-vertex depth, verts3d
    (V, 3) for the normals, faces (F, 3) -> (shade (size, size) in [0, 1]
    with 0 the background, depth map (size, size), 1e9 where empty).
    Row 0 is y = -1, column 0 is x = -1."""
    dev = v2d.device
    grid = torch.as_tensor(pixel_grid(size), device=dev)      # (3, P)
    px, py = grid[0], grid[1]
    faces = torch.as_tensor(faces, device=dev).long()
    coeffs, _, orient, valid = _edge_coeffs(v2d, faces)
    coeffs = coeffs * orient[:, None, None]
    f0, f1, f2 = faces[:, 0], faces[:, 1], faces[:, 2]
    area2 = _cross2(v2d[f1] - v2d[f0], v2d[f2] - v2d[f0]).abs()
    # flat shading: |normal . view| with a headlight at the camera
    n = torch.linalg.cross(verts3d[f1] - verts3d[f0],
                           verts3d[f2] - verts3d[f0])
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
    shade_f = 0.3 + 0.7 * n[:, 2].abs()
    zf = depth[faces]                                         # (F, 3)

    P = size * size
    zbuf = torch.full((P,), _FAR, dtype=torch.float32, device=dev)
    shade = torch.zeros(P, dtype=torch.float32, device=dev)
    for s in range(0, faces.shape[0], chunk):
        c = coeffs[s:s + chunk]
        # e_i(p) = a px + b py + c, written out (no matmul: no TF32)
        e = (c[..., 0:1] * px + c[..., 1:2] * py) + c[..., 2:3]  # (f, 3, P)
        inside = (e >= 0.0).all(1) & valid[s:s + chunk, None]
        w = e / torch.clamp(area2[s:s + chunk], min=1e-12)[:, None, None]
        del e
        zc = zf[s:s + chunk]
        # edge i is opposite vertex (i + 2) % 3
        zpix = (w[:, 0] * zc[:, 2:3] + w[:, 1] * zc[:, 0:1]
                + w[:, 2] * zc[:, 1:2])
        del w
        zpix = torch.where(inside, zpix, torch.full_like(zpix, _FAR))
        zmin, amin = zpix.min(0)          # first index among equal minima
        closer = zmin < zbuf
        zbuf = torch.where(closer, zmin, zbuf)
        shade = torch.where(closer, shade_f[s:s + chunk][amin], shade)
    return shade.reshape(size, size), zbuf.reshape(size, size)


def _device_of(meshes, device):
    if device is not None:
        return torch.device(device)
    for verts, _, _ in meshes:
        if torch.is_tensor(verts):
            return verts.device
    return torch.device("cpu")


def render_meshes_perspective(meshes, cam, crop_center, size: int = 256,
                              device=None) -> np.ndarray:
    """Render [(verts (V, 3), faces (F, 3), color (3,)), ...] through the
    pinhole camera into the crop window around crop_center (2,) pixels:
    (size, size, 3) float32 RGB, 0 where empty. Each mesh is rendered
    alone and the nearer surface wins (a strict <, so an earlier mesh
    keeps a tie). Renders on `device`, by default that of the first
    tensor among the verts (numpy verts: the CPU)."""
    dev = _device_of(meshes, device)
    img = torch.zeros(size, size, 3, dtype=torch.float32, device=dev)
    zfull = torch.full((size, size), _FAR, dtype=torch.float32, device=dev)
    cc = torch.tensor(np.asarray(crop_center, np.float32), device=dev)[None]
    for verts, faces, color in meshes:
        v = (verts.to(dev, torch.float32) if torch.is_tensor(verts)
             else torch.tensor(np.asarray(verts, np.float32), device=dev))
        ndc = cam.project_points(v[None], cc)[0, :, :2]
        shade, z = render_shaded(ndc, v[:, 2], v,
                                 torch.as_tensor(np.asarray(faces),
                                                 device=dev), size)
        closer = z < zfull
        zfull = torch.where(closer, z, zfull)
        rgb = torch.as_tensor(np.asarray(color, np.float32), device=dev)
        img = torch.where(closer[..., None], shade[..., None] * rgb, img)
    return img.cpu().numpy()


def checkerboard_ground(center=(0.0, 1.0, 2.5), extent: float = 3.0,
                        tiles: int = 10):
    """A checkerboard ground plane: (verts (V, 3), faces_white (F, 3),
    faces_black (F, 3)); render the two face sets in two colours. The
    plane is normal to y at height center[1] (the BEHAVE ground lies
    near y = +1 in camera frames)."""
    cx, cy, cz = center
    lin = np.linspace(-extent / 2, extent / 2, tiles + 1, dtype=np.float32)
    verts = np.stack(np.meshgrid(lin + cx, lin + cz, indexing="ij"),
                     -1).reshape(-1, 2)
    verts = np.stack([verts[:, 0], np.full(len(verts), cy, np.float32),
                      verts[:, 1]], -1)
    fw, fb = [], []
    for i in range(tiles):
        for j in range(tiles):
            a = i * (tiles + 1) + j
            b, c = a + 1, a + tiles + 1
            quad = [[a, b, c], [b, c + 1, c]]
            (fw if (i + j) % 2 == 0 else fb).extend(quad)
    return verts, np.asarray(fw, np.int32), np.asarray(fb, np.int32)


def side_by_side(frames_left: np.ndarray,
                 frames_right: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) x 2 -> (T, H, 2W, 3)."""
    return np.concatenate([frames_left, frames_right], axis=2)


MP4_REFUSAL = ("writing .mp4 needs cv2, which is not installed; an mp4 "
               "writer that needs no cv2 is not in the port yet "
               "(ROADMAP.md, Queue 1 item 8); write a .gif instead")


def mp4_writable() -> bool:
    """Can `save_video` write an .mp4 here (is cv2 importable)?"""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def save_video(frames: np.ndarray, path: str, fps: int = 15) -> str:
    """Write (T, H, W, 3) float frames in [0, 1], turned to uint8 as
    (clip * 255) truncated: `.mp4` paths through cv2's FFMPEG writer (the
    reference's imageio/FFMPEG role), any other extension as an animated
    GIF (data/gif.py) showing each frame int(1000 / fps) ms, looping.
    Without cv2 an .mp4 path raises SystemExit before anything is
    written."""
    mp4 = path.lower().endswith(".mp4")
    if mp4 and not mp4_writable():
        raise SystemExit(MP4_REFUSAL)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    rgb = [(np.clip(f, 0, 1) * 255).astype(np.uint8) for f in frames]
    if mp4:
        import cv2
        h, w = rgb[0].shape[:2]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 fps, (w, h))
        if not writer.isOpened():
            raise RuntimeError(f"cv2 VideoWriter failed for {path}")
        for f in rgb:
            writer.write(f[:, :, ::-1])  # cv2 wants BGR
        writer.release()
        return path
    from ..data.gif import save_gif
    return save_gif(rgb, path, duration_ms=int(1000 / fps), loop=0)


# 14 SMPL-part colours for the contact spheres (the reference's
# parts_color.pkl / COLOR_REORDER table, nr_utils.py:67-96)
PART_COLORS = np.array([
    (0.90, 0.30, 0.30), (0.30, 0.90, 0.30), (0.30, 0.30, 0.90),
    (0.90, 0.90, 0.30), (0.90, 0.30, 0.90), (0.30, 0.90, 0.90),
    (0.95, 0.60, 0.20), (0.60, 0.20, 0.95), (0.20, 0.95, 0.60),
    (0.70, 0.70, 0.70), (0.55, 0.35, 0.20), (0.95, 0.75, 0.75),
    (0.45, 0.60, 0.30), (0.30, 0.45, 0.60)], np.float32)


def sphere_mesh(center, radius: float, lat: int = 6, lon: int = 8):
    """A small UV sphere: (verts (V, 3) float32, faces (F, 3) int32)."""
    center = np.asarray(center, np.float32)
    th = np.linspace(0, np.pi, lat + 1)[1:-1]
    ph = np.linspace(0, 2 * np.pi, lon, endpoint=False)
    ring = np.stack([np.outer(np.sin(th), np.cos(ph)),
                     np.outer(np.sin(th), np.sin(ph)),
                     np.outer(np.cos(th), np.ones(lon))], -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 0, 1.0]], ring, [[0, 0, -1.0]]], 0)
    faces = []
    base = 1 + (lat - 2) * lon
    for j in range(lon):  # the caps
        faces.append([0, 1 + j, 1 + (j + 1) % lon])
        faces.append([len(verts) - 1, base + (j + 1) % lon, base + j])
    for i in range(lat - 2):
        for j in range(lon):
            a = 1 + i * lon + j
            b = 1 + i * lon + (j + 1) % lon
            faces.extend([[a, b, a + lon], [b, b + lon, a + lon]])
    return (verts.astype(np.float32) * radius + center,
            np.asarray(faces, np.int32))


def contact_spheres(smpl_verts: np.ndarray, part_labels: np.ndarray,
                    obj_verts: np.ndarray, thres: float = 0.04,
                    radius: float = 0.08) -> list:
    """Per-part contact spheres (the reference's
    nr_utils.py:get_contact_spheres): the object verts within `thres` of
    a SMPL vertex, grouped by that vertex's part label; one sphere at each
    part's contact centroid. [(color (3,), verts, faces), ...], empty
    without contact."""
    from scipy.spatial import cKDTree
    dist, idx = cKDTree(smpl_verts).query(obj_verts)
    mask = dist < thres
    if not mask.any():
        return []
    labels = np.asarray(part_labels)[idx[mask]]
    cverts = obj_verts[mask]
    out = []
    for p in range(len(PART_COLORS)):
        sel = labels == p
        if sel.any():
            v, f = sphere_mesh(cverts[sel].mean(0), radius)
            out.append((PART_COLORS[p], v, f))
    return out


def look_at(eye, at, up=(0.0, -1.0, 0.0)):
    """The camera-frame transform looking from eye to at, in the
    convention of pytorch3d's look_at_view_transform that the reference's
    render_recon.py:215 uses: world points map to the camera frame as
    v @ R + T. Returns (R (3, 3), T (3,)) float32."""
    eye = np.asarray(eye, np.float32)
    at = np.asarray(at, np.float32)
    z = at - eye
    z = z / max(np.linalg.norm(z), 1e-12)
    x = np.cross(np.asarray(up, np.float32), z)
    x = x / max(np.linalg.norm(x), 1e-12)
    y = np.cross(z, x)
    R = np.stack([x, y, z], 1)  # columns
    T = -eye @ R
    return R.astype(np.float32), T.astype(np.float32)


def render_top_view(meshes, cam, size: int = 256, eye=(0.0, -1.8, 2.3),
                    at=(0.0, 0.0, 2.2), ground_center=(0.0, 1.0, 2.5),
                    device=None) -> np.ndarray:
    """The scene from above (render_recon.py:213-225) over a checkerboard
    ground; meshes [(verts, faces, color)] as numpy. (size, size, 3)
    float32, rendered on `device` (default: the CPU)."""
    R, T = look_at(eye, at)
    gv, fw, fb = checkerboard_ground(center=ground_center)
    all_meshes = list(meshes) + [(gv, fw, (0.85, 0.85, 0.85)),
                                 (gv, fb, (0.35, 0.35, 0.35))]
    moved = [(np.asarray(v, np.float32) @ R + T, f, c)
             for v, f, c in all_meshes]
    center = torch.as_tensor(np.asarray(at, np.float32) @ R + T)
    center_px = cam.project_screen(center[None, None]).numpy()[0, 0]
    return render_meshes_perspective(moved, cam, center_px, size=size,
                                     device=device)
