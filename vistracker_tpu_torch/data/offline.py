"""Offline (precomputed-npz) SIF-Net training data and the depth-rescale
test crop.

Port of vistracker_tpu/data/offline.py, without PIL: frames are read
through data/imageio.py and resized with data/images.py's
resize_float_bilinear, PIL's float BILINEAR (to the bit, or one float32
ulp from it).

  * `save_boundary_npz` writes one frame's boundary samples in the
    reference's npz schema: per-sigma dicts points / dist_h / dist_o /
    parts (+ neighbours_h / neighbours_o with add_neighbours), pca_axis,
    smpl_center, body_kpts, obj_center and image_file. Each sigma bucket
    takes max(int(ratio * N), N // 2) surface samples (the reference's
    get_sample_num floor with thres = N // 2, so every bucket gets at
    least half the total) plus grid_ratio of that in grid samples;
    flip=True writes the left/right-swapped part labels of the
    `_flip.npz` variant.
  * `offline_example` draws one training example from such a file: a
    per-sigma subsample at the release ratios, the object center
    relative to the SMPL center, the RGBM3 crop of the stored image file,
    optionally the triplane PNG and a horizontal flip.
  * `prepare_test_crop` is the depth-rescale test path: resize into the
    2048 px Kinect space, crop around the mask union's center at a size
    rescaled so the person appears at z_0 = 2.2 m, optionally padded to
    the mean crop center, with a crop_info pkl beside the frame.
"""
from __future__ import annotations

import json
import os.path as osp
import pickle

import numpy as np
import torch

from .imageio import read_image, read_l, read_rgb
from .images import (compose_rgbm3, crop_around, masks_to_bbox,
                     resize_float_bilinear)
from .sampling import (GRID_BMAX, GRID_BMIN, MeshDistance, compute_pca_axes,
                       flip_part_labels)
from ..utils.mesh import sample_surface

KINECT_SIZE = (2048, 1536)  # (w, h) of the BEHAVE Kinect colour image
MEAN_CROP_CENTER = np.array([1008.0, 995.0])


def _get_sample_num(ratio: float, total: int) -> int:
    """Surface samples of one sigma bucket: int(ratio * total), at least
    total // 2."""
    return max(int(ratio * total), total // 2)


def save_boundary_npz(out_path: str, smpl_verts, smpl_faces, obj_verts,
                      obj_faces, part_labels, body_center, body_kpts,
                      image_file: str, sigmas=(0.08, 0.02, 0.003),
                      ratios=(0.01, 0.49, 0.5), sample_num: int = 20000,
                      grid_ratio: float = 1.0 / 16.0,
                      add_neighbours: bool = False, flip: bool = False,
                      rng: np.random.RandomState | None = None) -> str:
    """Write one frame's boundary samples (the module docstring's schema);
    returns the written path."""
    rng = rng or np.random.RandomState()
    smpl_verts = np.asarray(smpl_verts, np.float32)
    obj_verts = np.asarray(obj_verts, np.float32)
    comb_v = np.concatenate([smpl_verts, obj_verts], 0)
    comb_f = np.concatenate(
        [np.asarray(smpl_faces), np.asarray(obj_faces) + len(smpl_verts)], 0)
    md_h = MeshDistance(smpl_verts, smpl_faces)
    md_o = MeshDistance(obj_verts, obj_faces)

    fields = {k: {} for k in ("points", "dist_h", "dist_o", "parts",
                              "neighbours_h", "neighbours_o")}
    for s, r in zip(sigmas, ratios):
        n = _get_sample_num(r, sample_num)
        pts = sample_surface(comb_v, comb_f, n, rng) + s * rng.randn(n, 3)
        grid = (rng.rand(int(grid_ratio * n), 3) * (GRID_BMAX - GRID_BMIN)
                + GRID_BMIN)
        pts = np.concatenate([pts, grid], 0).astype(np.float32)
        d_h, n_h = md_h.query(pts)
        d_o, n_o = md_o.query(pts)
        parts = np.asarray(part_labels)[md_h.nearest_vertex(pts)]
        if flip:
            parts = flip_part_labels(parts)
        key = f"sigma{s}"
        fields["points"][key] = pts
        fields["dist_h"][key] = d_h.astype(np.float32)
        fields["dist_o"][key] = d_o.astype(np.float32)
        fields["parts"][key] = parts.astype(np.uint8)
        fields["neighbours_h"][key] = n_h.astype(np.float32)
        fields["neighbours_o"][key] = n_o.astype(np.float32)

    data = dict(points=fields["points"], dist_h=fields["dist_h"],
                dist_o=fields["dist_o"], parts=fields["parts"],
                pca_axis=compute_pca_axes(obj_verts),
                smpl_center=np.asarray(body_center, np.float32),
                body_kpts=np.asarray(body_kpts, np.float32),
                obj_center=obj_verts.mean(0).astype(np.float32),
                image_file=image_file)
    if add_neighbours:
        data["neighbours_h"] = fields["neighbours_h"]
        data["neighbours_o"] = fields["neighbours_o"]
    np.savez(out_path, **data)
    return out_path if out_path.endswith(".npz") else out_path + ".npz"


def _load_frame_images(rgb_file: str, flip: bool = False):
    """RGB and person / object masks (float32, 0..255) of a frame, with
    the reference's file-name fallbacks, optionally flipped
    horizontally."""
    rgb = read_rgb(rgb_file)
    pm_file = rgb_file.replace(".color.jpg", ".person_mask.png")
    if not osp.isfile(pm_file):
        pm_file = rgb_file.replace(".color.jpg", ".person_mask.jpg")
    om_file = None
    for pat in (".obj_rend_mask.png", ".obj_rend_mask.jpg",
                ".obj_mask.png", ".obj_mask.jpg"):
        om_file = rgb_file.replace(".color.jpg", pat)
        if osp.isfile(om_file):
            break
    pm = read_l(pm_file).astype(np.float32)
    om = read_l(om_file).astype(np.float32)
    if flip:
        rgb, pm, om = rgb[:, ::-1], pm[:, ::-1], om[:, ::-1]
    return rgb.astype(np.float32), pm, om


def _crop_rgbm3(rgb, pm, om, center, crop_size, net_size) -> np.ndarray:
    """The (net, net, 5) RGBM3 input of a crop around `center`, resized
    with PIL's float BILINEAR (the union mask thresholds the resized
    masks at 0.5, so the resize must follow PIL's rounding)."""
    def crop(img):
        patch = crop_around(img, center, crop_size)
        if patch.shape[0] != patch.shape[1]:  # the reference's aspect check
            raise ValueError(f"aspect mismatch: crop {patch.shape} vs "
                             f"({net_size}, {net_size})")
        return resize_float_bilinear(patch, (net_size, net_size)) / 255.0
    return compose_rgbm3(crop(rgb), crop(pm), crop(om))


def offline_example(npz_path: str, sigmas=(0.08, 0.02, 0.003),
                    ratios=(0.01, 0.49, 0.5), total_samples: int = 20000,
                    crop_size: int = 1200, net_size: int = 512,
                    load_triplane: bool = False, flip: bool = False,
                    visibility: float = 1.0,
                    rng: np.random.RandomState | None = None) -> dict:
    """One training example from a boundary npz: the same dict as
    data/datasets.py:sifnet_example, ready for the SIF-Net train step."""
    rng = rng or np.random.RandomState()
    if flip:
        npz_path = npz_path.replace(".npz", "_flip.npz")
    data = np.load(npz_path, allow_pickle=True)

    pts, dfs_h, dfs_o, parts = [], [], [], []
    for s, r in zip(sigmas, ratios):
        key = f"sigma{s}"
        bucket = data["points"].item()[key]
        choice = rng.choice(bucket.shape[0], int(total_samples * r),
                            replace=False)
        pts.append(bucket[choice])
        dfs_h.append(data["dist_h"].item()[key][choice])
        dfs_o.append(data["dist_o"].item()[key][choice])
        parts.append(data["parts"].item()[key][choice])
    points = np.concatenate(pts, 0).astype(np.float32)
    n = len(points)

    rgb_file = str(data["image_file"])
    rgb, pm, om = _load_frame_images(rgb_file, flip)
    bmin, bmax = masks_to_bbox([pm, om])
    center = (bmin + bmax) // 2
    # the train-time crop: around the union bbox's center, no rescale
    images = _crop_rgbm3(rgb, pm, om, center, crop_size, net_size)
    if load_triplane:
        tri_file = rgb_file.replace(".color.jpg", ".smpl_triplane.png")
        tri = read_image(tri_file)[0][..., :3].astype(np.float32) / 255.0
        if flip:
            tri = tri[:, ::-1]
        if tri.shape[0] != net_size:
            tri = resize_float_bilinear(tri, (net_size, net_size))
        images = np.concatenate([images, tri.astype(np.float32)], -1)

    body_center = np.asarray(data["smpl_center"], np.float32)
    return dict(
        images=images.astype(np.float32),
        points=points,
        df_h=np.concatenate(dfs_h, 0).astype(np.float32),
        df_o=np.concatenate(dfs_o, 0).astype(np.float32),
        parts=np.concatenate(parts, 0).astype(np.int32),
        pca=np.broadcast_to(np.asarray(data["pca_axis"], np.float32),
                            (n, 3, 3)).copy(),
        obj_center=(np.asarray(data["obj_center"], np.float32)
                    - body_center),
        visibility=np.full(n, visibility, np.float32),
        crop_center=center.astype(np.float32),
        body_center=body_center,
    )


# ---------------------------------------------------------------------------
# the depth-rescale test crop
# ---------------------------------------------------------------------------

def _bbox_width(j2d: np.ndarray, exp: float = 1.1) -> np.ndarray:
    """(bmax - bmin) * exp of a 2D joint set."""
    return (j2d.max(0) - j2d.min(0)) * exp


def fullbody_scale(kpts: np.ndarray, mocap_verts: np.ndarray,
                   landmarks, camera, depth: float = 2.2) -> float:
    """Crop-scale factor that makes the person appear at z_0: the mocap
    mesh's body25 joints projected at depth z_0 against the detected 2D
    joints, by joint-bbox size."""
    if np.sum(kpts[:, 2]) == 0:
        return 1.0
    v = mocap_verts - mocap_verts.mean(0) + np.array([0.0, 0.0, depth])
    j3d = np.asarray(landmarks.body25.cpu(), np.float64) @ v
    j3d_proj = camera.project_screen(
        torch.as_tensor(j3d, dtype=torch.float32)).numpy()
    valid = kpts[:, 2] > 0.3
    w, h = _bbox_width(kpts[valid, :2])
    wm, hm = _bbox_width(j3d_proj[valid, :2])
    if w >= h and wm >= hm:
        return float(w / wm)
    return float(h / hm)


def _pad_to_mean_center(img: np.ndarray, crop_center: np.ndarray):
    """Zero-pad so the crop center lands on MEAN_CROP_CENTER."""
    h, w = img.shape[:2]
    top_left = (MEAN_CROP_CENTER - crop_center).astype(int)
    bottom_right = np.array([w, h]) + top_left
    kw, kh = KINECT_SIZE
    new_size = np.maximum(np.array([kw, kh]), bottom_right).astype(int)
    new_img = np.zeros((new_size[1], new_size[0]) + img.shape[2:], img.dtype)
    x1y1 = np.maximum(np.zeros(2), top_left).astype(int)
    x2y2 = np.minimum(np.array([kw, kh]), bottom_right).astype(int)
    x1 = max(0, -top_left[0])
    y1 = max(0, -top_left[1])
    x2 = min(w, w - (bottom_right[0] - kw))
    y2 = min(h, h - (bottom_right[1] - kh))
    new_img[x1y1[1]:x2y2[1], x1y1[0]:x2y2[0]] = img[y1:y2, x1:x2]
    return new_img


def prepare_test_crop(rgb_file: str, landmarks, camera,
                      crop_size: int = 1200, net_size: int = 512,
                      use_mean_center: bool = False, depth: float = 2.2,
                      save_crop_info: bool = True) -> dict:
    """The depth-rescale test item: crop AND rescale the patch so the
    person appears as if at z_0. Returns dict(images (net, net, 5)
    float32, crop_center, resize_scale, crop_scale, old_crop_center) and
    writes `<frame>.crop_info.pkl` beside the RGB unless it exists or
    save_crop_info is False."""
    from ..utils.mesh import load_ply

    rgb, pm, om = _load_frame_images(rgb_file, flip=False)
    bmin, bmax = masks_to_bbox([pm, om])
    if not bmax[0] > 0:
        raise ValueError(f"no valid mask found for image {rgb_file}")
    crop_center = (bmin + bmax) // 2
    rh, rw = rgb.shape[:2]

    # everything into the equivalent 2048 px Kinect space
    if rw > rh:
        resize_scale = KINECT_SIZE[0] / rw
        newsize = (KINECT_SIZE[0], int(rh * resize_scale))
    else:
        resize_scale = KINECT_SIZE[1] / rh
        newsize = (int(rw * resize_scale), KINECT_SIZE[1])
    crop_center = np.round(resize_scale * crop_center)
    rgb, pm, om = (resize_float_bilinear(x, newsize) for x in (rgb, pm, om))

    with open(rgb_file.replace(".color.jpg", ".color.json")) as f:
        kpts = np.array(json.load(f)["body_joints"],
                        np.float64).reshape(-1, 3)
    if np.sum(kpts[:, 2]) == 0:
        raise ValueError(f"no valid person keypoints in image {rgb_file}")
    kpts[:, :2] *= resize_scale

    mocap_verts, _ = load_ply(rgb_file.replace(".color.jpg", ".mocap.ply"))
    scale = fullbody_scale(kpts, mocap_verts, landmarks, camera, depth)
    scaled_crop = scale * crop_size

    old_center = crop_center.copy()
    if use_mean_center:
        rgb, pm, om = (_pad_to_mean_center(x, crop_center)
                       for x in (rgb, pm, om))
        crop_center = MEAN_CROP_CENTER.copy()
    images = _crop_rgbm3(rgb, pm, om, crop_center, scaled_crop, net_size)

    info_file = rgb_file.replace(".color.jpg", ".crop_info.pkl")
    if save_crop_info and not osp.isfile(info_file):
        with open(info_file, "wb") as f:
            pickle.dump({"rgb_newsize": np.array(newsize),
                         "resize_scale": resize_scale,
                         "crop_center": old_center,
                         "crop_scale": scale,
                         "crop_size": scaled_crop}, f)
    return dict(images=images.astype(np.float32),
                crop_center=crop_center.astype(np.float32),
                resize_scale=float(resize_scale),
                crop_scale=float(scale),
                old_crop_center=old_center.astype(np.float32))
