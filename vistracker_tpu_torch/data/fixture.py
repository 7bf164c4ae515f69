"""BEHAVE-layout fixture sequences: a capsule humanoid, rendered frames, GT.

Port of vistracker_tpu/data/fixture.py. The released SMPL-H model files
are licensed and not redistributable, so the fixture is an articulated
capsule humanoid with the full SMPL-H parameterization (6890 vertices, 52
joints, the real kinematic tree, skinning weights and joint regressors, a
closed triangulation) plus a BEHAVE-layout sequence on disk: Kinect
geometry (2048 x 1536 pixel coordinates), rendered person and object
masks, OpenPose-format keypoints, FrankMocap-style init JSONs and a GT
pack. The numpy and scipy parts are the JAX module's, draw for draw; the
skinning and the rendering (render/viz.py:render_shaded) run on a
`device`, and the files are written through data/imageio.py (JPEG colour
with PIL's default settings, PNG masks), so no PIL is needed.
"""
from __future__ import annotations

import json
import os
import os.path as osp
import pickle

import numpy as np
import torch

from ..core.smpl import SMPLH_PARENTS

# ---------------------------------------------------------------------------
# capsule humanoid construction
# ---------------------------------------------------------------------------

# T-pose joint offsets from parent (SMPL canonical frame: +y up, +x left).
# Plausible adult proportions in meters.
_J_OFFSETS = {
    0: (0.0, 0.0, 0.0),          # pelvis (root)
    1: (0.07, -0.08, 0.0),       # left hip
    2: (-0.07, -0.08, 0.0),      # right hip
    3: (0.0, 0.12, 0.0),         # spine1
    4: (0.0, -0.38, 0.0),        # left knee
    5: (0.0, -0.38, 0.0),        # right knee
    6: (0.0, 0.13, 0.0),         # spine2
    7: (0.0, -0.40, 0.0),        # left ankle
    8: (0.0, -0.40, 0.0),        # right ankle
    9: (0.0, 0.06, 0.0),         # spine3
    10: (0.0, -0.06, 0.12),      # left foot
    11: (0.0, -0.06, 0.12),      # right foot
    12: (0.0, 0.21, 0.0),        # neck
    13: (0.08, 0.12, 0.0),       # left collar
    14: (-0.08, 0.12, 0.0),      # right collar
    15: (0.0, 0.07, 0.0),        # head
    16: (0.10, 0.02, 0.0),       # left shoulder
    17: (-0.10, 0.02, 0.0),      # right shoulder
    18: (0.26, 0.0, 0.0),        # left elbow
    19: (-0.26, 0.0, 0.0),       # right elbow
    20: (0.25, 0.0, 0.0),        # left wrist
    21: (-0.25, 0.0, 0.0),       # right wrist
}
_FINGER_STEP = 0.032  # per-phalanx offset for the 2x15 hand joints


def _tpose_joints() -> np.ndarray:
    """(52, 3) T-pose joint locations from the offset table."""
    J = np.zeros((52, 3), np.float32)
    parents = np.asarray(SMPLH_PARENTS)
    for j in range(1, 52):
        p = parents[j]
        if j in _J_OFFSETS:
            off = np.asarray(_J_OFFSETS[j], np.float32)
        else:
            # hand joints: 22-36 left (3 per finger x 5), 37-51 right
            side = 1.0 if j < 37 else -1.0
            base = j - 22 if j < 37 else j - 37
            finger = base // 3
            off = np.asarray([side * _FINGER_STEP, 0.0,
                              (finger - 2) * 0.012], np.float32)
        J[j] = J[p] + off
    return J


def _capsule(p0, p1, radius, lat, lon):
    """Stretched-sphere capsule mesh from p0 to p1. Returns (verts, faces)."""
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    axis = p1 - p0
    length = float(np.linalg.norm(axis))
    z = axis / max(length, 1e-9) if length > 1e-9 \
        else np.asarray([0.0, 1.0, 0.0], np.float32)
    # orthonormal frame around z
    a = np.asarray([1.0, 0.0, 0.0], np.float32)
    if abs(np.dot(a, z)) > 0.9:
        a = np.asarray([0.0, 0.0, 1.0], np.float32)
    x = np.cross(a, z)
    x /= max(np.linalg.norm(x), 1e-9)
    y = np.cross(z, x)
    th = np.linspace(0, np.pi, lat + 2)[1:-1]
    ph = np.linspace(0, 2 * np.pi, lon, endpoint=False)
    ring = np.stack([np.outer(np.sin(th), np.cos(ph)),
                     np.outer(np.sin(th), np.sin(ph)),
                     np.outer(np.cos(th), np.ones(lon))], -1).reshape(-1, 3)
    unit = np.concatenate([[[0, 0, 1.0]], ring, [[0, 0, -1.0]]], 0)
    half = length / 2.0 + radius
    local = unit * np.asarray([radius, radius, half], np.float32)
    center = (p0 + p1) / 2.0
    verts = center + local @ np.stack([x, y, z], 0)
    faces = []
    for j in range(lon):
        faces.append([0, 1 + j, 1 + (j + 1) % lon])
        base = 1 + (lat - 1) * lon
        faces.append([len(unit) - 1, base + (j + 1) % lon, base + j])
    for i in range(lat - 1):
        for j in range(lon):
            a0 = 1 + i * lon + j
            b0 = 1 + i * lon + (j + 1) % lon
            c0, d0 = a0 + lon, b0 + lon
            faces.extend([[a0, b0, c0], [b0, d0, c0]])
    return verts.astype(np.float32), np.asarray(faces, np.int32)


# (driving joint, end joint, radius, lat, lon) — driving joint is the SMPL
# joint whose rotation moves this capsule's vertices
_BONES = [
    (0, 3, 0.13, 8, 14),    # pelvis->spine1 (lower torso)
    (3, 6, 0.13, 8, 14),    # spine1->spine2
    (6, 9, 0.12, 8, 14),    # spine2->spine3 (chest)
    (9, 12, 0.10, 6, 12),   # spine3->neck (upper chest)
    (12, 15, 0.045, 4, 8),  # neck
    (15, 15, 0.105, 8, 12), # head (sphere at head joint + offset handled below)
    (1, 4, 0.075, 8, 12),   # left thigh
    (2, 5, 0.075, 8, 12),   # right thigh
    (4, 7, 0.055, 8, 12),   # left calf
    (5, 8, 0.055, 8, 12),   # right calf
    (7, 10, 0.04, 4, 8),    # left foot
    (8, 11, 0.04, 4, 8),    # right foot
    (13, 16, 0.05, 4, 8),   # left collar->shoulder
    (14, 17, 0.05, 4, 8),   # right collar->shoulder
    (16, 18, 0.048, 6, 10), # left upper arm
    (17, 19, 0.048, 6, 10), # right upper arm
    (18, 20, 0.04, 6, 10),  # left forearm
    (19, 21, 0.04, 6, 10),  # right forearm
    (20, 25, 0.035, 4, 8),  # left palm (wrist->middle finger root area)
    (21, 40, 0.035, 4, 8),  # right palm
]


def build_humanoid_smplh(num_betas: int = 16, seed: int = 0,
                         return_aux: bool = False):
    """Full-size articulated SMPL-H stand-in model dict (the layout of the
    released chumpy pkls, loadable by core.smpl.load_smpl_pkl).

    With return_aux=True also returns {joints (52,3) T-pose locations,
    drive (6890,) driving joint per vertex} for asset synthesis."""
    rng = np.random.RandomState(seed)
    J = _tpose_joints()
    parents = np.asarray(SMPLH_PARENTS)

    verts_list, faces_list, drive_list, frac_list = [], [], [], []
    offset = 0
    for drive, end, radius, lat, lon in _BONES:
        p0 = J[drive]
        p1 = J[end] if end != drive else J[drive] + np.asarray(
            [0.0, 0.16, 0.0], np.float32)  # head sphere above the head joint
        v, f = _capsule(p0, p1, radius, lat, lon)
        # fraction along the bone for weight blending
        axis = p1 - p0
        denom = max(float(axis @ axis), 1e-9)
        s = np.clip(((v - p0) @ axis) / denom, 0.0, 1.0)
        verts_list.append(v)
        faces_list.append(f + offset)
        drive_list.append(np.full(len(v), drive, np.int32))
        frac_list.append(s.astype(np.float32))
        offset += len(v)
    # pad with tiny finger capsules until exactly 6890 verts
    fingers = [j for j in range(22, 52)]
    fi = 0
    while offset < 6890:
        need = 6890 - offset
        j = fingers[fi % len(fingers)]
        lat, lon = (2, 4) if need >= 10 else (1, max(3, need - 2))
        p0 = J[parents[j]] if parents[j] >= 22 else J[j]
        v, f = _capsule(p0, J[j], 0.012, lat, lon)
        if len(v) > need:  # final filler: isolated degenerate-free points
            v = np.repeat(J[j][None], need, 0) + \
                rng.randn(need, 3).astype(np.float32) * 0.004
            f = np.zeros((0, 3), np.int32) if need < 3 else \
                np.asarray([[0, 1, 2]], np.int32)
        verts_list.append(v)
        faces_list.append(f + offset)
        drive_list.append(np.full(len(v), int(parents[j]), np.int32))
        frac_list.append(np.full(len(v), 0.5, np.float32))
        offset += len(v)
        fi += 1
    v_template = np.concatenate(verts_list, 0)
    faces = np.concatenate(faces_list, 0)
    drive = np.concatenate(drive_list, 0)
    frac = np.concatenate(frac_list, 0)
    assert v_template.shape == (6890, 3), v_template.shape

    # skinning: blend between the driving joint and its first child along
    # the bone (weight shifts toward the child at the far end)
    child_of = {int(d): int(e) for d, e, *_ in _BONES if e != d}
    weights = np.zeros((6890, 52), np.float32)
    for i in range(6890):
        d = int(drive[i])
        c = child_of.get(d, d)
        wc = 0.5 * frac[i] if c != d else 0.0
        weights[i, d] = 1.0 - wc
        if c != d:
            weights[i, c] = wc

    # joint regressor: verts nearest each joint (uniform over the k nearest)
    from scipy.spatial import cKDTree
    tree = cKDTree(v_template)
    jreg = np.zeros((52, 6890), np.float32)
    for j in range(52):
        _, idx = tree.query(J[j], k=24)
        jreg[j, idx] = 1.0 / len(idx)

    # shape dirs: component 0 = overall scale, 1 = height, rest smooth noise
    shapedirs = np.zeros((6890, 3, num_betas), np.float32)
    shapedirs[:, :, 0] = (v_template - v_template.mean(0)) * 0.05
    shapedirs[:, 1, 1] = (v_template[:, 1] - v_template[:, 1].mean()) * 0.08
    shapedirs[:, :, 2:] = rng.randn(6890, 3, num_betas - 2) * 0.002
    posedirs = (rng.randn(6890, 3, 9 * 51) * 1e-4).astype(np.float32)

    kintree = np.zeros((2, 52), np.int64)
    kintree[0] = parents
    kintree[0, 0] = 2 ** 32 - 1
    kintree[1] = np.arange(52)
    model = dict(
        v_template=v_template.astype(np.float64),
        shapedirs=shapedirs.astype(np.float64),
        posedirs=posedirs.astype(np.float64),
        J_regressor=jreg.astype(np.float64),
        weights=weights.astype(np.float64),
        f=faces.astype(np.int64),
        kintree_table=kintree,
        betas=np.zeros(num_betas),
        gender="male",
    )
    if return_aux:
        return model, dict(joints=J, drive=drive)
    return model


# OpenPose BODY_25 keypoint -> (skeleton joint, offset) on the humanoid
# (the role of the real assets/body25_regressor.pkl: sparse, LOCALIZED
# regressors with correct body semantics — the real asset's vertex ids
# only localize on the licensed SMPL topology)
_BODY25_ANCHORS = {
    0: (15, (0.0, 0.13, 0.09)),    # nose
    1: (12, (0.0, 0.0, 0.0)),      # neck
    2: (17, (0.0, 0.0, 0.0)), 3: (19, (0.0, 0.0, 0.0)),
    4: (21, (0.0, 0.0, 0.0)),      # right arm chain
    5: (16, (0.0, 0.0, 0.0)), 6: (18, (0.0, 0.0, 0.0)),
    7: (20, (0.0, 0.0, 0.0)),      # left arm chain
    8: (0, (0.0, -0.06, 0.0)),     # midhip (the canonical "smpl center")
    9: (2, (0.0, 0.0, 0.0)), 10: (5, (0.0, 0.0, 0.0)),
    11: (8, (0.0, 0.0, 0.0)),      # right leg chain
    12: (1, (0.0, 0.0, 0.0)), 13: (4, (0.0, 0.0, 0.0)),
    14: (7, (0.0, 0.0, 0.0)),      # left leg chain
    15: (15, (-0.035, 0.15, 0.08)), 16: (15, (0.035, 0.15, 0.08)),  # eyes
    17: (15, (-0.08, 0.13, 0.0)), 18: (15, (0.08, 0.13, 0.0)),      # ears
    19: (10, (0.01, 0.0, 0.05)), 20: (10, (-0.01, 0.0, 0.04)),
    21: (7, (0.0, -0.02, -0.03)),  # left toes/heel
    22: (11, (-0.01, 0.0, 0.05)), 23: (11, (0.01, 0.0, 0.04)),
    24: (8, (0.0, -0.02, -0.03)),  # right toes/heel
}

# driving joint -> the 14 dense SMPL part names (assets/smpl_parts_dense)
_DRIVE_TO_PART = {
    15: "head", 12: "torso", 0: "torso", 3: "torso", 6: "torso",
    9: "torso", 13: "torso", 14: "torso",
    1: "upper_left_leg", 2: "upper_right_leg",
    4: "left_leg", 5: "right_leg",
    7: "left_foot", 10: "left_foot", 8: "right_foot", 11: "right_foot",
    16: "left_upperarm", 17: "right_upperarm",
    18: "left_midarm", 19: "right_midarm",
    20: "left_forearm", 21: "right_forearm",
}


def write_fixture_assets(assets_dir: str, model_dict: dict, aux: dict,
                         real_assets: str | None = None):
    """Synthesize the asset files the pipeline loads (landmark regressors,
    part labels) so they are sparse + localized on the humanoid topology;
    priors are copied from the real assets when available, else isotropic.
    """
    import scipy.sparse as sp
    from scipy.spatial import cKDTree
    os.makedirs(osp.join(assets_dir, "priors"), exist_ok=True)
    v = np.asarray(model_dict["v_template"], np.float32)
    J = aux["joints"]
    tree = cKDTree(v)

    def localized_regressor(points, k=12):
        reg = np.zeros((len(v), len(points)), np.float32)
        for i, p in enumerate(points):
            _, idx = tree.query(p, k=k)
            reg[idx, i] = 1.0 / k
        return sp.coo_matrix(reg)

    body25_pts = [J[j] + np.asarray(off, np.float32)
                  for j, (j_, off) in
                  ((k, _BODY25_ANCHORS[k]) for k in range(25))
                  for j in [j_]]
    with open(osp.join(assets_dir, "body25_regressor.pkl"), "wb") as f:
        pickle.dump(localized_regressor(body25_pts), f)
    # face: 70 points around the head; hands: 21 per wrist
    rngf = np.random.RandomState(1)
    head = J[15] + np.asarray([0.0, 0.13, 0.0], np.float32)
    face_pts = head + rngf.randn(70, 3).astype(np.float32) * 0.04
    with open(osp.join(assets_dir, "face_regressor.pkl"), "wb") as f:
        pickle.dump(localized_regressor(face_pts), f)
    hand_pts = np.concatenate([
        J[20] + rngf.randn(21, 3).astype(np.float32) * 0.03,
        J[21] + rngf.randn(21, 3).astype(np.float32) * 0.03])
    with open(osp.join(assets_dir, "hand_regressor.pkl"), "wb") as f:
        pickle.dump(localized_regressor(hand_pts), f)

    # part labels from the capsule structure
    part_names = ["head", "left_foot", "left_forearm", "left_leg",
                  "left_midarm", "left_upperarm", "right_foot",
                  "right_forearm", "right_leg", "right_midarm",
                  "right_upperarm", "torso", "upper_left_leg",
                  "upper_right_leg"]
    drive = aux["drive"]
    parts = {n: [] for n in part_names}
    for i in range(len(v)):
        parts[_DRIVE_TO_PART.get(int(drive[i]), "torso")].append(i)
    with open(osp.join(assets_dir, "smpl_parts_dense.pkl"), "wb") as f:
        pickle.dump({k: np.asarray(ix, np.int64)
                     for k, ix in parts.items()}, f)

    # priors: the real ones if present (they are generic pose plausibility)
    import shutil
    copied = False
    if real_assets and osp.isdir(osp.join(real_assets, "priors")):
        for n in ("body_prior.pkl", "lh_prior.pkl", "rh_prior.pkl"):
            src = osp.join(real_assets, "priors", n)
            if osp.isfile(src):
                shutil.copy(src, osp.join(assets_dir, "priors", n))
                copied = True
    if not copied:
        with open(osp.join(assets_dir, "priors", "body_prior.pkl"),
                  "wb") as f:
            pickle.dump(dict(mean=np.zeros(63), precision=np.eye(63) * 0.2),
                        f)
        for n in ("lh_prior.pkl", "rh_prior.pkl"):
            with open(osp.join(assets_dir, "priors", n), "wb") as f:
                pickle.dump(dict(mean=np.zeros(45),
                                 precision=np.eye(45) * 0.2), f)


# ---------------------------------------------------------------------------
# sequence rendering (full Kinect pixel geometry)
# ---------------------------------------------------------------------------

def _render_frame(cam, verts_s, faces_s, verts_o, faces_o, raster: int):
    """Person/object masks + a shaded RGB at full Kinect pixel coordinates.

    verts_s / verts_o are (V, 3) tensors on the render device. Rasterizes
    on a raster x raster NDC grid spanning the full image width (y shares
    the x scale, rows beyond 3/4 aspect are cropped) and upsamples to
    (height, width) as PIL's resize does (BILINEAR for the colour, NEAREST
    for the masks). Returns uint8 rgb, person, object and the object's
    visible share.
    """
    from ..data.images import resize_uint8_bilinear, resize_uint8_nearest
    from ..render.viz import render_shaded
    W, H = cam.width, cam.height

    def draw(v, f):
        ndc = 2.0 * cam.project_screen(v[None])[0] / W - 1.0
        shade, z = render_shaded(ndc, v[:, 2], v, f, raster)
        return shade.cpu().numpy(), z.cpu().numpy()

    s_sh, s_z = draw(verts_s, faces_s)
    o_sh, o_z = draw(verts_o, faces_o)
    rows = int(round(raster * H / W))
    sl = slice(0, rows)
    person = (s_z[sl] < 1e8)
    obj = (o_z[sl] < 1e8)
    # occlusion-aware visible masks (detector-style): nearer surface wins
    person_vis = person & (s_z[sl] <= o_z[sl])
    obj_vis = obj & (o_z[sl] < s_z[sl])
    rgb = np.zeros((rows, raster, 3), np.float32)
    rgb += 0.18  # background
    rgb = np.where(person_vis[..., None],
                   s_sh[sl][..., None] * np.asarray([0.55, 0.45, 0.40]), rgb)
    rgb = np.where(obj_vis[..., None],
                   o_sh[sl][..., None] * np.asarray([0.35, 0.55, 0.75]), rgb)
    rgb8 = resize_uint8_bilinear((np.clip(rgb, 0, 1) * 255).astype(np.uint8),
                                 (W, H))
    pm8 = resize_uint8_nearest((person_vis * 255).astype(np.uint8), (W, H))
    om8 = resize_uint8_nearest((obj_vis * 255).astype(np.uint8), (W, H))
    occ_ratio = float(obj_vis.sum()) / max(float(obj.sum()), 1.0)
    return rgb8, pm8, om8, occ_ratio


def generate_fixture_sequence(out_dir: str, T: int = 30,
                              seed: int = 0, raster: int = 512,
                              kid: int = 1, noise_px: float = 2.0,
                              real_assets: str | None = None,
                              motion_seed: int = 0,
                              object_shape: str = "box",
                              device="cuda", timings: dict | None = None):
    """Write a BEHAVE-layout sequence + GT pack + model pkl + template.

    Layout written under out_dir:
      Date09_Sub99_boxmedium/      the sequence (info.json, tXXXX.XXX/...)
      Date09_Sub99_boxmedium_GT-packed.pkl
      SMPLH_male.pkl               the capsule-humanoid model
      assets/                      synthesized regressors/parts (+ real
                                   priors when real_assets is given)
      objects/boxmedium/boxmedium.ply
    Returns a dict of the paths + GT arrays.

    motion_seed != 0 draws different motion-trajectory phases/rates while
    keeping the humanoid model, assets and object template byte-identical
    to motion_seed=0 (a held-out sequence). object_shape is "box" (with a
    cuboid's 180-degree self-symmetries) or "lbox"
    (cli/synthetic.py:lbox_mesh, no rotational self-symmetry); the
    sequence keeps the name "boxmedium" either way.

    Skinning and rendering run on `device` (cuda unless the caller asks
    for the CPU). If `timings` is a dict, it receives the seconds spent
    rendering, encoding and writing frames and, on a GPU, the render's
    peak device memory in GiB.
    """
    import time

    from scipy.spatial.transform import Rotation

    from ..cli.real_track import resolve_device
    from ..cli.synthetic import box_mesh, lbox_mesh
    from ..core.camera import PerspectiveCamera
    from ..core.landmarks import load_landmarks
    from ..core.smpl import lbs_forward, load_smpl_pkl
    from ..data.imageio import encode_jpeg, encode_png
    from ..data.packed import save_packed
    from ..utils.mesh import save_ply

    device = resolve_device(str(device))
    rng = np.random.RandomState(seed)
    if motion_seed:
        mr = np.random.RandomState(motion_seed)
        ph = float(mr.uniform(0.5, 2 * np.pi - 0.5))   # body sway phase
        ph_o = float(mr.uniform(0.5, 2 * np.pi - 0.5))  # orbit/spin phase
        amp = float(mr.uniform(0.8, 1.2))               # sway amplitude
        rspeed = float(mr.uniform(0.7, 1.4))            # object spin rate
        seq_name = f"Date{9 + motion_seed:02d}_Sub99_boxmedium"
    else:
        ph, ph_o, amp, rspeed = 0.0, 0.0, 1.0, 1.0
        seq_name = "Date09_Sub99_boxmedium"
    seq_dir = osp.join(out_dir, seq_name)
    os.makedirs(seq_dir, exist_ok=True)

    model_pkl = osp.join(out_dir, "SMPLH_male.pkl")
    model_dict, aux = build_humanoid_smplh(seed=seed, return_aux=True)
    with open(model_pkl, "wb") as f:
        pickle.dump(model_dict, f)
    model = load_smpl_pkl(model_pkl, device)
    assets_root = osp.join(out_dir, "assets")
    write_fixture_assets(assets_root, model_dict, aux,
                         real_assets=real_assets)
    landmarks = load_landmarks(assets_root, device)
    cam = PerspectiveCamera(crop_size=1200)

    # GT motion: smooth body sway + an object orbiting THROUGH the body
    # line of sight (creating a genuine occlusion interval for stage 5)
    t = np.linspace(0, 1, T).astype(np.float32)
    poses = np.zeros((T, 156), np.float32)
    swing = 0.35 * amp * np.sin(2 * np.pi * t + ph)
    for j, jamp in ((16, 0.5), (17, -0.5), (1, 0.25), (2, -0.25)):
        poses[:, 3 * j + 2] = swing * jamp
    # the canonical +y-up body flipped into the Kinect camera frame (y
    # down), as real BEHAVE SMPL fits carry it, composed with a z sway
    base = Rotation.from_euler("x", np.pi)
    sway = Rotation.from_euler(
        "z", (0.1 * amp * np.sin(2 * np.pi * t + ph))[:, None])
    poses[:, :3] = (base * sway).as_rotvec().astype(np.float32)
    betas = np.zeros((T, 10), np.float32)
    trans = np.stack([0.15 * amp * np.sin(2 * np.pi * t + ph),
                      0.35 + 0.02 * np.sin(np.pi * t),
                      2.4 + 0.1 * np.sin(np.pi * t + ph)], -1).astype(
                          np.float32)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    with torch.no_grad():
        verts = lbs_forward(model, dev(poses), dev(betas), dev(trans))[0]
        joints2d = cam.project_screen(
            landmarks.body_joints(verts)).cpu().numpy()

    if object_shape == "lbox":
        temp_v, temp_f = lbox_mesh((0.45, 0.3, 0.35))
    else:
        temp_v, temp_f = box_mesh((0.45, 0.3, 0.35))
    obj_root = osp.join(out_dir, "objects", "boxmedium")
    os.makedirs(obj_root, exist_ok=True)
    save_ply(osp.join(obj_root, "boxmedium.ply"), temp_v, temp_f)
    ang = 1.6 * rspeed * t + 0.3 * np.sin(2 * np.pi * t + ph_o)
    rot_gt = Rotation.from_euler(
        "yxz", np.stack([ang, 0.2 * np.sin(3 * t + ph_o),
                         0.1 * rspeed * t], -1)
    ).as_matrix().astype(np.float32)  # (T, 3, 3) REAL rotations
    # orbit: passes behind the person once per sequence
    orbit = 2 * np.pi * (t - 0.5) + ph_o
    obj_trans_gt = trans + np.stack(
        [0.75 * np.sin(orbit), 0.1 * np.cos(2 * orbit),
         0.55 * np.cos(orbit)], -1).astype(np.float32)

    with open(osp.join(seq_dir, "info.json"), "w") as f:
        json.dump(dict(cat="boxmedium", gender="male",
                       kinects=[0, 1, 2, 3], config=None, empty=None,
                       intrinsic=None, beta=[0.0] * 10), f)

    clock = dict.fromkeys(("render", "encode", "write"), 0.0)
    on_gpu = device.type == "cuda"
    if on_gpu:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    faces_s = torch.as_tensor(model.faces, device=device).long()
    faces_o = torch.as_tensor(temp_f, device=device).long()
    occ_ratios = np.zeros(T, np.float32)
    frames = [f"t0{i:03d}.000" for i in range(T)]
    for i in range(T):
        t0 = time.perf_counter()
        ov = temp_v @ rot_gt[i].T + obj_trans_gt[i]
        with torch.no_grad():
            rgb, pm, om, occ = _render_frame(cam, verts[i], faces_s,
                                             dev(ov), faces_o, raster)
        t1 = time.perf_counter()
        files = {f"k{kid}.color.jpg": encode_jpeg(rgb),
                 f"k{kid}.person_mask.png": encode_png(pm),
                 f"k{kid}.obj_rend_mask.png": encode_png(om)}
        t2 = time.perf_counter()
        occ_ratios[i] = occ
        fd = osp.join(seq_dir, frames[i])
        os.makedirs(fd, exist_ok=True)
        for name, data in files.items():
            with open(osp.join(fd, name), "wb") as f:
                f.write(data)
        kp = np.concatenate(
            [joints2d[i] + rng.randn(25, 2) * noise_px,
             np.full((25, 1), 0.9, np.float32)], -1)
        with open(osp.join(fd, f"k{kid}.color.json"), "w") as f:
            json.dump(dict(body_joints=kp.reshape(-1).tolist()), f)
        # FrankMocap-style init: noised GT body pose (72-d)
        p72 = np.concatenate([poses[i, :66], poses[i, 111:117]], 0)
        with open(osp.join(fd, f"k{kid}.mocap.json"), "w") as f:
            json.dump(dict(
                pose=(p72 + rng.randn(72) * 0.03).tolist(),
                betas=np.zeros(10).tolist()), f)
        clock["render"] += t1 - t0
        clock["encode"] += t2 - t1
        clock["write"] += time.perf_counter() - t2
    if timings is not None:
        timings.update(clock)
        if on_gpu:
            timings["render_peak_gib"] = \
                torch.cuda.max_memory_allocated(device) / 2 ** 30

    gt_pack = osp.join(out_dir, f"{seq_name}_GT-packed.pkl")
    occ4 = np.tile(occ_ratios[:, None], (1, 4)).astype(np.float32)
    save_packed(gt_pack, dict(
        poses=poses, betas=betas, trans=trans,
        obj_angles=Rotation.from_matrix(rot_gt).as_rotvec().astype(
            np.float32),  # GT packs store axis-angle
        obj_trans=obj_trans_gt, obj_scales=np.ones(T),
        occ_ratios=occ4, frames=frames, gender="male"))
    return dict(seq_dir=seq_dir, gt_pack=gt_pack, model_pkl=model_pkl,
                assets_root=assets_root,
                objects_root=osp.join(out_dir, "objects"),
                seq_name=seq_name, occ_ratios=occ_ratios,
                poses=poses, betas=betas, trans=trans, rot_gt=rot_gt,
                obj_trans_gt=obj_trans_gt)
