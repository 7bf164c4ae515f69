"""Synthetic scene generator: drives the whole pipeline without BEHAVE data.

Port of vistracker_tpu/cli/synthetic.py (the same numpy draws for a seed):
a toy SMPL body moving smoothly at ~2.2 m depth, a box orbiting it, a
pinhole camera, 2D keypoint observations and occlusion ratios, behind
`track --synthetic` (cli/main.py:run_synthetic_track). The fixture
generator (data/fixture.py) takes its object templates from here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.landmarks import BodyLandmarks
from ..core.priors import HandPrior, MahalanobisPrior
from ..core.smpl import SMPLModel, lbs_forward, random_smpl_model
from ..fit.smplt import SMPLTFitConfig, project_pixels


def box_mesh(extents=(0.3, 0.2, 0.25)):
    """Axis-aligned box template mesh centered at the origin."""
    ex, ey, ez = [e / 2.0 for e in extents]
    v = np.array([[sx * ex, sy * ey, sz * ez]
                  for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                 np.float32)
    f = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


def lbox_mesh(extents=(0.45, 0.3, 0.35), flange=(0.2, 0.18, 0.16)):
    """Asymmetric template: the main box plus a smaller flange box fused
    onto one corner. A plain box has exact 180-degree rotational
    self-symmetries; the flange breaks every one of them, so the object
    pose is fully observable."""
    v1, f1 = box_mesh(extents)
    v2, f2 = box_mesh(flange)
    off = np.array([extents[0] / 2 + flange[0] / 2 - 0.02,
                    extents[1] / 2 - flange[1] / 2,
                    extents[2] / 2 - flange[2] / 2], np.float32)
    v = np.concatenate([v1, v2 + off], 0)
    f = np.concatenate([f1, f2 + len(v1)], 0)
    return (v - v.mean(0)).astype(np.float32), f.astype(np.int32)


@dataclasses.dataclass
class SyntheticScene:
    model: SMPLModel              # toy model on the scene's device
    landmarks: BodyLandmarks
    body_prior: MahalanobisPrior
    hand_prior: HandPrior
    fit_cfg: SMPLTFitConfig
    # GT trajectory
    poses_gt: np.ndarray          # (T, 156)
    betas_gt: np.ndarray          # (T, 10)
    trans_gt: np.ndarray          # (T, 3)
    obj_rot_gt: np.ndarray        # (T, 3, 3) row-vector convention
    obj_trans_gt: np.ndarray      # (T, 3)
    # observations
    kpts: np.ndarray              # (T, 25, 3) pixel x, y, conf
    occ_ratios: np.ndarray        # (T,)
    # object template
    temp_verts: np.ndarray
    temp_faces: np.ndarray
    part_labels: np.ndarray       # (V,) toy part labels
    smpl_faces: np.ndarray


def make_scene(n_frames: int = 8, num_verts: int = 128, seed: int = 0,
               device="cpu") -> SyntheticScene:
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    model = random_smpl_model(seed, num_joints=52, num_verts=num_verts,
                              device=device)
    reg = rng.rand(25, num_verts).astype(np.float32)
    reg /= reg.sum(1, keepdims=True)
    reg_t = torch.as_tensor(reg, device=device)
    landmarks = BodyLandmarks(body25=reg_t, face=reg_t[:1], hand=reg_t[:1])
    body_prior = MahalanobisPrior(
        mean=torch.zeros(63, device=device),
        prec=torch.eye(63, device=device) * 0.1)
    hand_prior = HandPrior(mean=torch.zeros(90, device=device),
                           lhand_prec=torch.eye(45, device=device) * 0.1,
                           rhand_prec=torch.eye(45, device=device) * 0.1)
    cfg = SMPLTFitConfig()

    T = n_frames
    t = np.linspace(0, 1, T).astype(np.float32)
    poses = np.zeros((T, 156), np.float32)
    poses[:, 3:66] = 0.15 * np.sin(2 * np.pi * t)[:, None] \
        * rng.randn(63)[None] * 0.3
    betas = np.zeros((T, 10), np.float32)
    trans = np.stack([0.2 * np.sin(2 * np.pi * t), 0.05 * t,
                      2.2 + 0.1 * np.sin(np.pi * t)], -1).astype(np.float32)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    with torch.no_grad():
        verts = lbs_forward(model, dev(poses), dev(betas), dev(trans))[0]
        joints = landmarks.body_joints(verts)
        kpts2d = project_pixels(joints, cfg).cpu().numpy()
        body_centers = landmarks.smpl_center(verts).cpu().numpy()
    kpts = np.concatenate(
        [kpts2d + rng.randn(T, 25, 2) * 1.0,  # 1px observation noise
         np.ones((T, 25, 1), np.float32)], -1).astype(np.float32)

    # object: a box orbiting the body, smooth rotation
    temp_verts, temp_faces = box_mesh()
    ang = 0.8 * t
    rot = Rotation.from_euler("y", ang[:, None]).as_matrix().astype(
        np.float32)
    obj_rot = rot.transpose(0, 2, 1)  # row-vector convention
    obj_trans = body_centers + np.stack(
        [0.45 * np.cos(2 * np.pi * t), 0.1 * np.ones(T),
         0.45 * np.sin(2 * np.pi * t) * 0.2], -1).astype(np.float32)

    occ = np.clip(0.8 + 0.3 * np.sin(4 * np.pi * t)
                  + rng.randn(T) * 0.05, 0.0, 1.0).astype(np.float32)

    part_labels = rng.randint(0, 14, num_verts).astype(np.int32)
    return SyntheticScene(
        model=model, landmarks=landmarks, body_prior=body_prior,
        hand_prior=hand_prior, fit_cfg=cfg, poses_gt=poses, betas_gt=betas,
        trans_gt=trans, obj_rot_gt=obj_rot, obj_trans_gt=obj_trans,
        kpts=kpts, occ_ratios=occ, temp_verts=temp_verts,
        temp_faces=temp_faces, part_labels=part_labels,
        smpl_faces=model.faces)
