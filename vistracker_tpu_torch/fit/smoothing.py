"""SmoothNet inference runners (pipeline stage 2 and the stage-5 object
rotation smoothing).

Port of vistracker_tpu/fit/smoothing.py: the sequence becomes overlapping
W=64 windows, all windows go through the net in one batch, and the
overlap average brings them back. SMPL-T: 24-joint rot6d + betas +
per-window-relative translation (SMPL-H poses reduced to joints 0-22 plus
the right-hand root). Object: rot6d of real rotations; the result is
returned TRANSPOSED, the packed obj_angles convention.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.rotations import (axis_angle_to_rot6d, rot6d_to_axis_angle,
                              rot6d_to_rotmat, rotmat_to_rot6d)
from ..ops.window_ops import pad_to_window, seq_to_windows, windows_to_seq

SMPLT_START = 24 * 6 + 10  # translation offset in the 157-d feature


def smplh_to_smpl_pose(pose: np.ndarray) -> np.ndarray:
    """(T, 156) SMPL-H -> (T, 72) SMPL body pose."""
    return np.concatenate([pose[:, :69], pose[:, 111:114]], 1)


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def smooth_smplt(model, poses: np.ndarray, betas: np.ndarray,
                 trans: np.ndarray, window: int = 64, step: int = 1) -> dict:
    """Smooth an SMPL-T trajectory with a SmoothNetSMPL (in eval mode, on
    its own device). poses (T, 156 or 72). Returns numpy poses (T, 72),
    betas, trans and nan dummy object entries."""
    dev = _device_of(model)
    T = len(poses)
    p72 = smplh_to_smpl_pose(poses) if poses.shape[-1] == 156 else poses
    rot6d = axis_angle_to_rot6d(torch.as_tensor(
        np.asarray(p72, np.float32).reshape(-1, 3))).numpy().reshape(T, 144)
    feats = np.concatenate([rot6d, betas, trans], 1).astype(np.float32)
    feats, orig_len = pad_to_window(feats, window)

    w = seq_to_windows(torch.as_tensor(feats, device=dev), window, step)
    tsl = slice(SMPLT_START, SMPLT_START + 3)
    t_init = w[:, 0:1, tsl].clone()
    w[:, :, tsl] -= t_init          # per-window-relative translation
    den = model(w.transpose(1, 2)).transpose(1, 2).clone()
    den[:, :, tsl] += t_init
    seq = windows_to_seq(den, step)[:orig_len]
    out_pose = rot6d_to_axis_angle(seq[:, :144].reshape(-1, 6)) \
        .reshape(orig_len, 72)
    seq = seq.cpu().numpy()
    L = orig_len
    return {"poses": out_pose.cpu().numpy(), "betas": seq[:, 144:154],
            "trans": seq[:, tsl],
            "obj_angles": np.full((L, 3, 3), np.nan),
            "obj_trans": np.full((L, 3), np.nan),
            "obj_scales": np.full((L,), np.nan)}


@torch.no_grad()
def smooth_objrot(model, obj_rot_real: np.ndarray, window: int = 64,
                  step: int = 1) -> np.ndarray:
    """Smooth object rotations with a SmoothNet. obj_rot_real (T, 3, 3)
    REAL rotation matrices; returns (T, 3, 3) in the packed (transposed)
    convention."""
    dev = _device_of(model)
    rot6d = rotmat_to_rot6d(torch.as_tensor(
        np.asarray(obj_rot_real, np.float32))).numpy()
    feats, orig_len = pad_to_window(rot6d.astype(np.float32), window)
    w = seq_to_windows(torch.as_tensor(feats, device=dev), window, step)
    den = model(w.transpose(1, 2)).transpose(1, 2)
    seq = windows_to_seq(den, step)[:orig_len]
    return rot6d_to_rotmat(seq).cpu().numpy().transpose(0, 2, 1)
