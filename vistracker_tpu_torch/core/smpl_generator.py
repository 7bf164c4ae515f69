"""SMPL-H batch construction (port of vistracker_tpu/core/smpl_generator.py)."""
from __future__ import annotations

import numpy as np
import torch

from ..fit.smplt import SMPLTParams
from .priors import mean_hand_pose


def smplh_params(pose: np.ndarray, betas: np.ndarray, trans: np.ndarray,
                 assets_root: str | None = None,
                 mean_hands: np.ndarray | None = None,
                 device="cpu") -> SMPLTParams:
    """Split SMPL-H parameters from packed arrays. 72-d poses keep body
    pose [:66] and take the GRAB mean hand pose (the reference drops the
    72-d pose's wrist entries 66:72)."""
    pose = np.asarray(pose, np.float32).reshape(len(pose), -1)
    if pose.shape[1] == 72:
        if mean_hands is None:
            if not assets_root:
                raise ValueError("need assets_root or mean_hands to pad a "
                                 "72-d pose")
            mean_hands = mean_hand_pose(assets_root)
        full = np.zeros((len(pose), 156), np.float32)
        full[:, :66] = pose[:, :66]
        full[:, 66:] = mean_hands
        pose = full
    if pose.shape[1] != 156:
        raise ValueError(f"pose must be 72- or 156-d, got {pose.shape}")
    betas = np.asarray(betas, np.float32)
    if betas.shape[1] < 10:
        betas = np.pad(betas, ((0, 0), (0, 10 - betas.shape[1])))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    return SMPLTParams.from_full(t(pose), t(betas[:, :10]), t(trans))
