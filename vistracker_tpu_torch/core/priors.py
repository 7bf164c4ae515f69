"""SMPL pose priors (Mahalanobis body prior, GRAB hand priors).

Port of vistracker_tpu/core/priors.py.
"""
from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MahalanobisPrior:
    """Weighted L2 on whitened pose coefficients over pose[start:end]."""

    mean: torch.Tensor  # (D,)
    prec: torch.Tensor  # (D, D)
    start: int = 3
    end: int = 66

    def __call__(self, pose: torch.Tensor, weight: float = 1.0):
        """pose (B, P) full axis-angle pose -> (B,) prior energy."""
        w = ((pose[:, self.start:self.end] - self.mean) @ self.prec) * weight
        return (w * w).sum(1)


@dataclasses.dataclass(frozen=True)
class HandPrior:
    """GRAB hand prior on SMPL-H pose[prefix:], 45 dims per hand."""

    mean: torch.Tensor        # (90,)
    lhand_prec: torch.Tensor  # (45, 45)
    rhand_prec: torch.Tensor  # (45, 45)
    prefix: int = 66

    HAND_POSE_NUM = 45

    def __call__(self, full_pose: torch.Tensor) -> torch.Tensor:
        d = full_pose[:, self.prefix:] - self.mean
        w = torch.cat([d[:, :self.HAND_POSE_NUM] @ self.lhand_prec,
                       d[:, self.HAND_POSE_NUM:] @ self.rhand_prec], dim=1)
        return (w * w).sum(1)


def _load(assets_root: str, name: str) -> dict:
    with open(os.path.join(assets_root, "priors", name), "rb") as f:
        return pickle.load(f, encoding="latin1")


def load_body_prior(assets_root: str, device="cpu") -> MahalanobisPrior:
    dat = _load(assets_root, "body_prior.pkl")
    return MahalanobisPrior(
        mean=torch.as_tensor(np.asarray(dat["mean"], np.float32).reshape(-1),
                             device=device),
        prec=torch.as_tensor(np.asarray(dat["precision"], np.float32),
                             device=device))


def load_hand_prior(assets_root: str, device="cpu") -> HandPrior:
    lh, rh = _load(assets_root, "lh_prior.pkl"), _load(assets_root,
                                                       "rh_prior.pkl")
    return HandPrior(
        mean=torch.as_tensor(mean_hand_pose(assets_root), device=device),
        lhand_prec=torch.as_tensor(np.asarray(lh["precision"], np.float32),
                                   device=device),
        rhand_prec=torch.as_tensor(np.asarray(rh["precision"], np.float32),
                                   device=device))


def mean_hand_pose(assets_root: str) -> np.ndarray:
    """(90,) GRAB mean hand pose, used to pad 72-d poses to SMPL-H."""
    lh, rh = _load(assets_root, "lh_prior.pkl"), _load(assets_root,
                                                       "rh_prior.pkl")
    return np.concatenate([np.asarray(lh["mean"], np.float32).reshape(-1),
                           np.asarray(rh["mean"], np.float32).reshape(-1)])
