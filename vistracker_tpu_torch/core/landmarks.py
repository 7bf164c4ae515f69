"""Body/face/hand landmark regressors (dense (K, V) matrices).

Port of vistracker_tpu/core/landmarks.py. The "SMPL center" used across
the pipeline is body25 joint 8 (mid-hip).
"""
from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch

SMPL_CENTER_JOINT = 8  # body25 mid-hip


def _load_sparse_T(path: str) -> np.ndarray:
    """scipy-sparse regressor pkl -> dense (num_landmarks, num_verts)."""
    with open(path, "rb") as f:
        mat = pickle.load(f, encoding="latin1")
    return np.asarray(mat.T.todense() if hasattr(mat, "todense") else mat.T,
                      dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class BodyLandmarks:
    body25: torch.Tensor  # (25, V)
    face: torch.Tensor    # (70, V)
    hand: torch.Tensor    # (42, V)

    def body_joints(self, verts: torch.Tensor) -> torch.Tensor:
        """verts (..., V, 3) -> body25 joints (..., 25, 3)."""
        return torch.einsum("jv,...vk->...jk", self.body25, verts)

    def smpl_center(self, verts: torch.Tensor) -> torch.Tensor:
        """verts (..., V, 3) -> (..., 3) body25 joint 8 (mid-hip)."""
        return self.body_joints(verts)[..., SMPL_CENTER_JOINT, :]


def load_landmarks(assets_root: str, device="cpu") -> BodyLandmarks:
    def reg(name):
        return torch.as_tensor(
            _load_sparse_T(os.path.join(assets_root, f"{name}.pkl")),
            device=device)

    return BodyLandmarks(body25=reg("body25_regressor"),
                         face=reg("face_regressor"),
                         hand=reg("hand_regressor"))


def load_part_labels(assets_root: str) -> dict:
    """Per-vertex part index dict from smpl_parts_dense.pkl."""
    with open(os.path.join(assets_root, "smpl_parts_dense.pkl"), "rb") as f:
        return pickle.load(f, encoding="latin1")


def part_labels_array(parts: dict, num_verts: int = 6890) -> np.ndarray:
    """{part_name: vertex_ids} -> (V,) int32 labels; part index is the
    dict's iteration order (the reference's label convention)."""
    labels = np.zeros(num_verts, np.int32)
    for idx, name in enumerate(parts):
        labels[np.asarray(parts[name]).reshape(-1)] = idx
    return labels
