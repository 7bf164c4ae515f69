"""Evaluation metrics: Procrustes alignment, chamfer, v2v, acceleration.

Port of vistracker_tpu/eval/metrics.py. The alignment and the per-vertex
metrics stay numpy float64, as there (the reference's float64 SVD); the
chamfer samples the two surfaces with the same numpy draws and runs
its nearest neighbours through kernel K4 (ops/chamfer.py) on the given
device. Units: metres * 100 = cm.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.chamfer import chamfer_distance
from ..utils.mesh import sample_surface

UNIT_CVT = 100.0  # metres -> centimetres


def compute_transform(s1: np.ndarray, s2: np.ndarray):
    """Similarity transform (R (3, 3), t (3, 1), scale) mapping s1 -> s2,
    both (N, 3): aligned = scale * R @ v + t."""
    S1, S2 = np.asarray(s1, np.float64).T, np.asarray(s2, np.float64).T
    mu1 = S1.mean(axis=1, keepdims=True)
    mu2 = S2.mean(axis=1, keepdims=True)
    X1, X2 = S1 - mu1, S2 - mu2
    var1 = np.sum(X1 ** 2)
    K = X1 @ X2.T
    U, _, Vh = np.linalg.svd(K)
    V = Vh.T
    Z = np.eye(3)
    Z[-1, -1] = np.sign(np.linalg.det(U @ V.T))
    R = V @ Z @ U.T
    scale = np.trace(R @ K) / var1
    t = mu2 - scale * (R @ mu1)
    return R, t, scale


def apply_transform(verts: np.ndarray, R: np.ndarray, t: np.ndarray,
                    scale: float) -> np.ndarray:
    """(T, N, 3) or (N, 3) -> aligned, matching (scale * R @ v.T + t).T."""
    return scale * np.einsum("ij,...nj->...ni", R, verts) + t[:, 0]


def v2v_error(gt: np.ndarray, recon: np.ndarray) -> float:
    """Mean per-vertex L2 distance, cm."""
    return float(np.sqrt(((gt - recon) ** 2).sum(-1)).mean() * UNIT_CVT)


def chamfer_error(gt_verts, gt_faces, recon_verts, recon_faces,
                  n_samples: int = 10000, seed: int = 0,
                  device="cuda") -> float:
    """Bidirectional sqrt chamfer on area-weighted surface samples, cm;
    the samples are drawn from RandomState(seed) as in the JAX version,
    the distances computed on `device`."""
    rng = np.random.RandomState(seed)
    p1 = sample_surface(np.asarray(gt_verts), np.asarray(gt_faces),
                        n_samples, rng)
    p2 = sample_surface(np.asarray(recon_verts), np.asarray(recon_faces),
                        n_samples, rng)
    d = chamfer_distance(torch.as_tensor(p1, device=device)[None],
                         torch.as_tensor(p2, device=device)[None],
                         sqrt=True)
    return float(d[0]) * UNIT_CVT


def accel_error(verts_gt: np.ndarray, verts_recon: np.ndarray) -> float:
    """Mean ||accel_gt - accel_recon|| over a window, cm."""
    if len(verts_gt) < 3:
        return 0.0
    a_gt = verts_gt[:-2] - 2 * verts_gt[1:-1] + verts_gt[2:]
    a_rc = verts_recon[:-2] - 2 * verts_recon[1:-1] + verts_recon[2:]
    return float(np.linalg.norm(a_gt - a_rc, axis=2).mean() * UNIT_CVT)
