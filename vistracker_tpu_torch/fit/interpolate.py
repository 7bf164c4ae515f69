"""Slerp/lerp object-pose infilling, the non-learned baseline for HVOP-Net.

Port of vistracker_tpu/fit/interpolate.py: occluded intervals come from a
visibility threshold; inside an interval the object rotation is the
quaternion slerp and the translation the lerp between the nearest visible
frames on either side; leading and trailing occluded frames copy the
nearest visible one. Rotations go through float32 quaternions, as in the
JAX version.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.rotations import quat_slerp, quat_to_rotmat, rotmat_to_quat


def occluded_intervals(visible: np.ndarray) -> list[tuple[int, int]]:
    """Maximal [start, end) runs of invisible frames."""
    out = []
    T = len(visible)
    i = 0
    while i < T:
        if not visible[i]:
            j = i
            while j < T and not visible[j]:
                j += 1
            out.append((i, j))
            i = j
        else:
            i += 1
    return out


def slerp_fill(rots: np.ndarray, trans: np.ndarray, occ_ratios: np.ndarray,
               thres: float = 0.5):
    """Fill occluded object poses by interpolation: rots (T, 3, 3) REAL
    rotations, trans (T, 3); a frame is occluded where occ_ratios < thres.
    Returns (rots_filled, trans_filled); unchanged copies when every frame
    or no frame is visible."""
    T = len(rots)
    visible = np.asarray(occ_ratios).reshape(-1) >= thres
    if visible.all() or not visible.any():
        return rots.copy(), trans.copy()

    quats = rotmat_to_quat(torch.as_tensor(np.asarray(rots, np.float32)))
    out_q = quats.clone()
    out_t = trans.copy()
    for start, end in occluded_intervals(visible):
        left, right = start - 1, end
        if left < 0:  # leading: copy the right anchor
            out_q[start:end] = quats[right]
            out_t[start:end] = trans[right]
            continue
        if right >= T:  # trailing: copy the left anchor
            out_q[start:end] = quats[left]
            out_t[start:end] = trans[left]
            continue
        n = end - start
        ts = (np.arange(1, n + 1) / (n + 1)).astype(np.float32)
        out_q[start:end] = quat_slerp(quats[left].expand(n, 4),
                                      quats[right].expand(n, 4),
                                      torch.as_tensor(ts))
        out_t[start:end] = ((1 - ts)[:, None] * trans[left]
                            + ts[:, None] * trans[right])
    return quat_to_rotmat(out_q).numpy(), out_t
