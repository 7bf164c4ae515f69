"""Signed-distance-grid sampling: the collision penalty of the stage-6
joint phase (port of vistracker_tpu/ops/sdf_grid.py).

A dense SDF grid of the object TEMPLATE is built once per sequence on the
host (utils/mesh.py:signed_distance_grid); SMPL vertices brought into the
template frame are penalized where their trilinear SDF is negative.
Differentiable w.r.t. the points, hence the object pose.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SDFGrid:
    values: torch.Tensor  # (R, R, R) signed distances (negative inside)
    bmin: torch.Tensor    # (3,) grid origin
    bmax: torch.Tensor    # (3,) grid extent


def sample_sdf(grid: SDFGrid, points: torch.Tensor) -> torch.Tensor:
    """Trilinear SDF lookup at points (..., 3) in the grid (template)
    frame; points outside clamp to the boundary value."""
    R = grid.values.shape[0]
    t = (points - grid.bmin) / (grid.bmax - grid.bmin) * (R - 1)
    t0 = torch.floor(t)
    w = t - t0
    i0 = torch.clamp(t0.detach().to(torch.int64), 0, R - 1)
    i1 = torch.clamp(i0 + 1, 0, R - 1)
    ix, iy, iz = ((i0[..., k], i1[..., k]) for k in range(3))
    v = grid.values
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    c00 = v[ix[0], iy[0], iz[0]] * (1 - wz) + v[ix[0], iy[0], iz[1]] * wz
    c01 = v[ix[0], iy[1], iz[0]] * (1 - wz) + v[ix[0], iy[1], iz[1]] * wz
    c10 = v[ix[1], iy[0], iz[0]] * (1 - wz) + v[ix[1], iy[0], iz[1]] * wz
    c11 = v[ix[1], iy[1], iz[0]] * (1 - wz) + v[ix[1], iy[1], iz[1]] * wz
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    return c0 * (1 - wx) + c1 * wx


def penetration_loss(grid: SDFGrid, points_template_frame: torch.Tensor):
    """Mean squared penetration depth of points into the template."""
    sdf = sample_sdf(grid, points_template_frame)
    return torch.clamp(sdf, max=0.0).square().mean()
