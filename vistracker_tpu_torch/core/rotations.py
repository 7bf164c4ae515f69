"""Rotation representation conversions as batched torch functions.

Port of the converters of vistracker_tpu/core/rotations.py, with the
same conventions:
  * quaternions are (w, x, y, z)
  * rot6d is the first two COLUMNS of R, flattened row-major from R[..., :2]
  * rot6d -> R is the Zhou et al. Gram-Schmidt with b1, b2, b3 as columns
Every function vectorizes over arbitrary leading axes.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def axis_angle_to_quat(theta: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> unit quaternion (..., 4); the angle is
    ||theta + 1e-8|| so the zero rotation is well-defined."""
    angle = torch.linalg.norm(theta + _EPS, dim=-1, keepdim=True)
    normalized = theta / angle
    half = angle * 0.5
    return torch.cat([torch.cos(half), torch.sin(half) * normalized], dim=-1)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Unit-normalizes and converts quaternion (..., 4) -> rotmat (..., 3, 3)."""
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = quat.unbind(-1)
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rot = torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=-1)
    return rot.reshape(quat.shape[:-1] + (3, 3))


def axis_angle_to_rotmat(theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle (..., 3) -> rotation matrix (..., 3, 3)."""
    return quat_to_rotmat(axis_angle_to_quat(theta))


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6D rotation (..., 6) -> rotmat (..., 3, 3), Zhou et al. Gram-Schmidt
    on the two raw columns of the (3, 2) matrix."""
    m = x.reshape(x.shape[:-1] + (3, 2))
    a1, a2 = m[..., 0], m[..., 1]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True),
                          min=1e-12)
    b2u = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2u / torch.clamp(torch.linalg.norm(b2u, dim=-1, keepdim=True),
                           min=1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_rot6d(rot: torch.Tensor) -> torch.Tensor:
    """Rotmat (..., 3, 3) -> 6D (..., 6): first two columns, row-major."""
    return rot[..., :, :2].reshape(rot.shape[:-2] + (6,))


def rotmat_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotmat (..., 3, 3) -> unit quaternion (..., 4), branch-free
    Shepperd-style selection of the best-conditioned candidate."""
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    tr = m00 + m11 + m22

    def _safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-12))

    s0 = _safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], dim=-1)
    s1 = _safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], dim=-1)
    s2 = _safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], dim=-1)
    s3 = _safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], dim=-1)

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1,
                                           torch.where(cond2, q2, q3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_axis_angle(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) -> axis-angle (..., 3), angle in [0, pi]."""
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    quat = torch.where(quat[..., 0:1] < 0.0, -quat, quat)
    w = quat[..., 0]
    xyz = quat[..., 1:]
    sin_half = torch.linalg.norm(xyz, dim=-1)
    angle = 2.0 * torch.atan2(sin_half, w)
    # near zero rotation, axis*angle ~= 2*xyz (sin(t/2) ~ t/2)
    small = sin_half < 1e-6
    scale = torch.where(small, torch.full_like(angle, 2.0),
                        angle / torch.where(small, torch.ones_like(sin_half),
                                            sin_half))
    return xyz * scale[..., None]


def rotmat_to_axis_angle(rot: torch.Tensor) -> torch.Tensor:
    return quat_to_axis_angle(rotmat_to_quat(rot))


def axis_angle_to_rot6d(theta: torch.Tensor) -> torch.Tensor:
    return rotmat_to_rot6d(axis_angle_to_rotmat(theta))


def rot6d_to_axis_angle(x: torch.Tensor) -> torch.Tensor:
    return rotmat_to_axis_angle(rot6d_to_rotmat(x))


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
    """Shortest-arc spherical interpolation between unit quaternions
    (..., 4), t broadcastable to (...,) or (..., 1). As the JAX version:
    for dot(q0, q1) < 0 it takes the true shortest arc (q1 flipped, angle
    from |dot|) where the reference slerp keeps the obtuse half-angle in
    its weights; where |dot| > 0.9995 it lerps."""
    q0 = q0 / torch.linalg.norm(q0, dim=-1, keepdim=True)
    q1 = q1 / torch.linalg.norm(q1, dim=-1, keepdim=True)
    dot = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(dot < 0.0, -q1, q1)
    dot = torch.clamp(dot.abs(), -1.0, 1.0)
    theta = torch.acos(dot)
    sin_theta = torch.sin(theta)
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.dim() == q0.dim() - 1:
        t = t[..., None]
    use_lerp = dot > 0.9995
    safe_sin = torch.where(use_lerp, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(use_lerp, 1.0 - t,
                     torch.sin((1.0 - t) * theta) / safe_sin)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / safe_sin)
    out = w0 * q0 + w1 * q1
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)


def project_so3(mat: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) matrices onto SO(3): U diag(1, 1, det(U Vt)) Vt
    from the SVD, so the result is a proper rotation. Differentiable (the
    stage-6 optimizer differentiates it; see fit/joint.py:decopose_axis
    for the perturbation that keeps the singular values apart)."""
    u, _, vt = torch.linalg.svd(mat)
    det = torch.linalg.det(u @ vt)
    d = torch.cat([torch.ones_like(det)[..., None].expand(
        det.shape + (2,)), det[..., None]], -1)
    return (u * d[..., None, :]) @ vt


def rotation_angle_deg(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle in degrees between rotation matrices (..., 3, 3)."""
    rel = r1 @ r2.transpose(-1, -2)
    tr = rel[..., 0, 0] + rel[..., 1, 1] + rel[..., 2, 2]
    return torch.rad2deg(torch.acos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)))
