"""Orthographic coverage masks for the stage-3 triplane inputs.

Port of vistracker_tpu/ops/rasterizer.py. Each face becomes 5 inside-positive
linear planes -- its 3 unit-normal edge lines and 2 caps through the
endpoints of its longest edge -- and a pixel is covered iff the min over
a face's planes is >= 0 for some face. `render_triplane_masks_batch`
runs every view through the coverage kernel (ops/coverage.py, kernel K1);
`rasterize_mask` is the plain dense formulation kept as a reference, and
`soft_silhouette` the plain dense differentiable silhouette that the
stage-6 kernel path (ops/coverage.py:soft_silhouette_batch) is tested
against. `render_triplane_masks` is the per-frame form of the stage-3
render over `rasterize_mask`; it equals `render_triplane_masks_batch`
frame by frame.
"""
from __future__ import annotations

import numpy as np
import torch


def pixel_grid(size: int) -> np.ndarray:
    """(3, P) homogeneous NDC pixel centers, align_corners=True: col 0 ->
    x=-1, col size-1 -> x=+1; row 0 -> y=-1."""
    lin = np.linspace(-1.0, 1.0, size, dtype=np.float32)
    xx, yy = np.meshgrid(lin, lin)
    return np.stack([xx.reshape(-1), yy.reshape(-1),
                     np.ones(size * size, np.float32)], 0)


def _edge_coeffs(v2d: torch.Tensor, faces: torch.Tensor):
    """Per-face edge-function coefficients for v2d (..., V, 2), faces
    (F, 3): coeffs (..., F, 3, 3) with e_i(p) = coeffs . [px, py, 1],
    lengths (..., F, 3), orient (..., F) = +-1 (inside positive) and the
    non-degenerate flag (..., F)."""
    a = v2d[..., faces[:, 0], :]
    b = v2d[..., faces[:, 1], :]
    c = v2d[..., faces[:, 2], :]

    def edge(p0, p1):
        dx = p1[..., 0] - p0[..., 0]
        dy = p1[..., 1] - p0[..., 1]
        return (torch.stack([-dy, dx, dy * p0[..., 0] - dx * p0[..., 1]], -1),
                torch.sqrt(dx * dx + dy * dy + 1e-12))

    e0, l0 = edge(a, b)
    e1, l1 = edge(b, c)
    e2, l2 = edge(c, a)
    coeffs = torch.stack([e0, e1, e2], -2)
    lengths = torch.stack([l0, l1, l2], -1)
    area2 = (e0 * torch.stack([c[..., 0], c[..., 1],
                               torch.ones_like(c[..., 0])], -1)).sum(-1)
    orient = torch.sign(area2)
    # scale-aware degeneracy cut: fp32 roundoff in area2 is ~1e-7 * Lmax,
    # so an absolute threshold would let exactly-degenerate faces flicker
    lmax = lengths.amax(-1)
    nondegenerate = area2.abs() > 1e-6 * (lmax + lmax * lmax)
    return coeffs, lengths, orient, nondegenerate


def _face_planes(v2d: torch.Tensor, faces: torch.Tensor):
    """Normalized inside-positive planes (..., F, 5, 3) + validity (..., F).

    Rows 0-2: the edge lines as unit-normal signed distances. Rows 3-4:
    caps through the longest edge's endpoints, perpendicular to it and
    facing the segment. Inside a valid triangle the caps never bind; for
    near-collinear faces they clip the otherwise unbounded "ghost ray"
    where the three edge lines nearly coincide.
    """
    coeffs, lengths, orient, nondeg = _edge_coeffs(v2d, faces)
    planes = coeffs * (orient[..., None, None] / lengths[..., None])
    pts = v2d[..., faces, :]                          # (..., F, 3, 2)
    ends = torch.roll(pts, -1, dims=-2)
    j = torch.argmax(lengths, dim=-1)                 # longest edge
    idx = j[..., None, None].expand(j.shape + (1, 2))
    p0 = torch.gather(pts, -2, idx)[..., 0, :]
    p1 = torch.gather(ends, -2, idx)[..., 0, :]
    u = (p1 - p0) / lengths.amax(-1, keepdim=True)
    cap0 = torch.cat([u, -(u * p0).sum(-1, keepdim=True)], -1)
    cap1 = torch.cat([-u, (u * p1).sum(-1, keepdim=True)], -1)
    planes = torch.cat([planes, cap0[..., None, :], cap1[..., None, :]], -2)
    return planes, nondeg


def rasterize_mask(v2d: torch.Tensor, faces: torch.Tensor, size: int = 512,
                   chunk: int = 512) -> torch.Tensor:
    """Binary coverage mask (size, size) float32 {0, 1} of one 2D mesh
    (v2d (V, 2) NDC, faces (F, 3)); row 0 is y = -1. Dense reference:
    every face against every pixel, `chunk` faces at a time."""
    grid = torch.as_tensor(pixel_grid(size), device=v2d.device)
    planes, nondeg = _face_planes(v2d, faces)
    mask = torch.zeros(size * size, dtype=torch.bool, device=v2d.device)
    for s in range(0, faces.shape[0], chunk):
        e = torch.einsum("fip,pn->fin", planes[s:s + chunk], grid)
        inside = (e >= 0.0).all(1) & nondeg[s:s + chunk, None]
        mask |= inside.any(0)
    return mask.reshape(size, size).float()


def soft_silhouette(v2d: torch.Tensor, faces: torch.Tensor, size: int = 256,
                    sigma: float = 1e-4, chunk: int = 512) -> torch.Tensor:
    """Differentiable silhouette (size, size) in [0, 1] of one 2D mesh:
    per face p_f = sigmoid(min over its 5 planes / sigma), faces combined
    with max. Dense and differentiable through autograd (max and min
    split a cotangent equally among exact ties, as torch.amax / amin do);
    an independent reference, not a path."""
    grid = torch.as_tensor(pixel_grid(size), device=v2d.device)
    planes, nondeg = _face_planes(v2d, faces)
    sil = torch.zeros(size * size, dtype=v2d.dtype, device=v2d.device)
    for s in range(0, faces.shape[0], chunk):
        e = torch.einsum("fip,pn->fin", planes[s:s + chunk], grid)
        p = torch.sigmoid(e.amin(1) / sigma)
        p = torch.where(nondeg[s:s + chunk, None], p, torch.zeros_like(p))
        sil = torch.maximum(sil, p.amax(0))
    return sil.reshape(size, size)


def triplane_ndc(verts: torch.Tensor,
                 body_center: torch.Tensor) -> torch.Tensor:
    """(V, 3) camera-frame verts, (3,) body center -> (3, V, 2) NDC on
    the right/back/top planes, the convention of the SIF-Net query path
    (core/camera.py:triplane_project)."""
    from ..core.camera import triplane_project
    return triplane_project(verts[None], body_center[None])[0]


def render_triplane_masks(verts: torch.Tensor, faces: torch.Tensor,
                          body_center: torch.Tensor,
                          size: int = 512) -> torch.Tensor:
    """One frame's stage-3 triplane masks through the plain dense
    rasterizer: (size, size, 3) float {0, 1}, channels right/back/top."""
    ndc = triplane_ndc(verts, body_center)
    return torch.stack([rasterize_mask(ndc[i], faces, size)
                        for i in range(3)], -1)


def render_triplane_masks_batch(verts: torch.Tensor, faces: torch.Tensor,
                                body_centers: torch.Tensor,
                                size: int = 512) -> torch.Tensor:
    """Stage-3 triplane render: (B, V, 3) camera-frame verts, (F, 3)
    faces, (B, 3) body centers -> (B, size, size, 3) float {0, 1},
    channels right/back/top. All 3B views go through one coverage call
    (the K1 kernel on a CUDA tensor)."""
    from ..core.camera import triplane_project
    from .coverage import coverage_mask_batch

    ndc = triplane_project(verts, body_centers)          # (B, 3, V, 2)
    B, _, V, _ = ndc.shape
    masks = coverage_mask_batch(ndc.reshape(B * 3, V, 2), faces, size)
    return masks.reshape(B, 3, size, size).permute(0, 2, 3, 1)
