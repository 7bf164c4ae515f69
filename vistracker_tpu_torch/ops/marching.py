"""Iso-surface extraction from dense scalar grids (marching tetrahedra).

Port of vistracker_tpu/ops/marching.py, host numpy in both packages: the
dense-grid evaluation and mesh extraction of a neural distance field
(the reference's model/mesh_util.py:reconstruction, which uses
skimage's marching cubes; skimage is not a dependency). Each grid cell
is split into 6 tetrahedra, and a tetrahedron crossing the level set
emits 1-2 triangles; the output is watertight.
"""
from __future__ import annotations

import numpy as np

# 6-tetrahedra decomposition of a cube (corner indices 0..7, where corner
# bits are (x, y, z) offsets: idx = x*4 + y*2 + z)
_TETS = np.array([
    [0, 5, 1, 3], [0, 5, 3, 7], [0, 5, 7, 4],
    [0, 7, 3, 2], [0, 7, 2, 6], [0, 7, 6, 4]], np.int64)

_CUBE_OFFS = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                       for z in (0, 1)], np.int64)


def marching_tets(values: np.ndarray, level: float = 0.0,
                  bmin=(-1.0, -1.0, -1.0), bmax=(1.0, 1.0, 1.0)):
    """Extract the `level` iso-surface of values (Nx, Ny, Nz).

    Returns (verts (V, 3) float32 in [bmin, bmax], faces (F, 3) int32),
    oriented so normals point toward increasing values.
    """
    v = np.asarray(values, np.float64) - level
    nx, ny, nz = v.shape
    bmin = np.asarray(bmin, np.float64)
    bmax = np.asarray(bmax, np.float64)
    spacing = (bmax - bmin) / (np.array([nx, ny, nz]) - 1)

    # cell corner coordinates + values: (C, 8)
    cx, cy, cz = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                             np.arange(nz - 1), indexing="ij")
    cells = np.stack([cx.ravel(), cy.ravel(), cz.ravel()], -1)  # (C, 3)
    corner_idx = cells[:, None, :] + _CUBE_OFFS[None]           # (C, 8, 3)
    vals8 = v[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]

    # only cells straddling the surface
    straddle = (vals8.min(1) < 0) & (vals8.max(1) > 0)
    cells = cells[straddle]
    corner_idx = corner_idx[straddle]
    vals8 = vals8[straddle]
    if len(cells) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    pos8 = corner_idx * spacing + bmin                          # (C, 8, 3)

    tri_list = []
    for tet in _TETS:
        tv = vals8[:, tet]                                      # (C, 4)
        tp = pos8[:, tet]                                       # (C, 4, 3)
        inside = tv < 0.0                                       # (C, 4)
        count = inside.sum(1)

        def edge_point(ci, a, b):
            va, vb = tv[ci, a], tv[ci, b]
            t = va / (va - vb)
            return tp[ci, a] + t[:, None] * (tp[ci, b] - tp[ci, a])

        # one corner inside -> 1 triangle; three inside -> 1 triangle
        # (flipped); two inside -> quad = 2 triangles
        for target, flip in ((1, False), (3, True)):
            sel = np.nonzero(count == target)[0]
            if len(sel) == 0:
                continue
            ins = inside[sel] if target == 1 else ~inside[sel]
            corner = ins.argmax(1)
            others = np.argsort(~ins, axis=1)[:, 1:4]  # the 3 other corners
            others = np.sort(others, 1)
            p0 = edge_point(sel, corner, others[:, 0])
            p1 = edge_point(sel, corner, others[:, 1])
            p2 = edge_point(sel, corner, others[:, 2])
            tri = np.stack([p0, p1, p2] if not flip else [p0, p2, p1], 1)
            tri_list.append(tri)

        sel = np.nonzero(count == 2)[0]
        if len(sel):
            ins = inside[sel]
            # indices of the 2 inside and 2 outside corners
            in_idx = np.argsort(~ins, 1)[:, :2]
            out_idx = np.argsort(ins, 1)[:, :2]
            a0 = edge_point(sel, in_idx[:, 0], out_idx[:, 0])
            a1 = edge_point(sel, in_idx[:, 0], out_idx[:, 1])
            b0 = edge_point(sel, in_idx[:, 1], out_idx[:, 0])
            b1 = edge_point(sel, in_idx[:, 1], out_idx[:, 1])
            tri_list.append(np.stack([a0, a1, b1], 1))
            tri_list.append(np.stack([a0, b1, b0], 1))

    tris = np.concatenate(tri_list, 0)                          # (F, 3, 3)
    # weld vertices
    flat = tris.reshape(-1, 3)
    key = np.round(flat / (spacing.min() * 1e-4)).astype(np.int64)
    _, first, inv = np.unique(key, axis=0, return_index=True,
                              return_inverse=True)
    verts = flat[first].astype(np.float32)
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces
    keep = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    return verts, faces[keep]


def _host(values) -> np.ndarray:
    """A query's distances as numpy; a torch tensor (on any device) is
    moved to the host explicitly."""
    if hasattr(values, "detach"):
        values = values.detach().cpu().numpy()
    return np.asarray(values)


def udf_to_mesh(query_fn, resolution: int = 64, bmin=(-1, -1, -1),
                bmax=(1, 1, 1), level: float = 0.01,
                batch: int = 65536):
    """Mesh the `level` iso-surface of an unsigned distance field.

    query_fn(points (N, 3) float32 numpy) -> (N,) distances, numpy or a
    torch tensor on any device. Evaluates the dense grid in batches
    (mesh_util.py:reconstruction role for SIF-Net's UDF heads).
    """
    lin = [np.linspace(bmin[k], bmax[k], resolution) for k in range(3)]
    gx, gy, gz = np.meshgrid(*lin, indexing="ij")
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
    vals = np.concatenate([_host(query_fn(pts[s:s + batch]))
                           for s in range(0, len(pts), batch)])
    grid = vals.reshape(resolution, resolution, resolution)
    return marching_tets(grid, level, bmin, bmax)
