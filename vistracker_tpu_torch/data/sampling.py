"""GT boundary sampling for SIF-Net training (host side, numpy).

Port of vistracker_tpu/data/sampling.py. Per training example:
Gaussian-perturbed surface samples of the combined human + object mesh
at sigmas (0.08, 0.02, 0.003) with ratios (0.01, 0.49, 0.5), plus grid
samples in [-3, 3] x [-0.9, 1.8] x [0.2, 4]; labels are the unsigned
distances to the human and object meshes, the SMPL part label of the
nearest SMPL vertex, the object's PCA axes and its center.

The distances come from the exact host BVH (csrc/pointmesh.cpp through
native/pointmesh.py). Unlike the JAX package, which falls back to a
kd-tree search when the library does not build, a failed build raises.
The random draws are numpy RandomState draws in the JAX package's order.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from ..native.pointmesh import PointMeshBVH
from ..utils.mesh import compute_pca_axes, sample_surface

GRID_BMIN = np.array([-3.0, -0.9, 0.2])
GRID_BMAX = np.array([3.0, 1.80, 4.0])

# left/right part-label swap of a horizontally flipped example
FLIP_PARTS = {1: 6, 2: 7, 3: 8, 4: 9, 5: 10, 6: 1, 7: 2, 8: 3, 9: 4,
              10: 5, 12: 13, 13: 12}

def closest_point_triangle(p: np.ndarray, a: np.ndarray, b: np.ndarray,
                           c: np.ndarray) -> np.ndarray:
    """Exact closest point on triangles (a, b, c) to points p, all
    (..., 3): Ericson's regions (Real-Time Collision Detection 5.1.5),
    vectorized."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = np.sum(ab * ap, -1)
    d2 = np.sum(ac * ap, -1)
    bp = p - b
    d3 = np.sum(ab * bp, -1)
    d4 = np.sum(ac * bp, -1)
    cp = p - c
    d5 = np.sum(ab * cp, -1)
    d6 = np.sum(ac * cp, -1)

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4
    denom = np.where(va + vb + vc != 0, va + vb + vc, 1.0)
    v = vb / denom
    w = vc / denom
    out = a + v[..., None] * ab + w[..., None] * ac      # interior
    # edge and vertex regions override, in the JAX package's order
    t_ac = np.clip(d2 / np.where(d2 - d6 != 0, d2 - d6, 1.0), 0, 1)
    out = np.where(((d2 >= 0) & (d6 <= 0) & (vb <= 0))[..., None],
                   a + t_ac[..., None] * ac, out)
    t_bc = np.clip((d4 - d3) / np.where((d4 - d3) + (d5 - d6) != 0,
                                        (d4 - d3) + (d5 - d6), 1.0), 0, 1)
    out = np.where(((d4 - d3 >= 0) & (d5 - d6 >= 0) & (va <= 0))[..., None],
                   b + t_bc[..., None] * (c - b), out)
    t_ab = np.clip(d1 / np.where(d1 - d3 != 0, d1 - d3, 1.0), 0, 1)
    out = np.where(((d1 >= 0) & (d3 <= 0) & (vc <= 0))[..., None],
                   a + t_ab[..., None] * ab, out)
    out = np.where(((d6 >= 0) & (d5 <= d6))[..., None], c, out)
    out = np.where(((d3 >= 0) & (d4 <= d3))[..., None], b, out)
    out = np.where(((d1 <= 0) & (d2 <= 0))[..., None], a, out)
    return out


class MeshDistance:
    """Unsigned-distance queries against one mesh through the host BVH,
    and nearest-vertex queries through a kd-tree of its vertices."""

    def __init__(self, verts: np.ndarray, faces: np.ndarray):
        self.bvh = PointMeshBVH(verts, faces)
        self.vert_tree = cKDTree(np.asarray(verts, np.float64))

    def query(self, points: np.ndarray):
        """(unsigned distance (N,), closest surface point (N, 3)),
        float32."""
        dist, closest, _ = self.bvh.query(points)
        return dist, closest

    def nearest_vertex(self, points: np.ndarray) -> np.ndarray:
        return self.vert_tree.query(np.asarray(points, np.float64), k=1)[1]


def flip_part_labels(parts: np.ndarray) -> np.ndarray:
    """Swap left and right SMPL part labels (FLIP_PARTS)."""
    out = parts.copy()
    for src, dst in FLIP_PARTS.items():
        out[parts == src] = dst
    return out


def boundary_sample(smpl_verts: np.ndarray, smpl_faces: np.ndarray,
                    obj_verts: np.ndarray, obj_faces: np.ndarray,
                    part_labels: np.ndarray,
                    sigmas=(0.08, 0.02, 0.003), ratios=(0.01, 0.49, 0.5),
                    num_samples: int = 20000, grid_ratio: float = 0.01,
                    rng: np.random.RandomState | None = None) -> dict:
    """One training example's query points and GT labels, the sigma
    buckets and the grid samples concatenated: points (N, 3), df_h (N,),
    df_o (N,), parts (N,) int32, pca_axis (3, 3), obj_center (3,)."""
    rng = rng or np.random.RandomState()
    comb_v = np.concatenate([smpl_verts, obj_verts], 0)
    comb_f = np.concatenate([smpl_faces, obj_faces + len(smpl_verts)], 0)

    buckets = []
    for s, r in zip(sigmas, ratios):
        n = max(int(r * num_samples), 1)
        pts = sample_surface(comb_v, comb_f, n, rng)
        buckets.append(pts + s * rng.randn(n, 3))
    n_grid = max(int(grid_ratio * num_samples), 1)
    grid = rng.rand(n_grid, 3) * (GRID_BMAX - GRID_BMIN) + GRID_BMIN
    buckets.append(grid.astype(np.float32))
    points = np.concatenate(buckets, 0).astype(np.float32)

    md_h = MeshDistance(smpl_verts, smpl_faces)
    md_o = MeshDistance(obj_verts, obj_faces)
    df_h, _ = md_h.query(points)
    df_o, _ = md_o.query(points)
    parts = part_labels[md_h.nearest_vertex(points)].astype(np.int32)
    return dict(points=points, df_h=df_h, df_o=df_o, parts=parts,
                pca_axis=compute_pca_axes(obj_verts),
                obj_center=obj_verts.mean(0).astype(np.float32))
