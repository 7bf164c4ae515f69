"""Host-side mesh utilities (PLY I/O, surface sampling, vertex normals,
point-to-mesh distances, PCA axes, SDF grids), numpy only.

The port's own copy of the JAX package's utils/mesh.py and of
data/sampling.py:compute_pca_axes. The random draws are numpy
RandomState draws in the same order, so both packages sample the same
template points from the same seed.
"""
from __future__ import annotations

import numpy as np


def save_ply(path: str, verts: np.ndarray, faces: np.ndarray | None = None):
    """Binary little-endian PLY with float vertices and int triangles."""
    verts = np.asarray(verts, np.float32)
    faces = (np.zeros((0, 3), np.int32) if faces is None
             else np.asarray(faces, np.int32))
    with open(path, "wb") as f:
        f.write(("ply\nformat binary_little_endian 1.0\n"
                 f"element vertex {len(verts)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 f"element face {len(faces)}\n"
                 "property list uchar int vertex_indices\nend_header\n")
                .encode())
        f.write(verts.astype("<f4").tobytes())
        if len(faces):
            rec = np.zeros(len(faces), dtype=[("n", "u1"), ("v", "<i4", 3)])
            rec["n"] = 3
            rec["v"] = faces
            f.write(rec.tobytes())


def load_ply(path: str):
    """ascii or binary_little_endian PLY -> (verts (V, 3) float32, faces
    (F, 3) int32)."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.find(b"end_header\n") + len(b"end_header\n")
    lines = [ln.strip() for ln in
             data[:head_end].decode("ascii", errors="replace").splitlines()]
    fmt = next(ln.split()[1] for ln in lines if ln.startswith("format"))
    n_vert = n_face = 0
    vert_props, cur = [], None
    for ln in lines:
        if ln.startswith("element vertex"):
            n_vert, cur = int(ln.split()[-1]), "v"
        elif ln.startswith("element face"):
            n_face, cur = int(ln.split()[-1]), "f"
        elif ln.startswith("property") and cur == "v":
            parts = ln.split()
            vert_props.append((parts[-1], parts[1]))
    names = [p[0] for p in vert_props]
    if fmt == "ascii":
        body = data[head_end:].decode().split()
        n_props = len(vert_props)
        vals = np.asarray(body[:n_vert * n_props],
                          np.float64).reshape(n_vert, n_props)
        verts = vals[:, [names.index(k) for k in "xyz"]]
        faces, idx = [], n_vert * n_props
        for _ in range(n_face):
            cnt = int(body[idx])
            faces.append([int(v) for v in body[idx + 1:idx + 1 + cnt]][:3])
            idx += cnt + 1
        return (verts.astype(np.float32),
                np.asarray(faces, np.int32).reshape(-1, 3))
    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4",
                "short": "<i2", "ushort": "<u2", "uint": "<u4"}
    vdt = np.dtype([(name, type_map[t]) for name, t in vert_props])
    rec = np.frombuffer(data, dtype=vdt, count=n_vert, offset=head_end)
    verts = np.stack([rec["x"], rec["y"], rec["z"]], -1).astype(np.float32)
    fdt = np.dtype([("n", "u1"), ("v", "<i4", 3)])
    frec = np.frombuffer(data, dtype=fdt, count=n_face,
                         offset=head_end + n_vert * vdt.itemsize)
    return verts, frec["v"].astype(np.int32).copy()


def face_areas(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    a = verts[faces[:, 1]] - verts[faces[:, 0]]
    b = verts[faces[:, 2]] - verts[faces[:, 0]]
    return 0.5 * np.linalg.norm(np.cross(a, b), axis=-1)


def _surface_draws(verts, faces, n, rng):
    """Area-weighted face picks and barycentric draws: (points, face idx)."""
    areas = face_areas(verts, faces)
    probs = areas / max(areas.sum(), 1e-12)
    fidx = rng.choice(len(faces), size=n, p=probs)
    u, v = rng.rand(n, 1), rng.rand(n, 1)
    flip = (u + v) > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    tri = verts[faces[fidx]]
    return (tri[:, 0] + u * (tri[:, 1] - tri[:, 0])
            + v * (tri[:, 2] - tri[:, 0])), fidx


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                   rng: np.random.RandomState | None = None) -> np.ndarray:
    """Area-weighted uniform surface sampling, (n, 3) float32."""
    rng = rng or np.random.RandomState(0)
    return _surface_draws(verts, faces, n, rng)[0].astype(np.float32)


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Unit area-weighted vertex normals (V, 3)."""
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    return vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)


def point_mesh_distance(points: np.ndarray, verts: np.ndarray,
                        faces: np.ndarray, n_surface: int = 60000):
    """Approximate unsigned distance (N,) and closest surface point
    (N, 3): the nearest of n_surface area-weighted surface samples (seed
    0) and the vertices, by kd-tree. data/sampling.py:MeshDistance is the
    exact query."""
    from scipy.spatial import cKDTree
    samp = sample_surface(verts, faces, n_surface, np.random.RandomState(0))
    all_pts = np.concatenate([samp, verts.astype(np.float32)], 0)
    dist, idx = cKDTree(all_pts).query(points, k=1)
    return dist.astype(np.float32), all_pts[idx]


def decimate_faces(faces: np.ndarray, max_faces: int,
                   rng: np.random.RandomState | None = None) -> np.ndarray:
    """Subsample faces for coverage-only rasterization (silhouettes are
    robust to missing interior faces)."""
    if len(faces) <= max_faces:
        return faces
    rng = rng or np.random.RandomState(0)
    idx = rng.choice(len(faces), max_faces, replace=False)
    return faces[np.sort(idx)]


def compute_pca_axes(verts: np.ndarray) -> np.ndarray:
    """PCA components of mesh vertices, rows = axes by descending
    variance, with the U-based sign convention of the sklearn release the
    reference used (each U column's largest-magnitude entry positive).
    The sign matters: a flipped axis puts the object rotation init in the
    wrong basin."""
    x = verts - verts.mean(0)
    u, _, vt = np.linalg.svd(x, full_matrices=False)
    max_abs = np.argmax(np.abs(u), axis=0)
    signs = np.sign(u[max_abs, range(u.shape[1])])
    signs[signs == 0] = 1.0
    return (vt * signs[:, None]).astype(np.float32)


def signed_distance_grid(verts: np.ndarray, faces: np.ndarray,
                         resolution: int = 64, padding: float = 0.1):
    """Approximate signed distance grid of a mesh (for the collision
    penalty): unsigned distance to a kd-tree of surface samples, sign from
    the nearest sample's face normal. Returns (values (R, R, R) float32,
    bmin (3,), bmax (3,))."""
    from scipy.spatial import cKDTree
    rng = np.random.RandomState(0)
    n_samp = min(50000, max(10000, len(faces) * 4))
    pts, fidx = _surface_draws(verts, faces, n_samp, rng)
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
    normals = fn[fidx]
    bmin = verts.min(0) - padding
    bmax = verts.max(0) + padding
    lin = [np.linspace(bmin[k], bmax[k], resolution) for k in range(3)]
    grid_pts = np.stack(np.meshgrid(*lin, indexing="ij"), -1).reshape(-1, 3)
    dist, idx = cKDTree(pts).query(grid_pts, k=1)
    sign = np.sign(np.sum((grid_pts - pts[idx]) * normals[idx], -1))
    sign[sign == 0] = 1.0
    values = (dist * sign).reshape(resolution, resolution, resolution)
    return (values.astype(np.float32), bmin.astype(np.float32),
            bmax.astype(np.float32))
