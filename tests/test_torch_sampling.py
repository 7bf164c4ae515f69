"""The port's boundary sampling (data/sampling.py, native/pointmesh.py,
utils/mesh.py) against the JAX package on the same numpy inputs and
seeds. The host BVH is the same C++ built with the same flags, so its
distances, closest points and face ids are equal; the numpy helpers are
held within 1e-6. The port's MeshDistance has no fallback: without g++
the library does not build and MeshDistance raises."""
import shutil

import numpy as np
import pytest

from vistracker_tpu.data import sampling as JS
from vistracker_tpu.native import pointmesh as JPM
from vistracker_tpu.utils import mesh as JM
from vistracker_tpu_torch.data import sampling as TS
from vistracker_tpu_torch.native import pointmesh as TPM
from vistracker_tpu_torch.utils import cuda_build
from vistracker_tpu_torch.utils import mesh as TM


def _sphere(n_lat=12, n_lon=16, r=0.5):
    vs, fs = [], []
    for i in range(n_lat + 1):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            vs.append([r * np.sin(th) * np.cos(ph), r * np.cos(th),
                       r * np.sin(th) * np.sin(ph)])
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            fs += [[a, b, c], [b, d, c]]
    return np.asarray(vs, np.float32), np.asarray(fs, np.int32)


def _scene(rng):
    """A sphere 'body' with part labels and a smaller box-like 'object'."""
    sv, sf = _sphere()
    sv = sv + np.float32([0.0, 0.0, 2.2])
    ov, of = _sphere(4, 6, 0.15)
    ov = (ov * np.float32([1.0, 0.6, 1.4]) + np.float32([0.5, 0.0, 2.4]))
    parts = (np.arange(len(sv)) % 14).astype(np.int32)
    return sv, sf, ov, of, parts


def test_bvh_equals_jax_library_and_brute_force(rng):
    verts, faces = _sphere()
    pts = (rng.randn(400, 3) * 0.7).astype(np.float32)
    d, cp, fi = TPM.PointMeshBVH(verts, faces).query(pts)
    assert JPM.available()
    dj, cpj, fij = JPM.PointMeshBVH(verts, faces).query(pts)
    np.testing.assert_array_equal(d, dj)
    np.testing.assert_array_equal(cp, cpj)
    np.testing.assert_array_equal(fi, fij)
    tris = verts[faces].astype(np.float64)
    cands = TS.closest_point_triangle(pts[:, None].astype(np.float64),
                                      tris[None, :, 0], tris[None, :, 1],
                                      tris[None, :, 2])
    dist = np.linalg.norm(cands - pts[:, None], axis=-1)
    np.testing.assert_allclose(d, dist.min(1), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(cp - pts, axis=-1), d,
                               atol=1e-5)
    # the reported face holds the closest point
    np.testing.assert_allclose(dist[np.arange(len(pts)), fi], d, atol=1e-5)


def test_mesh_distance_raises_without_a_compiler(monkeypatch, tmp_path):
    """No kd-tree fallback: a missing g++ is an error, not a slower
    path."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    cuda_build.load_host_library.cache_clear()
    TPM.get_lib.cache_clear()
    verts, faces = _sphere(4, 6)
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            TS.MeshDistance(verts, faces)
    finally:
        cuda_build.load_host_library.cache_clear()
        TPM.get_lib.cache_clear()


def test_closest_point_triangle_matches(rng):
    p = rng.randn(50, 7, 3)
    a, b, c = (rng.randn(50, 7, 3) for _ in range(3))
    np.testing.assert_allclose(TS.closest_point_triangle(p, a, b, c),
                               JS.closest_point_triangle(p, a, b, c),
                               atol=1e-6)


def test_mesh_distance_matches(rng):
    sv, sf, _, _, _ = _scene(rng)
    pts = (rng.randn(300, 3) * 0.4 + [0, 0, 2.2]).astype(np.float32)
    mt, mj = TS.MeshDistance(sv, sf), JS.MeshDistance(sv, sf)
    for a, b in zip(mt.query(pts), mj.query(pts)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mt.nearest_vertex(pts),
                                  mj.nearest_vertex(pts))


@pytest.mark.parametrize("grid_ratio", [0.01, 0.1])
def test_boundary_sample_matches(rng, grid_ratio):
    sv, sf, ov, of, parts = _scene(rng)
    out = TS.boundary_sample(sv, sf, ov, of, parts, num_samples=500,
                             grid_ratio=grid_ratio,
                             rng=np.random.RandomState(3))
    ref = JS.boundary_sample(sv, sf, ov, of, parts, num_samples=500,
                             grid_ratio=grid_ratio,
                             rng=np.random.RandomState(3))
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype, k
        np.testing.assert_allclose(out[k], ref[k], atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(out["parts"], ref["parts"])


def test_flip_part_labels_and_pca_match(rng):
    parts = rng.randint(0, 14, 200).astype(np.uint8)
    np.testing.assert_array_equal(TS.flip_part_labels(parts),
                                  JS.flip_part_labels(parts))
    assert TS.FLIP_PARTS == JS.FLIP_PARTS
    np.testing.assert_array_equal(TS.GRID_BMIN, JS.GRID_BMIN)
    np.testing.assert_array_equal(TS.GRID_BMAX, JS.GRID_BMAX)
    v = rng.randn(80, 3) * [1.0, 0.5, 0.2]
    np.testing.assert_allclose(TS.compute_pca_axes(v),
                               JS.compute_pca_axes(v), atol=1e-6)


def test_vertex_normals_and_point_mesh_distance_match(rng):
    verts, faces = _sphere(6, 8)
    np.testing.assert_allclose(TM.vertex_normals(verts, faces),
                               JM.vertex_normals(verts, faces), atol=1e-6)
    pts = (rng.randn(100, 3) * 0.6).astype(np.float32)
    for a, b in zip(TM.point_mesh_distance(pts, verts, faces, 2000),
                    JM.point_mesh_distance(pts, verts, faces, 2000)):
        np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.mark.parametrize("faces", [np.array([[0, 1, 9]]),
                                   np.array([[0, -1, 2]]),
                                   np.zeros((0, 3), np.int32),
                                   np.array([0, 1, 2])])
def test_bvh_refuses_faces_outside_the_vertices(faces):
    verts = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError, match="faces"):
        TPM.PointMeshBVH(verts, faces)
