"""ctypes binding of the host BVH point-to-mesh distance library
(csrc/pointmesh.cpp), built with g++ at first use into build/kernels/ by
utils/cuda_build.py:load_host_library.

There is no fallback: without a C++ compiler the build raises, and so
does every MeshDistance (data/sampling.py) that needs it.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..utils.cuda_build import load_host_library

_F32 = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The built library with its ctypes signatures set."""
    lib = load_host_library("pointmesh")
    lib.pmd_build.restype = ctypes.c_void_p
    lib.pmd_build.argtypes = [_F32, ctypes.c_int, _I32, ctypes.c_int]
    lib.pmd_query.restype = None
    lib.pmd_query.argtypes = [ctypes.c_void_p, _F32, ctypes.c_int, _F32,
                              _F32, _I32]
    lib.pmd_free.restype = None
    lib.pmd_free.argtypes = [ctypes.c_void_p]
    return lib


class PointMeshBVH:
    """Exact nearest-point-on-mesh queries against one triangle mesh."""

    def __init__(self, verts: np.ndarray, faces: np.ndarray):
        self._lib = get_lib()
        self._verts = np.ascontiguousarray(verts, np.float32)
        self._faces = np.ascontiguousarray(faces, np.int32)
        # the C++ side indexes vertices by these without checks
        if self._verts.ndim != 2 or self._verts.shape[1] != 3 \
                or self._faces.ndim != 2 or self._faces.shape[1] != 3 \
                or not len(self._faces) or self._faces.min() < 0 \
                or self._faces.max() >= len(self._verts):
            raise ValueError(f"need (V, 3) vertices and (F >= 1, 3) faces "
                             f"indexing them: {self._verts.shape}, "
                             f"{self._faces.shape}")
        self._handle = self._lib.pmd_build(
            self._verts.ctypes.data_as(_F32), len(self._verts),
            self._faces.ctypes.data_as(_I32), len(self._faces))

    def query(self, points: np.ndarray):
        """points (N, 3) -> (distance (N,), closest point (N, 3), face id
        (N,))."""
        pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
        n = len(pts)
        dist = np.empty(n, np.float32)
        closest = np.empty((n, 3), np.float32)
        face = np.empty(n, np.int32)
        self._lib.pmd_query(self._handle, pts.ctypes.data_as(_F32), n,
                            dist.ctypes.data_as(_F32),
                            closest.ctypes.data_as(_F32),
                            face.ctypes.data_as(_I32))
        return dist, closest, face

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.pmd_free(self._handle)
            self._handle = None
