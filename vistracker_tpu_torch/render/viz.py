"""Z-buffered flat-shaded rendering.

Port of vistracker_tpu/render/viz.py:render_shaded, the rasterizer the
fixture generator (data/fixture.py) draws its frames with: per-face edge
functions, barycentric depth interpolation and a running min-depth /
argmin reduction over face chunks, in PyTorch on the device of its
inputs. Within a chunk the first argmin wins and across chunks the
comparison is a strict <, so the lowest face index wins every tie and the
result does not depend on the chunk. The rest of the JAX module (the
perspective mesh renderer, videos, the `render` subcommand) is not ported
yet (ROADMAP.md, Queue 1 item 8).
"""
from __future__ import annotations

import torch

from ..ops.rasterizer import _edge_coeffs, pixel_grid

_FAR = 1e9
# faces per chunk: a (chunk, 3, size^2) float32 tensor is 402 MB at a 512
# raster, and the step holds a few of them
CHUNK = 128


def _cross2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def render_shaded(v2d: torch.Tensor, depth: torch.Tensor,
                  verts3d: torch.Tensor, faces: torch.Tensor,
                  size: int = 256, chunk: int = CHUNK):
    """v2d (V, 2) NDC vertices, depth (V,) per-vertex depth, verts3d
    (V, 3) for the normals, faces (F, 3) -> (shade (size, size) in [0, 1]
    with 0 the background, depth map (size, size), 1e9 where empty).
    Row 0 is y = -1, column 0 is x = -1."""
    dev = v2d.device
    grid = torch.as_tensor(pixel_grid(size), device=dev)      # (3, P)
    px, py = grid[0], grid[1]
    faces = torch.as_tensor(faces, device=dev).long()
    coeffs, _, orient, valid = _edge_coeffs(v2d, faces)
    coeffs = coeffs * orient[:, None, None]
    f0, f1, f2 = faces[:, 0], faces[:, 1], faces[:, 2]
    area2 = _cross2(v2d[f1] - v2d[f0], v2d[f2] - v2d[f0]).abs()
    # flat shading: |normal . view| with a headlight at the camera
    n = torch.linalg.cross(verts3d[f1] - verts3d[f0],
                           verts3d[f2] - verts3d[f0])
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
    shade_f = 0.3 + 0.7 * n[:, 2].abs()
    zf = depth[faces]                                         # (F, 3)

    P = size * size
    zbuf = torch.full((P,), _FAR, dtype=torch.float32, device=dev)
    shade = torch.zeros(P, dtype=torch.float32, device=dev)
    for s in range(0, faces.shape[0], chunk):
        c = coeffs[s:s + chunk]
        # e_i(p) = a px + b py + c, written out (no matmul: no TF32)
        e = (c[..., 0:1] * px + c[..., 1:2] * py) + c[..., 2:3]  # (f, 3, P)
        inside = (e >= 0.0).all(1) & valid[s:s + chunk, None]
        w = e / torch.clamp(area2[s:s + chunk], min=1e-12)[:, None, None]
        del e
        zc = zf[s:s + chunk]
        # edge i is opposite vertex (i + 2) % 3
        zpix = (w[:, 0] * zc[:, 2:3] + w[:, 1] * zc[:, 0:1]
                + w[:, 2] * zc[:, 1:2])
        del w
        zpix = torch.where(inside, zpix, torch.full_like(zpix, _FAR))
        zmin, amin = zpix.min(0)          # first index among equal minima
        closer = zmin < zbuf
        zbuf = torch.where(closer, zmin, zbuf)
        shade = torch.where(closer, shade_f[s:s + chunk][amin], shade)
    return shade.reshape(size, size), zbuf.reshape(size, size)
