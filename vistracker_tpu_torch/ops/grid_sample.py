"""Pixel-aligned feature sampling at sparse points.

Port of vistracker_tpu/ops/grid_sample.py: bilinear, align_corners=True,
zero padding outside the map -- torch grid_sample semantics -- written
as four corner gathers and a blend so a bfloat16 feature map is read in
bfloat16 and blended in the points' float32.
"""
from __future__ import annotations

import torch


def grid_sample_points(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """feat (B, H, W, C) channels-last (any strides), uv (B, N, 2) in
    [-1, 1] with uv[..., 0] along W -> (B, N, C) in uv's dtype; points
    outside the map blend with zeros. Differentiable in uv."""
    B, H, W, C = feat.shape
    x = (uv[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (uv[..., 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    bidx = torch.arange(B, device=feat.device)[:, None]

    def corner(yi, xi):
        valid = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H))[..., None]
        g = feat[bidx, yi.clamp(0, H - 1), xi.clamp(0, W - 1)]  # (B, N, C)
        return g.to(uv.dtype) * valid.to(uv.dtype)

    f00 = corner(y0i, x0i)
    f01 = corner(y0i, x0i + 1)
    f10 = corner(y0i + 1, x0i)
    f11 = corner(y0i + 1, x0i + 1)
    top = f00 * (1 - wx) + f01 * wx
    bot = f10 * (1 - wx) + f11 * wx
    return top * (1 - wy) + bot * wy
