"""Resampling ops of the hourglass encoder (port of vistracker_tpu/ops/resize.py).

The JAX package writes the torch grids out as interpolation matrices;
here they are the torch ops themselves, on NCHW tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample2x_bicubic(x: torch.Tensor) -> torch.Tensor:
    """F.interpolate(scale_factor=2, bicubic, align_corners=True): the
    Keys kernel with a = -0.75 and border clamping, (B, C, H, W)."""
    return F.interpolate(x, scale_factor=2, mode="bicubic",
                         align_corners=True)


def avg_pool2x(x: torch.Tensor) -> torch.Tensor:
    """F.avg_pool2d(x, 2, stride=2) on (B, C, H, W)."""
    return F.avg_pool2d(x, 2, stride=2)
