"""Camera projection (port of vistracker_tpu/core/camera.py).

Points live in the Kinect color-camera frame (+z forward, meters);
`project_screen` maps to full-resolution pixels, `normalize_crop` to
[-1, 1] across a crop of `crop_size` pixels around a per-example center.
"""
from __future__ import annotations

import dataclasses

import torch

# Kinect Azure color camera, normalized by image width 2048
KINECT_FX = 979.7844 / 2048.0
KINECT_FY = 979.840 / 2048.0
KINECT_CX = 1018.952 / 2048.0
KINECT_CY = 779.486 / 2048.0

# InterCap cameras (6 kinects, 1920x1080), normalized by width 1920
ICAP_SIZE = 1920
ICAP_FOCALS = (
    (918.457763671875, 918.4373779296875),
    (915.29962158203125, 915.1966552734375),
    (912.8626708984375, 912.67633056640625),
    (909.82025146484375, 909.62469482421875),
    (920.533447265625, 920.09722900390625),
    (909.17633056640625, 909.23529052734375),
)
ICAP_CENTERS = (
    (956.9661865234375, 555.944580078125),
    (956.664306640625, 551.6165771484375),
    (956.72003173828125, 554.2166748046875),
    (957.6181640625, 554.60296630859375),
    (958.4615478515625, 550.42987060546875),
    (956.14801025390625, 555.01593017578125),
)


@dataclasses.dataclass(frozen=True)
class PerspectiveCamera:
    """Pinhole camera with normalized intrinsics (relative to width)."""

    crop_size: int = 1200
    fx: float = KINECT_FX
    fy: float = KINECT_FY
    cx: float = KINECT_CX
    cy: float = KINECT_CY
    width: int = 2048
    height: int = 1536

    @property
    def fx_px(self) -> float:
        return self.fx * self.width

    @property
    def fy_px(self) -> float:
        return self.fy * self.width

    @property
    def cx_px(self) -> float:
        return self.cx * self.width

    @property
    def cy_px(self) -> float:
        return self.cy * self.width

    def project_screen(self, points: torch.Tensor) -> torch.Tensor:
        """(..., N, 3) -> full-image pixel coords (..., N, 2)."""
        z = points[..., 2:3]
        px = self.fx_px * points[..., 0:1] / z + self.cx_px
        py = self.fy_px * points[..., 1:2] / z + self.cy_px
        return torch.cat([px, py], dim=-1)

    def normalize_crop(self, pix: torch.Tensor,
                       crop_center: torch.Tensor) -> torch.Tensor:
        """(..., N, 2) pixels -> [-1, 1] of the crop around (..., 2)."""
        local = self.crop_size / 2.0 + pix - crop_center[..., None, :]
        return 2.0 * local / self.crop_size - 1.0

    def project_points(self, points: torch.Tensor,
                       crop_center: torch.Tensor) -> torch.Tensor:
        """(..., N, 3) -> (..., N, 3): crop-normalized x, y plus raw z."""
        nxy = self.normalize_crop(self.project_screen(points), crop_center)
        return torch.cat([nxy, points[..., 2:3]], dim=-1)


def intercap_camera(kid: int = 0, crop_size: int = 800) -> PerspectiveCamera:
    """InterCap color camera for kinect `kid` (0..5)."""
    if not 0 <= kid < 6:
        raise ValueError(f"invalid InterCap kinect index {kid}")
    fx, fy = ICAP_FOCALS[kid]
    cx, cy = ICAP_CENTERS[kid]
    return PerspectiveCamera(
        crop_size=crop_size, fx=fx / ICAP_SIZE, fy=fy / ICAP_SIZE,
        cx=cx / ICAP_SIZE, cy=cy / ICAP_SIZE, width=ICAP_SIZE, height=1080)


def triplane_project(points: torch.Tensor, body_center: torch.Tensor,
                     fx: float = 1.0, cx: float = 0.0) -> torch.Tensor:
    """Orthographic projection onto the right/back/top planes.

    points (..., N, 3), body_center (..., 3) -> (..., 3, N, 2):
    right = (z, y), back = (-x, y), top = (x, -z) after centering.
    """
    c = points - body_center[..., None, :]
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    right = torch.stack([z * fx + cx, y * fx + cx], dim=-1)
    back = torch.stack([-x * fx + cx, y * fx + cx], dim=-1)
    top = torch.stack([x * fx + cx, -z * fx + cx], dim=-1)
    return torch.stack([right, back, top], dim=-3)
