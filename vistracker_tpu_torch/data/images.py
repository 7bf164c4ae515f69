"""Host-side image preprocessing for the network inputs.

Port of vistracker_tpu/data/images.py: a square crop around the center of
the person|object mask union (zero-padded at the borders), resized to the
network size, composed into the 5-channel RGBM3 input (RGB masked by the
union + person mask + object mask), channels-last. The JAX package
resizes with PIL BILINEAR, which antialiases when it shrinks; here the
resize is F.interpolate(bilinear, antialias=True), which follows PIL's
filter, so no PIL is needed.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def crop_around(img: np.ndarray, center, crop_size: int) -> np.ndarray:
    """Square crop around center (x, y), zero-padded at the image borders
    (including the reference's clamping of x2 / y2 to size - 1)."""
    h, w = img.shape[:2]
    center = np.asarray(center, np.float64)
    topleft = np.round(center - crop_size / 2).astype(int)
    bottom_right = np.round(center + crop_size / 2).astype(int)
    x1, y1 = max(0, topleft[0]), max(0, topleft[1])
    x2, y2 = min(w - 1, bottom_right[0]), min(h - 1, bottom_right[1])
    cropped = img[y1:y2, x1:x2]
    p1 = max(0, -topleft[0])
    p2 = max(0, -topleft[1])
    p3 = max(0, bottom_right[0] - w + 1)
    p4 = max(0, bottom_right[1] - h + 1)
    pad = [[p2, p4], [p1, p3]] + [[0, 0]] * (img.ndim - 2)
    return np.pad(cropped, pad)


def resize_bilinear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Resize (H, W) or (H, W, C) float images to (width, height) with an
    antialiased bilinear filter; the aspect ratio must match."""
    h, w = img.shape[:2]
    if w * size[1] != h * size[0]:
        raise ValueError(f"aspect mismatch: image {img.shape} vs {size}")
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    x = x[None, None] if img.ndim == 2 else x.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(size[1], size[0]), mode="bilinear",
                      align_corners=False, antialias=True)[0]
    return (y[0] if img.ndim == 2 else y.permute(1, 2, 0)).numpy()


def masks_to_bbox(masks) -> tuple[np.ndarray, np.ndarray]:
    """Union bbox (bmin, bmax) in (x, y) of binary masks."""
    union = np.zeros(masks[0].shape, bool)
    for m in masks:
        union |= m > 0.5
    ys, xs = np.nonzero(union)
    if len(xs) == 0:
        h, w = union.shape
        return np.array([0, 0]), np.array([w - 1, h - 1])
    return np.array([xs.min(), ys.min()]), np.array([xs.max(), ys.max()])


def crop_center_from_masks(person_mask, obj_mask) -> np.ndarray:
    bmin, bmax = masks_to_bbox([person_mask, obj_mask])
    return (bmin + bmax) // 2


def compose_rgbm3(rgb, person_mask, obj_mask) -> np.ndarray:
    """(H, W, 5): RGB * (person | object) + both masks."""
    union = (person_mask > 0.5) | (obj_mask > 0.5)
    return np.dstack([rgb * union[..., None], person_mask,
                      obj_mask]).astype(np.float32)


def prepare_input_crop(rgb: np.ndarray, person_mask: np.ndarray,
                       obj_mask: np.ndarray, crop_size: int = 1200,
                       net_size: int = 512):
    """One frame -> ((net, net, 5) image, crop_center (2,)). rgb uint8
    (H, W, 3); masks bool or float (H, W)."""
    pm = person_mask.astype(np.float32) * (255.0 if person_mask.dtype == bool
                                           else 1.0)
    om = obj_mask.astype(np.float32) * (255.0 if obj_mask.dtype == bool
                                        else 1.0)
    center = crop_center_from_masks(pm, om)
    out = (net_size, net_size)
    rgb_c = resize_bilinear(crop_around(rgb.astype(np.float32), center,
                                        crop_size), out) / 255.0
    pm_c = resize_bilinear(crop_around(pm, center, crop_size), out) / 255.0
    om_c = resize_bilinear(crop_around(om, center, crop_size), out) / 255.0
    return compose_rgbm3(rgb_c, pm_c, om_c), center.astype(np.float32)
