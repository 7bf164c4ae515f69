"""Host-side image preprocessing for the network inputs.

Port of vistracker_tpu/data/images.py: a square crop around the center of
the person|object mask union (zero-padded at the borders), resized to the
network size, composed into the 5-channel RGBM3 input (RGB masked by the
union + person mask + object mask), channels-last. The JAX package
resizes with PIL BILINEAR, which antialiases when it shrinks; here the
resize is F.interpolate(bilinear, antialias=True), which follows PIL's
filter, so no PIL is needed.

`resize_uint8_bilinear` and `resize_uint8_nearest` are PIL's
`Image.resize((W, H), BILINEAR | NEAREST)` on uint8 images, bit for bit:
the fixture (data/fixture.py) upsamples its renders with them.
`resize_float_bilinear` is PIL's BILINEAR on float ("F" mode) images of
any aspect (equal to PIL's, or one float32 ulp from it), as the offline
training crops and the depth-rescale test crop (data/offline.py) use.
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


_PIL_PRECISION_BITS = 32 - 8 - 2


def _pil_bilinear_coeffs(in_size: int, out_size: int):
    """PIL's precompute_coeffs + normalize_coeffs_8bpc for the bilinear
    filter: per output sample its first input index, tap count and
    fixed-point weights (PRECISION_BITS = 22)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) / filterscale))
             for x in range(xmax)]
        ww = sum(w)
        w = [v / ww if ww != 0.0 else v for v in w]
        for x, v in enumerate(w):
            kk[xx, x] = int((-0.5 if v < 0 else 0.5)
                            + v * (1 << _PIL_PRECISION_BITS))
        xmins[xx] = xmin
    return xmins, kk


def _pil_pass(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One separable pass of PIL's 8-bit resample along `axis`. The
    bilinear weights are non-negative and sum to ~2^22, so the sums stay
    below 255 * 2^22 + 2^21 < 2^31: int32 holds them."""
    xmins, kk = _pil_bilinear_coeffs(img.shape[axis], out_size)
    kk = kk.astype(np.int32)
    src = np.moveaxis(img, axis, 0).astype(np.int32)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PIL_PRECISION_BITS - 1),
                  np.int32)
    idx = np.minimum(xmins[:, None] + np.arange(kk.shape[1]),
                     img.shape[axis] - 1)
    wshape = (out_size,) + (1,) * (src.ndim - 1)
    for k in range(kk.shape[1]):
        acc += src[idx[:, k]] * kk[:, k].reshape(wshape)
    out = np.clip(acc >> _PIL_PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_uint8_bilinear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """PIL's Image.resize((width, height), BILINEAR) of an (H, W) or
    (H, W, C) uint8 image: a horizontal then a vertical pass, each with
    fixed-point weights and a uint8 image between them."""
    w, h = size
    out = img
    if w != img.shape[1]:
        out = _pil_pass(out, 1, w)
    if h != img.shape[0]:
        out = _pil_pass(out, 0, h)
    return np.ascontiguousarray(out)


def _pil_nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """PIL's ImagingScaleAffine source index: x0 = scale / 2, then scale is
    added once per output sample (float64), truncated."""
    a = in_size / out_size
    pos = np.cumsum(np.r_[a * 0.5, np.full(out_size - 1, a)])
    return np.minimum(pos.astype(np.int64), in_size - 1)


def resize_uint8_nearest(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """PIL's Image.resize((width, height), NEAREST) of a uint8 image."""
    w, h = size
    rows = _pil_nearest_index(img.shape[0], h)
    cols = _pil_nearest_index(img.shape[1], w)
    return np.ascontiguousarray(img[rows][:, cols])


def _pil_pass_float(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One separable pass of PIL's float32 BILINEAR resample along `axis`:
    double weights normalized to their running sum, each output summed in
    double in tap order, stored as float32. The order matters: with the
    dyadic weights of simple scales many sums land on float32 rounding
    midpoints, where a sum in another order rounds the other way. PIL's
    own build still rounds a few of those the other way at some scales
    (1200 -> 512: 0.04% of values one float32 ulp apart)."""
    in_size = img.shape[axis]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ss = 1.0 / filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss))
             for x in range(xmax)]
        ww = sum(w)
        kk[xx, :xmax] = [v / ww if ww != 0.0 else v for v in w]
        idx[xx] = np.minimum(xmin + np.arange(ksize), in_size - 1)
    # the resampled axis first and contiguous: each tap gathers whole rows
    src = np.ascontiguousarray(np.moveaxis(np.asarray(img, np.float32),
                                           axis, 0))
    acc = np.zeros((out_size,) + src.shape[1:], np.float64)
    wshape = (out_size,) + (1,) * (src.ndim - 1)
    for k in range(ksize):
        acc += src[idx[:, k]] * kk[:, k].reshape(wshape)
    return np.moveaxis(acc.astype(np.float32), 0, axis)


def resize_float_bilinear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """PIL's Image.resize((width, height), BILINEAR) of a float32 ("F"
    mode) (H, W) image, or of each channel of an (H, W, C) one, any
    aspect: the horizontal pass, then the vertical one."""
    return _pil_pass_float(_pil_pass_float(img, 1, size[0]), 0, size[1])


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
