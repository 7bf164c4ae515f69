"""Host-side preparation of occlusion-aware silhouette references (port
of vistracker_tpu/data/silprep.py): a square object bbox (expansion 0.3)
from the network-input object mask, nearest-neighbour crop + resize of
the object and person masks to the render size, the keep mask (1 = object
or background, 0 = person-occluded), and the ROI box in original pixels.
"""
from __future__ import annotations

import numpy as np


def mask_to_square_bbox(mask: np.ndarray, expansion: float = 0.3) -> np.ndarray:
    """Binary mask -> square (x, y, side), expanded; the whole mask when
    it is empty."""
    ys, xs = np.nonzero(mask > 0.5)
    if len(xs) == 0:
        return np.array([0.0, 0.0, float(mask.shape[0])], np.float32)
    x0, x1 = xs.min(), xs.max() + 1
    y0, y1 = ys.min(), ys.max() + 1
    w, h = x1 - x0, y1 - y0
    side = max(w, h) * (1.0 + expansion)
    cx, cy = x0 + w / 2.0, y0 + h / 2.0
    return np.array([cx - side / 2.0, cy - side / 2.0, side], np.float32)


def crop_resize_mask(mask: np.ndarray, box: np.ndarray, out: int) -> np.ndarray:
    """Nearest-neighbour crop + resize of a mask to (out, out); zero
    outside the mask."""
    x, y, side = box
    coords = (np.arange(out) + 0.5) / out * side
    xs = np.clip((x + coords).astype(np.int64), 0, mask.shape[1] - 1)
    ys = np.clip((y + coords).astype(np.int64), 0, mask.shape[0] - 1)
    valid_x = (x + coords >= 0) & (x + coords < mask.shape[1])
    valid_y = (y + coords >= 0) & (y + coords < mask.shape[0])
    crop = mask[np.ix_(ys, xs)].astype(np.float32)
    crop *= valid_y[:, None] * valid_x[None, :]
    return crop


def prepare_sil_refs(person_masks: np.ndarray, obj_masks: np.ndarray,
                     crop_centers: np.ndarray, crop_size: int,
                     net_size: int, rend_size: int = 256,
                     expansion: float = 0.3, device="cpu"):
    """SilRefs (fit/joint.py) for a chunk, on `device`. person_masks /
    obj_masks (B, net_size, net_size) network-input masks; crop_centers
    (B, 2) original-image pixel crop centers."""
    import torch
    from ..fit.joint import SilRefs

    scale = crop_size / float(net_size)
    refs, keeps, rois = [], [], []
    for i in range(len(obj_masks)):
        box = mask_to_square_bbox(obj_masks[i], expansion)
        fore = crop_resize_mask(obj_masks[i], box, rend_size) > 0.5
        person = crop_resize_mask(person_masks[i], box, rend_size) > 0.5
        keeps.append(np.where(person & ~fore, 0.0, 1.0).astype(np.float32))
        refs.append(fore.astype(np.float32))
        box_orig = box * scale
        box_orig[:2] += crop_centers[i] - crop_size / 2.0
        rois.append(box_orig)

    def dev(x):
        return torch.as_tensor(np.stack(x), dtype=torch.float32,
                               device=device)

    return SilRefs(image_ref=dev(refs), keep_mask=dev(keeps),
                   roi_xyb=dev(rois))
