"""Nearest-neighbour and chamfer distances through kernel K4.

Port of vistracker_tpu/ops/chamfer.py (nn_distances, chamfer_distance,
one_way_sq, nearest_index) and of the TPU kernel behind
vistracker_tpu/ops/pallas_nn.py:nn_min_sqdist_pallas / chamfer_pallas:
for each x point the squared distance to, and index of, its nearest valid
y point, d = max(|x|^2 + |y|^2 - 2 x.y, 0), 1e10 where no y point is
valid. The evaluation chamfer (eval/metrics.py:chamfer_error) is its
caller: four calls a frame.

`nn_min_sqdist_fwd` is the wrapper: a CUDA tensor launches the
hand-written kernel csrc/label_nn.cu (entry vt_nn_min: 128 x points a
block, y split over its 8 warps and over `_splits` blocks, merged in
ascending y order) or raises, a CPU tensor runs the plain
PyTorch version `nn_min_sqdist_plain`, which spells out the kernel's
arithmetic operation by operation and is bit-equal to it. Every function
here reaches the points through the wrapper, once per call on the whole
cloud; `chunk` only blocks the plain version. Forward only: no gradient
flows through these distances.

The labelled variant (the stage-6 contact pairing, kernel K3) is
ops/label_nn.py:label_nn, re-exported here as label_compatible_nn; it
takes batched (B, N, 3) points where the JAX function takes (N, 3).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .label_nn import _PLAIN_ROWS, masked_min_plain
from .label_nn import label_nn as label_compatible_nn  # noqa: F401


def _check(x, y, y_valid):
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"nn_min_sqdist takes float32 points, got {x.dtype} "
                        f"and {y.dtype}")
    if x.dim() != 3 or y.dim() != 3 or x.shape[2] != 3 or y.shape[2] != 3 \
            or x.shape[0] != y.shape[0] or 0 in x.shape or 0 in y.shape:
        raise ValueError(f"points must be (B, N, 3) and (B, M, 3), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.shape[0] > 65535:
        raise ValueError(f"batch {x.shape[0]} exceeds the kernel's 65535")
    if y_valid.shape != y.shape[:2] or y_valid.dtype != torch.bool:
        raise ValueError(f"y_valid must be bool (B, M), got {y_valid.dtype} "
                         f"{tuple(y_valid.shape)}")
    if not x.device == y.device == y_valid.device:
        raise ValueError("all inputs must share a device")


def nn_min_sqdist_plain(x, y, y_valid, rows: int = _PLAIN_ROWS):
    """Plain PyTorch K4: (min squared distance (B, N) float32, argmin
    (B, N) int64) over the valid y points, in the kernel's rounding order
    (ops/label_nn.py:masked_min_plain), `rows` x points at a time."""
    _check(x, y, y_valid)
    return masked_min_plain(x, y, y_valid, rows=rows)


_X_BLOCK = 128   # x points a block of the kernel
_MIN_SPLIT = 256  # least y points a split of the kernel takes
_PER_SM = 3       # blocks an SM the split aims at


def _splits(x_blocks: int, m: int, sms: int) -> int:
    """How many y ranges the kernel splits M points into, for x_blocks
    blocks of x points on `sms` SMs: the most that keep the grid within
    three blocks an SM, each range at least 256 points, and at least one
    (5 at the evaluate shape: 395 blocks on 132 SMs). From the shapes
    alone: no host sync."""
    return max(1, min(_PER_SM * sms // x_blocks, m // _MIN_SPLIT))


@functools.cache
def _kernel():
    """csrc/label_nn.cu's entry vt_nn_min, built and loaded at first use,
    with its ctypes signature."""
    from ..utils.cuda_build import load_library

    fn = load_library("label_nn").vt_nn_min
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def nn_min_sqdist_fwd(x, y, y_valid, rows: int = _PLAIN_ROWS):
    """K4 -> (min (B, N) float32, argmin (B, N) int64) for x (B, N, 3), y
    (B, M, 3) float32 and y_valid (B, M) bool. A CUDA tensor launches the
    hand-written kernel (two launches in one call when y is split over
    blocks); a CPU tensor runs nn_min_sqdist_plain (blocked by `rows`)."""
    if x.device.type == "cpu":
        return nn_min_sqdist_plain(x, y, y_valid, rows)
    if x.device.type != "cuda":
        raise ValueError(f"nn_min_sqdist: unsupported device {x.device}")
    _check(x, y, y_valid)
    B, N, _ = x.shape
    M = y.shape[1]
    xc, yc = x.detach().contiguous(), y.detach().contiguous()
    valid = y_valid.contiguous().view(torch.uint8)
    dev = x.device
    splits = _splits(B * -(-N // _X_BLOCK), M, _sm_count(dev.index or 0))
    dmin = torch.empty((B, N), dtype=torch.float32, device=dev)
    idx = torch.empty((B, N), dtype=torch.int64, device=dev)
    part_d = part_j = None
    if splits > 1:  # (splits, B, N) partial minima and indices
        part = torch.empty((2, splits, B, N), dtype=torch.float32,
                           device=dev)
        part_d, part_j = part[0].data_ptr(), part[1].data_ptr()
    with torch.cuda.device(dev):
        err = _kernel()(xc.data_ptr(), yc.data_ptr(), valid.data_ptr(),
                        part_d, part_j, dmin.data_ptr(), idx.data_ptr(), B,
                        N, M, splits, torch.cuda.current_stream(dev)
                        .cuda_stream)
    if err != 0:
        raise RuntimeError(f"nn_min_sqdist kernel launch failed: CUDA error "
                           f"{err}")
    nn_min_sqdist_fwd.launches += 1
    return dmin, idx


nn_min_sqdist_fwd.launches = 0


def _weights(mask, pts):
    """A mask as the float weights of its points; None -> all ones."""
    if mask is None:
        return torch.ones(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
    return mask.to(pts.dtype)


def _valid(mask, pts):
    return _weights(mask, pts) != 0


def nn_distances(x, y, y_mask=None, chunk: int = 2048,
                 with_idx: bool = False):
    """For each x point (N, 3) the squared distance to (and index of) its
    nearest y point (M, 3); y_mask (M,) marks the valid ones. Returns
    (N,) [+ (N,) int64]."""
    d, idx = nn_min_sqdist_fwd(x[None], y[None], _valid(y_mask, y)[None],
                               chunk)
    return (d[0], idx[0]) if with_idx else d[0]


def chamfer_distance(s1, s2, mask1=None, mask2=None, w1: float = 1.0,
                     w2: float = 1.0, sqrt: bool = True,
                     chunk: int = 2048) -> torch.Tensor:
    """Bidirectional chamfer of batched clouds s1 (B, N, 3), s2 (B, M, 3):
    w1 * mean over s1 of its NN distance into s2 + w2 * the reverse, the
    distances square-rooted when `sqrt`. Masks (B, N) / (B, M) mark the
    valid points: an invalid point is nobody's neighbour and its own
    distance is left out of its side's mean. Returns (B,)."""
    d12 = nn_min_sqdist_fwd(s1, s2, _valid(mask2, s2), chunk)[0]
    d21 = nn_min_sqdist_fwd(s2, s1, _valid(mask1, s1), chunk)[0]
    if sqrt:
        d12, d21 = torch.sqrt(d12), torch.sqrt(d21)
    if mask1 is None and mask2 is None:
        return d12.mean(-1) * w1 + d21.mean(-1) * w2
    m1, m2 = _weights(mask1, s1), _weights(mask2, s2)
    a = (d12 * m1).sum(-1) / torch.clamp(m1.sum(-1), min=1.0)
    b = (d21 * m2).sum(-1) / torch.clamp(m2.sum(-1), min=1.0)
    return a * w1 + b * w2


def one_way_sq(src, tgt, tgt_mask=None, chunk: int = 2048) -> torch.Tensor:
    """Batched one-way squared NN distance: (B, N, 3), (B, M, 3) -> (B, N)."""
    return nn_min_sqdist_fwd(src, tgt, _valid(tgt_mask, tgt), chunk)[0]


def nearest_index(src, tgt, tgt_mask=None, chunk: int = 2048):
    """Batched nearest neighbours: (dists_sq (B, N), idx (B, N) int64), the
    least index on exact ties."""
    return nn_min_sqdist_fwd(src, tgt, _valid(tgt_mask, tgt), chunk)
