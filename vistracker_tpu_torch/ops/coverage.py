"""Hard coverage masks through the K1 max-logit kernel (stage 3).

Port of the forward half of vistracker_tpu/ops/pallas_raster.py. Faces
become 5 inside-positive planes (rasterizer._face_planes), are sorted
into equal-count y bands and x-sorted within each band so that every
128-face block is compact, and are padded to a block multiple with dead
rows [0, 0, -1e9]. An exact bbox liveness mask marks the (8-row strip,
x tile, face block) cells a block can cover. The kernel returns per pixel
the max over faces of the min over planes (m) and the number of faces
tied at it (cnt); a pixel is covered iff m >= 0.

`max_logit_fwd` is the wrapper: a CUDA tensor launches the hand-written
kernel csrc/max_logit_fwd.cu (or raises), a CPU tensor runs the plain
PyTorch version `max_logit_fwd_plain`, which repeats the kernel's
arithmetic in the same order and is bit-equal to it.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

_BIG = 1e9
_FBLK = 128      # faces per block
_RBLK = 8        # image rows per strip
_XBLK = 128      # pixel columns per x tile above 256 px
_NPL = 5         # planes per face
_CW = 3 * _NPL   # coefficients per face
_BAND_BLOCKS = 2  # y-band height of the face sort, in face blocks


def _xblk(size: int) -> int:
    """x tile width: the full row up to 256 px, 128-px tiles above."""
    return size if size <= 256 else min(_XBLK, size)


def _planes(v2d: torch.Tensor, faces: torch.Tensor, want_bounds=False):
    """(B, V, 2) NDC verts + (F, 3) faces -> sorted, padded planes
    (B, F', 15), F' a multiple of 128, dead rows [0, 0, -1e9] per plane.
    With want_bounds also the matching per-face (ymin, ymax, xmin, xmax),
    dead rows reading the empty interval (+1e9, -1e9). Sorts are stable."""
    from .rasterizer import _face_planes

    faces = faces.long()
    coeffs, nondeg = _face_planes(v2d, faces)
    dead = torch.tensor([0.0, 0.0, -_BIG], dtype=coeffs.dtype,
                        device=coeffs.device)
    coeffs = torch.where(nondeg[..., None, None], coeffs, dead)
    B, F = coeffs.shape[:2]
    cpl = coeffs.reshape(B, F, _CW)

    fy = v2d[:, faces, 1]
    fx = v2d[:, faces, 0]
    big = torch.tensor(_BIG, dtype=v2d.dtype, device=v2d.device)
    ymin = torch.where(nondeg, fy.amin(-1), big)
    xmin = torch.where(nondeg, fx.amin(-1), big)
    if _BAND_BLOCKS and F > _BAND_BLOCKS * _FBLK:
        # dead faces have maximal y rank and x key, so they sort last
        yrank = torch.argsort(torch.argsort(ymin, dim=1, stable=True),
                              dim=1, stable=True)
        band = yrank // (_BAND_BLOCKS * _FBLK)
        key = band.to(torch.float32) * 1e4 + torch.clamp(xmin, -8.0, 8.0)
        order = torch.argsort(key, dim=1, stable=True)
    else:
        order = torch.argsort(ymin, dim=1, stable=True)
    cpl = torch.gather(cpl, 1, order[..., None].expand(B, F, _CW))

    pad = (-F) % _FBLK
    if pad:
        dead_rows = torch.zeros(B, pad, _CW, dtype=cpl.dtype,
                                device=cpl.device)
        dead_rows[..., 2::3] = -_BIG
        cpl = torch.cat([cpl, dead_rows], 1)
    if not want_bounds:
        return cpl
    ymax = torch.where(nondeg, fy.amax(-1), -big)
    xmax = torch.where(nondeg, fx.amax(-1), -big)

    def srt(v, fill):
        v = torch.gather(v, 1, order)
        return torch.cat([v, torch.full((B, pad), fill, dtype=v.dtype,
                                        device=v.device)], 1)

    return (cpl, srt(ymin, _BIG), srt(ymax, -_BIG), srt(xmin, _BIG),
            srt(xmax, -_BIG))


def _strip_active_bbox(ymin, ymax, xmin, xmax, size: int) -> torch.Tensor:
    """Exact (strip, x tile, block) liveness for the hard mask from the
    per-face intervals (B, F'): a covered pixel lies inside its face's
    bbox, so a cell is live iff the block's merged bbox meets it. Returns
    int32 (B * n_strips, n_xblk * n_fblk), x-major columns."""
    B, Fp = ymin.shape
    n_fblk, n_strips = Fp // _FBLK, size // _RBLK
    xblk = _xblk(size)
    n_xblk = size // xblk
    blo = ymin.reshape(B, n_fblk, _FBLK).amin(2)
    bhi = ymax.reshape(B, n_fblk, _FBLK).amax(2)
    xlo = xmin.reshape(B, n_fblk, _FBLK).amin(2)
    xhi = xmax.reshape(B, n_fblk, _FBLK).amax(2)
    scale = 2.0 / (size - 1)
    f32 = dict(dtype=torch.float32, device=ymin.device)
    s_lo = torch.arange(n_strips, **f32) * _RBLK * scale - 1.0
    s_hi = s_lo + (_RBLK - 1) * scale
    t_lo = torch.arange(n_xblk, **f32) * xblk * scale - 1.0
    t_hi = t_lo + (xblk - 1) * scale
    live_y = (blo[:, None, :] <= s_hi[None, :, None]) \
        & (bhi[:, None, :] >= s_lo[None, :, None])          # (B, S, nblk)
    live_x = (xlo[:, None, :] <= t_hi[None, :, None]) \
        & (xhi[:, None, :] >= t_lo[None, :, None])          # (B, X, nblk)
    live = live_y[:, :, None, :] & live_x[:, None, :, :]
    return live.to(torch.int32).reshape(B * n_strips, n_xblk * n_fblk)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Single-rounded float32 a*b + c (what a hardware FMA returns) on any
    device. The float64 product is exact; the float64 sum is rounded once
    more, which changes the float32 result only when it lands exactly on a
    float32 midpoint -- then the exact TwoSum remainder decides the side."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    r = s.float()
    rd = r.double()
    inf = torch.tensor(float("inf"), dtype=r.dtype, device=r.device)
    other = torch.nextafter(r, torch.where(s > rd, inf, -inf))
    mid = (s != rd) & ((rd + other.double()) * 0.5 == s) & (err != 0)
    up = torch.maximum(r, other)
    down = torch.minimum(r, other)
    return torch.where(mid, torch.where(err > 0, up, down), r)


def _check(cpl: torch.Tensor, active: torch.Tensor, size: int):
    if cpl.dtype != torch.float32 or active.dtype != torch.int32:
        raise TypeError("max_logit_fwd takes float32 planes and int32 "
                        f"liveness, got {cpl.dtype} and {active.dtype}")
    if cpl.dim() != 3 or cpl.shape[2] != _CW or cpl.shape[1] % _FBLK:
        raise ValueError(f"planes must be (B, 128k, {_CW}), got "
                         f"{tuple(cpl.shape)}")
    xblk = _xblk(size)
    if size % _RBLK or size % xblk:
        raise ValueError(f"size {size} must be a multiple of {_RBLK} and "
                         f"of the x tile {xblk}")
    B, Fp = cpl.shape[:2]
    want = (B * (size // _RBLK), (size // xblk) * (Fp // _FBLK))
    if tuple(active.shape) != want:
        raise ValueError(f"liveness must be {want}, got "
                         f"{tuple(active.shape)}")
    if active.device != cpl.device:
        raise ValueError("planes and liveness must share a device")


def max_logit_fwd_plain(cpl: torch.Tensor, active: torch.Tensor,
                        size: int):
    """Plain PyTorch K1: the same liveness, the same per-plane arithmetic
    (e = fma(a, px, fma(b, py, c)), px = fma(col, 2/(S-1), -1)), the same
    block-wise (max, tie count) update as the TPU kernel. Loops over views
    and face blocks and evaluates each live block only on the rectangle of
    its live cells, so it fits at stage-3 shapes."""
    _check(cpl, active, size)
    B, Fp, _ = cpl.shape
    xblk = _xblk(size)
    n_strips, n_xblk, n_fblk = size // _RBLK, size // xblk, Fp // _FBLK
    dev = cpl.device
    col = torch.arange(size, dtype=torch.float32, device=dev)
    coord = fma32(col, torch.full_like(col, 2.0 / (size - 1)),
                  torch.full_like(col, -1.0))
    m = torch.full((B, size, size), -_BIG, dtype=torch.float32, device=dev)
    cnt = torch.zeros((B, size, size), dtype=torch.float32, device=dev)
    live = active.reshape(B, n_strips, n_xblk, n_fblk).cpu().numpy() != 0
    for b in range(B):
        for f in range(n_fblk):
            rs, xs = np.nonzero(live[b, :, :, f])
            if rs.size == 0:
                continue
            r0, r1 = rs.min(), rs.max() + 1
            x0, x1 = xs.min(), xs.max() + 1
            rows = slice(r0 * _RBLK, r1 * _RBLK)
            cols = slice(x0 * xblk, x1 * xblk)
            ct = cpl[b, f * _FBLK:(f + 1) * _FBLK, :, None, None]
            px = coord[cols][None, None, :]
            py = coord[rows][None, :, None]
            mm = None
            for j in range(_NPL):
                inner = fma32(ct[:, 3 * j + 1].expand(-1, py.shape[1], 1),
                              py.expand(_FBLK, -1, 1), ct[:, 3 * j + 2]
                              .expand(-1, py.shape[1], 1))
                shape = (_FBLK, py.shape[1], px.shape[2])
                e = fma32(ct[:, 3 * j].expand(shape), px.expand(shape),
                          inner.expand(shape))
                mm = e if mm is None else torch.minimum(mm, e)
            bm = mm.amax(0)
            bc = (mm == bm).sum(0, dtype=torch.float32)
            cells = torch.from_numpy(live[b, r0:r1, x0:x1, f]).to(dev)
            cells = cells.repeat_interleave(_RBLK, 0) \
                .repeat_interleave(xblk, 1)
            old_m, old_c = m[b, rows, cols], cnt[b, rows, cols]
            new_c = torch.where(bm > old_m, bc,
                                torch.where(bm == old_m, old_c + bc, old_c))
            m[b, rows, cols] = torch.where(cells, torch.maximum(old_m, bm),
                                           old_m)
            cnt[b, rows, cols] = torch.where(cells, new_c, old_c)
    return m, cnt


def max_logit_fwd(cpl: torch.Tensor, active: torch.Tensor, size: int):
    """K1 forward: (B, F', 15) planes + int32 liveness -> (m, cnt), each
    (B, size, size) float32. A CUDA tensor launches the hand-written
    kernel; a CPU tensor runs max_logit_fwd_plain."""
    if cpl.device.type == "cpu":
        return max_logit_fwd_plain(cpl, active, size)
    if cpl.device.type != "cuda":
        raise ValueError(f"max_logit_fwd: unsupported device {cpl.device}")
    _check(cpl, active, size)
    if not (cpl.is_contiguous() and active.is_contiguous()):
        raise ValueError("max_logit_fwd needs contiguous inputs")
    from ..utils.cuda_build import load_library

    fn = load_library("max_logit_fwd").vt_max_logit_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, Fp, _ = cpl.shape
    m = torch.empty((B, size, size), dtype=torch.float32, device=cpl.device)
    cnt = torch.empty_like(m)
    with torch.cuda.device(cpl.device):
        err = fn(cpl.data_ptr(), active.data_ptr(), m.data_ptr(),
                 cnt.data_ptr(), B, Fp, size, _xblk(size), 2.0 / (size - 1),
                 torch.cuda.current_stream(cpl.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"max_logit_fwd kernel launch failed: CUDA "
                           f"error {err}")
    max_logit_fwd.launches += 1
    return m, cnt


max_logit_fwd.launches = 0


def coverage_mask_batch(v2d: torch.Tensor, faces: torch.Tensor,
                        size: int = 512) -> torch.Tensor:
    """Batched hard coverage mask: (B, V, 2) NDC verts + (F, 3) faces ->
    (B, size, size) float32 {0, 1}; a pixel is covered iff all 3 edge
    functions of some face are >= 0, i.e. iff max_f m_f >= 0. All B views
    go through one kernel call."""
    cpl, ymin, ymax, xmin, xmax = _planes(v2d, faces, want_bounds=True)
    active = _strip_active_bbox(ymin, ymax, xmin, xmax, size)
    m, _ = max_logit_fwd(cpl.contiguous(), active.contiguous(), size)
    return (m >= 0.0).to(torch.float32)
