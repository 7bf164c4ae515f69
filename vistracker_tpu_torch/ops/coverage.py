"""Coverage rasters through the max-logit kernels: hard masks (stage 3,
kernel K1) and the differentiable soft silhouette (stage 6, K1 + K2).

Port of vistracker_tpu/ops/pallas_raster.py. Faces
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
arithmetic in the same order and is bit-equal to it. The kernel skips
faces that cannot reach a pixel's max by an exact per-tile bound;
`max_logit_fwd_walks` returns its skip counts, and
`max_logit_fwd_walks_plain` is its algorithm in plain PyTorch.

The soft silhouette is sigmoid(m / sigma): the kernel is sigma-free and
autograd supplies the sigmoid's p (1 - p) / sigma. Its liveness is a
conservative interval bound on m (`_strip_active`): a cell is skipped
when no face of the block can come within 20 sigma of any of its pixels.
`max_logit_bwd` is the backward wrapper (kernel K2, csrc/max_logit_bwd.cu;
plain version `max_logit_bwd_plain`): it recomputes the planes, picks the
winning faces by bitwise equality with the saved max, splits equally
among tied planes, and reduces against [px, py, 1]. Ties among faces are
not rare (fold-adjacent faces share edge distances over whole regions),
so the forward's tie count divides the cotangent first.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

_BIG = 1e9
_FBLK = 128      # faces per block
_RBLK = 8        # image rows per strip
_XBLK = 128      # pixel columns per x tile above 256 px
_NPL = 5         # planes per face
_CW = 3 * _NPL   # coefficients per face
_BAND_BLOCKS = 2  # y-band height of the face sort, in face blocks
# faces farther than this many sigmas from every pixel of a cell are
# culled: sigmoid(-20) ~ 2e-9 moves neither the max nor the gradient
_CUT_SIGMAS = 20.0


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


def _strip_active(cpl: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """Conservative (strip, x tile, face block) liveness for the soft
    silhouette from the sorted, padded planes cpl (B, F', 15). Per face,
    strip and x sub-segment (8 per image row, OR-ed within a tile) the max
    of m = min_j e_j over the pixel box is bounded by
        min_j (a_j xc + |a_j| xh + max(b_j ylo, b_j yhi) + c_j);
    a cell is live iff any face of the block can reach -20 sigma in any
    sub-segment. Dead rows bound to -1e9. Returns int32
    (B * n_strips, n_xblk * n_fblk), x-major columns."""
    B, Fp, _ = cpl.shape
    n_fblk, n_strips = Fp // _FBLK, size // _RBLK
    n_xblk = size // _xblk(size)
    nsub = 8 // n_xblk if n_xblk <= 8 else 1
    nseg = n_xblk * nsub
    a = cpl[..., 0::3, None, None]                  # (B, F', 5, 1, 1)
    b = cpl[..., 1::3, None, None]
    c = cpl[..., 2::3, None, None]
    scale = 2.0 / (size - 1)
    f32 = dict(dtype=torch.float32, device=cpl.device)
    s_lo = torch.arange(n_strips, **f32) * _RBLK * scale - 1.0
    s_hi = s_lo + (_RBLK - 1) * scale
    xh = 1.0 / nseg
    xc = ((torch.arange(nseg, **f32) + 0.5) * 2.0 * xh - 1.0)[:, None]
    ub_e = (a * xc + a.abs() * xh
            + torch.maximum(b * s_lo, b * s_hi) + c)  # (B, F', 5, nseg, S)
    live = ub_e.amin(2) >= -_CUT_SIGMAS * float(sigma)
    live = live.reshape(B, n_fblk, _FBLK, n_xblk, nsub, n_strips)
    live = live.any(4).any(2)                        # (B, nblk, nx, S)
    return live.permute(0, 3, 2, 1).to(torch.int32) \
        .reshape(B * n_strips, n_xblk * n_fblk).contiguous()


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
        raise TypeError("the max-logit kernels take float32 planes and "
                        f"int32 liveness, got {cpl.dtype} and {active.dtype}")
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


def _live_blocks(cpl: torch.Tensor, active: torch.Tensor, size: int):
    """For the plain versions: yield, for every (view, face block) with a
    live cell, (b, face slice, row slice, col slice, planes, px, py,
    cells) over the rectangle spanned by its live cells. planes is the
    list of the 5 plane values (128, rows, cols), each fma(a, px,
    fma(b, py, c)) with px, py = fma(index, 2/(S-1), -1); px is
    (1, 1, cols), py (1, rows, 1); cells (rows, cols) marks the pixels of
    live cells."""
    B, Fp, _ = cpl.shape
    xblk = _xblk(size)
    n_strips, n_xblk, n_fblk = size // _RBLK, size // xblk, Fp // _FBLK
    dev = cpl.device
    col = torch.arange(size, dtype=torch.float32, device=dev)
    coord = fma32(col, torch.full_like(col, 2.0 / (size - 1)),
                  torch.full_like(col, -1.0))
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
            fsl = slice(f * _FBLK, (f + 1) * _FBLK)
            ct = cpl[b, fsl, :, None, None]
            px = coord[cols][None, None, :]
            py = coord[rows][None, :, None]
            planes = []
            for j in range(_NPL):
                inner = fma32(ct[:, 3 * j + 1].expand(-1, py.shape[1], 1),
                              py.expand(_FBLK, -1, 1), ct[:, 3 * j + 2]
                              .expand(-1, py.shape[1], 1))
                shape = (_FBLK, py.shape[1], px.shape[2])
                planes.append(fma32(ct[:, 3 * j].expand(shape),
                                    px.expand(shape), inner.expand(shape)))
            cells = torch.from_numpy(live[b, r0:r1, x0:x1, f]).to(dev)
            cells = cells.repeat_interleave(_RBLK, 0) \
                .repeat_interleave(xblk, 1)
            yield b, fsl, rows, cols, planes, px, py, cells


def max_logit_fwd_plain(cpl: torch.Tensor, active: torch.Tensor,
                        size: int):
    """Plain PyTorch K1: the same liveness, the same per-plane arithmetic
    (e = fma(a, px, fma(b, py, c)), px = fma(col, 2/(S-1), -1)), the same
    block-wise (max, tie count) update as the TPU kernel. Loops over views
    and face blocks and evaluates each live block only on the rectangle of
    its live cells, so it fits at stage-3 shapes."""
    _check(cpl, active, size)
    B, dev = cpl.shape[0], cpl.device
    m = torch.full((B, size, size), -_BIG, dtype=torch.float32, device=dev)
    cnt = torch.zeros((B, size, size), dtype=torch.float32, device=dev)
    for b, _, rows, cols, planes, _, _, cells in _live_blocks(cpl, active,
                                                              size):
        mm = planes[0]
        for e in planes[1:]:
            mm = torch.minimum(mm, e)
        bm = mm.amax(0)
        bc = (mm == bm).sum(0, dtype=torch.float32)
        old_m, old_c = m[b, rows, cols], cnt[b, rows, cols]
        new_c = torch.where(bm > old_m, bc,
                            torch.where(bm == old_m, old_c + bc, old_c))
        m[b, rows, cols] = torch.where(cells, torch.maximum(old_m, bm),
                                       old_m)
        cnt[b, rows, cols] = torch.where(cells, new_c, old_c)
    return m, cnt


_TILE_COLS = 16  # columns of the kernel's warp tile (8 rows x 16)
_BATCH = 32      # faces the kernel tests at once (one a lane)


def max_logit_fwd_walks_plain(cpl: torch.Tensor, active: torch.Tensor,
                              size: int):
    """The kernel's own algorithm (csrc/max_logit_fwd.cu) in plain
    PyTorch, for its skip counts: per (view, strip, x tile) and tile of 8
    rows x 16 columns, T0 = max over the faces of the live blocks of their
    least value over the tile's corners; then 32 faces at a time in
    ascending order, the faces whose greatest corner value reaches
    max(T0, the tile's least running max) are walked. Every value is the
    kernel's fma32. Returns (m, cnt, tested, walked): m and cnt must equal
    max_logit_fwd_plain's, tested and walked count (face, tile) pairs as
    the kernel's `stats` does."""
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
    starts = list(range(0, xblk, _TILE_COLS))
    lasts = [min(s + _TILE_COLS, xblk) - 1 for s in starts]
    tile_of = torch.arange(xblk, device=dev) // _TILE_COLS
    live = active.reshape(B, n_strips, n_xblk, n_fblk).cpu().numpy() != 0
    tested = walked = 0
    for b, r, x in zip(*np.nonzero(live.any(3))):
        blocks = np.nonzero(live[b, r, x])[0]
        fc = torch.cat([cpl[b, f * _FBLK:(f + 1) * _FBLK] for f in blocks])
        a, bb, c = fc[:, 0::3], fc[:, 1::3], fc[:, 2::3]       # (F, 5)
        rows = slice(r * _RBLK, (r + 1) * _RBLK)
        cols = slice(x * xblk, (x + 1) * xblk)
        inner = fma32(bb[:, None, :], coord[rows][None, :, None],
                      c[:, None, :])                          # (F, 8, 5)
        shape = (fc.shape[0], _RBLK, xblk, _NPL)
        mins = fma32(a[:, None, None, :].expand(shape),
                     coord[cols][None, None, :, None].expand(shape),
                     inner[:, :, None, :].expand(shape)).amin(-1)
        ih = torch.maximum(inner[:, 0], inner[:, -1])[:, None, :]
        il = torch.minimum(inner[:, 0], inner[:, -1])[:, None, :]
        ends = [coord[cols][ix][None, :, None] for ix in (starts, lasts)]
        aa = a[:, None, :]
        hi = torch.maximum(*(fma32(aa, p, ih) for p in ends)).amin(-1)
        t_low = torch.minimum(*(fma32(aa, p, il) for p in ends)) \
            .amin(-1).amax(0)                                 # (tiles,)
        run_m = torch.full((_RBLK, xblk), -_BIG, device=dev)
        run_c = torch.zeros((_RBLK, xblk), device=dev)
        for f0 in range(0, fc.shape[0], _BATCH):
            least = torch.stack([run_m[:, s:e + 1].amin()
                                 for s, e in zip(starts, lasts)])
            walk = hi[f0:f0 + _BATCH] >= torch.maximum(t_low, least)
            tested += walk.numel()
            walked += int(walk.sum())
            vals = torch.where(walk[:, tile_of][:, None, :],
                               mins[f0:f0 + _BATCH], -float("inf"))
            bm = vals.amax(0)
            bc = (vals == bm).sum(0, dtype=torch.float32)
            run_c = torch.where(bm > run_m, bc, torch.where(
                bm == run_m, run_c + bc, run_c))
            run_m = torch.maximum(run_m, bm)
        m[b, rows, cols] = run_m
        cnt[b, rows, cols] = run_c
    return m, cnt, tested, walked


@functools.cache
def _fwd_kernel():
    """csrc/max_logit_fwd.cu's entry, built and loaded at first use, with
    its ctypes signature."""
    from ..utils.cuda_build import load_library

    fn = load_library("max_logit_fwd").vt_max_logit_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _fwd_launch(cpl, active, size, stats=None):
    if cpl.device.type != "cuda":
        raise ValueError(f"max_logit_fwd: unsupported device {cpl.device}")
    _check(cpl, active, size)
    if not (cpl.is_contiguous() and active.is_contiguous()):
        raise ValueError("max_logit_fwd needs contiguous inputs")
    if cpl.data_ptr() % 16:
        raise ValueError("max_logit_fwd needs planes that start on 16 "
                         "bytes (the kernel stages them as float4)")
    B, Fp, _ = cpl.shape
    m = torch.empty((B, size, size), dtype=torch.float32, device=cpl.device)
    cnt = torch.empty_like(m)
    with torch.cuda.device(cpl.device):
        err = _fwd_kernel()(
            cpl.data_ptr(), active.data_ptr(), m.data_ptr(), cnt.data_ptr(),
            None if stats is None else stats.data_ptr(), B, Fp, size,
            _xblk(size), 2.0 / (size - 1),
            torch.cuda.current_stream(cpl.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"max_logit_fwd kernel launch failed: CUDA "
                           f"error {err}")
    max_logit_fwd.launches += 1
    return m, cnt


def max_logit_fwd(cpl: torch.Tensor, active: torch.Tensor, size: int):
    """K1 forward: (B, F', 15) planes + int32 liveness -> (m, cnt), each
    (B, size, size) float32. A CUDA tensor launches the hand-written
    kernel; a CPU tensor runs max_logit_fwd_plain."""
    if cpl.device.type == "cpu":
        return max_logit_fwd_plain(cpl, active, size)
    return _fwd_launch(cpl, active, size)


max_logit_fwd.launches = 0


def max_logit_fwd_walks(cpl: torch.Tensor, active: torch.Tensor, size: int):
    """K1 with its skip counts: (m, cnt, tested, walked), the (face, tile)
    pairs the kernel tested and walked. A CUDA tensor launches the kernel
    (a counted launch) with its counters; a CPU tensor runs
    max_logit_fwd_walks_plain, the same algorithm."""
    if cpl.device.type == "cpu":
        return max_logit_fwd_walks_plain(cpl, active, size)
    stats = torch.zeros(2, dtype=torch.int64, device=cpl.device)
    m, cnt = _fwd_launch(cpl, active, size, stats)
    tested, walked = stats.tolist()
    return m, cnt, tested, walked


def _check_bwd(cpl, active, m, gw, size):
    _check(cpl, active, size)
    want = (cpl.shape[0], size, size)
    for name, t in (("m", m), ("gw", gw)):
        if t.dtype != torch.float32 or tuple(t.shape) != want \
                or t.device != cpl.device:
            raise ValueError(f"max_logit_bwd: {name} must be float32 {want} "
                             f"on {cpl.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def max_logit_bwd_plain(cpl: torch.Tensor, active: torch.Tensor,
                        m: torch.Tensor, gw: torch.Tensor, size: int):
    """Plain PyTorch K2: d(sum gw * m)/d(planes), (B, F', 15), from the
    saved max m and the tie-split cotangent gw = g / max(cnt, 1). Planes
    are recomputed as in max_logit_fwd_plain; a face wins a pixel of a
    live cell iff its min equals m there bitwise; its cotangent gw / den
    goes to each of the den planes tied at the min, times [px, py, 1]."""
    _check_bwd(cpl, active, m, gw, size)
    dc = torch.zeros_like(cpl)
    for b, fsl, rows, cols, planes, px, py, cells in _live_blocks(
            cpl, active, size):
        mm = planes[0]
        for e in planes[1:]:
            mm = torch.minimum(mm, e)
        win = (mm == m[b, rows, cols]) & cells
        ties = [(e == mm).to(torch.float32) for e in planes]
        den = ties[0]
        for t in ties[1:]:
            den = den + t
        gm = gw[b, rows, cols] * win.to(torch.float32) / den
        for j, tj in enumerate(ties):
            de = gm * tj                                   # (128, R, C)
            dsum = de.sum(2)                               # (128, R)
            dc[b, fsl, 3 * j] += (de * px).sum((1, 2))
            dc[b, fsl, 3 * j + 1] += (dsum * py[0, :, 0]).sum(1)
            dc[b, fsl, 3 * j + 2] += dsum.sum(1)
    return dc


def max_logit_bwd(cpl: torch.Tensor, active: torch.Tensor, m: torch.Tensor,
                  gw: torch.Tensor, size: int) -> torch.Tensor:
    """K2: (B, F', 15) cotangent of the planes. A CUDA tensor launches the
    hand-written kernel (two launches, one call: per live cell, then a sum
    over cells); a CPU tensor runs max_logit_bwd_plain."""
    if cpl.device.type == "cpu":
        return max_logit_bwd_plain(cpl, active, m, gw, size)
    if cpl.device.type != "cuda":
        raise ValueError(f"max_logit_bwd: unsupported device {cpl.device}")
    _check_bwd(cpl, active, m, gw, size)
    if not (cpl.is_contiguous() and active.is_contiguous()
            and m.is_contiguous() and gw.is_contiguous()):
        raise ValueError("max_logit_bwd needs contiguous inputs")
    from ..utils.cuda_build import load_library

    fn = load_library("max_logit_bwd").vt_max_logit_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, Fp, _ = cpl.shape
    dc = torch.empty_like(cpl)
    # one slot of 128 x 15 partial sums per (view, strip, x tile, face
    # block) cell; the kernel writes and reads only the live cells' slots
    partial = torch.empty((active.numel(), _FBLK * _CW), dtype=torch.float32,
                          device=cpl.device)
    with torch.cuda.device(cpl.device):
        err = fn(cpl.data_ptr(), active.data_ptr(), m.data_ptr(),
                 gw.data_ptr(), partial.data_ptr(), dc.data_ptr(), B, Fp,
                 size, _xblk(size), 2.0 / (size - 1),
                 torch.cuda.current_stream(cpl.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"max_logit_bwd kernel launch failed: CUDA "
                           f"error {err}")
    max_logit_bwd.launches += 1
    return dc


max_logit_bwd.launches = 0


class _MaxLogit(torch.autograd.Function):
    """(B, F', 15) planes + liveness -> (B, size, size) per-pixel max
    signed distance, with the kernel pair as forward and backward.
    `fwd_launches` counts the forward kernel's launches made from here
    (the soft silhouette's share of max_logit_fwd.launches)."""

    fwd_launches = 0

    @staticmethod
    def forward(ctx, cpl, active, size):
        cpl = cpl.detach().contiguous()
        before = max_logit_fwd.launches
        m, cnt = max_logit_fwd(cpl, active, size)
        _MaxLogit.fwd_launches += max_logit_fwd.launches - before
        ctx.save_for_backward(cpl, active, m, cnt)
        ctx.size = size
        return m

    @staticmethod
    def backward(ctx, g):
        cpl, active, m, cnt = ctx.saved_tensors
        # equal split among the faces tied at the max
        gw = (g.to(torch.float32) / torch.clamp(cnt, min=1.0)).contiguous()
        return max_logit_bwd(cpl, active, m, gw, ctx.size), None, None


def soft_silhouette_batch(v2d: torch.Tensor, faces: torch.Tensor,
                          size: int = 256,
                          sigma: float = 1.0 / 128.0) -> torch.Tensor:
    """Batched differentiable soft silhouette: (B, V, 2) NDC verts +
    (F, 3) faces -> (B, size, size) in [0, 1], the same function (and
    gradient convention) as ops.rasterizer.soft_silhouette per view. The
    planes, the liveness bound and the per-pixel sigmoid are plain
    PyTorch (O(F) or O(P)); only the O(F P) max runs in the kernels. All
    views go through one launch."""
    cpl = _planes(v2d, faces)
    active = _strip_active(cpl.detach(), size, float(sigma))
    m = _MaxLogit.apply(cpl, active, size)
    return torch.sigmoid(m * (1.0 / float(sigma)))


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
