"""Plain PyTorch references of the port's three `track` kernels.

FROZEN COPY. The arithmetic below is copied from the plain versions of
vistracker_tpu_torch/ops/coverage.py (max_logit_fwd_plain,
max_logit_bwd_plain, fma32, _live_blocks) and
vistracker_tpu_torch/ops/label_nn.py (masked_min_plain) at commit
ebfc849, with the checks and the counting variants left out. It is the
yardstick that decides `correct`: a change that claims a speed-up may not
edit this file. It imports nothing of the port.

  K1  max_logit_fwd(cpl, active, size) -> (m, cnt): per pixel the max
      over faces of the min over a face's 5 planes, and the number of
      faces tied at it, over the live (8-row strip, x tile, 128-face
      block) cells;
  K2  max_logit_bwd(cpl, active, m, gw, size) -> d(sum gw * m)/d(planes);
  K3  label_nn(x, labels_x, y, labels_y, y_valid) -> (min squared
      distance, argmin) over the valid y points of x's label.

`tf32(x)` rounds float32 to TF32's 10-bit mantissa: the controls feed the
references rounded inputs, the nearest precision below float32.
"""
from __future__ import annotations

import numpy as np
import torch

BIG = 1e9
FBLK = 128      # faces per block
RBLK = 8        # image rows per strip
XBLK = 128      # pixel columns per x tile above 256 px
NPL = 5         # planes per face
NONE = 1e10     # K3's distance where no compatible y point exists
PLAIN_ROWS = 1024


def xblk(size: int) -> int:
    return size if size <= 256 else min(XBLK, size)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest-even at TF32's 10 mantissa bits."""
    i = x.contiguous().view(torch.int32)
    keep = (i >> 13) & 1
    r = ((i + 0xFFF + keep) >> 13) << 13
    return torch.where(torch.isfinite(x), r.view(torch.float32), x)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Single-rounded float32 a*b + c (a hardware FMA) on any device."""
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


def _live_blocks(cpl, active, size):
    B, Fp, _ = cpl.shape
    xb = xblk(size)
    n_strips, n_xblk, n_fblk = size // RBLK, size // xb, Fp // FBLK
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
            rows = slice(r0 * RBLK, r1 * RBLK)
            cols = slice(x0 * xb, x1 * xb)
            fsl = slice(f * FBLK, (f + 1) * FBLK)
            ct = cpl[b, fsl, :, None, None]
            px = coord[cols][None, None, :]
            py = coord[rows][None, :, None]
            planes = []
            for j in range(NPL):
                inner = fma32(ct[:, 3 * j + 1].expand(-1, py.shape[1], 1),
                              py.expand(FBLK, -1, 1), ct[:, 3 * j + 2]
                              .expand(-1, py.shape[1], 1))
                shape = (FBLK, py.shape[1], px.shape[2])
                planes.append(fma32(ct[:, 3 * j].expand(shape),
                                    px.expand(shape), inner.expand(shape)))
            cells = torch.from_numpy(live[b, r0:r1, x0:x1, f]).to(dev)
            cells = cells.repeat_interleave(RBLK, 0) \
                .repeat_interleave(xb, 1)
            yield b, fsl, rows, cols, planes, px, py, cells


def max_logit_fwd(cpl, active, size):
    B, dev = cpl.shape[0], cpl.device
    m = torch.full((B, size, size), -BIG, dtype=torch.float32, device=dev)
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


def max_logit_bwd(cpl, active, m, gw, size):
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
            de = gm * tj
            dsum = de.sum(2)
            dc[b, fsl, 3 * j] += (de * px).sum((1, 2))
            dc[b, fsl, 3 * j + 1] += (dsum * py[0, :, 0]).sum(1)
            dc[b, fsl, 3 * j + 2] += dsum.sum(1)
    return dc


def _sq_norm(v):
    return (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) \
        + v[..., 2] * v[..., 2]


def label_nn(x, labels_x, y, labels_y, y_valid, rows: int = PLAIN_ROWS):
    N, M = x.shape[1], y.shape[1]
    yy = _sq_norm(y)[:, None, :]
    col = torch.arange(M, device=x.device)
    none = torch.tensor(NONE, dtype=torch.float32, device=x.device)
    mins, idxs = [], []
    for s in range(0, N, rows):
        xc = x[:, s:s + rows]
        xy = (xc[:, :, None, 0] * y[:, None, :, 0]
              + xc[:, :, None, 1] * y[:, None, :, 1]) \
            + xc[:, :, None, 2] * y[:, None, :, 2]
        d = torch.clamp((_sq_norm(xc)[:, :, None] + yy) - 2.0 * xy, min=0.0)
        ok = y_valid[:, None, :] \
            & (labels_x[:, s:s + rows, None] == labels_y[:, None, :])
        d = torch.where(ok, d, none)
        mn = d.amin(-1)
        mins.append(mn)
        idxs.append(torch.where(d <= mn[..., None], col, M).amin(-1))
    return torch.cat(mins, 1), torch.cat(idxs, 1)
