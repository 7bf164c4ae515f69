"""Operation and byte counts of the work the benchmark measures, from
shapes and inputs alone, so that they count the same work whatever
implements it.

FROZEN: a change that claims a speed-up may not edit this file.

  encode_flops, head_flops, train_step_flops  SIF-Net's model FLOPs:
      2 x the multiply-adds of every convolution and linear layer of the
      plain reference (portbench/reference/sifnet.py), counted on the
      meta device; norms, pooling, resampling and activations are not
      counted.
  bound, compatible_pairs, k1_need, k2_walk_share  the kernels' least
      times: copies of chip_smoke.py's at commit ebfc849 (the H100's
      float32 rate and memory rate, the operations each kernel's inputs
      need).
"""
from __future__ import annotations

import torch

from portbench.reference import kernels as RK
from portbench.reference import sifnet as RS

FP32_OPS = 67e12        # H100 SXM, float32 outside the tensor cores
HBM_BYTES = 3.35e12     # H100 SXM HBM3
K1_OPS_PER_PIXEL_FACE = 15  # 5 planes x 1 FMA (2 flops) + 4 min + 1 cmp
K1_OPS_PER_ROW_FACE = 10    # the row terms b*py + c: 5 FMAs
K1_OPS_PER_TILE_TEST = 55   # skip test of a (face, 8 x 16 tile)
K1_TILE_ROWS, K1_TILE_COLS = 8, 16
K1_OPS_PER_TILE_WALK = (K1_TILE_ROWS * K1_OPS_PER_ROW_FACE
                        + K1_TILE_ROWS * K1_TILE_COLS * K1_OPS_PER_PIXEL_FACE)
K3_OPS_PER_PAIR = 12    # x.y 5, distance 3, mask 2, running min 2


def encode_flops(cfg: dict, size: int, frames: int = 1,
                 train: bool = False) -> int:
    """Model FLOPs of encoding `frames` images of size^2 (the image
    filter and the shared triplane filter over the three views)."""
    p = {n: torch.empty(s, device="meta") for n, s in RS.param_spec(cfg)}
    images = torch.empty(frames, size, size, 8, device="meta")
    flops = [0]
    with RS.count(flops):
        RS.encode(p, cfg, images, train=train)
    return flops[0]


def head_flops(cfg: dict, head: str) -> int:
    """Model FLOPs of one decoder head at one point."""
    fs, hd = RS.feature_size(cfg), cfg["hidden_dim"]
    out = dict(RS.HEAD_OUT, parts=cfg["num_parts"])[head]
    return 2 * (fs * hd + 2 * hd * hd + hd * out)


def train_step_flops(cfg: dict, batch: int, points: int, size: int) -> int:
    """Model FLOPs of one training step: the forward (every stack kept,
    every head queried at every point of every stack) and a backward of
    twice its FLOPs."""
    heads = sum(head_flops(cfg, h) for h in RS.HEADS)
    fwd = (encode_flops(cfg, size, batch, train=True)
           + cfg["num_stack"] * batch * points * heads)
    return 3 * fwd


def bound(ops: float, nbytes: float) -> dict:
    """The least time the card could take: operations over the float32
    rate or bytes over the memory rate, whichever is larger."""
    t_ops, t_bytes = ops / FP32_OPS * 1e3, nbytes / HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def compatible_pairs(labels_x, labels_y, y_valid) -> int:
    """The (x, y) pairs where y is valid and shares x's label: what K3
    searches (counted by sort and binary search)."""
    key_y = torch.where(y_valid, labels_y.long(),
                        torch.iinfo(torch.int64).max)
    key_y = torch.sort(key_y, dim=1).values
    lx = labels_x.long().contiguous()
    return int((torch.searchsorted(key_y, lx, right=True)
                - torch.searchsorted(key_y, lx)).sum())


def k1_need(tested: int, walked: int, nbytes: int) -> dict:
    """K1's bound over the work its inputs need: one skip test of every
    (face, 8 x 16 tile) of a live cell, the walk of the pairs it keeps."""
    return bound(tested * K1_OPS_PER_TILE_TEST
                 + walked * K1_OPS_PER_TILE_WALK, nbytes)


def k2_walk_share(cpl, active, m, size, chunk=16) -> dict:
    """K2's work on these inputs: its (face, row, 16-column chunk)
    triples of live cells (each takes the bound test), the (pixel, face)
    pairs of those whose test keeps them, and the share of (32-face warp,
    row, chunk) triples where any face's test keeps it."""
    B, Fp, _ = cpl.shape
    xblk = RK.xblk(size)
    n_x, n_fblk = size // xblk, Fp // RK.FBLK
    live = active.reshape(B, size // RK.RBLK, n_x, n_fblk) != 0
    col = torch.arange(size, dtype=torch.float32, device=cpl.device)
    coord = RK.fma32(col, torch.full_like(col, 2.0 / (size - 1)),
                     torch.full_like(col, -1.0))
    starts = list(range(0, xblk, chunk))
    ends = [min(s + chunk, xblk) for s in starts]
    first = torch.tensor(starts, device=cpl.device)
    last = torch.tensor(ends, device=cpl.device) - 1
    width = last - first + 1
    faces = warps = walked = walked_px = walked_warps = 0
    for b in range(B):
        a, bb, c = (cpl[b, :, k::3][:, None, None, :] for k in range(3))
        for r in range(size // RK.RBLK):
            if not bool(live[b, r].any()):
                continue
            py = coord[r * RK.RBLK:(r + 1) * RK.RBLK][None, :, None, None]
            inner = RK.fma32(bb, py, c)
            for x in range(n_x):
                cells = live[b, r, x].repeat_interleave(RK.FBLK)
                if not bool(cells.any()):
                    continue
                px0, px1 = (coord[x * xblk + i][None, None, :, None]
                            for i in (first, last))
                test = torch.maximum(RK.fma32(a, px0, inner),
                                     RK.fma32(a, px1, inner)).amin(-1)
                mrow = m[b, r * RK.RBLK:(r + 1) * RK.RBLK,
                         x * xblk:(x + 1) * xblk]
                mmin = torch.stack([mrow[:, s:e].amin(1)
                                    for s, e in zip(starts, ends)], 1)
                walk = (test >= mmin) & cells[:, None, None]
                faces += int(cells.sum()) * RK.RBLK * len(starts)
                walked += int(walk.sum())
                walked_px += int((walk * width).sum())
                warps += int(cells.sum()) // 32 * RK.RBLK * len(starts)
                walked_warps += int(walk.reshape(Fp // 32, 32, RK.RBLK, -1)
                                    .any(1).sum())
    return {"triples": faces, "walked": walked,
            "walked_pixel_faces": walked_px,
            "share": walked / max(faces, 1),
            "warp_share": walked_warps / max(warps, 1)}
