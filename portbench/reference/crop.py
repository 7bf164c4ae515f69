"""Plain reference of the network's host input: BEHAVE's square crop
around the centre of the person and object masks' joint box (zero
outside the frame; the frame's last row and column count as outside,
as the published crop clamps its far corner to size - 1), resized to the
network's size by PIL's antialiased bilinear filter (a triangle whose
support grows with the shrink factor), and composed into RGB masked by
the two masks' union, then both masks. The resize runs as two matrix
products in float64; the control runs them in bfloat16.

It imports nothing of the port, and it is the yardstick that decides
`correct`: a change that claims a speed-up may not edit this file.
"""
from __future__ import annotations

import numpy as np
import torch

TIE = 1e-4  # a resized mask this near 0.5 leaves the union undecided


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) rows of PIL's bilinear resampling weights."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    w = np.zeros((n_out, n_in))
    for i in range(n_out):
        c = (i + 0.5) * scale
        lo = max(int(c - support + 0.5), 0)
        hi = min(int(c + support + 0.5), n_in)
        x = np.arange(lo, hi)
        row = np.maximum(0.0, 1.0 - np.abs((x - c + 0.5) / support))
        w[i, lo:hi] = row / row.sum()
    return w


def _window(img: np.ndarray, topleft, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    ys = np.arange(topleft[1], topleft[1] + size)
    xs = np.arange(topleft[0], topleft[0] + size)
    vy, vx = (ys >= 0) & (ys <= h - 2), (xs >= 0) & (xs <= w - 2)
    out = np.zeros((size, size) + img.shape[2:])
    out[np.ix_(vy, vx)] = img[np.ix_(ys[vy], xs[vx])]
    return out


def input_crop(rgb, person, obj, crop: int, net: int, device="cpu",
               control: bool = False) -> tuple:
    """One frame -> ((net, net, 5) float64 input, (net, net) bool: the
    pixels whose union is a tie, crop centre (x, y))."""
    pm = np.asarray(person, np.float64) * (255.0 if person.dtype == bool
                                           else 1.0)
    om = np.asarray(obj, np.float64) * (255.0 if obj.dtype == bool else 1.0)
    ys, xs = np.nonzero((pm > 0.5) | (om > 0.5))
    if len(xs):
        lo, hi = np.array([xs.min(), ys.min()]), np.array([xs.max(),
                                                           ys.max()])
    else:
        lo, hi = np.array([0, 0]), np.array([pm.shape[1] - 1,
                                             pm.shape[0] - 1])
    centre = (lo + hi) // 2
    topleft = np.round(centre - crop / 2).astype(int)
    size = int(np.round(centre + crop / 2).astype(int)[0] - topleft[0])
    stack = np.concatenate([_window(np.asarray(rgb, np.float64), topleft,
                                    size),
                            _window(pm, topleft, size)[..., None],
                            _window(om, topleft, size)[..., None]], -1)
    dt = torch.bfloat16 if control else torch.float64
    wt = torch.as_tensor(resize_weights(size, net), device=device).to(dt)
    x = torch.as_tensor(stack, device=device).to(dt).permute(2, 0, 1)
    out = (wt @ x @ wt.T).permute(1, 2, 0).double() / 255.0
    p_c, o_c = out[..., 3], out[..., 4]
    union = ((p_c > 0.5) | (o_c > 0.5)).double()
    tie = ((p_c - 0.5).abs() < TIE) | ((o_c - 0.5).abs() < TIE)
    return (torch.cat([out[..., :3] * union[..., None], out[..., 3:]], -1),
            tie, centre)


def crop_gap(got: torch.Tensor, ref: torch.Tensor, tie) -> float:
    """Largest |got - ref| over the 5 channels, the RGB ones left out
    at the union's ties."""
    d = (got[..., :5].double().cpu() - ref.cpu()).abs()
    d[..., :3] = d[..., :3].masked_fill(tie.cpu()[..., None], 0.0)
    return float(d.max())
