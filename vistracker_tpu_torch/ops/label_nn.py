"""Labelled nearest neighbour through kernel K3 (the contact pairing of
the stage-6 joint phase).

Mirrors vistracker_tpu/ops/chamfer.py:label_compatible_nn (the semantics)
and vistracker_tpu/ops/pallas_nn.py:label_nn_pallas_batched (the kernel
with its saved-argmin gradient). For x (B, N, 3) and y (B, M, 3) with
integer labels and a validity flag per y point, `label_nn` returns per x
point the min squared distance to the valid y points of the same label,
1e10 where there is none.

`label_nn_fwd` is the wrapper: a CUDA tensor launches the hand-written
kernel csrc/label_nn.cu (or raises), a CPU tensor runs the plain PyTorch
version `label_nn_plain`, which spells out the kernel's arithmetic
operation by operation and is bit-equal to it. The kernel compares each
x point only with the valid y points of its own label, through a plan
(`label_nn_plan`: both clouds sorted by label, per x the range of its
label's y points; on the card a plan kernel of csrc/label_nn.cu makes
it, on the CPU its plain version `label_nn_plan_plain`) that the wrapper
makes, or that a caller whose labels and masks stay fixed over many
calls makes once and passes in. The
gradient comes from the saved argmin: dx = 2 (x - y[idx]) g, dy its
negative scattered onto y; on exact distance ties the first y point gets
all of it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

_NONE = 1e10     # distance where no compatible y point exists
_PLAIN_ROWS = 1024  # x points per block of the plain version
# the key of an invalid y point: above every label (labels must be below it)
_SENTINEL = torch.iinfo(torch.int64).max
_BUCKETS = 32  # the plan sorts an element whose labels span fewer values


def _sq_norm(v: torch.Tensor) -> torch.Tensor:
    return (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) \
        + v[..., 2] * v[..., 2]


def _check(x, labels_x, y, labels_y, y_valid):
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"label_nn takes float32 points, got {x.dtype} and "
                        f"{y.dtype}")
    if x.dim() != 3 or y.dim() != 3 or x.shape[2] != 3 or y.shape[2] != 3 \
            or x.shape[0] != y.shape[0] or 0 in x.shape or 0 in y.shape:
        raise ValueError(f"points must be (B, N, 3) and (B, M, 3), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if labels_x.shape != x.shape[:2] or labels_y.shape != y.shape[:2] \
            or y_valid.shape != y.shape[:2]:
        raise ValueError("labels and validity must be (B, N), (B, M), (B, M)")
    if labels_x.dtype.is_floating_point or labels_y.dtype.is_floating_point \
            or y_valid.dtype != torch.bool:
        raise TypeError("labels must be integers and validity bool")
    if not (x.device == y.device == labels_x.device == labels_y.device
            == y_valid.device):
        raise ValueError("all inputs must share a device")


def masked_min_plain(x, y, y_valid, labels_x=None, labels_y=None,
                     rows: int = _PLAIN_ROWS):
    """The plain version of kernels K3 (with labels) and K4 (without), on
    checked inputs: (min squared distance (B, N) float32, argmin (B, N)
    int64), `rows` x points at a time. Each operation is rounded once, in
    the kernel's order: x.y = (x0 y0 + x1 y1) + x2 y2, d = max((|x|^2 +
    |y|^2) - 2 x.y, 0); a y point counts where y_valid (and its label is
    x's); the argmin is the least index attaining the min, 0 where no y
    point counts."""
    N, M = x.shape[1], y.shape[1]
    yy = _sq_norm(y)[:, None, :]
    col = torch.arange(M, device=x.device)
    none = torch.tensor(_NONE, dtype=torch.float32, device=x.device)
    mins, idxs = [], []
    for s in range(0, N, rows):
        xc = x[:, s:s + rows]
        xy = (xc[:, :, None, 0] * y[:, None, :, 0]
              + xc[:, :, None, 1] * y[:, None, :, 1]) \
            + xc[:, :, None, 2] * y[:, None, :, 2]
        d = torch.clamp((_sq_norm(xc)[:, :, None] + yy) - 2.0 * xy, min=0.0)
        ok = y_valid[:, None, :]
        if labels_x is not None:
            ok = ok & (labels_x[:, s:s + rows, None] == labels_y[:, None, :])
        d = torch.where(ok, d, none)
        m = d.amin(-1)
        mins.append(m)
        idxs.append(torch.where(d <= m[..., None], col, M).amin(-1))
    return torch.cat(mins, 1), torch.cat(idxs, 1)


def label_nn_plain(x, labels_x, y, labels_y, y_valid):
    """Plain PyTorch K3: (min squared distance (B, N) float32, argmin
    (B, N) int64) over the valid y points of x's label (masked_min_plain)."""
    _check(x, labels_x, y, labels_y, y_valid)
    return masked_min_plain(x, y, y_valid, labels_x, labels_y)


class LabelNNPlan(NamedTuple):
    """K3's search order for one (labels_x, labels_y, y_valid), all int64:
    key_x (B, N) the x labels ascending, perm_x (B, N) the x index of each;
    key_y (B, M) the y keys ascending (the label of a valid point, the
    sentinel of an invalid one), perm_y (B, M) the y index j of each,
    ascending within a key; lo, hi (B, N): the sorted y positions [lo, hi)
    whose key is the sorted x point's label. A batch element whose labels
    (x, and valid y) span 32 values or more keeps the index order instead
    (perm the identity, keys unsorted, every [lo, hi) = [0, M)): the kernel
    then tests labels over all its pairs."""

    key_x: torch.Tensor
    perm_x: torch.Tensor
    key_y: torch.Tensor
    perm_y: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor


def label_nn_plan_plain(labels_x, labels_y, y_valid) -> LabelNNPlan:
    """Plain PyTorch plan (LabelNNPlan) from labels (B, N), (B, M) and
    validity (B, M): stable sorts and binary searches, the index order
    where an element's labels span 32 values or more; no host sync.
    Labels must lie below the invalid points' sentinel 2^63 - 1."""
    lx = labels_x.long()
    ly = torch.where(y_valid, labels_y.long(), _SENTINEL)
    int64 = torch.iinfo(torch.int64)
    low = torch.minimum(lx.amin(1), ly.amin(1))
    high = torch.maximum(lx.amax(1),
                         torch.where(y_valid, ly, int64.min).amax(1))
    span = high - low  # negative where it wraps: 2^63 or more
    narrow = ((span >= 0) & (span < _BUCKETS))[:, None]
    key_y, perm_y = torch.sort(ly, dim=1, stable=True)
    key_x, perm_x = torch.sort(lx, dim=1, stable=True)
    every = torch.zeros_like(lx)
    N, M = lx.shape[1], ly.shape[1]
    return LabelNNPlan(
        torch.where(narrow, key_x, lx),
        torch.where(narrow, perm_x, torch.arange(N, device=lx.device)),
        torch.where(narrow, key_y, ly),
        torch.where(narrow, perm_y, torch.arange(M, device=lx.device)),
        torch.where(narrow, torch.searchsorted(key_y, key_x), every),
        torch.where(narrow, torch.searchsorted(key_y, key_x, right=True),
                    every + M))


@functools.cache
def _kernel(name: str):
    """csrc/label_nn.cu's entry `name`, built and loaded at first use,
    with its ctypes signature."""
    from ..utils.cuda_build import load_library

    fn = getattr(load_library("label_nn"), name)
    n_ptr = {"vt_label_nn": 10, "vt_label_nn_plan": 9}[name]
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def label_nn_plan(labels_x, labels_y, y_valid) -> LabelNNPlan:
    """K3's search order (LabelNNPlan) from labels (B, N), (B, M) and
    validity (B, M): on the card the plan kernel of csrc/label_nn.cu makes
    it, on the CPU label_nn_plan_plain. No host sync either way."""
    if labels_x.device.type == "cpu":
        return label_nn_plan_plain(labels_x, labels_y, y_valid)
    if labels_x.device.type != "cuda":
        raise ValueError(f"label_nn_plan: unsupported device "
                         f"{labels_x.device}")
    B, N = labels_x.shape
    M = labels_y.shape[1]
    lx = labels_x.long().contiguous()
    ly = labels_y.long().contiguous()
    valid = y_valid.contiguous().view(torch.uint8)
    xs = torch.empty((4, B, N), dtype=torch.int64, device=lx.device)
    ys = torch.empty((2, B, M), dtype=torch.int64, device=lx.device)
    plan = LabelNNPlan(xs[0], xs[1], ys[0], ys[1], xs[2], xs[3])
    with torch.cuda.device(lx.device):
        err = _kernel("vt_label_nn_plan")(
            lx.data_ptr(), ly.data_ptr(), valid.data_ptr(),
            *(t.data_ptr() for t in plan), B, N, M,
            torch.cuda.current_stream(lx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"label_nn plan kernel launch failed: CUDA error "
                           f"{err}")
    return plan


def label_nn_fwd(x, labels_x, y, labels_y, y_valid,
                 plan: LabelNNPlan | None = None):
    """K3 forward -> (min (B, N) float32, argmin (B, N) int64). A CUDA
    tensor launches the hand-written kernel over `plan`, made here from
    the labels and validity when not given; a CPU tensor runs
    label_nn_plain (and ignores the plan)."""
    if x.device.type == "cpu":
        return label_nn_plain(x, labels_x, y, labels_y, y_valid)
    if x.device.type != "cuda":
        raise ValueError(f"label_nn: unsupported device {x.device}")
    _check(x, labels_x, y, labels_y, y_valid)
    if plan is None:
        plan = label_nn_plan(labels_x, labels_y, y_valid)
    B, N, _ = x.shape
    M = y.shape[1]
    for name, t in zip(plan._fields, plan):
        want = (B, M) if name in ("key_y", "perm_y") else (B, N)
        if t.dtype != torch.int64 or t.shape != want \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"label_nn plan: {name} must be contiguous "
                             f"int64 {want} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    xc, yc = x.contiguous(), y.contiguous()
    dmin = torch.empty((B, N), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, N), dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel("vt_label_nn")(
            xc.data_ptr(), yc.data_ptr(), *(t.data_ptr() for t in plan),
            dmin.data_ptr(), idx.data_ptr(), B, N, M,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"label_nn kernel launch failed: CUDA error {err}")
    label_nn_fwd.launches += 1
    return dmin, idx


label_nn_fwd.launches = 0


class _LabelNN(torch.autograd.Function):
    """min squared distance with the gradient from the saved argmin."""

    @staticmethod
    def forward(ctx, x, labels_x, y, labels_y, y_valid, plan):
        d, idx = label_nn_fwd(x.detach(), labels_x, y.detach(), labels_y,
                              y_valid, plan)
        ctx.save_for_backward(x, y, idx, d < 0.5 * _NONE)
        return d

    @staticmethod
    def backward(ctx, g):
        x, y, idx, found = ctx.saved_tensors
        need_x, need_y = ctx.needs_input_grad[0], ctx.needs_input_grad[2]
        dx = dy = None
        if need_x or need_y:
            yn = torch.gather(y, 1, idx[..., None].expand(-1, -1, 3))
            diff = 2.0 * (x - yn) * (g * found.to(g.dtype))[..., None]
            dx = diff if need_x else None
            if need_y:
                # index_put_ with accumulate sorts the indices on a GPU, so
                # the sum has one order on every run (index_add_ uses
                # atomics there)
                rows = torch.arange(y.shape[0], device=y.device)[:, None] \
                    .expand_as(idx)
                dy = torch.zeros_like(y).index_put_((rows, idx), -diff,
                                                    accumulate=True)
        return dx, None, dy, None, None, None


def label_nn(x, labels_x, y, labels_y, y_valid,
             plan: LabelNNPlan | None = None) -> torch.Tensor:
    """(B, N) min squared distance from each x point to the valid y points
    of the same label (1e10 where none), differentiable w.r.t. x and y;
    `plan` is label_nn_plan(labels_x, labels_y, y_valid), made once where
    they stay fixed over many calls."""
    return _LabelNN.apply(x, labels_x, y, labels_y, y_valid, plan)
