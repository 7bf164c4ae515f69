"""Plain PyTorch reference of SIF-Net (chore-triplane-vis): its
parameters, encode, query, training loss and an Adam step, written as
functions over a dict of tensors named as the reference's checkpoints
name them (image_filter.*, triplane_encoder.*, df.*, part_predictor.*,
pca_predictor.*, center_predictor.*, visib_predictor.*).

It follows the published network (CHORE's stacked-hourglass filter,
PIFu's pixel-aligned query, VisTracker's triplane and visibility heads)
with torch's own operators: F.conv2d, F.group_norm, F.avg_pool2d,
bicubic F.interpolate, F.grid_sample (bilinear, zero padding,
align_corners=True) and F.linear. It imports nothing of the port, and it
is the yardstick that decides `correct`: a change that claims a speed-up
may not edit this file.

`count(flops)` makes every convolution and linear layer add its
multiply-adds x 2 to `flops[0]`; run on the meta device it counts a
forward pass without computing it (portbench/counters.py).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from .kernels import tf32

HG_FEATURES = 256
NORM_GROUPS = 32
LOSS_WEIGHTS = (1.0, 1.0, 0.006, 500.0, 1000.0, 1000.0)
HEADS = ("df", "parts", "pca", "centers", "vis")
HEAD_MODULES = {"df": "df", "parts": "part_predictor", "pca": "pca_predictor",
                "centers": "center_predictor", "vis": "visib_predictor"}
HEAD_OUT = {"df": 2, "pca": 9, "centers": 3, "vis": 1}

# Kinect Azure colour camera, normalised by the image width (2048)
KINECT = dict(fx=979.7844 / 2048.0, fy=979.840 / 2048.0,
              cx=1018.952 / 2048.0, cy=779.486 / 2048.0, width=2048)

_COUNT: list | None = None
_LOWER = False


@contextlib.contextmanager
def count(flops: list):
    global _COUNT
    _COUNT = flops
    try:
        yield
    finally:
        _COUNT = None


@contextlib.contextmanager
def lowered():
    """Every convolution and linear layer computed in TF32 (the
    controls): operands rounded to TF32's 10-bit mantissa, sums in
    float32; gradients pass the rounding unchanged. On a card cuDNN and
    cuBLAS are also let run TF32 (allow_tf32), so that the backward pass
    runs in TF32 too."""
    global _LOWER
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    _LOWER = True
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        _LOWER = False
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _round(x):
    return x + (tf32(x.detach()) - x).detach()


def low(x):
    """x as an operand of a matrix product: rounded to TF32 under
    lowered(), else x."""
    return _round(x) if _LOWER else x


def _conv(x, w, b=None, stride=1, padding=0):
    if _LOWER:
        x, w = _round(x), _round(w)
    y = F.conv2d(x, w, b, stride=stride, padding=padding)
    if _COUNT is not None:
        _COUNT[0] += 2 * y.numel() * w[0].numel()
    return y


def _linear(x, w, b):
    if _LOWER:
        x, w = _round(x), _round(w)
    y = F.linear(x, w, b)
    if _COUNT is not None:
        _COUNT[0] += 2 * y.numel() * w.shape[1]
    return y


# ------------------------------------------------------------ parameters

def _block_spec(pre, cin, cout):
    half, quarter = cout // 2, cout // 4
    out = [(pre + "conv1.weight", (half, cin, 3, 3)),
           (pre + "bn1.weight", (cin,)), (pre + "bn1.bias", (cin,)),
           (pre + "conv2.weight", (quarter, half, 3, 3)),
           (pre + "bn2.weight", (half,)), (pre + "bn2.bias", (half,)),
           (pre + "conv3.weight", (quarter, quarter, 3, 3)),
           (pre + "bn3.weight", (quarter,)), (pre + "bn3.bias", (quarter,))]
    if cin != cout:
        out += [(pre + "bn4.weight", (cin,)), (pre + "bn4.bias", (cin,)),
                (pre + "downsample.2.weight", (cout, cin, 1, 1))]
    return out


def _filter_spec(pre, cin, stacks, depth, dim, tmpx):
    hf = HG_FEATURES
    out = [(pre + "conv1.weight", (tmpx, cin, 7, 7)),
           (pre + "conv1.bias", (tmpx,)),
           (pre + "bn1.weight", (tmpx,)), (pre + "bn1.bias", (tmpx,))]
    out += _block_spec(pre + "conv2.", tmpx, 128)
    out += _block_spec(pre + "conv3.", 128, 128)
    out += _block_spec(pre + "conv4.", 128, hf)
    for i in range(stacks):
        for level in range(depth, 0, -1):
            for name in (f"b1_{level}", f"b2_{level}", f"b3_{level}"):
                out += _block_spec(f"{pre}m{i}.{name}.", hf, hf)
            if level == 1:
                out += _block_spec(f"{pre}m{i}.b2_plus_1.", hf, hf)
        out += _block_spec(f"{pre}top_m_{i}.", hf, hf)
        out += [(f"{pre}conv_last{i}.weight", (hf, hf, 1, 1)),
                (f"{pre}conv_last{i}.bias", (hf,)),
                (f"{pre}bn_end{i}.weight", (hf,)),
                (f"{pre}bn_end{i}.bias", (hf,)),
                (f"{pre}l{i}.weight", (dim, hf, 1, 1)),
                (f"{pre}l{i}.bias", (dim,))]
        if i < stacks - 1:
            out += [(f"{pre}bl{i}.weight", (hf, hf, 1, 1)),
                    (f"{pre}bl{i}.bias", (hf,)),
                    (f"{pre}al{i}.weight", (hf, dim, 1, 1)),
                    (f"{pre}al{i}.bias", (hf,))]
    return out


def feature_size(cfg) -> int:
    return (cfg["hourglass_dim"] + 3 + cfg["tmpx_dim"]
            + 3 * (cfg["triplane_hg_dim"] + cfg["triplane_tmpx_dim"]))


def param_spec(cfg) -> list:
    """[(name, shape)] of every parameter, in a fixed order."""
    out = _filter_spec("image_filter.", cfg["input_channels"],
                       cfg["num_stack"], cfg["num_hourglass"],
                       cfg["hourglass_dim"], cfg["tmpx_dim"])
    out += _filter_spec("triplane_encoder.", 1, cfg["triplane_stack"],
                        cfg["num_hourglass"], cfg["triplane_hg_dim"],
                        cfg["triplane_tmpx_dim"])
    fs, hd = feature_size(cfg), cfg["hidden_dim"]
    outs = dict(HEAD_OUT, parts=cfg["num_parts"])
    for head in HEADS:
        mod = HEAD_MODULES[head]
        dims = [fs, hd, hd, hd, outs[head]]
        for k in range(4):
            out += [(f"{mod}.{2 * k}.weight", (dims[k + 1], dims[k], 1)),
                    (f"{mod}.{2 * k}.bias", (dims[k + 1],))]
    return out


def aliases(names) -> dict:
    """A ConvBlock's bn4 is also its downsample.0: the checkpoint holds
    both names for one tensor. -> {alias: name}."""
    return {n.replace(".bn4.", ".downsample.0."): n for n in names
            if ".bn4." in n}


# --------------------------------------------------------------- forward

def _gn(p, pre, x):
    return F.group_norm(x, NORM_GROUPS, p[pre + "weight"], p[pre + "bias"],
                        eps=1e-5)


def _block(p, pre, x):
    out1 = _conv(F.relu(_gn(p, pre + "bn1.", x)), p[pre + "conv1.weight"],
                 padding=1)
    out2 = _conv(F.relu(_gn(p, pre + "bn2.", out1)), p[pre + "conv2.weight"],
                 padding=1)
    out3 = _conv(F.relu(_gn(p, pre + "bn3.", out2)), p[pre + "conv3.weight"],
                 padding=1)
    out = torch.cat([out1, out2, out3], 1)
    if pre + "downsample.2.weight" in p:
        x = _conv(F.relu(_gn(p, pre + "bn4.", x)),
                  p[pre + "downsample.2.weight"])
    return out + x


def _hourglass(p, pre, level, x):
    up1 = _block(p, f"{pre}b1_{level}.", x)
    low1 = _block(p, f"{pre}b2_{level}.", F.avg_pool2d(x, 2, stride=2))
    low2 = (_hourglass(p, pre, level - 1, low1) if level > 1
            else _block(p, f"{pre}b2_plus_1.", low1))
    low3 = _block(p, f"{pre}b3_{level}.", low2)
    return up1 + F.interpolate(low3, scale_factor=2, mode="bicubic",
                               align_corners=True)


def _filter(p, pre, stacks, depth, x):
    x = F.relu(_gn(p, pre + "bn1.", _conv(x, p[pre + "conv1.weight"],
                                          p[pre + "conv1.bias"], stride=2,
                                          padding=3)))
    tmpx = x
    x = F.avg_pool2d(_block(p, pre + "conv2.", x), 2, stride=2)
    x = _block(p, pre + "conv4.", _block(p, pre + "conv3.", x))
    previous, outputs = x, []
    for i in range(stacks):
        ll = _block(p, f"{pre}top_m_{i}.",
                    _hourglass(p, f"{pre}m{i}.", depth, previous))
        ll = F.relu(_gn(p, f"{pre}bn_end{i}.",
                        _conv(ll, p[f"{pre}conv_last{i}.weight"],
                              p[f"{pre}conv_last{i}.bias"])))
        out = _conv(ll, p[f"{pre}l{i}.weight"], p[f"{pre}l{i}.bias"])
        outputs.append(out)
        if i < stacks - 1:
            previous = (previous + _conv(ll, p[f"{pre}bl{i}.weight"],
                                         p[f"{pre}bl{i}.bias"])
                        + _conv(out, p[f"{pre}al{i}.weight"],
                                p[f"{pre}al{i}.bias"]))
    return outputs, tmpx


def encode(p, cfg, images, train=False) -> dict:
    """images (B, H, W, 8) -> cache of NCHW maps: rgb (per stack), tmpx
    (detached), tp (per view, per stack), tp_tmpx (per view, detached);
    every stack with train=True, else the last."""
    nchw = images.permute(0, 3, 1, 2)
    B = nchw.shape[0]
    rgb, tmpx = _filter(p, "image_filter.", cfg["num_stack"],
                        cfg["num_hourglass"], nchw[:, :5])
    planes = nchw[:, 5:8].transpose(0, 1).reshape(3 * B, 1, *nchw.shape[2:])
    tp, ttmp = _filter(p, "triplane_encoder.", cfg["triplane_stack"],
                       cfg["num_hourglass"], planes)
    keep = slice(None) if train else slice(-1, None)
    return dict(rgb=rgb[keep], tmpx=tmpx.detach(),
                tp=[[f[v * B:(v + 1) * B] for f in tp[keep]]
                    for v in range(3)],
                tp_tmpx=[ttmp[v * B:(v + 1) * B].detach() for v in range(3)])


def project_crop(cfg, points, crop_center):
    """Camera points (B, N, 3) -> crop-normalised x, y (B, N, 2)."""
    c, w, crop = KINECT, KINECT["width"], cfg["crop_size"]
    z = points[..., 2:3]
    px = c["fx"] * w * points[..., 0:1] / z + c["cx"] * w
    py = c["fy"] * w * points[..., 1:2] / z + c["cy"] * w
    pix = torch.cat([px, py], -1)
    return 2.0 * (crop / 2.0 + pix - crop_center[:, None, :]) / crop - 1.0


def triplane_uv(points, body_center):
    """(B, N, 3) -> right (z, y), back (-x, y), top (x, -z) after
    centring, (B, 3, N, 2)."""
    c = points - body_center[:, None, :]
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    return torch.stack([torch.stack([z, y], -1), torch.stack([-x, y], -1),
                        torch.stack([x, -z], -1)], 1)


def _sample(feat, uv):
    """feat (B, C, H, W), uv (B, N, 2) in [-1, 1] -> (B, N, C)."""
    out = F.grid_sample(feat, uv[:, :, None, :], mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[..., 0].transpose(1, 2)


def _head(p, mod, x):
    for k in range(4):
        x = _linear(x, p[f"{mod}.{2 * k}.weight"][..., 0],
                    p[f"{mod}.{2 * k}.bias"])
        if k < 3:
            x = F.relu(x)
    return torch.sigmoid(x) if mod == "visib_predictor" else x


def query(p, cfg, cache, points, crop_center, body_center,
          heads=HEADS) -> list:
    """Every cached stack at points (B, N, 3) -> [{head: (B, N, D)}],
    df = out_dist outside the crop; pca as (B, N, 3, 3)."""
    xy = project_crop(cfg, points, crop_center)
    inside = ((xy[..., 0] >= -1) & (xy[..., 0] <= 1)
              & (xy[..., 1] >= -1) & (xy[..., 1] <= 1))[..., None]
    z = torch.cat([points[..., 0:2], points[..., 2:3] - cfg["z0"]], -1)
    uv = triplane_uv(points, body_center)
    base = [_sample(cache["tmpx"], xy)] \
        + [_sample(cache["tp_tmpx"][v], uv[:, v]) for v in range(3)]
    out = []
    for s, rgb in enumerate(cache["rgb"]):
        t = min(s, len(cache["tp"][0]) - 1)
        feat = torch.cat([_sample(rgb, xy), z, base[0], *base[1:]]
                         + [_sample(cache["tp"][v][t], uv[:, v])
                            for v in range(3)], -1)
        preds = {h: _head(p, HEAD_MODULES[h], feat) for h in heads}
        if "df" in preds:
            preds["df"] = torch.where(inside, preds["df"],
                                      torch.full_like(preds["df"],
                                                      cfg["out_dist"]))
        if "pca" in preds:
            preds["pca"] = preds["pca"].reshape(*preds["pca"].shape[:-1],
                                                3, 3)
        out.append(preds)
    return out


def losses(preds_list, gt, weights=LOSS_WEIGHTS, max_dist=0.1):
    """(total, terms) of the vis variant's training loss, averaged over
    stacks: L1 of the clamped distances summed over points, part cross
    entropy, and masked squared errors of the PCA axes, the object centre
    and the visibility (means over all elements)."""
    w = weights
    names = ("df_h", "df_o", "parts", "pca", "ocenter", "vis")
    terms = dict.fromkeys(names, 0.0)
    total = 0.0
    n = len(preds_list)
    mask = (gt["df_o"] < 0.05).to(gt["df_o"].dtype)
    for pr in preds_list:
        vals = (
            (pr["df"][..., 0].clamp(max=max_dist)
             - gt["df_h"].clamp(max=max_dist)).abs().sum(-1).mean() * w[0],
            (pr["df"][..., 1].clamp(max=max_dist)
             - gt["df_o"].clamp(max=max_dist)).abs().sum(-1).mean() * w[1],
            (-torch.gather(F.log_softmax(pr["parts"], -1), -1,
                           gt["parts"].long()[..., None])[..., 0]
             * w[2]).sum(-1).mean(),
            ((pr["pca"] - gt["pca"]) ** 2
             * mask[..., None, None]).mean() * w[3],
            ((pr["centers"] - gt["obj_center"][:, None, :]) ** 2
             * mask[..., None]).mean() * w[4],
            ((pr["vis"][..., 0] - gt["visibility"]) ** 2 * mask).mean()
            * w[5])
        total = total + sum(vals)
        for k, v in zip(names, vals):
            terms[k] = terms[k] + v / n
    return total / n, terms


def training_loss(p, cfg, batch):
    cache = encode(p, cfg, batch["images"], train=True)
    preds = query(p, cfg, cache, batch["points"], batch["crop_center"],
                  batch["body_center"])
    return losses(preds, batch)


class Adam:
    """Adam with betas (0.9, 0.999), eps 1e-8 outside the root, a bias
    correction per step, over a dict of leaves."""

    def __init__(self, params: dict, lr: float):
        self.p, self.lr, self.t = params, lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, grads: dict):
        self.t += 1
        b1, b2 = 0.9, 0.999
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        with torch.no_grad():
            for k, g in grads.items():
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = self.v[k].sqrt() / math.sqrt(c2) + 1e-8
                self.p[k].addcdiv_(self.m[k], denom, value=-self.lr / c1)
