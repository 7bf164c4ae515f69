"""Stacked-hourglass image encoder (NCHW nn.Modules).

Port of vistracker_tpu/models/hourglass.py with the reference's module
names (conv1, bn1, conv2..4, m{i}.b1_{l}/b2_{l}/b2_plus_1/b3_{l},
top_m_{i}, conv_last{i}, bn_end{i}, l{i}, bl{i}, al{i}; ConvBlock
conv1..3, bn1..4, downsample = (bn4, ReLU, 1x1 conv)), so a released
state_dict loads with load_state_dict. GroupNorm(32), eps 1e-5.
`HGConfig.gconv` gives the reference's HGFilterGConv variant
(HGFilters.py:205-331): the stack-coupling 1x1 convs l{i}, bl{i} and
al{i} are grouped, groups = the hourglass width (256), which needs
hourglass_dim to be a multiple of it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import avg_pool2x, upsample2x_bicubic


HG_FEATURES = 256  # internal hourglass width
NORM_GROUPS = 32


@dataclasses.dataclass(frozen=True)
class HGConfig:
    input_channels: int = 5
    num_stack: int = 3
    num_hourglass: int = 2
    hourglass_dim: int = 256
    tmpx_dim: int = 64
    gconv: bool = False   # grouped stack-coupling convs (HGFilterGConv)


def _norm(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(NORM_GROUPS, ch, eps=1e-5)


class ConvBlock(nn.Module):
    """Residual dense-concat block: three pre-activated 3x3 convs whose
    outputs (half, quarter, quarter of out_planes) are concatenated."""

    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        half, quarter = out_planes // 2, out_planes // 4
        self.conv1 = nn.Conv2d(in_planes, half, 3, padding=1, bias=False)
        self.bn1 = _norm(in_planes)
        self.conv2 = nn.Conv2d(half, quarter, 3, padding=1, bias=False)
        self.bn2 = _norm(half)
        self.conv3 = nn.Conv2d(quarter, quarter, 3, padding=1, bias=False)
        self.bn3 = _norm(quarter)
        if in_planes != out_planes:
            self.bn4 = _norm(in_planes)
            self.downsample = nn.Sequential(
                self.bn4, nn.ReLU(),
                nn.Conv2d(in_planes, out_planes, 1, bias=False))
        else:
            self.downsample = None

    def forward(self, x):
        out1 = self.conv1(F.relu(self.bn1(x)))
        out2 = self.conv2(F.relu(self.bn2(out1)))
        out3 = self.conv3(F.relu(self.bn3(out2)))
        out = torch.cat([out1, out2, out3], 1)
        residual = x if self.downsample is None else self.downsample(x)
        return out + residual


class HourGlass(nn.Module):
    """Recursive hourglass: upper branch one ConvBlock; lower branch
    avg-pool 2x -> recurse -> bicubic 2x upsample; branches sum."""

    def __init__(self, depth: int, features: int):
        super().__init__()
        self.depth = depth
        for level in range(depth, 0, -1):
            for name in (f"b1_{level}", f"b2_{level}", f"b3_{level}"):
                self.add_module(name, ConvBlock(features, features))
            if level == 1:
                self.add_module("b2_plus_1",
                                ConvBlock(features, features))

    def _forward(self, level: int, inp):
        up1 = getattr(self, f"b1_{level}")(inp)
        low1 = getattr(self, f"b2_{level}")(avg_pool2x(inp))
        low2 = (self._forward(level - 1, low1) if level > 1
                else self.b2_plus_1(low1))
        low3 = getattr(self, f"b3_{level}")(low2)
        return up1 + upsample2x_bicubic(low3)

    def forward(self, x):
        return self._forward(self.depth, x)


class HGFilter(nn.Module):
    """Stacked hourglass encoder: (B, C, H, W) -> (per-stack list of
    (B, hourglass_dim, H/4, W/4), tmpx (B, tmpx_dim, H/2, W/2), normx)."""

    def __init__(self, cfg: HGConfig = HGConfig()):
        super().__init__()
        c = self.cfg = cfg
        hf = HG_FEATURES
        groups = hf if c.gconv else 1
        if c.hourglass_dim % groups:
            raise ValueError(f"gconv needs hourglass_dim ({c.hourglass_dim}) "
                             f"to be a multiple of {hf}")
        self.conv1 = nn.Conv2d(c.input_channels, c.tmpx_dim, 7, stride=2,
                               padding=3)
        self.bn1 = _norm(c.tmpx_dim)
        self.conv2 = ConvBlock(c.tmpx_dim, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, hf)
        for i in range(c.num_stack):
            self.add_module(f"m{i}", HourGlass(c.num_hourglass, hf))
            self.add_module(f"top_m_{i}", ConvBlock(hf, hf))
            self.add_module(f"conv_last{i}", nn.Conv2d(hf, hf, 1))
            self.add_module(f"bn_end{i}", _norm(hf))
            self.add_module(f"l{i}", nn.Conv2d(hf, c.hourglass_dim, 1,
                                               groups=groups))
            if i < c.num_stack - 1:
                self.add_module(f"bl{i}", nn.Conv2d(hf, hf, 1, groups=groups))
                self.add_module(f"al{i}", nn.Conv2d(c.hourglass_dim, hf, 1,
                                                    groups=groups))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        tmpx = x
        x = avg_pool2x(self.conv2(x))
        normx = x
        x = self.conv4(self.conv3(x))
        previous, outputs = x, []
        for i in range(self.cfg.num_stack):
            ll = getattr(self, f"top_m_{i}")(getattr(self, f"m{i}")(previous))
            ll = F.relu(getattr(self, f"bn_end{i}")(
                getattr(self, f"conv_last{i}")(ll)))
            tmp_out = getattr(self, f"l{i}")(ll)
            outputs.append(tmp_out)
            if i < self.cfg.num_stack - 1:
                previous = (previous + getattr(self, f"bl{i}")(ll)
                            + getattr(self, f"al{i}")(tmp_out))
        return outputs, tmpx, normx
