"""SmoothNet temporal smoothing networks.

Port of vistracker_tpu/models/smoothnet.py with the reference's torch
parameter names (encoder.0, res_blocks.{i}.linear1/linear2, decoder;
pose_net / trans_net for the SMPL variant), so a released checkpoint
loads with load_state_dict. A window MLP over the TIME axis of (N, C, T)
windows: LeakyReLU(0.1) encoder, residual blocks with LeakyReLU(0.2) and
dropout, linear decoder. Release sizes: window 64, hidden 512, residual
hidden 16, one block.
"""
from __future__ import annotations

import torch
from torch import nn


class SmoothNetResBlock(nn.Module):
    def __init__(self, in_channels: int, hidden_channels: int,
                 dropout: float = 0.5):
        super().__init__()
        self.linear1 = nn.Linear(in_channels, hidden_channels)
        self.linear2 = nn.Linear(hidden_channels, in_channels)
        self.lrelu = nn.LeakyReLU(0.2)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        y = self.lrelu(self.dropout(self.linear1(x)))
        y = self.lrelu(self.dropout(self.linear2(y)))
        return y + x


class SmoothNet(nn.Module):
    """Input and output (N, C, T): each channel's T-window goes through
    the same MLP over the time axis."""

    def __init__(self, window_size: int = 64, output_size: int = 64,
                 hidden_size: int = 512, res_hidden_size: int = 16,
                 num_blocks: int = 1, dropout: float = 0.5):
        super().__init__()
        self.window_size = window_size
        self.encoder = nn.Sequential(nn.Linear(window_size, hidden_size),
                                     nn.LeakyReLU(0.1))
        self.res_blocks = nn.Sequential(*[
            SmoothNetResBlock(hidden_size, res_hidden_size, dropout)
            for _ in range(num_blocks)])
        self.decoder = nn.Linear(hidden_size, output_size)

    def forward(self, x):
        if x.shape[-1] != self.window_size:
            raise ValueError(f"window mismatch: {x.shape[-1]} != "
                             f"{self.window_size}")
        return self.decoder(self.res_blocks(self.encoder(x)))


class SmoothNetSMPL(nn.Module):
    """Two SmoothNets: rot6d pose (144 channels) and translation (3); the
    betas (10) pass through. Input (N, 157, T)."""

    def __init__(self, **kw):
        super().__init__()
        self.pose_net = SmoothNet(**kw)
        self.trans_net = SmoothNet(**kw)

    def forward(self, x):
        if x.shape[1] != 157:
            raise ValueError(f"invalid input shape: {tuple(x.shape)}")
        return torch.cat([self.pose_net(x[:, :144]), x[:, 144:154],
                          self.trans_net(x[:, 154:])], dim=1)
