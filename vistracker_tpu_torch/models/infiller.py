"""Motion infiller networks (HVOP-Net and the unconditional baseline).

Port of vistracker_tpu/models/infiller.py with the reference's torch
parameter names. HVOP-Net: separate SMPL (d=128, 2 layers, 4 heads) and
object (d=32, 2 layers, 2 heads) encoders -- the object stream gets the
occlusion key-padding mask -- concatenated into a joint encoder (d=160,
4 layers, 1 head, GELU, dropout 0.05; pre-norm layers, no final norm),
then an MLP [160 -> 32 -> 6] predicting object rot6d.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .transformer import TransformerV2


@dataclasses.dataclass(frozen=True)
class InfillerConfig:
    """Hyperparameters, defaults = the release config cmf-k4-lrot."""

    dim_smpl: int = 147        # 24 joints x rot6d + 3 trans
    dim_obj: int = 6
    out_dim: int = 6
    d_model_smpl: int = 128
    num_layers_smpl: int = 2
    num_heads_smpl: int = 4
    dim_forward_smpl: int = 256
    dropout_smpl: float = 0.05
    pre_norm_smpl: bool = False
    activation_smpl: str = "gelu"
    d_model_obj: int = 32
    num_layers_obj: int = 2
    num_heads_obj: int = 2
    dim_forward_obj: int = 64
    dropout_obj: float = 0.05
    pre_norm_obj: bool = False
    activation_obj: str = "gelu"
    num_layers_joint: int = 4
    num_heads_joint: int = 1
    dim_forward_joint: int = 256
    dropout_joint: float = 0.05
    pre_norm_joint: bool = False
    activation_joint: str = "gelu"
    hidden_dims: tuple = (32,)
    clip_len: int = 180
    window: int = 30           # autoregressive context carry


def mlp_head(in_dim: int, hidden_dims: tuple, out_dim: int) -> nn.Sequential:
    """Linear + LeakyReLU(0.01) per hidden width, then a Linear: layers
    0, 2, ... of a Sequential, as in the reference."""
    layers, d = [], in_dim
    for h in hidden_dims:
        layers += [nn.Linear(d, h), nn.LeakyReLU(0.01)]
        d = h
    return nn.Sequential(*layers, nn.Linear(d, out_dim))


class ConditionalMInfiller(nn.Module):
    """HVOP-Net: object-pose infilling conditioned on SMPL motion."""

    def __init__(self, cfg: InfillerConfig = InfillerConfig()):
        super().__init__()
        c = self.cfg = cfg
        self.feat_proj_smpl = nn.Linear(c.dim_smpl, c.d_model_smpl)
        self.encoder_smpl = TransformerV2(
            c.num_layers_smpl, c.d_model_smpl, c.num_heads_smpl,
            c.dim_forward_smpl, c.dropout_smpl, c.pre_norm_smpl,
            c.activation_smpl)
        self.feat_proj_obj = nn.Linear(c.dim_obj, c.d_model_obj)
        self.encoder_obj = TransformerV2(
            c.num_layers_obj, c.d_model_obj, c.num_heads_obj,
            c.dim_forward_obj, c.dropout_obj, c.pre_norm_obj,
            c.activation_obj)
        d_joint = c.d_model_smpl + c.d_model_obj
        self.encoder_joint = TransformerV2(
            c.num_layers_joint, d_joint, c.num_heads_joint,
            c.dim_forward_joint, c.dropout_joint, c.pre_norm_joint,
            c.activation_joint)
        self.predictor = mlp_head(d_joint, c.hidden_dims, c.out_dim)

    def forward(self, data_smpl, mask_smpl, data_obj, mask_obj):
        """data_smpl (B, T, 147), data_obj (B, T, 6); masks (B, T) bool,
        True = occluded / ignored key. Returns (B, T, 6) object rot6d."""
        s = self.encoder_smpl(self.feat_proj_smpl(data_smpl), mask_smpl)
        o = self.encoder_obj(self.feat_proj_obj(data_obj), mask_obj)
        feat = self.encoder_joint(torch.cat([s, o], dim=-1), None)
        return self.predictor(feat)


class MotionInfiller(nn.Module):
    """Unconditional infiller: one encoder over the combined stream."""

    def __init__(self, input_dim: int = 153, out_dim: int = 6,
                 d_model: int = 256, num_layers: int = 4, num_heads: int = 4,
                 dim_forward: int = 512, dropout: float = 0.1,
                 pre_norm: bool = False, activation: str = "leaky_relu",
                 hidden_dims: tuple = (64,)):
        super().__init__()
        self.feat_proj = nn.Linear(input_dim, d_model)
        self.encoder = TransformerV2(num_layers, d_model, num_heads,
                                     dim_forward, dropout, pre_norm,
                                     activation)
        self.predictor = mlp_head(d_model, hidden_dims, out_dim)

    def forward(self, src, key_padding_mask):
        return self.predictor(self.encoder(self.feat_proj(src),
                                           key_padding_mask))
