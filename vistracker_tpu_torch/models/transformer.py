"""Transformer encoder (DeciWatch-style) for motion infilling.

Port of vistracker_tpu/models/transformer.py, batch-major (B, T, D), with
the reference's torch parameter names (encoder.layers.{i}.self_attn.
in_proj_weight / in_proj_bias / out_proj, linear1, linear2, norm1, norm2,
encoder.norm). Two quirks that checkpoint parity depends on are kept:

  1. Encoder layers are ALWAYS pre-norm; the `final_norm` flag (the
     reference's pre_norm constructor argument) only decides whether a
     final LayerNorm is appended. The release infiller sets it False:
     pre-norm layers, no final norm.
  2. The sine positional embedding uses dim_t = T^(2 i / npf) for i in
     0..npf-1 (no pairing), sin on even and cos on odd feature indices,
     positions normalized by the LAST position of the clip it is given
     and scaled to [0, 2 pi] -- so a truncated clip sees other codes than
     a padded one.

LayerNorm uses eps 1e-6 and GELU its tanh form, as the JAX package's
modules do.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


def sine_position_embedding(length: int, dim: int,
                            temperature: float = 10000.0,
                            scale: float = 2.0 * np.pi) -> np.ndarray:
    """(length, dim) positional embedding with the reference's formula."""
    npf = dim // 2
    pos = np.arange(length, dtype=np.float32)
    pos = pos / (pos[-1] + 1e-6) * scale
    dim_t = temperature ** (2.0 * np.arange(npf, dtype=np.float32) / npf)
    ang = pos[:, None] / dim_t[None, :]
    pe = np.zeros((length, dim), np.float32)
    if 2 * npf != dim:  # odd dim: the last channel is unused by sin
        pe[:, :-1][:, 0::2] = np.sin(ang)
    else:
        pe[:, 0::2] = np.sin(ang)
    pe[:, 1::2] = np.cos(ang)
    return pe


def _activation(name: str):
    return {"relu": F.relu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
            "glu": F.glu}[name]


class MultiheadSelfAttention(nn.Module):
    """Self-attention with torch.nn.MultiheadAttention's parameters
    (packed in_proj). q and k carry the positional code, v does not.
    key_padding_mask (B, T) bool, True = masked out; a row whose keys are
    all masked attends to nothing (zeros)."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        self.dropout = nn.Dropout(dropout)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q, k, v, key_padding_mask=None):
        B, T, D = q.shape
        H = self.num_heads
        hd = D // H
        w, b = self.in_proj_weight, self.in_proj_bias

        def proj(x, i):
            y = F.linear(x, w[i * D:(i + 1) * D], b[i * D:(i + 1) * D])
            return y.reshape(B, T, H, hd).transpose(1, 2)   # (B, H, T, hd)

        qh, kh, vh = proj(q, 0), proj(k, 1), proj(v, 2)
        logits = qh @ kh.transpose(-1, -2) / math.sqrt(hd)
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                        float("-inf"))
        attn = torch.nan_to_num(torch.softmax(logits, dim=-1))
        out = self.dropout(attn) @ vh
        return self.out_proj(out.transpose(1, 2).reshape(B, T, D))


class EncoderLayer(nn.Module):
    """Pre-norm transformer encoder layer."""

    def __init__(self, d_model: int, num_heads: int,
                 dim_feedforward: int = 256, dropout: float = 0.1,
                 activation: str = "leaky_relu"):
        super().__init__()
        self.self_attn = MultiheadSelfAttention(d_model, num_heads, dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = nn.Dropout(dropout)
        self.act = _activation(activation)

    def forward(self, src, pos, key_padding_mask=None):
        src2 = self.norm1(src)
        qk = src2 if pos is None else src2 + pos
        src = src + self.dropout(self.self_attn(qk, qk, src2,
                                                key_padding_mask))
        src2 = self.norm2(src)
        ff = self.linear2(self.dropout(self.act(self.linear1(src2))))
        return src + self.dropout(ff)


class _Encoder(nn.Module):
    def __init__(self, layers, norm):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = norm


class TransformerV2(nn.Module):
    """Stack of pre-norm encoder layers + the sine positional embedding
    of the clip's own length; a final LayerNorm only with final_norm."""

    def __init__(self, num_layers: int, d_model: int, num_heads: int,
                 dim_feedforward: int = 256, dropout: float = 0.1,
                 final_norm: bool = True, activation: str = "leaky_relu"):
        super().__init__()
        self.encoder = _Encoder(
            [EncoderLayer(d_model, num_heads, dim_feedforward, dropout,
                          activation) for _ in range(num_layers)],
            nn.LayerNorm(d_model, eps=LN_EPS) if final_norm else None)

    def forward(self, x, key_padding_mask=None):
        """x (B, T, D); key_padding_mask (B, T) bool, True = pad/occluded."""
        pos = torch.as_tensor(
            sine_position_embedding(x.shape[1], x.shape[2]),
            device=x.device)[None]
        for layer in self.encoder.layers:
            x = layer(x, pos, key_padding_mask)
        if self.encoder.norm is not None:
            x = self.encoder.norm(x)
        return x
