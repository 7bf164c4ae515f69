"""SIF-Net: pixel-aligned implicit network with triplane conditioning and
object-visibility prediction (the release `chore-triplane-vis` model).

Port of vistracker_tpu/models/sifnet.py. `encode` returns an explicit
feature cache (channels-last maps, as in the JAX package) and the query
methods consume it, so one encode serves the many queries of the surface
harvest. Parameter names are the reference's (image_filter.*,
triplane_encoder.*, df.{0,2,4,6}, part_predictor.*, pca_predictor.*,
center_predictor.*, visib_predictor.*): a released checkpoint loads with
load_state_dict once its "module." prefixes are stripped.

Query feature layout per stack (611 features at release width):
  [rgb_hg (256) | z_feat (3) | rgb_tmpx (64) |
   triplane_tmpx right/back/top (3*32) | triplane_hg right/back/top (3*64)]
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..core.camera import PerspectiveCamera, triplane_project
from ..ops.grid_sample import grid_sample_points
from .hourglass import HGConfig, HGFilter


@dataclasses.dataclass(frozen=True)
class SIFNetConfig:
    """The chore-triplane-vis network (the other variants of the JAX
    package's config are training-only and not ported)."""

    input_channels: int = 5
    num_stack: int = 3
    num_hourglass: int = 2
    hourglass_dim: int = 256
    tmpx_dim: int = 64
    triplane_stack: int = 3
    triplane_hg_dim: int = 64
    triplane_tmpx_dim: int = 32
    num_parts: int = 14
    hidden_dim: int = 128
    z0: float = 2.2
    out_dist: float = 5.0
    crop_size: int = 1200

    @property
    def feature_size(self) -> int:
        """Width of the assembled query feature (the decoders' input)."""
        return (self.hourglass_dim + 3 + self.tmpx_dim
                + (self.triplane_hg_dim + self.triplane_tmpx_dim) * 3)


def sifnet_preset(name: str, crop_size: int = 1200) -> SIFNetConfig:
    """Named size presets (same as the JAX package): release is the
    tri-vis-l2 network; small and tiny are for fixtures and tests."""
    if name == "release":
        return SIFNetConfig(crop_size=crop_size)
    if name == "small":
        return SIFNetConfig(num_stack=2, num_hourglass=2, hourglass_dim=64,
                            tmpx_dim=32, triplane_stack=1,
                            triplane_hg_dim=64, triplane_tmpx_dim=32,
                            hidden_dim=64, crop_size=crop_size)
    if name == "tiny":
        return SIFNetConfig(num_stack=1, num_hourglass=1, hourglass_dim=32,
                            tmpx_dim=32, triplane_stack=1,
                            triplane_hg_dim=32, triplane_tmpx_dim=32,
                            hidden_dim=16, crop_size=crop_size)
    raise ValueError(f"unknown sifnet preset {name!r}")


class DecoderHead(nn.Sequential):
    """4-layer 1x1-conv MLP (Conv1d at Sequential indices 0, 2, 4, 6 with
    ReLUs between; optional sigmoid), applied to (B, N, F) point features."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int = 128,
                 sigmoid: bool = False):
        layers = [nn.Conv1d(in_dim, hidden_dim, 1), nn.ReLU(),
                  nn.Conv1d(hidden_dim, hidden_dim, 1), nn.ReLU(),
                  nn.Conv1d(hidden_dim, hidden_dim, 1), nn.ReLU(),
                  nn.Conv1d(hidden_dim, out_dim, 1)]
        if sigmoid:
            layers.append(nn.Sigmoid())
        super().__init__(*layers)

    def forward(self, x):
        for layer in self:
            if isinstance(layer, nn.Conv1d):
                x = F.linear(x, layer.weight[..., 0], layer.bias)
            else:
                x = layer(x)
        return x


def cast_cache(cache: dict, dtype) -> dict:
    """Cast every feature map of an encode() cache to dtype (bfloat16
    halves the cache and the gather bytes; the blend and the decoder
    heads stay float32)."""
    def cast(v):
        return [cast(x) for x in v] if isinstance(v, list) else v.to(dtype)
    return {k: cast(v) for k, v in cache.items()}


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class SIFNet(nn.Module):
    def __init__(self, cfg: SIFNetConfig = SIFNetConfig(),
                 camera: PerspectiveCamera = PerspectiveCamera()):
        super().__init__()
        c = self.cfg = cfg
        self.camera = camera
        self.image_filter = HGFilter(HGConfig(
            input_channels=c.input_channels, num_stack=c.num_stack,
            num_hourglass=c.num_hourglass, hourglass_dim=c.hourglass_dim,
            tmpx_dim=c.tmpx_dim))
        # one encoder shared by the three triplane views
        self.triplane_encoder = HGFilter(HGConfig(
            input_channels=1, num_stack=c.triplane_stack,
            num_hourglass=c.num_hourglass, hourglass_dim=c.triplane_hg_dim,
            tmpx_dim=c.triplane_tmpx_dim))
        fs, hd = c.feature_size, c.hidden_dim
        self.df = DecoderHead(fs, 2, hd)
        self.part_predictor = DecoderHead(fs, c.num_parts, hd)
        self.pca_predictor = DecoderHead(fs, 9, hd)
        self.center_predictor = DecoderHead(fs, 3, hd)
        self.visib_predictor = DecoderHead(fs, 1, hd, sigmoid=True)

    def _heads(self) -> dict:
        return {"df": self.df, "parts": self.part_predictor,
                "pca": self.pca_predictor, "centers": self.center_predictor,
                "vis": self.visib_predictor}

    def encode(self, images: torch.Tensor) -> dict:
        """images (B, H, W, 8) = [RGB * union mask, person mask, object
        mask, triplane right, back, top] -> inference feature cache: only
        the last stack of each encoder, every map channels-last."""
        nchw = images.permute(0, 3, 1, 2)
        rgb_feats, tmpx, _ = self.image_filter(nchw[:, :5])
        # the 3 views in one batched call: GroupNorm is per sample, so this
        # equals three separate calls
        B = images.shape[0]
        planes = nchw[:, 5:8].transpose(0, 1).reshape(3 * B, 1,
                                                      *nchw.shape[2:])
        feats, ttmp, _ = self.triplane_encoder(planes)
        return dict(
            rgb_feats=[_nhwc(rgb_feats[-1])], tmpx=_nhwc(tmpx),
            tp_feats=[[_nhwc(feats[-1][i * B:(i + 1) * B])]
                      for i in range(3)],
            tp_tmpx=[_nhwc(ttmp[i * B:(i + 1) * B]) for i in range(3)])

    def _point_features(self, cache, stack_idx, points, crop_center,
                        body_center):
        """(B, N, F) features of one stack + in-image mask (B, N)."""
        xy = self.camera.project_points(points, crop_center)[..., :2]
        in_img = ((xy[..., 0] >= -1.0) & (xy[..., 0] <= 1.0)
                  & (xy[..., 1] >= -1.0) & (xy[..., 1] <= 1.0))
        z_feat = torch.cat([points[..., 0:2], points[..., 2:3] - self.cfg.z0],
                           -1)
        tp_uv = triplane_project(points, body_center)       # (B, 3, N, 2)
        # a main stack past the triplane encoder's last reads its deepest
        tp_idx = min(stack_idx, len(cache["tp_feats"][0]) - 1)
        feats = [grid_sample_points(cache["rgb_feats"][stack_idx], xy),
                 z_feat, grid_sample_points(cache["tmpx"], xy)]
        feats += [grid_sample_points(cache["tp_tmpx"][p], tp_uv[:, p])
                  for p in range(3)]
        feats += [grid_sample_points(cache["tp_feats"][p][tp_idx],
                                     tp_uv[:, p]) for p in range(3)]
        return torch.cat(feats, -1), in_img

    def decode(self, features: torch.Tensor) -> dict:
        """(B, N, F) -> dict of heads, channels-last (B, N, D)."""
        out = {k: head(features) for k, head in self._heads().items()}
        out["pca"] = out["pca"].reshape(out["pca"].shape[:-1] + (3, 3))
        return out

    def query_df(self, cache, points, crop_center, body_center):
        """df head of the last stack, (B, N, 2), OUT_DIST outside the
        crop -- the surface-projection inner loop."""
        feat, in_img = self._point_features(cache, -1, points, crop_center,
                                            body_center)
        return torch.where(in_img[..., None], self.df(feat),
                           torch.full_like(feat[..., :1], self.cfg.out_dist))

    def query_heads(self, cache, points, crop_center, body_center,
                    heads: tuple = ("df",)) -> dict:
        """Last-stack query restricted to a subset of the heads."""
        feat, in_img = self._point_features(cache, -1, points, crop_center,
                                            body_center)
        table, out = self._heads(), {}
        for h in heads:
            v = table[h](feat)
            if h == "df":
                v = torch.where(in_img[..., None], v,
                                torch.full_like(v, self.cfg.out_dist))
            elif h == "pca":
                v = v.reshape(v.shape[:-1] + (3, 3))
            out[h] = v
        return out

    def query(self, cache, points, crop_center, body_center) -> list:
        """All cached stacks at (B, N, 3) points -> list of head dicts;
        out-of-crop points get df = OUT_DIST."""
        preds_list = []
        for s in range(len(cache["rgb_feats"])):
            feat, in_img = self._point_features(cache, s, points,
                                                crop_center, body_center)
            preds = self.decode(feat)
            preds["df"] = torch.where(
                in_img[..., None], preds["df"],
                torch.full_like(preds["df"], self.cfg.out_dist))
            preds_list.append(preds)
        return preds_list
