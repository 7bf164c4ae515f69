"""SIF-Net: pixel-aligned implicit network with triplane conditioning and
object-visibility prediction, and its training loss.

Port of vistracker_tpu/models/sifnet.py, all three variants of the
model family:
  chore               plain CHORE: no triplane encoder, a 6-channel
                      center head (SMPL center + object center), no
                      visibility head;
  chore-triplane      + the triplane encoder(s), the same heads;
  chore-triplane-vis  the release SIF-Net: a 3-channel object-center head
                      and a sigmoid visibility head.
`encode` returns an explicit feature cache (channels-last maps, as in
the JAX package) and the query methods consume it, so one encode serves
the many queries of the surface harvest; `encode(train=True)` keeps
every stack for the training loss (`sifnet_losses`), and `remat`
recomputes each encoder's activations in the backward pass
(torch.utils.checkpoint). Parameter names are the reference's
(image_filter.*, triplane_encoder.* or triplane_encoder_{0,1,2}.*,
df.{0,2,4,6}, part_predictor.*, pca_predictor.*, center_predictor.*,
visib_predictor.*): a released checkpoint loads with load_state_dict
once its "module." prefixes are stripped.

Query feature layout per stack (611 features at release width):
  [rgb_hg (256) | z_feat (3) | rgb_tmpx (64) |
   triplane_tmpx right/back/top (3*32) | triplane_hg right/back/top (3*64)]
(the chore variant stops after rgb_tmpx).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.camera import PerspectiveCamera, triplane_project
from ..ops.grid_sample import grid_sample_points
from .hourglass import HGConfig, HGFilter


VARIANTS = ("chore", "chore-triplane", "chore-triplane-vis")
LOSS_WEIGHTS = (1.0, 1.0, 0.006, 500.0, 1000.0, 1000.0)


@dataclasses.dataclass(frozen=True)
class SIFNetConfig:
    """Network, query and memory settings (tri-vis-l2 by default); the
    loss's clamp and weights are `fit.train.TrainConfig`'s."""

    variant: str = "chore-triplane-vis"
    input_channels: int = 5
    num_stack: int = 3
    num_hourglass: int = 2
    hourglass_dim: int = 256
    tmpx_dim: int = 64
    triplane_stack: int = 3
    triplane_hg_dim: int = 64
    triplane_tmpx_dim: int = 32
    triplane_shared: bool = True
    num_parts: int = 14
    hidden_dim: int = 128
    z0: float = 2.2
    out_dist: float = 5.0
    crop_size: int = 1200
    remat: bool = False            # recompute encoder activations

    @property
    def has_triplane(self) -> bool:
        return self.variant != "chore"

    @property
    def has_visibility(self) -> bool:
        return self.variant == "chore-triplane-vis"

    @property
    def feature_size(self) -> int:
        """Width of the assembled query feature (the decoders' input)."""
        size = self.hourglass_dim + 3 + self.tmpx_dim
        if self.has_triplane:
            size += (self.triplane_hg_dim + self.triplane_tmpx_dim) * 3
        return size


def sifnet_preset(name: str, crop_size: int = 1200,
                  remat: bool = False) -> SIFNetConfig:
    """Named size presets (same as the JAX package): release is the
    tri-vis-l2 network; small and tiny are for fixtures and tests."""
    if name == "release":
        return SIFNetConfig(crop_size=crop_size, remat=remat)
    if name == "small":
        return SIFNetConfig(num_stack=2, num_hourglass=2, hourglass_dim=64,
                            tmpx_dim=32, triplane_stack=1,
                            triplane_hg_dim=64, triplane_tmpx_dim=32,
                            hidden_dim=64, crop_size=crop_size, remat=remat)
    if name == "tiny":
        return SIFNetConfig(num_stack=1, num_hourglass=1, hourglass_dim=32,
                            tmpx_dim=32, triplane_stack=1,
                            triplane_hg_dim=32, triplane_tmpx_dim=32,
                            hidden_dim=16, crop_size=crop_size, remat=remat)
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
        if cfg.variant not in VARIANTS:
            raise ValueError(f"unknown SIF-Net variant {cfg.variant!r}")
        c = self.cfg = cfg
        self.camera = camera
        self.image_filter = HGFilter(HGConfig(
            input_channels=c.input_channels, num_stack=c.num_stack,
            num_hourglass=c.num_hourglass, hourglass_dim=c.hourglass_dim,
            tmpx_dim=c.tmpx_dim))
        if c.has_triplane:
            tp_cfg = HGConfig(
                input_channels=1, num_stack=c.triplane_stack,
                num_hourglass=c.num_hourglass,
                hourglass_dim=c.triplane_hg_dim,
                tmpx_dim=c.triplane_tmpx_dim)
            if c.triplane_shared:  # one encoder for the three views
                self.triplane_encoder = HGFilter(tp_cfg)
            else:
                for i in range(3):
                    self.add_module(f"triplane_encoder_{i}", HGFilter(tp_cfg))
        fs, hd = c.feature_size, c.hidden_dim
        self.df = DecoderHead(fs, 2, hd)
        self.part_predictor = DecoderHead(fs, c.num_parts, hd)
        self.pca_predictor = DecoderHead(fs, 9, hd)
        # chore(-triplane): SMPL + object centers; the vis variant: the
        # object center and a visibility head
        self.center_predictor = DecoderHead(
            fs, 3 if c.has_visibility else 6, hd)
        if c.has_visibility:
            self.visib_predictor = DecoderHead(fs, 1, hd, sigmoid=True)

    def _heads(self) -> dict:
        heads = {"df": self.df, "parts": self.part_predictor,
                 "pca": self.pca_predictor, "centers": self.center_predictor}
        if self.cfg.has_visibility:
            heads["vis"] = self.visib_predictor
        return heads

    def _filter(self, encoder: HGFilter, x: torch.Tensor):
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(encoder, x, use_reentrant=False)
        return encoder(x)

    def encode(self, images: torch.Tensor, train: bool = False) -> dict:
        """images (B, H, W, 8) = [RGB * union mask, person mask, object
        mask, triplane right, back, top] (the chore variant reads the
        first 5) -> feature cache, every map channels-last. At inference
        only each encoder's last stack is kept; train=True keeps every
        stack. The stem maps (tmpx) are detached, as in the reference."""
        nchw = images.permute(0, 3, 1, 2)
        rgb_feats, tmpx, _ = self._filter(self.image_filter, nchw[:, :5])
        keep = slice(None) if train else slice(-1, None)
        cache = dict(rgb_feats=[_nhwc(f) for f in rgb_feats[keep]],
                     tmpx=_nhwc(tmpx.detach()), tp_feats=[], tp_tmpx=[])
        if not self.cfg.has_triplane:
            return cache
        B = images.shape[0]
        if self.cfg.triplane_shared:
            # the 3 views in one batched call: GroupNorm is per sample, so
            # this equals three separate calls
            planes = nchw[:, 5:8].transpose(0, 1).reshape(
                3 * B, 1, *nchw.shape[2:])
            feats, ttmp, _ = self._filter(self.triplane_encoder, planes)
            views = [([f[i * B:(i + 1) * B] for f in feats],
                      ttmp[i * B:(i + 1) * B]) for i in range(3)]
        else:
            views = [self._filter(getattr(self, f"triplane_encoder_{i}"),
                                  nchw[:, 5 + i:6 + i])[:2]
                     for i in range(3)]
        cache["tp_feats"] = [[_nhwc(f) for f in feats[keep]]
                             for feats, _ in views]
        cache["tp_tmpx"] = [_nhwc(ttmp.detach()) for _, ttmp in views]
        return cache

    def _point_features(self, cache, stack_idx, points, crop_center,
                        body_center):
        """(B, N, F) features of one stack + in-image mask (B, N)."""
        xy = self.camera.project_points(points, crop_center)[..., :2]
        in_img = ((xy[..., 0] >= -1.0) & (xy[..., 0] <= 1.0)
                  & (xy[..., 1] >= -1.0) & (xy[..., 1] <= 1.0))
        z_feat = torch.cat([points[..., 0:2], points[..., 2:3] - self.cfg.z0],
                           -1)
        feats = [grid_sample_points(cache["rgb_feats"][stack_idx], xy),
                 z_feat, grid_sample_points(cache["tmpx"], xy)]
        if not self.cfg.has_triplane:
            return torch.cat(feats, -1), in_img
        tp_uv = triplane_project(points, body_center)       # (B, 3, N, 2)
        # a main stack past the triplane encoder's last reads its deepest
        tp_idx = min(stack_idx, len(cache["tp_feats"][0]) - 1)
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

    def forward(self, images, points, crop_center, body_center,
                train: bool = False) -> list:
        """encode + query of every cached stack (the training forward with
        train=True)."""
        cache = self.encode(images, train=train)
        return self.query(cache, points, crop_center, body_center)


def sifnet_losses(preds_list, gt, loss_weights=LOSS_WEIGHTS,
                  max_dist: float = 0.1):
    """The training loss of every variant, averaged over stacks.

    gt: df_h, df_o (B, N), parts (B, N) int64, pca (B, N, 3, 3),
    obj_center (B, 3), and visibility (B, N) for the vis variant or
    body_center (B, 3) for chore / chore-triplane, whose 6-channel center
    head carries the SMPL center in channels 0:3. Returns (total, dict of
    the six terms df_h, df_o, parts, pca, ocenter, vis), the terms each
    divided by the number of stacks. The reference's reductions are kept:
    the df and part terms are summed over points and averaged over the
    batch; the masked MSE terms are plain means over all elements (the
    mask zeroes, nothing renormalizes).
    """
    w = loss_weights
    total = 0.0
    names = ("df_h", "df_o", "parts", "pca", "ocenter", "vis")
    terms = dict.fromkeys(names, 0.0)
    n_stacks = len(preds_list)
    mask_o = (gt["df_o"] < 0.05).to(gt["df_o"].dtype)          # (B, N)
    for preds in preds_list:
        df_h_pred, df_o_pred = preds["df"][..., 0], preds["df"][..., 1]
        l_h = (df_h_pred.clamp(max=max_dist) - gt["df_h"].clamp(
            max=max_dist)).abs().sum(-1).mean() * w[0]
        l_o = (df_o_pred.clamp(max=max_dist) - gt["df_o"].clamp(
            max=max_dist)).abs().sum(-1).mean() * w[1]
        logp = F.log_softmax(preds["parts"], dim=-1)
        ce = -torch.gather(logp, -1, gt["parts"].long()[..., None])[..., 0]
        l_parts = (ce * w[2]).sum(-1).mean()
        l_pca = ((preds["pca"] - gt["pca"]) ** 2
                 * mask_o[..., None, None]).mean() * w[3]
        if "vis" in preds:
            l_ocent = ((preds["centers"] - gt["obj_center"][:, None, :]) ** 2
                       * mask_o[..., None]).mean() * w[4]
            l_last = ((preds["vis"][..., 0] - gt["visibility"]) ** 2
                      * mask_o).mean() * w[5]
        else:
            l_ocent = ((preds["centers"][..., 3:]
                        - gt["obj_center"][:, None, :]) ** 2
                       * mask_o[..., None]).mean() * w[4]
            mask_h = (gt["df_h"] < 0.05).to(gt["df_h"].dtype)
            l_last = ((preds["centers"][..., :3]
                       - gt["body_center"][:, None, :]) ** 2
                      * mask_h[..., None]).mean() * w[5]
        total = total + l_h + l_o + l_parts + l_pca + l_ocent + l_last
        for k, v in zip(names, (l_h, l_o, l_parts, l_pca, l_ocent, l_last)):
            terms[k] = terms[k] + v / n_stacks
    return total / n_stacks, terms
