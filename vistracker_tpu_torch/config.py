"""Experiment configuration: the reference's JSON experiment configs
(with // comments, e.g. tri-vis-l2.json and cmf-k4-lrot.json) mapped
onto the port's config dataclasses.

Port of vistracker_tpu/config.py. `PathsConfig` reads the same
environment variables; its assets default is the relative "assets".
"""
from __future__ import annotations

import dataclasses
import json
import os
import re

from .fit.train import TrainConfig
from .models.infiller import InfillerConfig
from .models.sifnet import LOSS_WEIGHTS, SIFNetConfig


@dataclasses.dataclass(frozen=True)
class PathsConfig:
    """Where data, results, models and experiments live."""

    behave_root: str = os.environ.get("VISTRACKER_BEHAVE", "")
    recon_root: str = os.environ.get("VISTRACKER_RECON", "recon_out")
    smpl_model_root: str = os.environ.get("VISTRACKER_SMPL_MODELS", "")
    assets_root: str = os.environ.get("VISTRACKER_ASSETS", "assets")
    experiments_root: str = os.environ.get("VISTRACKER_EXPERIMENTS",
                                           "experiments")


def _strip_comments(text: str) -> str:
    return re.sub(r"^\s*//.*$", "", text, flags=re.M)


def load_reference_json(path: str) -> dict:
    with open(path) as f:
        return json.loads(_strip_comments(f.read()))


def sifnet_config_from_json(cfg: dict) -> SIFNetConfig:
    """tri-vis-l2.json-style keys -> SIFNetConfig (clamp_thres and
    loss_weights go to `train_config_from_json`)."""
    return SIFNetConfig(
        input_channels=5,
        num_stack=cfg.get("num_stack", 3),
        num_hourglass=cfg.get("num_hourglass", 2),
        hourglass_dim=cfg.get("hourglass_dim", 256),
        tmpx_dim=cfg.get("tmpx_dim", 64),
        triplane_stack=cfg.get("triplane_encoder_stack", 3),
        triplane_hg_dim=cfg.get("triplane_hg_dim", 64),
        triplane_tmpx_dim=cfg.get("triplane_tmpx_dim", 32),
        triplane_shared=cfg.get("triplane_shared_encoder", True),
        hidden_dim=cfg.get("hidden_dim", 128),
        z0=cfg.get("z_0", 2.2),
        crop_size=cfg.get("loadSize", 1200),
    )


def infiller_config_from_json(cfg: dict) -> InfillerConfig:
    """cmf-k4-lrot.json-style keys -> InfillerConfig; the JSON's window 1
    (a slide step) means a 30-frame carry."""
    keys = {f.name for f in dataclasses.fields(InfillerConfig)}
    kw = {k: v for k, v in cfg.items() if k in keys}
    if "hidden_dims" in kw:
        kw["hidden_dims"] = tuple(kw["hidden_dims"])
    if "window" in cfg:
        kw["window"] = 30 if cfg["window"] == 1 else cfg["window"]
    return InfillerConfig(**kw)


def camera_config_from_json(cfg: dict):
    """The camera of a config's camera_params (InterCap-style), or the
    BEHAVE Kinect defaults."""
    from .core.camera import PerspectiveCamera
    cp = cfg.get("camera_params")
    if cp is None:
        return PerspectiveCamera(crop_size=cfg.get("loadSize", 1200))
    return PerspectiveCamera(
        crop_size=cp.get("crop_size", cfg.get("loadSize", 800)),
        fx=cp["fx"], fy=cp["fy"], cx=cp["cx"], cy=cp["cy"],
        width=cp.get("image_width", 1920),
        height=cp.get("image_height", 1080))


def train_config_from_json(cfg: dict) -> TrainConfig:
    return TrainConfig(
        learning_rate=cfg.get("learning_rate", 1e-3),
        milestones=tuple(cfg.get("milestones", (15, 25))),
        max_dist=cfg.get("clamp_thres", 0.1),
        loss_weights=tuple(cfg.get("loss_weights", LOSS_WEIGHTS)),
    )
