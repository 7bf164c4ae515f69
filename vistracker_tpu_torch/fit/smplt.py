"""SMPL-T fitting: batched keypoint + temporal-loss Adam (stage 1).

Port of vistracker_tpu/fit/smplt.py. Two phases like the reference
fitter: phase 1 moves [global_pose, top_betas, trans] at lr 0.01 for
`global_iters` iterations, phase 2 everything but the hand pose at lr
0.001; 10 Adam steps per iteration; loss weights decay as w/(1 + it//3).
Inactive leaves are frozen by zeroing their gradients, and each phase
starts a fresh Adam state (zero-gradient Adam leaves a leaf unchanged).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.landmarks import BodyLandmarks
from ..core.priors import HandPrior, MahalanobisPrior
from ..core.smpl import SMPLModel, lbs_forward

# per-angle weights for the joint-acceleration loss (22 joints x 3)
JOINT_ACCEL_WEIGHTS = np.repeat(
    np.array([1.0, 10.0, 10.0, 10.0, 5.0, 5.0, 10.0, 1.0, 1.0, 10.0, 1.0,
              1.0, 0.0, 5.0, 5.0, 5.0, 5.0, 5.0, 1.0, 1.0, 1.0, 1.0],
             np.float32), 3)
JOINT_ACCEL_WEIGHTS[36:39] = (5.0, 10.0, 10.0)  # neck

_LEAVES = ("global_pose", "body_pose", "hand_pose", "top_betas",
           "other_betas", "trans")


@dataclasses.dataclass(frozen=True)
class SMPLTFitConfig:
    """Hyperparameters of the SMPL-T fitter (reference defaults)."""

    global_iters: int = 8
    max_iters: int = 100
    steps_per_iter: int = 10
    lr_global: float = 0.01
    lr_all: float = 0.001
    smpl_depth: float = 2.2
    # pixel-space intrinsics (BEHAVE kinect color)
    fx: float = 979.7844
    fy: float = 979.840
    cx: float = 1018.952
    cy: float = 779.486
    # loss weights, decayed as w/(1 + it//3)
    w_kpts: float = 0.3 ** 2
    w_temp: float = 30.0 ** 2
    w_ptemp: float = 5.0 ** 2
    w_pinit: float = 30.0 ** 2
    w_pose: float = 1e-5
    w_hand: float = 1e-5


@dataclasses.dataclass
class SMPLTParams:
    """Split SMPL-H parameters (the reference's SplitParams layout)."""

    global_pose: torch.Tensor  # (B, 3)
    body_pose: torch.Tensor    # (B, 63)
    hand_pose: torch.Tensor    # (B, 90)
    top_betas: torch.Tensor    # (B, 2)
    other_betas: torch.Tensor  # (B, 8)
    trans: torch.Tensor        # (B, 3)

    @property
    def pose(self) -> torch.Tensor:
        return torch.cat([self.global_pose, self.body_pose, self.hand_pose],
                         dim=-1)

    @property
    def betas(self) -> torch.Tensor:
        return torch.cat([self.top_betas, self.other_betas], dim=-1)

    @classmethod
    def from_full(cls, pose, betas, trans):
        return cls(global_pose=pose[:, :3], body_pose=pose[:, 3:66],
                   hand_pose=pose[:, 66:156], top_betas=betas[:, :2],
                   other_betas=betas[:, 2:], trans=trans)

    def leaves(self) -> list:
        return [getattr(self, k) for k in _LEAVES]


def init_trans_from_bbox(bbox_center: np.ndarray,
                         cfg: SMPLTFitConfig) -> np.ndarray:
    """Back-project person-mask bbox centers (N, 2) to depth smpl_depth."""
    bx = (bbox_center[:, 0] - cfg.cx) / cfg.fx * cfg.smpl_depth
    by = (bbox_center[:, 1] - cfg.cy) / cfg.fy * cfg.smpl_depth
    bz = np.full_like(bx, cfg.smpl_depth)
    return np.stack([bx, by, bz], -1).astype(np.float32)


def project_pixels(points: torch.Tensor, cfg: SMPLTFitConfig):
    """(B, J, 3) camera-frame -> (B, J, 2) full-image pixels."""
    z = points[..., 2:3]
    return torch.cat([points[..., 0:1] * cfg.fx / z + cfg.cx,
                      points[..., 1:2] * cfg.fy / z + cfg.cy], dim=-1)


def smplt_loss_terms(params: SMPLTParams, model: SMPLModel,
                     landmarks: BodyLandmarks, body_prior: MahalanobisPrior,
                     hand_prior: HandPrior, kpts: torch.Tensor,
                     pose_init: torch.Tensor, cfg: SMPLTFitConfig,
                     accel_w: torch.Tensor) -> dict:
    """All loss terms, un-weighted. kpts (B, 25, 3): pixel x, y, conf."""
    pose = params.pose
    verts = lbs_forward(model, pose, params.betas, params.trans)[0]
    proj = project_pixels(landmarks.body_joints(verts), cfg)
    terms = {"kpts": ((proj - kpts[..., :2]) ** 2 * kpts[..., 2:3]).mean()}
    velo1 = verts[1:-1] - verts[:-2]
    velo2 = verts[2:] - verts[1:-1]
    terms["temp"] = ((velo1 - velo2) ** 2).mean()
    p66 = pose[:, :66]
    pv1 = p66[1:-1] - p66[:-2]
    pv2 = p66[2:] - p66[1:-1]
    terms["ptemp"] = (((pv1 - pv2) ** 2) * accel_w[None]).mean()
    terms["pose"] = body_prior(pose[:, :72]).mean()
    terms["hand"] = hand_prior(pose).mean()
    terms["pinit"] = ((pose_init[:, 3:66] - params.body_pose) ** 2).mean()
    return terms


def weighted_total(terms: dict, cfg: SMPLTFitConfig, decay: float):
    """sum of w_k * term_k / (1 + decay) (the reference's sum_dict)."""
    scale = 1.0 / (1.0 + decay)
    w = dict(kpts=cfg.w_kpts, temp=cfg.w_temp, ptemp=cfg.w_ptemp,
             pinit=cfg.w_pinit, pose=cfg.w_pose, hand=cfg.w_hand)
    return sum(terms[k] * w[k] * scale for k in w)


def _phase(loss_fn, params: SMPLTParams, lr: float, n_steps: int,
           step_offset: int, steps_per_iter: int, active: set):
    """n_steps Adam steps with a fresh optimizer; leaves outside `active`
    get zeroed gradients. Returns (params, list of 0-d loss tensors)."""
    leaves = [p.detach().clone().requires_grad_(True)
              for p in params.leaves()]
    p = SMPLTParams(*leaves)
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for step in range(n_steps):
        decay = float(((step_offset + step) // steps_per_iter) // 3)
        opt.zero_grad(set_to_none=False)
        loss = loss_fn(p, decay)
        loss.backward()
        for name, leaf in zip(_LEAVES, leaves):
            if name not in active:
                leaf.grad.zero_()
        opt.step()
        losses.append(loss.detach())
    return SMPLTParams(*[x.detach() for x in leaves]), losses


def fit_smplt(model: SMPLModel, landmarks: BodyLandmarks,
              body_prior: MahalanobisPrior, hand_prior: HandPrior,
              kpts: torch.Tensor, init: SMPLTParams,
              cfg: SMPLTFitConfig = SMPLTFitConfig(),
              skip_global_phase: bool = False):
    """Fit a chunk of B consecutive frames -> (params, loss trace (S,))."""
    pose_init = init.pose.detach()
    accel_w = torch.as_tensor(JOINT_ACCEL_WEIGHTS, device=kpts.device)

    def loss_fn(p, decay):
        terms = smplt_loss_terms(p, model, landmarks, body_prior, hand_prior,
                                 kpts, pose_init, cfg, accel_w)
        return weighted_total(terms, cfg, decay)

    spi = cfg.steps_per_iter
    params, losses = init, []
    n1 = cfg.global_iters * spi
    if not skip_global_phase:
        params, l1 = _phase(loss_fn, params, cfg.lr_global, n1, 0, spi,
                            {"global_pose", "top_betas", "trans"})
        losses += l1
    n2 = (cfg.max_iters - (0 if skip_global_phase else cfg.global_iters)) \
        * spi
    offset = 0 if skip_global_phase else cfg.global_iters * spi
    # phase 2 moves everything except the hand pose (stays at GRAB mean)
    params, l2 = _phase(loss_fn, params, cfg.lr_all, n2, offset, spi,
                        {"global_pose", "body_pose", "top_betas",
                         "other_betas", "trans"})
    losses += l2
    trace = torch.stack(losses) if losses else torch.zeros(0)
    return params, trace
