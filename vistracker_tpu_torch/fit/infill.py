"""Autoregressive object-pose infilling with HVOP-Net (pipeline stage 5).

Port of vistracker_tpu/fit/infill.py (without downstream_recon_eval,
which belongs to the evaluation tools):
  * inputs: SMPL stream = 24-joint rot6d (144) + trans (3); object stream
    = rot6d (6) of the smoothed rotations, zeroed on occluded frames;
  * occlusion mask = predicted visibility < occ_thres (0.5); the first
    180-frame clip needs >= 30 visible frames, else the sequence passes
    through unmodified (run returns None);
  * clip 0 predicts all min(T, 180) frames; full clips then slide by 30
    frames at starts 0, 30, ... <= T - 180, take the previous predictions
    as their first 30 frames (forced visible) and keep pred[30:];
  * whenever T >= 150 exactly ONE truncated clip ends the schedule. It is
    run at its own length, not padded: the positional code is normalized
    by the clip length, so a padded clip would see other codes;
  * output rotations replace the input everywhere.
The clips depend on each other, so they run as a host loop of batched
transformer forwards.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.rotations import (axis_angle_to_rot6d, rot6d_to_rotmat,
                              rotmat_to_rot6d)
from ..models.infiller import ConditionalMInfiller, InfillerConfig
from .smoothing import smplh_to_smpl_pose


def prepare_streams(poses: np.ndarray, trans: np.ndarray,
                    obj_rot_real: np.ndarray):
    """Build the (T, 147) SMPL and (T, 6) object input streams (numpy)."""
    T = len(poses)
    p72 = smplh_to_smpl_pose(poses) if poses.shape[-1] == 156 else poses
    rot6d_smpl = axis_angle_to_rot6d(torch.as_tensor(
        np.asarray(p72, np.float32).reshape(-1, 3))).numpy().reshape(T, 144)
    smpl_stream = np.concatenate([rot6d_smpl, trans], 1).astype(np.float32)
    obj_stream = rotmat_to_rot6d(torch.as_tensor(
        np.asarray(obj_rot_real, np.float32))).numpy().astype(np.float32)
    return smpl_stream, obj_stream


def make_infiller(model, cfg: InfillerConfig = InfillerConfig()):
    """-> run(poses, trans, obj_rot_real, occ_ratios) for `model`, a
    ConditionalMInfiller or MotionInfiller in eval mode; the clips run on
    the model's device."""
    clip, win = cfg.clip_len, cfg.window
    conditional = isinstance(model, ConditionalMInfiller)

    def forward(smpl_clip, obj_clip, mask_clip):
        # object inputs zeroed where occluded; the clip length is whatever
        # the caller sliced
        L = smpl_clip.shape[0]
        obj_in = obj_clip * (~mask_clip)[:, None].float()
        if conditional:
            none = torch.zeros((1, L), dtype=torch.bool,
                               device=smpl_clip.device)
            pred = model(smpl_clip[None], none, obj_in[None],
                         mask_clip[None])
        else:
            pred = model(torch.cat([smpl_clip, obj_in], -1)[None],
                         mask_clip[None])
        return pred[0]  # (L, 6)

    def context_clip(out, ss, ob, ms, start, stop):
        """Predict frames [start + win, stop) from clip [start, stop) with
        the previous predictions as its first `win` frames."""
        oc, mc = ob[start:stop].clone(), ms[start:stop].clone()
        oc[:win] = out[start:start + win]
        mc[:win] = False
        pred = forward(ss[start:stop], oc, mc)
        out[start + win:stop] = pred[win:]

    @torch.no_grad()
    def run(poses, trans, obj_rot_real, occ_ratios, occ_thres: float = 0.5,
            init_thres: float = 0.5):
        """Returns (T, 3, 3) REAL rotations (numpy), or None when the seed
        clip has fewer than `win` visible frames (pass-through)."""
        dev = next(model.parameters()).device
        T = len(poses)
        smpl_stream, obj_stream = prepare_streams(poses, trans, obj_rot_real)
        occ = np.asarray(occ_ratios).reshape(-1)
        seed_mask = occ < init_thres
        if np.sum(~seed_mask[:clip]) < win:
            return None
        ss = torch.as_tensor(smpl_stream, device=dev)
        ob = torch.as_tensor(obj_stream, device=dev)
        ms = torch.as_tensor(occ < occ_thres, device=dev)
        mi = torch.as_tensor(seed_mask, device=dev)

        n0 = min(T, clip)
        out = torch.zeros((T, 6), device=dev)
        out[:n0] = forward(ss[:n0], ob[:n0], mi[:n0])
        if T >= clip:
            for start in range(0, T - clip + 1, win):
                context_clip(out, ss, ob, ms, start, start + clip)
        if T >= clip - win:
            # the schedule's one truncated step: the single multiple of
            # `win` in (T - clip, T - clip + win]
            context_clip(out, ss, ob, ms,
                         win * ((T - (clip - win)) // win), T)
        rots = rot6d_to_rotmat(out).cpu().numpy()
        if not np.isfinite(rots).all():
            raise FloatingPointError("nan in infilled rotations")
        return rots

    return run
