"""Autoregressive object-pose infilling with HVOP-Net (pipeline stage 5).

Port of vistracker_tpu/fit/infill.py:
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


def downstream_recon_eval(run_infill, seqs, occ_thres: float = 0.5,
                          init_thres: float = 0.5, samples: int = 2000,
                          seed: int = 0, device="cuda") -> dict:
    """Downstream evaluation of an infiller during training: run the whole
    autoregressive infill on held-out sequences and measure the object
    chamfer and v2v (cm) on the OCCLUDED frames (visibility <= occ_thres)
    against GT rotations; the chamfer runs on `device`.

    run_infill(poses, trans, obj_rot_real, occ, occ_thres=, init_thres=)
    is what make_infiller returns. seqs: dicts with poses (T, 72/156),
    trans (T, 3), obj_rot_real (T, 3, 3) input rotations, obj_rot_gt
    (T, 3, 3) GT REAL rotations, occ (T,) visibility ratios, temp_verts
    (V, 3) and temp_faces (F, 3). Returns {downstream_chamfer_cm,
    downstream_v2v_cm} averaged over the occluded frames of all
    sequences, {} when none was evaluated.
    """
    from ..ops.chamfer import chamfer_distance
    from ..utils.mesh import sample_surface
    v2v_all, chamf_all = [], []
    for si, seq in enumerate(seqs):
        occ = np.asarray(seq["occ"]).reshape(-1)
        filled = run_infill(seq["poses"], seq["trans"], seq["obj_rot_real"],
                            occ, occ_thres=occ_thres, init_thres=init_thres)
        if filled is None:  # unreliable seeds: pass-through, skipped
            continue
        keep = occ <= occ_thres
        if not keep.any():
            continue
        tv = np.asarray(seq["temp_verts"], np.float32)
        rot_gt = np.asarray(seq["obj_rot_gt"])[keep]
        # rotation only: the template turned by each rotation
        ov_pred = np.einsum("vj,tij->tvi", tv, filled[keep])
        ov_gt = np.einsum("vj,tij->tvi", tv, rot_gt)
        v2v_all.extend(
            (np.linalg.norm(ov_pred - ov_gt, axis=-1).mean(1) * 100.0)
            .tolist())
        # one fixed set of template samples for every frame
        sp = sample_surface(tv, np.asarray(seq["temp_faces"]), samples,
                            np.random.RandomState(seed + si))
        sp_pred = np.einsum("vj,tij->tvi", sp, filled[keep])
        sp_gt = np.einsum("vj,tij->tvi", sp, rot_gt)
        ch = chamfer_distance(
            torch.as_tensor(sp_pred.astype(np.float32), device=device),
            torch.as_tensor(sp_gt.astype(np.float32), device=device),
            w1=0.5, w2=0.5) * 100.0
        chamf_all.extend(ch.cpu().tolist())
    if not v2v_all:
        return {}
    return {"downstream_chamfer_cm": float(np.mean(chamf_all)),
            "downstream_v2v_cm": float(np.mean(v2v_all))}
