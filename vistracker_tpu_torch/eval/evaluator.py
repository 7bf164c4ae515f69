"""Windowed evaluation of packed reconstructions against GT packs.

Port of vistracker_tpu/eval/evaluator.py (the reference's
recon/eval/evalvideo_packed.py):
  * per sequence: SMPL verts from the packed parameters (the port's LBS,
    on the model's device) and object verts from the template and the
    packed pose;
  * one Procrustes (R, t, s) per W-frame window, fit on the SMPL and
    object verts of the window's recon_exist frames and applied to the
    whole window (W = 300 by default; W = 1 is the CHORE protocol);
  * per frame: bidirectional sqrt chamfer on 10k surface samples
    (kernel K4) and v2v, in cm;
  * per window: the acceleration error, given to each of its frames;
  * a JSON summary {metric: {mean, std}} over smpl_chamf, obj_chamf,
    smpl_v2v, obj_v2v, smpl-acc, obj-acc, with per-sequence and
    per-object breakdowns.
The window bookkeeping and the alignment stay numpy float64.
"""
from __future__ import annotations

import datetime
import json
import os

import numpy as np
import torch

from ..core.smpl import SMPLModel, lbs_forward
from .metrics import (accel_error, apply_transform, chamfer_error,
                      compute_transform, v2v_error)

ERROR_KEYS = ("smpl_chamf", "obj_chamf", "smpl_v2v", "obj_v2v",
              "smpl-acc", "obj-acc")


@torch.no_grad()
def smpl_verts_from_packed(model: SMPLModel, poses, betas, trans,
                           batch: int = 256) -> np.ndarray:
    """(T, 156/72), (T, 10), (T, 3) -> (T, V, 3) float32, LBS on the
    model's device in batches of `batch` frames."""
    dev = model.v_template.device
    out = []
    for s in range(0, len(poses), batch):
        p, b, t = (torch.as_tensor(np.asarray(a[s:s + batch], np.float32),
                                   device=dev) for a in (poses, betas, trans))
        out.append(lbs_forward(model, p, b, t)[0].cpu().numpy())
    return np.concatenate(out, 0)


def eval_sequence(sverts_gt: np.ndarray, overts_gt: np.ndarray,
                  sverts_recon: np.ndarray, overts_recon: np.ndarray,
                  smpl_faces: np.ndarray, obj_faces: np.ndarray,
                  recon_exist: np.ndarray | None = None,
                  window: int = 300, align: bool = True,
                  smpl_only: bool = False, chamfer_samples: int = 10000,
                  device="cuda") -> np.ndarray:
    """Per-frame error matrix (N_valid, 6) ordered like ERROR_KEYS; the
    chamfer distances run on `device`."""
    L = len(sverts_gt)
    recon_exist = (np.ones(L, bool) if recon_exist is None
                   else np.asarray(recon_exist, bool))
    errors_all = []
    smpl_acc, obj_acc = [], []
    win_sgt, win_srec, win_ogt, win_orec = [], [], [], []
    R = t = s = None
    count = 0
    for i in range(L):
        count += 1
        if align and (R is None or count % window == 0):
            bend = min(L, i + window)
            idx = np.arange(i, bend)[recon_exist[i:bend]]
            if len(idx) == 0:
                continue
            clip_gt = [sverts_gt[idx].reshape(-1, 3)]
            clip_rc = [sverts_recon[idx].reshape(-1, 3)]
            if not smpl_only:
                clip_gt.append(overts_gt[idx].reshape(-1, 3))
                clip_rc.append(overts_recon[idx].reshape(-1, 3))
            R, t, s = compute_transform(np.concatenate(clip_rc, 0),
                                        np.concatenate(clip_gt, 0))
        if not recon_exist[i]:
            continue
        if align:
            s_al = apply_transform(sverts_recon[i], R, t, s)
            o_al = apply_transform(overts_recon[i], R, t, s)
        else:
            s_al, o_al = sverts_recon[i], overts_recon[i]
        win_sgt.append(sverts_gt[i])
        win_srec.append(s_al)
        win_ogt.append(overts_gt[i])
        win_orec.append(o_al)
        errors_all.append([
            chamfer_error(sverts_gt[i], smpl_faces, s_al, smpl_faces,
                          chamfer_samples, device=device),
            chamfer_error(overts_gt[i], obj_faces, o_al, obj_faces,
                          chamfer_samples, device=device),
            v2v_error(sverts_gt[i], s_al),
            v2v_error(overts_gt[i], o_al),
        ])
        if count % window == 0 or i == L - 1:
            cl = len(win_sgt)
            acc_s = accel_error(np.stack(win_sgt), np.stack(win_srec))
            acc_o = accel_error(np.stack(win_ogt), np.stack(win_orec))
            smpl_acc.extend([acc_s] * cl)
            obj_acc.extend([acc_o] * cl)
            win_sgt, win_srec, win_ogt, win_orec = [], [], [], []
    if not errors_all:
        return np.zeros((0, 6))
    err = np.asarray(errors_all)
    return np.concatenate(
        [err, np.asarray(smpl_acc)[:, None], np.asarray(obj_acc)[:, None]], 1)


def rotation_errors_deg(rot_recon: np.ndarray,
                        rot_gt: np.ndarray) -> np.ndarray:
    """Per-frame geodesic rotation error in degrees (the reference's angle
    evaluator); both (T, 3, 3) REAL rotation matrices (packed obj_angles
    are transposed)."""
    rel = np.einsum("tij,tkj->tik", rot_recon, rot_gt)
    tr = np.clip((np.trace(rel, axis1=1, axis2=2) - 1.0) * 0.5, -1.0, 1.0)
    return np.degrees(np.arccos(tr))


def format_errors(errors: np.ndarray) -> dict:
    out = {}
    for i, k in enumerate(ERROR_KEYS):
        out[k] = {"mean": float(np.mean(errors[:, i])),
                  "std": float(np.std(errors[:, i]))}
    out["total"] = int(len(errors))
    return out


def object_name_of(seq_name: str) -> str:
    parts = seq_name.split("_")
    return parts[2] if len(parts) > 2 else seq_name


def collect_results(errors_dict: dict, outdir: str, save_name: str,
                    split_name: str = "", extra: dict | None = None) -> str:
    """Aggregate per-sequence error matrices into the reference's JSON
    layout; writes <outdir>/<split_name><save_name>_<time>.json and
    returns its path."""
    all_errs = np.concatenate(list(errors_dict.values()), 0)
    result = format_errors(all_errs)
    result["separate"] = {k: format_errors(v)
                          for k, v in sorted(errors_dict.items())}
    per_obj = {}
    for seq, errs in errors_dict.items():
        per_obj.setdefault(object_name_of(seq), []).append(errs)
    for name, errs in sorted(per_obj.items()):
        result[name] = format_errors(np.concatenate(errs, 0))
    result["save_name"] = save_name
    ts = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
    result["time"] = ts
    if extra:
        result.update(extra)
    os.makedirs(outdir, exist_ok=True)
    outfile = os.path.join(outdir, f"{split_name}{save_name}_{ts}.json")
    with open(outfile, "w", encoding="utf-8") as f:
        json.dump(result, f, ensure_ascii=False, indent=2)
    return outfile
