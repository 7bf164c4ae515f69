"""Plain PyTorch reference of the Adam fits whose first steps `correct`
follows: stage 1's SMPL-T keypoint fit (VisTracker's SMPL-T fitter),
the phase that opens stage 6's SMPL fit (shape and translation against
SIF-Net's body distance and parts, the priors and the temporal term),
and the object phase that opens stage 6's object fit (its object-only
phase: SIF-Net's object distance at the transformed template, the scale
prior and the temporal terms). With them the SMPL-H body model (linear
blend skinning, body25 regressor, the Mahalanobis body and the hand
priors), read from the benchmark's own asset files
(portbench/traffic/fabricate.py writes them).

Every hyperparameter comes from the configuration file's `fit` and
`joint` groups. `follow_*` runs the fit's first steps from its start
and returns the loss before each step, as the program's loss trace
holds it. Under sifnet.lowered() every matrix product takes TF32
operands (the control). It imports nothing of the port, and it is the
yardstick that decides `correct`: a change that claims a speed-up may
not edit this file.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from . import sifnet as RS

# the per-angle weights of the SMPL-T fitter's pose-acceleration term
# (22 joints x 3, the neck's three set apart), as VisTracker states them
ACCEL_WEIGHTS = np.repeat(np.array(
    [1.0, 10.0, 10.0, 10.0, 5.0, 5.0, 10.0, 1.0, 1.0, 10.0, 1.0, 1.0, 0.0,
     5.0, 5.0, 5.0, 5.0, 5.0, 1.0, 1.0, 1.0, 1.0], np.float32), 3)
ACCEL_WEIGHTS[36:39] = (5.0, 10.0, 10.0)
SMPLT_LEAVES = ("global_pose", "body_pose", "hand_pose", "top_betas",
                "other_betas", "trans")
STAGE1_ACTIVE = {1: ("global_pose", "top_betas", "trans"),
                 2: ("global_pose", "body_pose", "top_betas", "other_betas",
                     "trans")}
SMPL_PHASE1 = ("top_betas", "trans")  # what stage 6's first phase moves
MID_HIP = 8     # the body25 joint whose depth the smplz term holds at z0
KPTS_TOL = 0.1  # keypoints under this confidence are dropped (zeroed)
BETA0 = 2.2     # the fitter's first shape coefficient at the start


def _mm(eq: str, *ops):
    return torch.einsum(eq, *[RS.low(x) for x in ops])


def _pkl(path: str):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def load_body(smpl_pkl: str, assets: str, device) -> dict:
    """The SMPL-H model, body25 regressor and priors as plain tensors."""
    d = _pkl(smpl_pkl)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    parents = [int(p) for p in np.asarray(d["kintree_table"])[0]]
    parents[0] = -1
    body = dict(v_template=t(d["v_template"]), shapedirs=t(d["shapedirs"]),
                posedirs=t(d["posedirs"]), j_regressor=t(d["J_regressor"]),
                weights=t(d["weights"]), parents=parents,
                body25=t(np.asarray(_pkl(os.path.join(
                    assets, "body25_regressor.pkl"))).T))
    pri = os.path.join(assets, "priors")
    bp = _pkl(os.path.join(pri, "body_prior.pkl"))
    lh = _pkl(os.path.join(pri, "lh_prior.pkl"))
    rh = _pkl(os.path.join(pri, "rh_prior.pkl"))
    body.update(
        prior_mean=t(np.reshape(bp["mean"], -1)), prior_prec=t(bp["precision"]),
        hand_mean=t(np.concatenate([np.reshape(lh["mean"], -1),
                                    np.reshape(rh["mean"], -1)])),
        lh_prec=t(lh["precision"]), rh_prec=t(rh["precision"]))
    return body


def rodrigues(r: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation (..., 3, 3): I + a K + b K^2 with
    a = sin(t)/t, b = (1 - cos(t))/t^2, by their series near t = 0."""
    t2 = (r * r).sum(-1)
    t = torch.sqrt(torch.clamp(t2, min=1e-12))
    small = t2 < 1e-8
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / (t * t))
    x, y, z = r.unbind(-1)
    o = torch.zeros_like(x)
    k = torch.stack([o, -z, y, z, o, -x, -y, x, o], -1).reshape(
        r.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    return eye + a[..., None, None] * k + b[..., None, None] * (k @ k)


def skin(body: dict, pose, betas, trans) -> torch.Tensor:
    """SMPL-H vertices (B, V, 3): shape and pose blend shapes, joints
    from the rest shape, the kinematic chain joint by joint, linear blend
    skinning, then the translation."""
    B, J = pose.shape[0], len(body["parents"])
    rot = rodrigues(pose.reshape(B, J, 3))
    nb = betas.shape[-1]
    shaped = body["v_template"] + _mm("vks,bs->bvk",
                                      body["shapedirs"][:, :, :nb], betas)
    joints = _mm("jv,bvk->bjk", body["j_regressor"], shaped)
    eye = torch.eye(3, dtype=pose.dtype, device=pose.device)
    posed = shaped + _mm("vkp,bp->bvk", body["posedirs"],
                         (rot[:, 1:] - eye).reshape(B, -1))
    g_rot, g_t = [rot[:, 0]], [joints[:, 0]]
    for j in range(1, J):
        p = body["parents"][j]
        g_rot.append(g_rot[p] @ rot[:, j])
        g_t.append(g_t[p] + (g_rot[p] @ (joints[:, j] - joints[:, p])[
            ..., None])[..., 0])
    g_rot, g_t = torch.stack(g_rot, 1), torch.stack(g_t, 1)
    t_skin = g_t - (g_rot @ joints[..., None])[..., 0]
    a_rot = _mm("vj,bjrc->bvrc", body["weights"], g_rot)
    a_t = _mm("vj,bjr->bvr", body["weights"], t_skin)
    return (a_rot @ posed[..., None])[..., 0] + a_t + trans[:, None, :]


def _diff2(x):
    return ((x[1:-1] - x[:-2]) - (x[2:] - x[1:-1])) ** 2


def _diff1(x):
    return (x[1:] - x[:-1]) ** 2


def smplt_loss(body: dict, leaves: dict, kpts, pose_init, fit: dict,
               decay: float, frames: slice = slice(None)) -> torch.Tensor:
    """The SMPL-T fitter's weighted loss: 2D keypoints (pixels, by their
    confidence), vertex and pose acceleration, the pose and hand priors,
    the distance to the initial body pose; w / (1 + decay). `frames`
    picks the frames the means run over (the half-batch fault)."""
    lv = {k: v[frames] for k, v in leaves.items()}
    kpts, pose_init = kpts[frames], pose_init[frames]
    pose = torch.cat([lv["global_pose"], lv["body_pose"], lv["hand_pose"]],
                     -1)
    betas = torch.cat([lv["top_betas"], lv["other_betas"]], -1)
    verts = skin(body, pose, betas, lv["trans"])
    j = _mm("jv,bvk->bjk", body["body25"], verts)
    z = j[..., 2:3]
    proj = torch.cat([j[..., 0:1] * fit["fx"] / z + fit["cx"],
                      j[..., 1:2] * fit["fy"] / z + fit["cy"]], -1)
    accel = torch.as_tensor(ACCEL_WEIGHTS, device=pose.device)
    dp = RS.low(pose[:, 3:66] - body["prior_mean"])
    dh = pose[:, 66:] - body["hand_mean"]
    wp = dp @ RS.low(body["prior_prec"])
    wh = torch.cat([RS.low(dh[:, :45]) @ RS.low(body["lh_prec"]),
                    RS.low(dh[:, 45:]) @ RS.low(body["rh_prec"])], 1)
    terms = dict(
        kpts=((proj - kpts[..., :2]) ** 2 * kpts[..., 2:3]).mean(),
        temp=_diff2(verts).mean(),
        ptemp=(_diff2(pose[:, :66]) * accel).mean(),
        pose=(wp * wp).sum(1).mean(),
        hand=(wh * wh).sum(1).mean(),
        pinit=((pose_init[:, 3:66] - lv["body_pose"]) ** 2).mean())
    return sum(terms[k] * fit[f"w_{k}"] for k in terms) / (1.0 + decay)


def stage1_start(fab: dict, fit: dict, frames: int, device) -> tuple:
    """The fit's start from the sequence alone: (leaves, keypoints,
    initial pose). The mocap pose's body part with the mean hands, the
    first shape coefficient at 2.2, the translation back-projected from
    the person mask's box centre to the fitter's depth; keypoints under
    the confidence tolerance zeroed."""
    kp = np.asarray(fab["kpts"][:frames], np.float32).copy()
    kp[kp[..., 2] < KPTS_TOL] = 0.0
    centres = []
    for m in fab["person_mask"][:frames]:
        ys, xs = np.nonzero(m)
        centres.append([m.shape[1] / 2, m.shape[0] / 2] if len(xs) < 10 else
                       [(xs.max() + xs.min()) / 2, (ys.max() + ys.min()) / 2])
    c = np.asarray(centres, np.float32)
    d = fit["smpl_depth"]
    trans = np.stack([(c[:, 0] - fit["cx"]) / fit["fx"] * d,
                      (c[:, 1] - fit["cy"]) / fit["fy"] * d,
                      np.full(len(c), d, np.float32)], -1).astype(np.float32)
    hands = _pkl(os.path.join(fab["assets"], "priors", "lh_prior.pkl"))["mean"]
    hands = np.concatenate([np.reshape(hands, -1), np.reshape(_pkl(
        os.path.join(fab["assets"], "priors", "rh_prior.pkl"))["mean"], -1)])
    pose = np.zeros((frames, 156), np.float32)
    pose[:, :66] = np.asarray(fab["mocap_pose"][:frames])[:, :66]
    pose[:, 66:] = hands
    betas = np.zeros((frames, 10), np.float32)
    betas[:, 0] = BETA0

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)
    leaves = dict(global_pose=t(pose[:, :3]), body_pose=t(pose[:, 3:66]),
                  hand_pose=t(pose[:, 66:]), top_betas=t(betas[:, :2]),
                  other_betas=t(betas[:, 2:]), trans=t(trans))
    return leaves, t(kp), t(pose)


def follow_stage1(body: dict, start: tuple, fit: dict, steps: int,
                  frames: slice = slice(None), update: bool = True) -> list:
    """The loss before each of the fit's first `steps` steps: phase 1
    (global pose, top betas, translation at lr_global) for global_iters
    iterations, then phase 2 (all but the hands at lr_all) with a fresh
    Adam; the decay of step s is (s // steps_per_iter) // 3. Without
    update, the leaves never move (the unchanged-state fault)."""
    leaves0, kpts, pose_init = start
    spi, n1 = fit["steps_per_iter"], fit["global_iters"] * fit["steps_per_iter"]
    leaves = {k: v.clone().requires_grad_(True) for k, v in leaves0.items()}
    losses, opt, phase = [], None, 0
    for s in range(steps):
        want = 1 if s < n1 else 2
        if want != phase:
            phase = want
            lr = fit["lr_global"] if phase == 1 else fit["lr_all"]
            opt = RS.Adam(leaves, lr)
        loss = smplt_loss(body, leaves, kpts, pose_init, fit,
                          float((s // spi) // 3), frames)
        losses.append(float(loss.detach()))
        if s + 1 == steps:
            break
        grads = torch.autograd.grad(loss, list(leaves.values()))
        if update:
            opt.step({k: (g if k in STAGE1_ACTIVE[phase]
                          else torch.zeros_like(g))
                      for k, g in zip(leaves, grads)})
    return losses


def so3(m: torch.Tensor) -> torch.Tensor:
    """The nearest proper rotation: U diag(1, 1, det(U V^T)) V^T."""
    u, _, vt = torch.linalg.svd(m)
    det = torch.linalg.det(u @ vt)
    d = torch.ones(m.shape[:-1], dtype=m.dtype, device=m.device)
    d = torch.cat([d[..., :2], det[..., None]], -1)
    return (u * d[..., None, :]) @ vt


def object_loss(p, scfg: dict, cache: dict, start: dict, leaves: dict,
                joint: dict, tie, frames: slice = slice(None)):
    """The object phase's weighted loss at decay 1: SIF-Net's object
    distance (clamped) at the template's points under the rotation and
    translation, weighted by visibility; the scale prior; the object's
    acceleration and velocity; the centre anchor where its weight is not
    0."""
    b = frames
    rot = so3(leaves["obj_r"][b] + 1e-4 * tie)
    s = start["obj_s"][b]
    pts = (torch.bmm(RS.low(start["points"][b]), RS.low(rot))
           + leaves["obj_t"][b][:, None, :]) * s[:, None, None]
    c = {k: ([[f[b] for f in v] for v in cache[k]] if k == "tp" else
             [f[b] for f in cache[k]] if isinstance(cache[k], list)
             else cache[k][b]) for k in cache}
    df = RS.query(p, scfg, c, pts, start["cc"][b], start["bc"][b],
                  heads=("df",))[-1]["df"][..., 1]
    df = torch.clamp(df, max=joint["df_o_clamp"])
    terms = dict(object=(df.mean(-1) * start["occ"][b]).mean(),
                 scale=((s - joint["obj_scale"]) ** 2).mean())
    if pts.shape[0] >= 4:
        terms["otemp"] = _diff2(pts).mean()
        terms["ovtemp"] = _diff1(pts).mean()
    if joint["w_ocent"]:
        d2 = ((pts.mean(1) - start["obj_t"][b]) ** 2).sum(-1)
        terms["ocent"] = (d2 * start["occ"][b]).mean()
    return sum(terms[k] * joint[f"w_{k}"] for k in terms) / 2.0


def follow_object(p, scfg: dict, cache: dict, start: dict, joint: dict,
                  tie, steps: int, frames: slice = slice(None),
                  update: bool = True) -> list:
    """The loss before each of the object phase's first `steps` steps:
    rotation at lr_obj_r and translation at lr_obj_t, one Adam."""
    leaves = {k: start[k].clone().requires_grad_(True)
              for k in ("obj_r", "obj_t")}
    opts = {"obj_r": RS.Adam({"obj_r": leaves["obj_r"]}, joint["lr_obj_r"]),
            "obj_t": RS.Adam({"obj_t": leaves["obj_t"]}, joint["lr_obj_t"])}
    losses = []
    for s in range(steps):
        loss = object_loss(p, scfg, cache, start, leaves, joint, tie, frames)
        losses.append(float(loss.detach()))
        if s + 1 == steps:
            break
        grads = torch.autograd.grad(loss, list(leaves.values()))
        if update:
            for (k, g) in zip(leaves, grads):
                opts[k].step({k: g})
    return losses


def part_labels(assets: str, verts: int, device) -> torch.Tensor:
    """Each vertex's part index, the parts numbered in the order of the
    part file."""
    parts = _pkl(os.path.join(assets, "smpl_parts_dense.pkl"))
    labels = np.zeros(verts, np.int64)
    for i, name in enumerate(parts):
        labels[np.asarray(parts[name]).reshape(-1)] = i
    return torch.as_tensor(labels, device=device)


def smpl_phase_loss(p, scfg: dict, body: dict, labels, cache: dict,
                    start: dict, leaves: dict, joint: dict,
                    frames: slice = slice(None)) -> torch.Tensor:
    """The weighted loss of stage 6's first SMPL phase at decay 1:
    SIF-Net's body distance (clamped) and the part cross-entropy at the
    body's vertices (evenly strided where smpl_query_points says so, the
    cross-entropy scaled back to every vertex), the pose and hand priors,
    the mid-hip's depth against z0, the body pose's distance to the
    start's, the vertices' acceleration."""
    b = frames
    lv = {k: v[b] for k, v in leaves.items()}
    pose = torch.cat([lv["global_pose"], lv["body_pose"], lv["hand_pose"]],
                     -1)
    betas = torch.cat([lv["top_betas"], lv["other_betas"]], -1)
    verts = skin(body, pose, betas, lv["trans"])
    V, nq = verts.shape[1], joint["smpl_query_points"]
    qverts, qlab, ce_scale = verts, labels, 1.0
    if nq and nq < V:
        idx = torch.as_tensor(np.linspace(0, V - 1, nq, dtype=np.int64),
                              device=verts.device)
        qverts, qlab, ce_scale = verts[:, idx], labels[idx], V / float(nq)
    c = {k: ([[f[b] for f in v] for v in cache[k]] if k == "tp" else
             [f[b] for f in cache[k]] if isinstance(cache[k], list)
             else cache[k][b]) for k in cache}
    pred = RS.query(p, scfg, c, qverts, start["cc"][b], start["bc"][b],
                    heads=("df", "parts"))[-1]
    df = torch.clamp(pred["df"][..., 0], max=joint["df_h_clamp"])
    logp = torch.log_softmax(pred["parts"], -1)
    ce = -logp.gather(-1, qlab.expand(qverts.shape[:2])[..., None])[..., 0]
    j = _mm("jv,bvk->bjk", body["body25"], verts)
    dp = RS.low(pose[:, 3:66] - body["prior_mean"])
    dh = pose[:, 66:] - body["hand_mean"]
    wp = dp @ RS.low(body["prior_prec"])
    wh = torch.cat([RS.low(dh[:, :45]) @ RS.low(body["lh_prec"]),
                    RS.low(dh[:, 45:]) @ RS.low(body["rh_prec"])], 1)
    terms = dict(
        df_h=df.mean(), part=ce.sum(-1).mean() * ce_scale,
        pose=(wp * wp).sum(1).mean(), hand=(wh * wh).sum(1).mean(),
        smplz=((j[:, MID_HIP, 2] - joint["z0"]) ** 2).mean(),
        pinit=((lv["body_pose"] - start["body_pose"][b]) ** 2).sum(-1).mean())
    if verts.shape[0] >= 4:
        terms["stemp"] = _diff2(verts).mean()
    return sum(terms[k] * joint[f"w_{k}"] for k in terms) / 2.0


def follow_smpl_phase(p, scfg: dict, body: dict, labels, cache: dict,
                      start: dict, joint: dict, steps: int,
                      frames: slice = slice(None),
                      update: bool = True) -> list:
    """The loss before each of the first `steps` steps of stage 6's
    first SMPL phase: the top shape coefficients and the translation at
    lr_betas, one Adam; the other leaves frozen."""
    leaves = {k: start[k].clone().requires_grad_(k in SMPL_PHASE1)
              for k in SMPLT_LEAVES}
    opt = RS.Adam({k: leaves[k] for k in SMPL_PHASE1}, joint["lr_betas"])
    losses = []
    for s in range(steps):
        loss = smpl_phase_loss(p, scfg, body, labels, cache, start, leaves,
                               joint, frames)
        losses.append(float(loss.detach()))
        if s + 1 == steps:
            break
        grads = torch.autograd.grad(loss, [leaves[k] for k in SMPL_PHASE1])
        if update:
            opt.step(dict(zip(SMPL_PHASE1, grads)))
    return losses


def trace_gap(got: list, ref: list) -> float:
    """The largest |got - ref| / |ref| over the steps' losses."""
    return max(abs(g - r) / max(abs(r), 1e-30) for g, r in zip(got, ref))
