"""Joint SMPL + object optimization against the neural fields (stage 6),
the metric-critical loop. Port of vistracker_tpu/fit/joint.py.

  * SMPL phase (make_smpl_optimizer): betas + trans (Adam lr .02), then
    all pose and, from the next iteration on, the 2D keypoint term (Adam
    lr .006). Losses: df_h clamped at 0.1, part cross-entropy, priors,
    smplz, pinit, j2d, stemp; decay 1 except it/3 once keypoints are on.
  * Object phases (make_object_optimizer): object only, 15 iterations
    (Adam R lr .002, t lr .006) -> silhouette, 30 iterations (R, t lr
    .006) -> joint, up to 110 iterations (t lr .002, R frozen); every
    object and silhouette term weighted by the frame's visibility;
    temporal terms x10 in the joint phase; contact masks computed ONCE
    from the silhouette phase's result and frozen; 10 Adam steps per
    iteration.
Kept from the reference: SMPL phase 1 has its own Adam while the pose and
keypoint phases SHARE one (the keypoint term switches on by weight, so it
starts with warm moments); each object phase starts with fresh moments; a
frozen leaf gets no gradient at all, not merely a zero learning rate.

Every phase is a host loop of eager Adam steps, so there is no program
to segment (the CLI accepts --segment-iters and ignores it). The
silhouette runs through the coverage kernels
(ops/coverage.py:soft_silhouette_batch) and the contact pairing through
the labelled nearest-neighbour kernel (ops/label_nn.py); on CPU tensors
those run their plain versions. The optional collision term is an
SDF-grid penalty (ops/sdf_grid.py). `optimize_object.term_probe` is
the stage-6 diagnostic: every object term's weighted value and its
gradient w.r.t. obj_t, one term at a time.

With a `shard` (parallel/mesh.py:FrameShard) each rank optimizes its
block of the chunk: the stemp, otemp and ovtemp stencils read a 2-frame
halo, every mean over frames divides by the global (padded) count, the
contact term's pair count is the global one, the loss trace is global
and the early-stop test decides on the all-reduced loss, so every rank
leaves a phase at the same iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..core.landmarks import SMPL_CENTER_JOINT, BodyLandmarks
from ..core.priors import HandPrior, MahalanobisPrior
from ..core.rotations import project_so3
from ..core.smpl import SMPLModel, lbs_forward
from ..ops.coverage import soft_silhouette_batch
from ..ops.label_nn import label_nn, label_nn_plan
from ..ops.sdf_grid import SDFGrid, penetration_loss, sample_sdf
from ..parallel.mesh import (FrameShard, all_reduce_sum, diff_sq_mean,
                             frame_mean)
from ..utils import trace
from .smplt import SMPLTParams

NUM_PARTS = 14

# SVD gradients are undefined when singular values coincide, which is
# exactly the case for a clean rotation matrix. A FIXED perturbation
# breaks the tie and keeps the run deterministic.
_TIE_BREAK = np.array([[0.31, 0.74, 0.17],
                       [0.58, 0.09, 0.93],
                       [0.42, 0.66, 0.25]], np.float32)


def decopose_axis(rot: torch.Tensor) -> torch.Tensor:
    """SO(3) projection with the deterministic tie-breaking perturbation."""
    return project_so3(rot + 1e-4 * torch.as_tensor(_TIE_BREAK,
                                                    device=rot.device))


@dataclasses.dataclass(frozen=True)
class JointFitConfig:
    # SMPL phase: iterations x 10 steps
    iter_betas: int = 1
    iter_pose: int = 1
    iter_kpts: int = 1
    smpl_max_iter: int = 100
    lr_betas: float = 0.02
    lr_pose: float = 0.006
    # object phases
    iter_obj: int = 15
    iter_sil: int = 30
    joint_max_iter: int = 110  # the reference's max_iter(100) + joint_iter(10)
    lr_obj_r: float = 0.002
    lr_obj_t: float = 0.006
    lr_sil: float = 0.006
    lr_joint: float = 0.002
    steps_per_iter: int = 10
    # thresholds
    df_h_clamp: float = 0.1
    df_o_clamp: float = 0.8
    cont_thres: float = 0.08
    z0: float = 2.2
    obj_scale: float = 1.0
    sil_size: int = 256
    # fixed sigma (~1 px at sil_size); the min-edge-line sigmoid has
    # long-range gradients, so no coarse-to-fine anneal is used
    sil_sigma: float = 1.0 / 128.0
    collision: bool = False
    # early stopping (reference semantics); off by default so fixed-budget
    # runs stay deterministic in length
    early_stop: bool = False
    smpl_rel_tol: float = 1e-3
    joint_rel_tol: float = 1e-4
    early_stop_min_frac: float = 0.25
    # query only this many SMPL vertices (evenly strided) in the df/part
    # losses; 0 = all. The CE term is rescaled to keep the loss balance.
    smpl_query_points: int = 0
    # loss weight base constants (w * cst / (1 + decay))
    w_pose: float = 1e-5
    w_hand: float = 1e-5
    w_j2d: float = 0.3 ** 2
    w_object: float = 30.0 ** 2
    w_part: float = 0.05 ** 2
    w_contact: float = 30.0 ** 2
    w_scale: float = 10.0 ** 2
    w_df_h: float = 10.0 ** 2
    w_smplz: float = 30.0 ** 2
    w_mask: float = 0.03 ** 2
    w_ocent: float = 0.0
    w_collide: float = 3.0 ** 2
    w_pinit: float = 5.0 ** 2
    w_trans: float = 10.0 ** 2
    w_stemp: float = 100.0 ** 2
    w_otemp: float = 15.0 ** 2
    w_ovtemp: float = 50.0 ** 2


@dataclasses.dataclass
class SilRefs:
    """Host-prepared occlusion-aware silhouette references."""

    image_ref: torch.Tensor  # (B, S, S) object mask crop in the ROI
    keep_mask: torch.Tensor  # (B, S, S) 1 = scored pixel, 0 = person-occluded
    roi_xyb: torch.Tensor    # (B, 3) ROI square (x, y, side), orig pixels


def paired_parts(labels_h, labels_o, mask_h, mask_o):
    """Contact points by part (labels (B, V) and (B, N_o), masks alike)
    -> (one-hot (B, V, 14), one-hot (B, N_o, 14), pair_ok (B, 14)), each
    one-hot row zero where masked out; pair_ok: frame b has contact
    points of part p on both sides, the pairs the contact term averages
    over."""
    oh_h = F.one_hot(labels_h, NUM_PARTS).float() * mask_h[..., None].float()
    oh_o = F.one_hot(labels_o, NUM_PARTS).float() * mask_o[..., None].float()
    return oh_h, oh_o, (oh_h.sum(1) > 0) & (oh_o.sum(1) > 0)


def chunk_pairs(labels_h, labels_o, mask_h, mask_o,
                shard: FrameShard | None = None):
    """The contact term's denominator under sharding: the chunk's
    (frame, part) pairs with contacts on both sides, summed over the
    ranks (a ratio of sums: each rank's share divides by the whole
    chunk's count). None without a shard: the term counts its own."""
    if shard is None:
        return None
    return all_reduce_sum(paired_parts(labels_h, labels_o, mask_h,
                                       mask_o)[2].sum(), shard.d)


def transform_obj_verts(verts: torch.Tensor, obj_r: torch.Tensor,
                        obj_t: torch.Tensor, obj_s: torch.Tensor):
    """((B, N, 3) @ (B, 3, 3) + t) * s: the ROW-VECTOR convention (v @ R)
    of the packed obj_angles."""
    return (torch.bmm(verts, obj_r) + obj_t[:, None, :]) \
        * obj_s[:, None, None]


def init_object_orientation(tgt_axis: torch.Tensor,
                            src_axis: torch.Tensor) -> torch.Tensor:
    """Relative rotation from template PCA axes to predicted axes:
    pinv(src) @ tgt, projected to SO(3)."""
    return project_so3(torch.linalg.pinv(src_axis) @ tgt_axis)


def _adam_phase(loss_fn: Callable, params: dict, lrs: dict, max_iters: int,
                steps_per_iter: int, decay_fn: Callable,
                rel_tol: float = 0.0, min_iters: float = -1.0,
                shard: FrameShard | None = None, phase: str = "phase"):
    """One optimizer phase: fresh Adam moments, a learning rate per leaf
    (a leaf with rate 0 is frozen: it carries no gradient), up to
    max_iters iterations of steps_per_iter steps, decay_fn(step) passed to
    the loss. With rel_tol > 0 the phase stops after the first iteration
    `it` > min_iters whose closing loss satisfies
    |prev - loss| / |prev| < |prev| * rel_tol (prev starts at 300).
    Sharded, loss_fn gives this rank's share of the loss: the test reads
    the sum over the ranks (the same bits on every rank), and so does the
    returned trace. Returns (params, per-step losses (S,), iterations
    used). Traced as joint.phase:<phase>, each step's forward, backward
    and adam spans under a step span, the steps counted as adam_steps,
    and the early-stop test's read of the loss as early_stop_sync."""
    leaves = {k: v.detach().clone().requires_grad_(lrs.get(k, 0.0) > 0)
              for k, v in params.items()}
    opt = torch.optim.Adam(
        [{"params": [leaves[k]], "lr": lr} for k, lr in lrs.items()
         if lr > 0], betas=(0.9, 0.999), eps=1e-8)
    losses, prev, iters = [], np.float32(300.0), 0
    with trace.span(f"joint.phase:{phase}"):
        for it in range(max_iters):
            for k in range(steps_per_iter):
                with trace.span("step"):
                    opt.zero_grad(set_to_none=True)
                    with trace.span("forward"):
                        loss = loss_fn(leaves, decay_fn(it * steps_per_iter
                                                        + k))
                    with trace.span("backward"):
                        loss.backward()
                    with trace.span("adam"):
                        opt.step()
                    losses.append(loss.detach())
                trace.count("adam_steps")
            iters = it + 1
            if rel_tol > 0:
                with trace.span("early_stop_sync"):
                    last = losses[-1] if shard is None \
                        else all_reduce_sum(losses[-1], shard.d)
                    last = np.float32(last.item())
                rel = np.abs(prev - last) / np.maximum(np.abs(prev),
                                                       np.float32(1e-12))
                done = rel < np.abs(prev) * np.float32(rel_tol) \
                    and it > min_iters
                prev = last
                if done:
                    break
    loss_trace = torch.stack(losses) if losses else torch.zeros(0)
    if shard is not None:
        loss_trace = all_reduce_sum(loss_trace, shard.d)
    return {k: v.detach() for k, v in leaves.items()}, loss_trace, iters


# ---------------------------------------------------------------------------
# SMPL phase
# ---------------------------------------------------------------------------

def make_smpl_optimizer(query_fn, project_fn, model: SMPLModel,
                        landmarks: BodyLandmarks,
                        body_prior: MahalanobisPrior, hand_prior: HandPrior,
                        part_labels: np.ndarray,
                        cfg: JointFitConfig = JointFitConfig(),
                        report_iters: bool = False):
    """-> optimize_smpl(smpl, body_kpts, ctx, shard=None) ->
    (SMPLTParams, losses [, {"smpl": iterations, "smpl_max": budget}]).

    query_fn(ctx, points (B, N, 3)) -> head dict (df (B, N, 2), parts);
    project_fn(ctx, joints (B, J, 3)) -> crop-normalized 2D (B, J, 2).
    `ctx` is whatever those two need per chunk (feature cache, crop and
    body centers). body_kpts (B, 25, 3): crop-normalized x, y and the
    confidence."""
    dev = model.v_template.device
    labels = torch.as_tensor(np.asarray(part_labels), device=dev).long()
    n_verts = len(part_labels)
    if cfg.smpl_query_points and cfg.smpl_query_points < n_verts:
        q_idx = torch.as_tensor(np.linspace(
            0, n_verts - 1, cfg.smpl_query_points, dtype=np.int64),
            device=dev)
        ce_scale = n_verts / float(cfg.smpl_query_points)
        labels_q = labels[q_idx]
    else:
        q_idx, ce_scale, labels_q = None, 1.0, labels

    def loss_terms(p: SMPLTParams, aux, ctx, phase_kpts: bool, shard=None):
        verts = lbs_forward(model, p.pose, p.betas, p.trans)[0]
        qverts = verts if q_idx is None else verts[:, q_idx]
        preds = query_fn(ctx, qverts)
        terms = {}
        terms["df_h"] = frame_mean(torch.clamp(preds["df"][..., 0],
                                               max=cfg.df_h_clamp), shard)
        logp = F.log_softmax(preds["parts"], dim=-1)
        ce = -torch.gather(
            logp, -1, labels_q.expand(qverts.shape[:2])[..., None])[..., 0]
        terms["part"] = frame_mean(ce.sum(-1), shard) * ce_scale
        terms["pose"] = frame_mean(body_prior(p.pose[:, :72]), shard)
        terms["hand"] = frame_mean(hand_prior(p.pose), shard)
        joints = landmarks.body_joints(verts)
        terms["smplz"] = frame_mean(
            (joints[:, SMPL_CENTER_JOINT, 2] - cfg.z0) ** 2, shard)
        terms["pinit"] = frame_mean(
            ((p.body_pose - aux["pose_init"]) ** 2).sum(-1), shard)
        if phase_kpts:
            proj = project_fn(ctx, joints)  # crop-normalized (B, 25, 2)
            err = ((proj - aux["body_kpts"][..., :2]) ** 2).sum(-1)
            terms["j2d"] = frame_mean(err * aux["body_kpts"][..., 2], shard)
        if (verts.shape[0] if shard is None else shard.padded) >= 4:
            terms["stemp"] = diff_sq_mean(verts, 2, shard)
        return terms

    def weighted(terms, decay):
        w = dict(df_h=cfg.w_df_h, part=cfg.w_part, pose=cfg.w_pose,
                 hand=cfg.w_hand, smplz=cfg.w_smplz, pinit=cfg.w_pinit,
                 j2d=cfg.w_j2d, stemp=cfg.w_stemp)
        scale = 1.0 / (1.0 + decay)
        return sum(terms[k] * w[k] * scale for k in terms if k in w)

    spi = cfg.steps_per_iter

    def loss1(pdict, decay, env):
        return weighted(loss_terms(SMPLTParams(**pdict), env["aux"],
                                   env["ctx"], False, env.get("shard")),
                        decay)

    def loss23(pdict, decay_and_kw, env):
        # phases 2 + 3 run in ONE optimizer: the j2d term switches on by
        # weight instead of at a phase boundary
        decay, kw = decay_and_kw
        terms = loss_terms(SMPLTParams(**pdict), env["aux"], env["ctx"],
                           True, env.get("shard"))
        terms["j2d"] = terms["j2d"] * kw
        return weighted(terms, decay)

    kpts_from = cfg.iter_betas + cfg.iter_pose  # global iteration of phase 3

    def decay23(s):
        it = cfg.iter_betas + s // spi  # global iteration counter
        kpts_on = it >= kpts_from
        return (it / 3.0 if kpts_on else 1.0, float(kpts_on))

    zero = {f.name: 0.0 for f in dataclasses.fields(SMPLTParams)}
    # phase 1: betas (top) + trans
    lrs1 = {**zero, "top_betas": cfg.lr_betas, "trans": cfg.lr_betas}
    lrs23 = {**zero, "trans": cfg.lr_pose, "global_pose": cfg.lr_pose,
             "body_pose": cfg.lr_pose, "top_betas": cfg.lr_pose,
             "other_betas": cfg.lr_pose}
    n23 = cfg.iter_pose + cfg.iter_kpts + cfg.smpl_max_iter
    # the reference's gate is global (it > 0.25 max_iter + iter_betas +
    # iter_pose); this is its offset within the merged phase
    min23 = cfg.early_stop_min_frac * cfg.smpl_max_iter + cfg.iter_pose

    def optimize_smpl(smpl: SMPLTParams, body_kpts, ctx=None,
                      shard: FrameShard | None = None):
        env = dict(aux=dict(pose_init=smpl.body_pose.detach(),
                            body_kpts=body_kpts), ctx=ctx, shard=shard)
        pdict = {f.name: getattr(smpl, f.name)
                 for f in dataclasses.fields(SMPLTParams)}
        pdict, l1, _ = _adam_phase(lambda p, d: loss1(p, d, env), pdict,
                                   lrs1, cfg.iter_betas, spi,
                                   lambda s: 1.0, shard=shard, phase="betas")
        pdict, l23, it23 = _adam_phase(
            lambda p, d: loss23(p, d, env), pdict, lrs23, n23, spi, decay23,
            cfg.smpl_rel_tol if cfg.early_stop else 0.0,
            min23 if cfg.early_stop else -1.0, shard=shard, phase="pose")
        out = SMPLTParams(**pdict), torch.cat([l1, l23])
        return out + ({"smpl": it23, "smpl_max": n23},) if report_iters \
            else out

    optimize_smpl.loss1, optimize_smpl.loss23 = loss1, loss23
    return optimize_smpl


# ---------------------------------------------------------------------------
# Object phases
# ---------------------------------------------------------------------------

def make_object_optimizer(query_fn, project_px,
                          cfg: JointFitConfig = JointFitConfig(),
                          report_iters: bool = False,
                          contact_query_fn=None):
    """-> optimize_object(obj_r, obj_t, obj_s, obj_points, smpl_verts,
    labels_h, occ_ratios, sil, sil_verts, sil_faces, ctx, sdf_grid,
    shard=None) ->
    (R (B, 3, 3), t (B, 3), losses [, {"joint": iterations, "joint_max":
    budget}]).

    query_fn(ctx, points (B, N, 3)) -> head dict, of which the per-step
    losses read only "df"; project_px(ctx, points (B, N, 3)) ->
    original-image pixel coords (B, N, 2) for the ROI silhouette.
    contact_query_fn (default: query_fn) is used once per chunk by
    contact_masks and must also return "parts". Per chunk: template
    points (B, N_o, 3), visibility occ_ratios (B,), smpl_verts (B, V, 3)
    (frozen during the object phases), part labels, silhouette refs, the
    silhouette mesh and optionally an SDF grid."""
    contact_query_fn = contact_query_fn or query_fn

    def obj_losses(preds, obj_s, occ, terms, shard=None):
        df_o = torch.clamp(preds["df"][..., 1], max=cfg.df_o_clamp)
        terms["object"] = frame_mean(df_o.mean(-1) * occ, shard)
        terms["scale"] = frame_mean((obj_s - cfg.obj_scale) ** 2, shard)

    def ocent_loss(obj, env, terms):
        """Opt-in (w_ocent > 0) anchor of the transformed object centroid
        to the stage-4 neural center (the initial obj_t), weighted by
        visibility. The release table zeroes this term."""
        if cfg.w_ocent:
            d2 = ((obj.mean(1) - env["ocent_target"]) ** 2).sum(-1)
            terms["ocent"] = frame_mean(d2 * env["occ"], env.get("shard"))

    def temporal(obj, phase_joint, terms, shard=None):
        if (obj.shape[0] if shard is None else shard.padded) >= 4:
            w = 10.0 if phase_joint else 1.0
            terms["otemp"] = diff_sq_mean(obj, 2, shard) * w
            terms["ovtemp"] = diff_sq_mean(obj, 1, shard) * w

    def contact_loss(obj, smpl_verts, labels_h, labels_o, mask_h, mask_o,
                     plans, pairs=None):
        """Part-paired squared chamfer between contact regions: per frame
        and part, the mean squared nearest-neighbour distance of the
        human contact points of the part to the object contact points of
        the same part, plus the reverse; a FLAT mean over all (frame,
        part) pairs of the chunk where both sides are non-empty. Frames
        where either side has no contacts contribute no pair. `plans` are
        the two directions' label_nn plans (contact_plans). `pairs`, when
        given, is the mean's denominator (the chunk's pair count over all
        ranks under sharding: a ratio of sums)."""
        lh_b = labels_h.expand(smpl_verts.shape[:2])
        d_h_b = label_nn(smpl_verts, lh_b, obj, labels_o, mask_o,
                         plans[0])                             # (B, V)
        d_o_b = label_nn(obj, labels_o, smpl_verts, lh_b, mask_h,
                         plans[1])                             # (B, N_o)
        oh_h, oh_o, pair_ok = paired_parts(lh_b, labels_o, mask_h, mask_o)
        cnt_h, cnt_o = oh_h.sum(1), oh_o.sum(1)                   # (B, 14)
        mean_h = torch.einsum("bv,bvp->bp", d_h_b, oh_h) \
            / torch.clamp(cnt_h, min=1.0)
        mean_o = torch.einsum("bn,bnp->bp", d_o_b, oh_o) \
            / torch.clamp(cnt_o, min=1.0)
        per_pair = torch.where(pair_ok, mean_h + mean_o,
                               torch.zeros_like(mean_h))
        return per_pair.sum() / torch.clamp(
            pair_ok.sum() if pairs is None else pairs, min=1)

    def sil_loss(ctx, obj_r, obj_t, obj_s, sil: SilRefs, sil_verts,
                 sil_faces, occ, sigma=None, shard=None):
        """Occlusion-aware ROI silhouette L2."""
        verts = transform_obj_verts(sil_verts, obj_r, obj_t, obj_s)
        px = project_px(ctx, verts)  # (B, V, 2) original-image pixels
        sigma = cfg.sil_sigma if sigma is None else sigma
        ndc = 2.0 * (px - sil.roi_xyb[:, None, :2]) \
            / sil.roi_xyb[:, None, 2:3] - 1.0
        imgs = soft_silhouette_batch(ndc, sil_faces, cfg.sil_size, sigma)
        imgs = imgs * sil.keep_mask
        per_ex = ((imgs - sil.image_ref) ** 2).sum((1, 2))
        return frame_mean(per_ex * occ, shard)

    spi = cfg.steps_per_iter

    def _weighted(terms, decay):
        w = dict(object=cfg.w_object, scale=cfg.w_scale,
                 otemp=cfg.w_otemp, ovtemp=cfg.w_ovtemp,
                 mask=cfg.w_mask, trans=cfg.w_trans,
                 contact=cfg.w_contact, collide=cfg.w_collide,
                 ocent=cfg.w_ocent)
        s = 1.0 / (1.0 + decay)
        return sum(terms[k] * w[k] * s for k in terms if k in w)

    def transformed(p, env):
        r = decopose_axis(p["obj_r"])
        return transform_obj_verts(env["obj_points"], r, p["obj_t"],
                                   env["obj_s"]), r

    # ---------------- phase 1: object only ----------------
    def loss_obj(p, decay, env):
        obj, _ = transformed(p, env)
        terms, shard = {}, env.get("shard")
        obj_losses(query_fn(env["ctx"], obj), env["obj_s"], env["occ"],
                   terms, shard)
        ocent_loss(obj, env, terms)
        temporal(obj, False, terms, shard)
        return _weighted(terms, decay)

    # ---------------- phase 2: silhouette ----------------
    def loss_sil(p, decay, env):
        obj, r = transformed(p, env)
        terms, shard = {}, env.get("shard")
        terms["mask"] = sil_loss(env["ctx"], r, p["obj_t"], env["obj_s"],
                                 env["sil"], env["sil_verts"],
                                 env["sil_faces"], env["occ"], shard=shard)
        terms["scale"] = frame_mean((env["obj_s"] - cfg.obj_scale) ** 2,
                                    shard)
        terms["trans"] = frame_mean((p["obj_t"] - env["trans_init"]) ** 2,
                                    shard)
        temporal(obj, False, terms, shard)
        return _weighted(terms, decay)

    # ---------------- phase 3: joint ----------------
    def loss_joint(p, decay, env):
        obj, r = transformed(p, env)
        terms, shard = {}, env.get("shard")
        obj_losses(query_fn(env["ctx"], obj), env["obj_s"], env["occ"],
                   terms, shard)
        ocent_loss(obj, env, terms)
        temporal(obj, True, terms, shard)
        terms["contact"] = contact_loss(obj, env["smpl_verts"],
                                        env["labels_h"], env["labels_o"],
                                        env["mask_h"], env["mask_o"],
                                        env["nn_plans"], env.get("pairs"))
        if cfg.collision and "sdf_grid" in env:
            local = torch.bmm(
                env["smpl_verts"] / env["obj_s"][:, None, None]
                - p["obj_t"][:, None, :], r.transpose(-1, -2))
            terms["collide"] = frame_mean(torch.clamp(
                sample_sdf(env["sdf_grid"], local), max=0.0).square(), shard)
        return _weighted(terms, decay)

    @torch.no_grad()
    def contact_masks(params, env):
        """Contact distances computed ONCE from the silhouette phase's
        result and frozen: (object part labels (B, N_o), human contact
        mask (B, V), object contact mask (B, N_o))."""
        obj_now, _ = transformed(params, env)
        preds_o = contact_query_fn(env["ctx"], obj_now)
        labels_o = preds_o["parts"].argmax(-1)
        preds_h = contact_query_fn(env["ctx"], env["smpl_verts"])
        return (labels_o, preds_h["df"][..., 1] < cfg.cont_thres,
                preds_o["df"][..., 0] < cfg.cont_thres)

    def contact_plans(smpl_verts, labels_h, labels_o, mask_h, mask_o):
        """The contact loss's two label_nn plans (human -> object, object
        -> human), made once from the frozen contact masks and reused by
        every joint step."""
        lh_b = labels_h.expand(smpl_verts.shape[:2])
        return (label_nn_plan(lh_b, labels_o, mask_o),
                label_nn_plan(labels_o, lh_b, mask_h))

    def decay2(s):
        return float(s // spi) + 1.0

    def decay_j(s):
        return float((s + (cfg.iter_obj + cfg.iter_sil) * spi) // spi
                     - cfg.iter_obj + 1) / 3.0

    lrs_1 = {"obj_r": cfg.lr_obj_r, "obj_t": cfg.lr_obj_t}
    lrs_2 = {"obj_r": cfg.lr_sil, "obj_t": cfg.lr_sil}
    lrs_j = {"obj_r": 0.0, "obj_t": cfg.lr_joint}
    # the reference's early-stop gate is global (it > 0.25 max_iter with it
    # already past iter_obj + iter_sil), so the joint phase may stop on
    # its first converged iteration
    min_j = max(0.0, cfg.early_stop_min_frac * cfg.joint_max_iter
                - (cfg.iter_obj + cfg.iter_sil))

    def _all_terms(p, env):
        """Every obj_t-coupled object term, WEIGHTED at decay 0, as a dict
        of scalars: the joint phase's terms always; the silhouette term
        when env carries sil refs; contact when it carries the frozen
        masks (labels_o, mask_h, mask_o; nn_plans are made here when it
        has none); collision when it carries an sdf_grid. ocent is
        computed whatever the run's w_ocent and reported at weight
        max(w_ocent, 1): the probe measures its pull before it is
        switched on."""
        obj, r = transformed(p, env)
        terms = {}
        obj_losses(query_fn(env["ctx"], obj), env["obj_s"], env["occ"],
                   terms)
        if "ocent_target" in env:
            d2 = ((obj.mean(1) - env["ocent_target"]) ** 2).sum(-1)
            terms["ocent"] = (d2 * env["occ"]).mean()
        temporal(obj, True, terms)
        if "labels_o" in env:
            labels_h = torch.as_tensor(np.asarray(env["labels_h"]),
                                       device=obj.device).long()
            plans = env.get("nn_plans") or contact_plans(
                env["smpl_verts"], labels_h, env["labels_o"], env["mask_h"],
                env["mask_o"])
            terms["contact"] = contact_loss(
                obj, env["smpl_verts"], labels_h, env["labels_o"],
                env["mask_h"], env["mask_o"], plans)
        if "sil" in env:
            terms["mask"] = sil_loss(env["ctx"], r, p["obj_t"], env["obj_s"],
                                     env["sil"], env["sil_verts"],
                                     env["sil_faces"], env["occ"])
        if "sdf_grid" in env:
            local = torch.bmm(
                env["smpl_verts"] / env["obj_s"][:, None, None]
                - p["obj_t"][:, None, :], r.transpose(-1, -2))
            terms["collide"] = penetration_loss(env["sdf_grid"], local)
        w = dict(object=cfg.w_object, otemp=cfg.w_otemp,
                 ovtemp=cfg.w_ovtemp, mask=cfg.w_mask,
                 contact=cfg.w_contact, collide=cfg.w_collide,
                 ocent=max(cfg.w_ocent, 1.0))
        return {k: terms[k] * w[k] for k in terms if k in w}

    def term_probe(params, env):
        """Per-term value and gradient w.r.t. obj_t: {term: (scalar value,
        (B, 3) gradient)}, names sorted. The gradient is that of the WHOLE
        weighted term w.r.t. each frame's translation, so for coupled
        terms (temporal, contact's flat pair mean) it is the true
        per-frame pull, cross-frame coupling included: a term helps frame
        i's translation iff -grad[i] points toward the true one. One
        forward of every term, then torch.autograd.grad one term at a
        time."""
        obj_t = params["obj_t"].detach().clone().requires_grad_(True)
        terms = _all_terms({"obj_r": params["obj_r"].detach(),
                            "obj_t": obj_t}, env)
        out = {}
        for name in sorted(terms):
            grad, = torch.autograd.grad(terms[name], obj_t,
                                        retain_graph=True)
            out[name] = (terms[name].detach(), grad)
        return out

    def optimize_object(obj_r, obj_t, obj_s, obj_points, smpl_verts,
                        labels_h, occ_ratios, sil: SilRefs, sil_verts,
                        sil_faces, ctx=None, sdf_grid: SDFGrid | None = None,
                        shard: FrameShard | None = None):
        params = {"obj_r": obj_r, "obj_t": obj_t}
        env = dict(obj_points=obj_points, obj_s=obj_s, occ=occ_ratios,
                   ocent_target=obj_t.detach(), ctx=ctx, shard=shard)
        params, l1, _ = _adam_phase(lambda p, d: loss_obj(p, d, env), params,
                                    lrs_1, cfg.iter_obj, spi, lambda s: 1.0,
                                    shard=shard, phase="obj")

        env2 = dict(env, sil=sil, sil_verts=sil_verts, sil_faces=sil_faces,
                    trans_init=params["obj_t"].detach())
        params, l2, _ = _adam_phase(lambda p, d: loss_sil(p, d, env2),
                                    params, lrs_2, cfg.iter_sil, spi, decay2,
                                    shard=shard, phase="sil")

        env3 = dict(env, smpl_verts=smpl_verts, labels_h=torch.as_tensor(
            np.asarray(labels_h), device=obj_t.device).long())
        if cfg.collision and sdf_grid is not None:
            env3["sdf_grid"] = sdf_grid
        with trace.span("contact_plans"):
            labels_o, mask_h, mask_o = contact_masks(params, env3)
            env3.update(labels_o=labels_o, mask_h=mask_h, mask_o=mask_o,
                        nn_plans=contact_plans(smpl_verts, env3["labels_h"],
                                               labels_o, mask_h, mask_o))
            env3["pairs"] = chunk_pairs(
                env3["labels_h"].expand(smpl_verts.shape[:2]), labels_o,
                mask_h, mask_o, shard)
        params, l3, it_j = _adam_phase(
            lambda p, d: loss_joint(p, d, env3), params, lrs_j,
            cfg.joint_max_iter, spi, decay_j,
            cfg.joint_rel_tol if cfg.early_stop else 0.0,
            min_j if cfg.early_stop else -1.0, shard=shard, phase="joint")

        with torch.no_grad():
            r_final = decopose_axis(params["obj_r"])
        out = r_final, params["obj_t"], torch.cat([l1, l2, l3])
        return out + ({"joint": it_j, "joint_max": cfg.joint_max_iter},) \
            if report_iters else out

    optimize_object.loss_obj, optimize_object.loss_sil = loss_obj, loss_sil
    optimize_object.loss_joint = loss_joint
    optimize_object.contact_masks = contact_masks
    optimize_object.contact_plans = contact_plans
    optimize_object.term_probe = term_probe
    return optimize_object
