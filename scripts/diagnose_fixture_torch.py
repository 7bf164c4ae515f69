"""Per-stage object diagnostics of a run_fixture_eval_torch.py run folder.

The port's counterpart of scripts/diagnose_fixture.py. It locates where
object accuracy is lost: the stage-4 neural center, the rotation init
from the neural PCA axes (the stage-5 input), or the final stage-6 pose;
and it reports the SMPL error unaligned. It writes
<run>/diagnostics_torch[_heldout][_PRESET][_TAG].json, beside the JAX
script's diagnostics*.json.

The stage-4 neural center is relative to the body center; tracking used
the stage-2 smoothed body, which the pack does not keep, so the center is
rebuilt from the pack's stage-6a body and carries a cm-scale bias: good
enough to attribute a decimetre error, not for cm-accurate stage-4
numbers.

Usage: python scripts/diagnose_fixture_torch.py --run fixture_run
       [--net-preset tiny] [--recon-tag TAG] [--heldout] [--device cpu]
"""
import argparse
import json
import os.path as osp
import sys

import numpy as np

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", default="fixture_run")
    ap.add_argument("--net-preset", default="tiny",
                    help="which run_fixture_eval_torch preset's recon to "
                         "diagnose (non-tiny paths carry a _PRESET suffix)")
    ap.add_argument("--recon-tag", default="",
                    help="extra recon-folder suffix of a "
                         "run_fixture_eval_torch --recon-tag variant")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu only when asked for")
    ap.add_argument("--heldout", action="store_true",
                    help="diagnose the held-out-motion recon "
                         "(fixture2_meta + recon_heldout paths)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from vistracker_tpu_torch.cli.real_track import resolve_device
    from vistracker_tpu_torch.core.landmarks import load_landmarks
    from vistracker_tpu_torch.core.smpl import lbs_forward, load_smpl_pkl
    from vistracker_tpu_torch.data.packed import load_packed_recon
    from vistracker_tpu_torch.eval.evaluator import rotation_errors_deg
    from vistracker_tpu_torch.fit.joint import init_object_orientation
    from vistracker_tpu_torch.utils.mesh import compute_pca_axes, load_ply

    device = resolve_device(args.device)
    meta = "fixture2_meta.npz" if args.heldout else "fixture_meta.npz"
    m = np.load(osp.join(args.run, meta))
    fx = {k: m[k] for k in m.files}
    seq_name = str(fx["seq_name"])
    psuf = "" if args.net_preset == "tiny" else f"_{args.net_preset}"
    rsuf = psuf + (f"_{args.recon_tag}" if args.recon_tag else "")
    rdir = ("recon_heldout" if args.heldout else "recon") + rsuf
    recon = load_packed_recon(osp.join(args.run, rdir, "recon_fixture",
                                       f"{seq_name}_k1.pkl"))
    gt = load_packed_recon(str(fx["gt_pack"]))
    T = recon.num_frames

    rot_gt = np.asarray(fx["rot_gt"])            # (T, 3, 3) real rotations
    t_gt = np.asarray(fx["obj_trans_gt"])        # (T, 3)
    occ = np.asarray(fx["occ_ratios"])
    occ = occ[:, 1] if occ.ndim == 2 else occ
    vis = occ > 0.5

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    model = load_smpl_pkl(str(fx["model_pkl"]), device)
    lms = load_landmarks(osp.join(args.run, "data", "assets"), device)
    with torch.no_grad():
        verts = lbs_forward(model, dev(recon.poses), dev(recon.betas),
                            dev(recon.trans))[0]
        bc = lms.smpl_center(verts).cpu().numpy()
        gt_verts = lbs_forward(model, dev(gt.poses), dev(gt.betas),
                               dev(gt.trans))[0].cpu().numpy()
    verts = verts.cpu().numpy()
    t_neural = np.asarray(recon.neural_trans) + bc
    pred_vis = np.asarray(recon.neural_visibility).reshape(-1)

    temp_v, _ = load_ply(osp.join(str(fx["objects_root"]), "boxmedium",
                                  "boxmedium.ply"))
    temp_v = temp_v - temp_v.mean(0)
    pca_init = compute_pca_axes(temp_v)
    # init_object_orientation gives the packed (row-vector) convention;
    # transposed to real rotations as track does before smoothing
    with torch.no_grad():
        rot_init = init_object_orientation(
            torch.as_tensor(np.asarray(recon.neural_pca, np.float32)),
            torch.as_tensor(pca_init, dtype=torch.float32).expand(T, 3, 3)
        ).numpy().transpose(0, 2, 1)
    # the final stage-6 pose (the packed obj_angles are transposed)
    rot_fin = np.asarray(recon.obj_angles).transpose(0, 2, 1)
    t_fin = np.asarray(recon.obj_trans)

    def stats(name, err):
        out = {}
        for label, msk in (("all", np.ones(T, bool)), ("visible", vis),
                           ("occluded", ~vis)):
            out[label] = float(np.mean(err[msk])) if msk.any() else None
        fmt = lambda v: "n/a" if v is None else f"{v:.4g}"  # noqa: E731
        print(f"{name:38s} all={fmt(out['all'])}  "
              f"vis={fmt(out['visible'])}  occ={fmt(out['occluded'])}")
        return out

    print(f"frames={T}, visible={int(vis.sum())}, occluded={int((~vis).sum())}")
    print(f"GT box extent: {temp_v.max(0) - temp_v.min(0)}")
    rep = {}
    rep["neural_center_m"] = stats("stage4 neural center err (m)",
                                   np.linalg.norm(t_neural - t_gt, axis=1))
    rep["pred_vis_corr"] = float(np.corrcoef(pred_vis, occ)[0, 1])
    print(f"predicted-visibility corr with GT occ: {rep['pred_vis_corr']:.3f}")
    rep["rot_init_deg"] = stats("stage5-in PCA rotation err (deg)",
                                rotation_errors_deg(rot_init, rot_gt))
    rep["rot_final_deg"] = stats("stage6 final rotation err (deg)",
                                 rotation_errors_deg(rot_fin, rot_gt))
    rep["t_final_m"] = stats("stage6 final center err (m)",
                             np.linalg.norm(t_fin - t_gt, axis=1))
    rep["smpl_v2v_cm"] = float(np.linalg.norm(
        verts - gt_verts, axis=-1).mean() * 100)
    print(f"SMPL raw (unaligned) v2v: {rep['smpl_v2v_cm']:.2f} cm")
    hsuf = "_heldout" if args.heldout else ""
    out = osp.join(args.run, f"diagnostics_torch{hsuf}{rsuf}.json")
    with open(out, "w") as f:
        json.dump(rep, f, indent=2, default=float)
    return rep


if __name__ == "__main__":
    main()
