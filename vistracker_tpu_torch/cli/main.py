"""vistracker_tpu_torch command line.

    python -m vistracker_tpu_torch.cli.main track \
        --seq <BEHAVE sequence> --smpl-model <SMPLH pkl> --assets <dir> \
        --objects-root <object templates> \
        --sifnet-ckpt <tar | experiment dir | random> \
        --infiller-ckpt <tar | random> \
        [--smoothnet-smpl-ckpt <tar | random>] \
        [--smoothnet-objrot-ckpt <tar | random>] [--device cpu]

    python -m vistracker_tpu_torch.cli.main evaluate \
        (--split <json> --gt-root <dir> --objects-root <dir> \
         [--recon-root <dir>] [--save-name <name>] \
         | --recon <pkl> | --recon-seq <seq dir>) \
        [--gt <pkl> --template <ply>] \
        --smpl-model <SMPLH pkl> [--window 300] [--smpl-only] [--angles] \
        [--out results] [--device cpu]
    python -m vistracker_tpu_torch.cli.main unpack --packed <pkl> --seq <dir>
    python -m vistracker_tpu_torch.cli.main pack --seq <dir> --out <pkl>
    python -m vistracker_tpu_torch.cli.main rename-masks --seq <dir> \
        --mask-path <dir>

`track` and `evaluate` run on the GPU (`--device cuda`, the default)
unless `--device cpu` is given; without a GPU a cuda run raises. The
flags carry the names and defaults of the JAX package's subcommands
(its `--cpu` is `--device cpu` here); what the port does not have yet is
refused by cli/real_track.py:check_supported.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vistracker-torch",
                                description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("track", help="tracking pipeline (stages 1-6 and "
                                      "the pack)")
    tr.add_argument("--seq", required=True, help="BEHAVE sequence folder")
    tr.add_argument("--out", default="track_out")
    tr.add_argument("--device", default="cuda",
                    help="torch device; cpu only when asked for")
    tr.add_argument("--dataset", choices=["behave", "intercap"],
                    default="behave", help="camera model")
    tr.add_argument("--kid", type=int, default=1)
    tr.add_argument("--start", type=int, default=0)
    tr.add_argument("--end", type=int, default=None)
    tr.add_argument("--chunk-size", type=int, default=96)
    tr.add_argument("--crop-size", type=int, default=1200)
    tr.add_argument("--net-size", type=int, default=512)
    tr.add_argument("--save-name", default="track")
    tr.add_argument("--smpl-model", required=True, help="SMPL-H model pkl")
    tr.add_argument("--assets", default=os.environ.get(
        "VISTRACKER_ASSETS", "assets"))
    tr.add_argument("--sifnet-ckpt", required=True,
                    help="tri-vis-l2 checkpoint (torch tar or experiment "
                         "dir), or 'random' for untrained weights")
    tr.add_argument("--objects-root", help="object template folder")
    tr.add_argument("--infiller-ckpt",
                    help="HVOP-Net (cmf-k4-lrot) checkpoint, or 'random'")
    tr.add_argument("--smoothnet-smpl-ckpt",
                    help="stage-2 SmoothNet checkpoint or 'random'; stage 2 "
                         "runs only when given")
    tr.add_argument("--smoothnet-objrot-ckpt",
                    help="stage-5 object-rotation SmoothNet checkpoint or "
                         "'random'; the smoothing runs only when given")
    tr.add_argument("--segment-iters", type=int, default=0,
                    help="accepted for the JAX package's command lines; the "
                         "stage-6 phases are host loops here, so it changes "
                         "nothing")
    tr.add_argument("--collision", action="store_true",
                    help="human-object interpenetration term in the stage-6 "
                         "joint phase (SDF-grid penalty, ops/sdf_grid.py); "
                         "builds the template SDF grid once per sequence")
    tr.add_argument("--sdf-res", type=int, default=64,
                    help="template SDF grid resolution for --collision")
    tr.add_argument("--ocent", type=float, default=0.0,
                    help="weight of the object-center anchor term in the "
                         "stage-6 object and joint phases; 0 = off, the "
                         "reference release's value")
    tr.add_argument("--early-stop", action="store_true",
                    help="enable the stage-6 relative-loss early-stop gates "
                         "(default off: fixed budgets are reference parity)")
    tr.add_argument("--smpl-query-points", type=int, default=0,
                    help="subsample SMPL vertices in the stage-6 df losses "
                         "(0 = all, reference parity)")
    tr.add_argument("--shard-frames", action="store_true",
                    help="multi-device frame sharding (refused: ROADMAP.md "
                         "Queue 1 item 6)")
    tr.add_argument("--robust-centers", action="store_true",
                    help="median instead of mean aggregation of the neural "
                         "object centers/pca over surface points")
    tr.add_argument("--fast-gen", dest="fast_gen", action="store_true",
                    default=True, help="stage-4 funnel harvest (default)")
    tr.add_argument("--no-fast-gen", dest="fast_gen", action="store_false",
                    help="reference-budget harvest (3 rounds x 10 "
                         "projection steps, no prefilter)")
    tr.add_argument("--cache-dtype", choices=("float32", "bfloat16"),
                    default="float32",
                    help="SIF-Net feature-cache storage dtype")
    tr.add_argument("--tiny-nets", action="store_true",
                    help="alias for --net-preset tiny")
    tr.add_argument("--net-preset", choices=("tiny", "small", "release"),
                    default="release")
    tr.add_argument("--redo", action="store_true",
                    help="re-run even if the packed output exists")
    tr.add_argument("--neural-only", action="store_true",
                    help="stop after stage 4 and pack the neural outputs")

    ev = sub.add_parser("evaluate", help="windowed eval of packed recon vs GT")
    ev.add_argument("--recon", help="packed recon pkl (single-sequence mode)")
    ev.add_argument("--gt", help="packed GT pkl (single-sequence mode)")
    ev.add_argument("--template", help="object template ply (single-seq)")
    ev.add_argument("--split", help="json with {'seqs': [...]}")
    ev.add_argument("--save-name", default="track",
                    help="recon name: "
                         "<recon-root>/recon_<name>/<seq>_k<tid>.pkl")
    ev.add_argument("--recon-root", default="recon_out")
    ev.add_argument("--gt-root", help="folder with <seq>_GT-packed.pkl")
    ev.add_argument("--objects-root", help="object template folder")
    ev.add_argument("--tid", type=int, default=1)
    ev.add_argument("--smpl-model", help="SMPL-H model pkl")
    ev.add_argument("--window", type=int, default=300)
    ev.add_argument("--smpl-only", action="store_true",
                    help="align on SMPL verts only")
    ev.add_argument("--angles", action="store_true",
                    help="also report object rotation errors in degrees")
    ev.add_argument("--out", default="results")
    ev.add_argument("--device", default="cuda",
                    help="torch device; cpu only when asked for")
    ev.add_argument("--recon-seq", default=None,
                    help="sequence folder with per-frame fit pkls "
                         "(frame-folder mode; replaces --recon)")

    up = sub.add_parser("unpack", help="packed pkl -> per-frame "
                        "k<kid>.smplfit_/objfit_<name>.pkl files")
    up.add_argument("--packed", required=True, help="packed recon pkl")
    up.add_argument("--seq", required=True, help="sequence folder")
    up.add_argument("--save-name", default="track")
    up.add_argument("--kid", type=int, default=1)

    pk = sub.add_parser("pack", help="per-frame fit pkls -> packed pkl "
                        "(dummy-fills missing frames, records recon_exist)")
    pk.add_argument("--seq", required=True, help="sequence folder")
    pk.add_argument("--out", required=True, help="output packed pkl path")
    pk.add_argument("--save-name", default="track")
    pk.add_argument("--kid", type=int, default=1)

    rm = sub.add_parser("rename-masks",
                        help="move flat t<frame>-k<kid>.*.png mask files "
                             "into the sequence's per-frame folders")
    rm.add_argument("--seq", required=True, help="sequence folder")
    rm.add_argument("--mask-path", required=True,
                    help="root containing <seq_name>/t*-k*.png files")
    return p


def eval_one(model, recon_path, gt_path, temp_v, temp_f, window, smpl_only,
             device, chamfer_samples: int = 10000) -> np.ndarray:
    """The (N_valid, 6) error matrix of one recon pack against its GT pack
    (GT object rotations axis-angle (T, 3) or row-vector (T, 3, 3))."""
    from ..data.packed import (gt_obj_verts, load_packed, load_packed_recon,
                               recon_obj_verts)
    from ..eval.evaluator import eval_sequence, smpl_verts_from_packed

    rec = load_packed_recon(recon_path)
    gt = load_packed(gt_path)
    sverts_rc = smpl_verts_from_packed(model, rec.poses, rec.betas, rec.trans)
    overts_rc = recon_obj_verts(temp_v, rec.obj_angles, rec.obj_trans,
                                rec.obj_scales)
    sverts_gt = smpl_verts_from_packed(
        model, np.asarray(gt["poses"]).reshape(len(gt["poses"]), -1),
        np.asarray(gt["betas"]), np.asarray(gt["trans"]))
    ga = np.asarray(gt["obj_angles"])
    if ga.ndim == 2:
        overts_gt = gt_obj_verts(temp_v, ga, np.asarray(gt["obj_trans"]))
    else:
        overts_gt = recon_obj_verts(temp_v, ga, np.asarray(gt["obj_trans"]),
                                    np.ones(len(ga)))
    return eval_sequence(sverts_gt, overts_gt, sverts_rc, overts_rc,
                         model.faces, temp_f, rec.recon_exist, window,
                         smpl_only=smpl_only, chamfer_samples=chamfer_samples,
                         device=device)


def rot_errors(recon_path, gt_path) -> np.ndarray:
    """Per-frame object rotation errors in degrees over the recon_exist
    frames: GT rotation (axis-angle or matrix) against the transposed
    packed recon rotation."""
    from scipy.spatial.transform import Rotation

    from ..data.packed import load_packed, load_packed_recon
    from ..eval.evaluator import rotation_errors_deg

    rec = load_packed_recon(recon_path)
    ga = np.asarray(load_packed(gt_path)["obj_angles"])
    rot_gt = Rotation.from_rotvec(ga).as_matrix() if ga.ndim == 2 else ga
    errs = rotation_errors_deg(np.asarray(rec.obj_angles).transpose(0, 2, 1),
                               rot_gt)
    return errs[np.asarray(rec.recon_exist, bool)]


def _rot_extra(rot_errs: dict):
    if not rot_errs:
        return None
    allr = np.concatenate(list(rot_errs.values()))
    return {"rot_error": {"mean": float(allr.mean()),
                          "std": float(allr.std())},
            "rot_error_separate": {
                k: {"mean": float(v.mean()), "std": float(v.std())}
                for k, v in sorted(rot_errs.items())}}


def run_evaluate(args) -> str:
    """`evaluate` in split, single-sequence or frame-folder mode; prints
    and returns the path of the results JSON."""
    import torch

    from ..core.smpl import load_smpl_pkl
    from ..data.behave import load_template
    from ..eval.evaluator import collect_results, object_name_of
    from ..utils.mesh import load_ply
    from .real_track import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = load_smpl_pkl(args.smpl_model, device)
    errors, rot_errs = {}, {}
    if args.split:
        with open(args.split) as f:
            seqs = json.load(f)["seqs"]
        for seq in seqs:
            recon = os.path.join(args.recon_root, f"recon_{args.save_name}",
                                 f"{seq}_k{args.tid}.pkl")
            gt = os.path.join(args.gt_root, f"{seq}_GT-packed.pkl")
            temp_v, temp_f = load_template(args.objects_root,
                                           object_name_of(seq))
            print(f"[evaluate] {seq}")
            errors[seq] = eval_one(model, recon, gt, temp_v, temp_f,
                                   args.window, args.smpl_only, device)
            if args.angles:
                rot_errs[seq] = rot_errors(recon, gt)
    else:
        recon = args.recon
        if args.recon_seq:
            # frame-folder mode: per-frame fit pkls -> a pack (dummy-filled,
            # recon_exist for missing frames), then evaluate that
            from ..data.behave import FrameDataReader
            from ..data.packed import pack_from_frames, save_packed
            reader = FrameDataReader(args.recon_seq)
            packed = pack_from_frames(args.recon_seq, reader.frames,
                                      args.save_name, kid=args.tid)
            packed.update(gender=reader.seq_info.get_gender())
            recon = os.path.join(args.out, f"recon_{args.save_name}",
                                 f"{reader.seq_name}_k{args.tid}.pkl")
            save_packed(recon, packed)
            print(f"[evaluate] packed {args.recon_seq} -> {recon}")
        if not (recon and args.gt and args.template):
            raise SystemExit("evaluate needs --split, --recon, or "
                             "--recon-seq (+ --gt/--template)")
        temp_v, temp_f = load_ply(args.template)
        temp_v = temp_v - temp_v.mean(0)
        seq_name = os.path.basename(recon).replace(".pkl", "")
        errors[seq_name] = eval_one(model, recon, args.gt, temp_v, temp_f,
                                    args.window, args.smpl_only, device)
        if args.angles:
            rot_errs[seq_name] = rot_errors(recon, args.gt)
    out = collect_results(errors, args.out, args.save_name,
                          extra=_rot_extra(rot_errs))
    print(out)
    return out


def rename_masks(seq: str, mask_path: str):
    """Move flat <mask_path>/<seq name>/t<frame>-k<kid>.<kind>.png files to
    <seq>/t<frame>/k<kid>.<kind>.png, leaving those whose destination
    exists; returns (moved, skipped)."""
    seq_name = os.path.basename(os.path.normpath(seq))
    moved = skipped = 0
    for f in sorted(glob.glob(os.path.join(mask_path, seq_name, "t*.png"))):
        parts = os.path.basename(f).split("-")
        if len(parts) != 2:
            continue
        dst = os.path.join(seq, parts[0], parts[1])
        if os.path.isfile(dst):
            skipped += 1
            continue
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        os.replace(f, dst)
        moved += 1
    return moved, skipped


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "track":
        from .real_track import run_real_track
        run_real_track(args)
    elif args.cmd == "evaluate":
        run_evaluate(args)
    elif args.cmd == "unpack":
        from ..data.packed import load_packed, unpack_to_frames
        written = unpack_to_frames(load_packed(args.packed), args.seq,
                                   args.save_name, kid=args.kid)
        print(f"unpacked {len(written)} frames to {args.seq}")
    elif args.cmd == "pack":
        from ..data.behave import FrameDataReader
        from ..data.packed import pack_from_frames, save_packed
        reader = FrameDataReader(args.seq)
        packed = pack_from_frames(args.seq, reader.frames, args.save_name,
                                  kid=args.kid)
        packed["gender"] = reader.seq_info.get_gender()
        save_packed(args.out, packed)
        n_ok = int(np.asarray(packed["recon_exist"]).sum())
        print(f"packed {len(reader.frames)} frames ({n_ok} with recon) "
              f"-> {args.out}")
    elif args.cmd == "rename-masks":
        moved, skipped = rename_masks(args.seq, args.mask_path)
        print(f"moved {moved} mask files ({skipped} already present)")


if __name__ == "__main__":
    main()
