"""vistracker_tpu_torch command line.

    python -m vistracker_tpu_torch.cli.main track --synthetic [--frames 8] \
        [--device cpu]
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

`track --synthetic` runs the whole pipeline (stages 1-7, evaluation
included) on a generated scene (cli/synthetic.py) with seeded random
networks of the JAX package's narrow synthetic widths; `track --seq` runs
it on a BEHAVE-layout sequence folder (cli/real_track.py).

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
    tr.add_argument("--synthetic", action="store_true",
                    help="run on a generated scene (no BEHAVE data needed)")
    tr.add_argument("--seq", help="BEHAVE sequence folder")
    tr.add_argument("--out", default="track_out")
    tr.add_argument("--device", default="cuda",
                    help="torch device; cpu only when asked for")
    # --synthetic sizes and budgets (the JAX command line's)
    tr.add_argument("--frames", type=int, default=8)
    tr.add_argument("--verts", type=int, default=128)
    tr.add_argument("--image-size", type=int, default=64)
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--global-iters", type=int, default=2)
    tr.add_argument("--smplt-iters", type=int, default=10)
    tr.add_argument("--refit-iters", type=int, default=3)
    tr.add_argument("--sif-stacks", type=int, default=1)
    tr.add_argument("--gen-samples", type=int, default=1024)
    tr.add_argument("--gen-points", type=int, default=256)
    tr.add_argument("--joint-smpl-iters", type=int, default=3)
    tr.add_argument("--joint-obj-iters", type=int, default=3)
    tr.add_argument("--joint-sil-iters", type=int, default=2)
    tr.add_argument("--joint-iters", type=int, default=3)
    tr.add_argument("--eval-window", type=int, default=300)
    tr.add_argument("--render", action="store_true",
                    help="GT | recon side-by-side GIF (refused: ROADMAP.md "
                         "Queue 1 item 8)")
    tr.add_argument("--dataset", choices=["behave", "intercap"],
                    default="behave", help="camera model")
    tr.add_argument("--kid", type=int, default=1)
    tr.add_argument("--start", type=int, default=0)
    tr.add_argument("--end", type=int, default=None)
    tr.add_argument("--chunk-size", type=int, default=96)
    tr.add_argument("--crop-size", type=int, default=1200)
    tr.add_argument("--net-size", type=int, default=512)
    tr.add_argument("--save-name", default="track")
    tr.add_argument("--smpl-model", help="SMPL-H model pkl")
    tr.add_argument("--assets", default=os.environ.get(
        "VISTRACKER_ASSETS", "assets"))
    tr.add_argument("--sifnet-ckpt",
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


def _stage(msg):
    print(f"[vistracker] {msg}", flush=True)


def run_synthetic_track(args, weights: dict | None = None,
                        draws=None) -> dict:
    """`track --synthetic`: the whole pipeline on a generated scene with
    the JAX command line's narrow networks (SIF-Net hourglass 32, tmpx 32,
    hidden 16), then the windowed evaluation against the scene's ground
    truth. Stage 3 runs kernel K1 (hard), stage 6b K1 soft, K2 and K3, and
    the evaluation's chamfer K4.

    weights: optional state dicts for "sifnet", "smoothnet_smpl",
    "smoothnet_objrot" and "infiller" (default: seeded random weights);
    draws: the stage-4 generator's draw source (default TorchDraws(3)).
    Returns (and prints) the eval JSON path, the packed path, the mean
    SMPL and object v2v in cm and the per-stage seconds."""
    import time

    import torch

    from ..core.camera import PerspectiveCamera
    from ..core.smpl import lbs_forward
    from ..data.packed import (load_packed_recon, recon_obj_verts,
                               save_packed)
    from ..data.silprep import prepare_sil_refs
    from ..eval.evaluator import (collect_results, eval_sequence,
                                  smpl_verts_from_packed)
    from ..fit import generator as gen_mod
    from ..fit import joint as joint_mod
    from ..fit.infill import make_infiller
    from ..fit.smoothing import smooth_objrot, smooth_smplt
    from ..fit.smplt import (SMPLTFitConfig, SMPLTParams, fit_smplt,
                             init_trans_from_bbox)
    from ..models.infiller import ConditionalMInfiller, InfillerConfig
    from ..models.sifnet import SIFNet, SIFNetConfig
    from ..models.smoothnet import SmoothNet, SmoothNetSMPL
    from ..models.weights import init_random_
    from ..ops.rasterizer import rasterize_mask, render_triplane_masks_batch
    from ..utils.mesh import compute_pca_axes
    from .real_track import _NOT_PORTED, resolve_device
    from .synthetic import make_scene

    if args.render:
        raise SystemExit("--render (the GT | recon side-by-side GIF) is "
                         + _NOT_PORTED.format("8 (rendering)"))
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights = weights or {}

    def net(model, key, seed):
        """The caller's weights, or seeded random ones; eval mode, no
        gradients, on the device."""
        if key in weights:
            model.load_state_dict(weights[key])
        else:
            init_random_(model, torch.Generator().manual_seed(seed))
        return model.to(device).eval().requires_grad_(False)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def host(x):
        return x.detach().cpu().numpy()

    t_start = time.perf_counter()
    os.makedirs(args.out, exist_ok=True)
    T = args.frames
    scene = make_scene(T, num_verts=args.verts, seed=args.seed, device=device)
    model, lms = scene.model, scene.landmarks
    cam = PerspectiveCamera(crop_size=1200)
    net_size = args.image_size
    frames = [f"t{i:04d}.000" for i in range(T)]
    timings = {}

    def lap(key, t0):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings[key] = time.perf_counter() - t0
        return time.perf_counter()

    def norm_kpts(kpts_px, crop_centers):
        xy = 2.0 * (600.0 + kpts_px[..., :2] - crop_centers[:, None, :]) \
            / 1200.0 - 1.0
        return np.concatenate([xy, kpts_px[..., 2:]], -1).astype(np.float32)

    def lbs(pose, betas, trans):
        with torch.no_grad():
            return lbs_forward(model, pose, betas, trans)[0]

    # ---------------- stage 1: SMPL-T keypoint pre-fit ----------------
    _stage("stage 1/7: SMPL-T keypoint fitting")
    t0 = time.perf_counter()
    fit_cfg = SMPLTFitConfig(global_iters=args.global_iters,
                             max_iters=args.smplt_iters)
    bbox_centers = scene.kpts[:, :, :2].mean(1)
    init = SMPLTParams.from_full(
        torch.zeros(T, 156, device=device), torch.zeros(T, 10, device=device),
        dev(init_trans_from_bbox(bbox_centers, fit_cfg)))
    params1, _ = fit_smplt(model, lms, scene.body_prior, scene.hand_prior,
                           dev(scene.kpts), init, fit_cfg)
    t0 = lap("smplt_fit", t0)

    # ---------------- stage 2: SmoothNet smooth + re-fit ----------------
    _stage("stage 2/7: SmoothNet smoothing + re-fit")
    W = min(64, T)
    sn_smpl = net(SmoothNetSMPL(window_size=W, output_size=W),
                  "smoothnet_smpl", 1)
    smoothed = smooth_smplt(sn_smpl, host(params1.pose), host(params1.betas),
                            host(params1.trans), window=W)
    # re-fit from the smoothed init (no global phase)
    poses_sm = np.zeros((T, 156), np.float32)
    poses_sm[:, :66] = smoothed["poses"][:, :66]
    init2 = SMPLTParams.from_full(dev(poses_sm), dev(smoothed["betas"]),
                                  dev(smoothed["trans"]))
    params2, _ = fit_smplt(model, lms, scene.body_prior, scene.hand_prior,
                           dev(scene.kpts), init2,
                           SMPLTFitConfig(max_iters=args.refit_iters),
                           skip_global_phase=True)
    save_packed(os.path.join(args.out, "recon_smplt-smoothed-fit.pkl"), dict(
        poses=host(params2.pose), betas=host(params2.betas),
        trans=host(params2.trans),
        obj_angles=np.broadcast_to(np.eye(3), (T, 3, 3)).copy(),
        obj_trans=np.zeros((T, 3)), obj_scales=np.zeros(T),
        gender="male", frames=frames))
    t0 = lap("smooth_refit", t0)

    # ---------------- stage 3: triplane rendering ----------------
    _stage("stage 3/7: triplane rendering")
    verts2 = lbs(params2.pose, params2.betas, params2.trans)
    body_centers = lms.smpl_center(verts2)
    smpl_faces = torch.as_tensor(scene.smpl_faces[:256],
                                 device=device).long()
    with torch.no_grad():
        triplanes = host(render_triplane_masks_batch(
            verts2, smpl_faces, body_centers, net_size))
    t0 = lap("triplane", t0)

    # ---------------- stage 4: SIF-Net + surface generation ------------
    _stage("stage 4/7: SIF-Net neural reconstruction")
    sifnet = net(SIFNet(SIFNetConfig(
        num_stack=args.sif_stacks, num_hourglass=1, hourglass_dim=32,
        tmpx_dim=32, triplane_stack=args.sif_stacks, triplane_hg_dim=32,
        triplane_tmpx_dim=32, hidden_dim=16), cam), "sifnet", 2)
    crop_centers = host(cam.project_screen(body_centers[:, None, :])[:, 0])
    cc = dev(crop_centers)
    temp_faces = torch.as_tensor(scene.temp_faces, device=device).long()
    obj_gt_world = recon_obj_verts(scene.temp_verts, scene.obj_rot_gt,
                                   scene.obj_trans_gt, np.ones(T))
    with torch.no_grad():
        # the 8-channel inputs: masks rasterized in crop space + triplanes
        ndc_smpl = cam.project_points(verts2, cc)[..., :2]
        ndc_obj = cam.project_points(dev(obj_gt_world), cc)[..., :2]
        person_masks = np.stack([host(rasterize_mask(
            ndc_smpl[i], smpl_faces, net_size)) for i in range(T)])
        obj_masks = np.stack([host(rasterize_mask(
            ndc_obj[i], temp_faces, net_size)) for i in range(T)])
    rgb = np.repeat(person_masks[..., None], 3, -1) * 0.5 \
        + np.repeat(obj_masks[..., None], 3, -1) * 0.3
    images = np.concatenate([rgb, person_masks[..., None],
                             obj_masks[..., None], triplanes],
                            -1).astype(np.float32)
    with torch.no_grad():
        cache = sifnet.encode(dev(images))
    generate = gen_mod.make_generator(
        gen_mod.sifnet_query_fn(sifnet), gen_mod.GeneratorConfig(
            num_steps=4, num_rounds=2, samples_per_round=args.gen_samples,
            num_points=args.gen_points))
    pc = generate(cache, cc, body_centers,
                  draws if draws is not None
                  else gen_mod.TorchDraws(3, device))
    obj = {k: host(v) for k, v in pc["object"].items()}
    save_packed(os.path.join(args.out, "recon_neural.pkl"), dict(
        neural_pca=obj["pca_axis"], neural_trans=obj["centers"],
        neural_visibility=obj["visibility"][:, 0],
        recon_exist=np.ones(T, bool), recon_name="neural", frames=frames,
        gender="male"))
    t0 = lap("sifnet_recon", t0)

    # ---------------- stage 5: object-rot smoothing + infill -----------
    _stage("stage 5/7: SmoothNet object rotation + HVOP-Net infill")
    pca_init = compute_pca_axes(scene.temp_verts)
    with torch.no_grad():
        rot_neural = host(joint_mod.init_object_orientation(
            dev(obj["pca_axis"]), dev(pca_init).expand(T, 3, 3)))
    Wr = min(64, T)
    sn_rot = net(SmoothNet(window_size=Wr, output_size=Wr),
                 "smoothnet_objrot", 4)
    obj_angles_sm = smooth_objrot(sn_rot, rot_neural.transpose(0, 2, 1),
                                  window=Wr)
    inf_cfg = InfillerConfig(clip_len=min(180, max(4, T)),
                             window=max(1, min(30, T // 3)))
    run_infill = make_infiller(net(ConditionalMInfiller(inf_cfg),
                                   "infiller", 5), inf_cfg)
    occ = obj["visibility"][:, 0]
    occ = np.where(np.isfinite(occ), occ, scene.occ_ratios)
    rots_filled = run_infill(host(params2.pose), host(params2.trans),
                             obj_angles_sm.transpose(0, 2, 1), occ,
                             occ_thres=0.5, init_thres=0.0)
    if rots_filled is None:
        rots_filled = obj_angles_sm.transpose(0, 2, 1)
    t0 = lap("smooth_infill", t0)

    # ---------------- stage 6: joint optimization ----------------
    _stage("stage 6/7: joint SMPL+object optimization")
    jcfg = joint_mod.JointFitConfig(
        iter_betas=1, iter_pose=1, iter_kpts=1,
        smpl_max_iter=args.joint_smpl_iters, iter_obj=args.joint_obj_iters,
        iter_sil=args.joint_sil_iters, joint_max_iter=args.joint_iters,
        sil_size=64, sil_sigma=1 / 32.0)
    ctx = dict(cache=cache, cc=cc, bc=body_centers)

    def query_fn(ctx, points):
        return sifnet.query(ctx["cache"], points, ctx["cc"], ctx["bc"])[-1]

    opt_smpl = joint_mod.make_smpl_optimizer(
        query_fn, lambda ctx, j: cam.project_points(j, ctx["cc"])[..., :2],
        model, lms, scene.body_prior, scene.hand_prior, scene.part_labels,
        jcfg)
    smpl_final, _ = opt_smpl(params2, dev(norm_kpts(scene.kpts,
                                                    crop_centers)), ctx)
    verts_final = lbs(smpl_final.pose, smpl_final.betas, smpl_final.trans)
    sil = prepare_sil_refs(person_masks, obj_masks, crop_centers, 1200,
                           net_size, jcfg.sil_size, device=device)
    opt_obj = joint_mod.make_object_optimizer(
        query_fn, lambda ctx, p: cam.project_screen(p), jcfg)
    obj_pts = dev(scene.temp_verts).expand(T, -1, -1)
    r_fin, t_fin, _ = opt_obj(
        dev(rots_filled.transpose(0, 2, 1)),
        dev(obj["centers"] + host(body_centers)),
        torch.ones(T, device=device), obj_pts, verts_final,
        scene.part_labels, dev(occ), sil, obj_pts, temp_faces, ctx)
    t0 = lap("joint_opt", t0)

    # ---------------- stage 7: pack + evaluate ----------------
    _stage("stage 7/7: packing + evaluation")
    recon_pack_path = os.path.join(args.out, "recon_track.pkl")
    save_packed(recon_pack_path, dict(
        poses=host(smpl_final.pose), betas=host(smpl_final.betas),
        trans=host(smpl_final.trans), obj_angles=host(r_fin),
        obj_trans=host(t_fin), obj_scales=np.ones(T),
        recon_exist=np.ones(T, bool), recon_name="track", frames=frames,
        gender="male"))
    rec = load_packed_recon(recon_pack_path)
    sverts_rc = smpl_verts_from_packed(model, rec.poses, rec.betas,
                                       rec.trans)
    overts_rc = recon_obj_verts(scene.temp_verts, rec.obj_angles,
                                rec.obj_trans, rec.obj_scales)
    sverts_gt = host(lbs(dev(scene.poses_gt), dev(scene.betas_gt),
                         dev(scene.trans_gt)))
    errs = eval_sequence(sverts_gt, obj_gt_world, sverts_rc, overts_rc,
                         scene.smpl_faces, scene.temp_faces,
                         window=args.eval_window, chamfer_samples=1000,
                         device=device)
    outfile = collect_results({"Date00_Sub00_synthetic": errs}, args.out,
                              "synthetic-track")
    lap("pack_eval", t0)
    timings["total"] = time.perf_counter() - t_start

    with open(outfile) as f:
        summary = json.load(f)
    result = dict(
        eval_json=outfile, recon_pack=recon_pack_path,
        smpl_v2v_cm=summary["smpl_v2v"]["mean"],
        obj_v2v_cm=summary["obj_v2v"]["mean"],
        timings={k: round(v, 2) for k, v in timings.items()})
    print(json.dumps(result, indent=2))
    return result


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
        if not args.synthetic and not args.seq:
            raise SystemExit("track requires --synthetic or --seq")
        if args.synthetic:
            run_synthetic_track(args)
        else:
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
