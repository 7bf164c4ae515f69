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

    python -m vistracker_tpu_torch.cli.main boundary-sample --seq <dir> \
        --gt-pack <pkl> --smpl-model <pkl> --assets <dir> \
        --objects-root <dir> --out <npz dir> [--samples 20000] [--flip] \
        [--neighbours] [--end N] [--redo] [--device cpu]
    python -m vistracker_tpu_torch.cli.main train-sifnet \
        (--synthetic [--frames 8] | --offline-data <npz dir> \
         [--crop-size 1200] [--load-triplane] [--random-flip]) \
        [--variant chore-triplane-vis] [--image-size 32] [--samples 512] \
        [--batch-size 2] [--epochs 2] [--lr 1e-3] [--out <dir>] \
        [--device cpu]
    python -m vistracker_tpu_torch.cli.main train-smoothnet --synthetic \
        [--variant smpl | objrot] [--window 64] [--frames 300] [--device cpu]
    python -m vistracker_tpu_torch.cli.main train-infiller --synthetic \
        [--clip-len 40] [--frames 120] [--device cpu]

    python -m vistracker_tpu_torch.cli.main render --recon <pkl> \
        [--recon2 <pkl>] --template <ply> --smpl-model <pkl> \
        [--out render_out/side_by_side.gif] [--top] [--contact-spheres] \
        [--assets <dir>] [--size 256] [--fps 15] [--max-frames 300] \
        [--device cpu]

`track --synthetic` runs the whole pipeline (stages 1-7, evaluation
included) on a generated scene (cli/synthetic.py) with seeded random
networks of the JAX package's narrow synthetic widths (`--render` adds
the GT | recon side-by-side GIF); `track --seq` runs it on a
BEHAVE-layout sequence folder (cli/real_track.py).

`render` draws packed reconstructions (render/viz.py) as a GIF (no PIL)
or, where cv2 is installed, an .mp4.

`boundary-sample` writes the per-frame boundary-sample npz files that
`train-sifnet --offline-data` trains from; the three trainers write the
reference's torch checkpoints (fit/trainer_loop.py), which `track`
loads (`--sifnet-ckpt <train-sifnet out>`).

`track`, `evaluate`, `render`, `boundary-sample` and the trainers run on
the GPU
(`--device cuda`, the default) unless `--device cpu` is given; without a
GPU a cuda run raises. The flags carry the names and defaults of the JAX
package's subcommands (its `--cpu` is `--device cpu` here); what the
port does not have yet is refused by cli/real_track.py:check_supported.
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
                    help="GT | recon side-by-side GIF (--synthetic)")
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

    def device_flag(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device; cpu only when asked for")

    ts = sub.add_parser("train-sifnet", help="train SIF-Net")
    ts.add_argument("--synthetic", action="store_true")
    device_flag(ts)
    ts.add_argument("--out", default="experiments/sifnet")
    ts.add_argument("--epochs", type=int, default=2)
    ts.add_argument("--batch-size", type=int, default=2)
    ts.add_argument("--frames", type=int, default=8)
    ts.add_argument("--image-size", type=int, default=32)
    ts.add_argument("--samples", type=int, default=512)
    ts.add_argument("--lr", type=float, default=1e-3)
    ts.add_argument("--offline-data", default=None,
                    help="directory of boundary-sample npz files")
    ts.add_argument("--crop-size", type=int, default=1200)
    ts.add_argument("--variant", default="chore-triplane-vis",
                    choices=["chore", "chore-triplane", "chore-triplane-vis"])
    ts.add_argument("--load-triplane", action="store_true",
                    help="concat the .smpl_triplane.png channels "
                         "(offline mode)")
    ts.add_argument("--random-flip", action="store_true",
                    help="random horizontal flip loading _flip.npz labels")

    bs = sub.add_parser("boundary-sample",
                        help="per-frame boundary-sample npz files from a "
                             "GT-packed sequence")
    bs.add_argument("--seq", required=True, help="BEHAVE-layout seq dir")
    bs.add_argument("--gt-pack", required=True, help="GT packed pkl")
    bs.add_argument("--smpl-model", required=True)
    bs.add_argument("--assets", required=True)
    bs.add_argument("--objects-root", required=True)
    bs.add_argument("--out", required=True, help="output npz directory")
    bs.add_argument("--kid", type=int, default=1)
    bs.add_argument("--samples", type=int, default=20000)
    bs.add_argument("--grid-ratio", type=float, default=1.0 / 16.0)
    bs.add_argument("--flip", action="store_true",
                    help="also write the _flip.npz part-label variants")
    bs.add_argument("--neighbours", action="store_true",
                    help="store closest-surface-point labels")
    bs.add_argument("--end", type=int, default=None)
    bs.add_argument("--redo", action="store_true")
    device_flag(bs)

    tsm = sub.add_parser("train-smoothnet",
                         help="train SmoothNet (smpl or objrot variant)")
    tsm.add_argument("--synthetic", action="store_true")
    device_flag(tsm)
    tsm.add_argument("--variant", choices=["smpl", "objrot"], default="smpl")
    tsm.add_argument("--out", default="experiments/smoothnet")
    tsm.add_argument("--epochs", type=int, default=2)
    tsm.add_argument("--batch-size", type=int, default=32)
    tsm.add_argument("--window", type=int, default=64)
    tsm.add_argument("--frames", type=int, default=300)
    tsm.add_argument("--lr", type=float, default=1e-4)
    tsm.add_argument("--noise", type=float, default=0.05)

    ti = sub.add_parser("train-infiller", help="train HVOP-Net")
    ti.add_argument("--synthetic", action="store_true")
    device_flag(ti)
    ti.add_argument("--out", default="experiments/infiller")
    ti.add_argument("--epochs", type=int, default=2)
    ti.add_argument("--batch-size", type=int, default=8)
    ti.add_argument("--clip-len", type=int, default=40)
    ti.add_argument("--frames", type=int, default=120)
    ti.add_argument("--lr", type=float, default=1e-4)

    rd = sub.add_parser("render",
                        help="side-by-side video (gif/mp4) of packed "
                             "recon(s), optional top view + contact spheres")
    rd.add_argument("--recon", required=True, help="packed recon pkl")
    rd.add_argument("--recon2", help="second recon (or GT pack) to compare")
    rd.add_argument("--template", required=True, help="object template ply")
    rd.add_argument("--smpl-model", required=True)
    rd.add_argument("--out", default="render_out/side_by_side.mp4",
                    help=".mp4 -> FFMPEG video through cv2 (refused where "
                         "cv2 is not installed); other extensions -> GIF")
    rd.add_argument("--top", action="store_true",
                    help="also write a top-down view video with "
                         "checkerboard ground (*_top.<ext>)")
    rd.add_argument("--contact-spheres", action="store_true",
                    help="draw per-part human-object contact spheres")
    rd.add_argument("--assets", default=os.environ.get(
        "VISTRACKER_ASSETS", "assets"),
        help="assets root (part labels for contact spheres)")
    rd.add_argument("--size", type=int, default=256)
    rd.add_argument("--fps", type=int, default=15)
    rd.add_argument("--max-frames", type=int, default=300)
    rd.add_argument("--device", default="cuda",
                    help="torch device (the JAX command line's --cpu is "
                         "--device cpu); cpu only when asked for")
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
    from .real_track import resolve_device
    from .synthetic import make_scene

    device = resolve_device(args.device)
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
    if args.render:
        # stage-7 visualization: the GT | recon side-by-side GIF
        from ..render.viz import (render_meshes_perspective, save_video,
                                  side_by_side)
        sf = scene.smpl_faces[:256]
        left, right = [], []
        for i in range(T):
            left.append(render_meshes_perspective(
                [(sverts_gt[i], sf, (0.4, 0.8, 0.4)),
                 (obj_gt_world[i], scene.temp_faces, (0.9, 0.6, 0.2))],
                cam, crop_centers[i], size=128, device=device))
            right.append(render_meshes_perspective(
                [(sverts_rc[i], sf, (0.4, 0.6, 0.9)),
                 (overts_rc[i], scene.temp_faces, (0.9, 0.4, 0.4))],
                cam, crop_centers[i], size=128, device=device))
        vid = save_video(side_by_side(np.stack(left), np.stack(right)),
                         os.path.join(args.out, "side_by_side.gif"))
        _stage(f"wrote visualization {vid}")
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


def run_render(args) -> list:
    """`render`: side-by-side mesh rendering of packed reconstructions
    (the reference's render/render_side_comp.py and render_recon.py
    roles) as a GIF, or an .mp4 where cv2 is installed, with an optional
    top-down view over a checkerboard ground (render_recon.py:173-183,
    213-225) and per-part contact spheres (nr_utils.py:
    get_contact_spheres). Renders on the device; prints and returns the
    files written."""
    import torch

    from ..core.camera import PerspectiveCamera
    from ..core.smpl import load_smpl_pkl
    from ..data.packed import gt_obj_verts, load_packed, recon_obj_verts
    from ..eval.evaluator import smpl_verts_from_packed
    from ..render.viz import (MP4_REFUSAL, contact_spheres, mp4_writable,
                              render_meshes_perspective, render_top_view,
                              save_video, side_by_side)
    from ..utils.mesh import decimate_faces, load_ply
    from .real_track import resolve_device

    if args.out.lower().endswith(".mp4") and not mp4_writable():
        raise SystemExit(MP4_REFUSAL)
    device = resolve_device(args.device)
    model = load_smpl_pkl(args.smpl_model, device)
    temp_v, temp_f = load_ply(args.template)
    temp_v = temp_v - temp_v.mean(0)
    temp_f = decimate_faces(temp_f, 2500)
    smpl_f = decimate_faces(model.faces, 4000)
    cam = PerspectiveCamera()
    part_labels = None
    if args.contact_spheres:
        from ..core.landmarks import load_part_labels, part_labels_array
        part_labels = np.asarray(part_labels_array(
            load_part_labels(args.assets),
            num_verts=model.v_template.shape[0]))

    def load_verts(path):
        d = load_packed(path)
        poses = np.asarray(d["poses"]).reshape(len(d["poses"]), -1)
        sv = smpl_verts_from_packed(model, poses, np.asarray(d["betas"]),
                                    np.asarray(d["trans"]))
        ga = np.asarray(d["obj_angles"])
        if ga.ndim == 2:
            ov = gt_obj_verts(temp_v, ga, np.asarray(d["obj_trans"]))
        else:
            scales = np.asarray(d.get("obj_scales", np.ones(len(ga))))
            ov = recon_obj_verts(temp_v, ga, np.asarray(d["obj_trans"]),
                                 np.where(np.isfinite(scales) & (scales > 0),
                                          scales, 1.0))
        return sv, ov

    sv1, ov1 = load_verts(args.recon)
    T = min(len(sv1), args.max_frames)

    def frame_meshes(sv, ov, colors, i):
        meshes = [(sv[i], smpl_f, colors[0]), (ov[i], temp_f, colors[1])]
        if part_labels is not None:
            for color, cv, cf in contact_spheres(sv[i], part_labels, ov[i]):
                meshes.append((cv, cf, color))
        return meshes

    def render_all(sv, ov, colors, top=False):
        frames = []
        for i in range(T):
            meshes = frame_meshes(sv, ov, colors, i)
            if top:
                frames.append(render_top_view(meshes, cam, size=args.size,
                                              device=device))
            else:
                cc = cam.project_screen(torch.as_tensor(
                    sv[i].mean(0, keepdims=True))[None]).numpy()[0, 0]
                frames.append(render_meshes_perspective(
                    meshes, cam, cc, size=args.size, device=device))
        return np.stack(frames)

    colors1 = [(0.4, 0.6, 0.9), (0.9, 0.4, 0.4)]
    colors2 = [(0.4, 0.8, 0.4), (0.9, 0.6, 0.2)]
    sv2 = ov2 = None
    if args.recon2:
        sv2, ov2 = load_verts(args.recon2)

    def video(top=False):
        left = render_all(sv1, ov1, colors1, top)
        if sv2 is None:
            return left
        return side_by_side(left, render_all(sv2, ov2, colors2, top))

    outputs = [save_video(video(), args.out, args.fps)]
    if args.top:
        # the companion top view (render_recon.py writes *_top.mp4)
        stem, ext = os.path.splitext(args.out)
        outputs.append(save_video(video(top=True), f"{stem}_top{ext}",
                                  args.fps))
    print("\n".join(outputs))
    return outputs


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
    from ..core.smpl import load_smpl_pkl
    from ..data.behave import load_template
    from ..eval.evaluator import collect_results, object_name_of
    from ..utils.mesh import load_ply
    from .real_track import resolve_device

    device = resolve_device(args.device)
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


def _to_device(device):
    import torch
    return lambda batch: {k: torch.as_tensor(v, device=device)
                          for k, v in batch.items()}


def sifnet_synthetic_frames(T: int, S: int, device):
    """The frames of `train-sifnet --synthetic`: the generated scene's GT
    bodies and objects, the person and object masks rasterized in crop
    space and the triplane masks (kernel K1, hard, on the card), composed
    into the 8-channel inputs. Returns (frames, the scene's part
    labels)."""
    import torch

    from ..core.camera import PerspectiveCamera
    from ..core.smpl import lbs_forward
    from ..data.packed import recon_obj_verts
    from ..ops.rasterizer import rasterize_mask, render_triplane_masks_batch
    from .synthetic import make_scene

    cam = PerspectiveCamera(crop_size=1200)
    scene = make_scene(T, num_verts=128, seed=0, device=device)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    with torch.no_grad():
        verts = lbs_forward(scene.model, dev(scene.poses_gt),
                            dev(scene.betas_gt), dev(scene.trans_gt))[0]
        bc = scene.landmarks.smpl_center(verts)
        cc = cam.project_screen(bc[:, None, :])[:, 0]
        smpl_faces = torch.as_tensor(scene.smpl_faces[:256],
                                     device=device).long()
        temp_faces = torch.as_tensor(scene.temp_faces, device=device).long()
        obj_world = recon_obj_verts(scene.temp_verts, scene.obj_rot_gt,
                                    scene.obj_trans_gt, np.ones(T))
        tris = render_triplane_masks_batch(verts, smpl_faces, bc,
                                           S).cpu().numpy()
        frames = []
        for i in range(T):
            ndc_s = cam.project_points(verts[i:i + 1],
                                       cc[i:i + 1])[0, :, :2]
            ndc_o = cam.project_points(dev(obj_world[i:i + 1]),
                                       cc[i:i + 1])[0, :, :2]
            pm = rasterize_mask(ndc_s, smpl_faces, S).cpu().numpy()
            om = rasterize_mask(ndc_o, temp_faces, S).cpu().numpy()
            rgb = np.repeat(pm[..., None], 3, -1) * 0.5 \
                + np.repeat(om[..., None], 3, -1) * 0.3
            image = np.concatenate([rgb, pm[..., None], om[..., None],
                                    tris[i]], -1).astype(np.float32)
            frames.append(dict(
                image=image, crop_center=cc[i].cpu().numpy(),
                body_center=bc[i].cpu().numpy().astype(np.float32),
                smpl_verts=verts[i].cpu().numpy(),
                smpl_faces=scene.smpl_faces,
                obj_verts=obj_world[i].astype(np.float32),
                obj_faces=scene.temp_faces,
                visibility=float(scene.occ_ratios[i])))
    return frames, scene.part_labels


def run_train_sifnet(args) -> dict:
    """`train-sifnet`: the JAX command line's fixed network (the tiny
    dimensions with remat) on --synthetic frames (online GT labelling of
    the generated scene) or on --offline-data boundary npz files; prints
    and returns {out, steps}."""
    import torch

    from ..core.camera import PerspectiveCamera
    from ..data.datasets import PrefetchLoader, sifnet_example
    from ..fit.train import (TrainConfig, init_train_state,
                             make_train_step, sifnet_loss)
    from ..fit.trainer_loop import LoopConfig, train_loop
    from ..models.sifnet import SIFNet, SIFNetConfig
    from ..models.weights import init_random_
    from .real_track import resolve_device

    if args.offline_data:
        from ..data.offline import offline_example
        files = sorted(f for f in glob.glob(
            os.path.join(args.offline_data, "*.npz"))
            if not f.endswith("_flip.npz"))
        if not files:
            raise SystemExit(f"no npz files under {args.offline_data}")
        device = resolve_device(args.device)
        cam = PerspectiveCamera(crop_size=args.crop_size)
        T = len(files)

        def example(i):
            rng = np.random.RandomState(i * 9973 + 7)
            flip = bool(args.random_flip and rng.rand() > 0.5)
            return offline_example(files[i], total_samples=args.samples,
                                   crop_size=args.crop_size,
                                   net_size=args.image_size,
                                   load_triplane=args.load_triplane,
                                   flip=flip, rng=rng)
    elif not args.synthetic:
        raise SystemExit("training needs --synthetic or --offline-data")
    else:
        device = resolve_device(args.device)
        cam = PerspectiveCamera(crop_size=1200)
        T = args.frames
        frames, part_labels = sifnet_synthetic_frames(T, args.image_size,
                                                      device)

        def example(i):
            return sifnet_example(frames[i], part_labels,
                                  num_samples=args.samples,
                                  rng=np.random.RandomState(i))

    loader = PrefetchLoader(example, T, args.batch_size, num_workers=2)
    cfg = SIFNetConfig(variant=args.variant, num_stack=1, num_hourglass=1,
                       hourglass_dim=32, tmpx_dim=32, triplane_stack=1,
                       triplane_hg_dim=32, triplane_tmpx_dim=32,
                       hidden_dim=16, remat=True, crop_size=args.crop_size)
    model = init_random_(SIFNet(cfg, cam), torch.Generator().manual_seed(0))
    tcfg = TrainConfig(learning_rate=args.lr)
    state = init_train_state(model.to(device), tcfg)
    state = train_loop(
        state, make_train_step(model, tcfg), loader, val_loader=loader,
        val_loss_fn=lambda st, b: sifnet_loss(st.model, b, tcfg)[0],
        cfg=LoopConfig(num_epochs=args.epochs, out_dir=args.out,
                       ck_period_min=1e9),
        to_device=_to_device(device))
    result = {"out": args.out, "steps": state.step}
    print(json.dumps(result))
    return result


def run_boundary_sample(args) -> dict:
    """`boundary-sample`: per-frame boundary npz files (and `_flip`
    variants) from a GT-packed sequence, for `train-sifnet
    --offline-data`; a frame whose file exists is skipped unless --redo.
    Prints and returns {out, frames, written}."""
    import torch

    from ..core.landmarks import (load_landmarks, load_part_labels,
                                  part_labels_array)
    from ..core.smpl import lbs_forward, load_smpl_pkl
    from ..data.behave import FrameDataReader, load_template
    from ..data.offline import save_boundary_npz
    from ..data.packed import gt_obj_verts, load_packed, recon_obj_verts
    from .real_track import resolve_device

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    model = load_smpl_pkl(args.smpl_model, device)
    landmarks = load_landmarks(args.assets, device)
    part_labels = part_labels_array(load_part_labels(args.assets),
                                    num_verts=model.v_template.shape[0])
    reader = FrameDataReader(args.seq)
    temp_v, temp_f = load_template(args.objects_root,
                                   reader.seq_info.get_obj_name())

    gt = load_packed(args.gt_pack)
    T = len(gt["poses"])
    if args.end is not None:
        T = min(T, args.end)
    poses = np.asarray(gt["poses"]).reshape(len(gt["poses"]), -1)[:T]

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    with torch.no_grad():
        verts = lbs_forward(model, dev(poses),
                            dev(np.asarray(gt["betas"])[:T]),
                            dev(np.asarray(gt["trans"])[:T]))[0]
        body_kpts = landmarks.body_joints(verts).cpu().numpy()
    verts = verts.cpu().numpy()
    centers = body_kpts[:, 8]  # the SMPL center: body25 joint 8
    ga = np.asarray(gt["obj_angles"])[:T]
    if ga.ndim == 2:  # GT packs store axis-angle
        overts = gt_obj_verts(temp_v, ga, np.asarray(gt["obj_trans"])[:T])
    else:
        overts = recon_obj_verts(temp_v, ga, np.asarray(gt["obj_trans"])[:T],
                                 np.ones(T))

    smpl_faces = np.asarray(model.faces)
    written = 0
    for i in range(T):
        out = os.path.join(args.out, f"{reader.frames[i]}_k{args.kid}.npz")
        if os.path.isfile(out) and not args.redo:
            continue
        kw = dict(smpl_verts=verts[i], smpl_faces=smpl_faces,
                  obj_verts=overts[i], obj_faces=temp_f,
                  part_labels=part_labels, body_center=centers[i],
                  body_kpts=body_kpts[i],
                  image_file=reader.get_color_file(i, args.kid),
                  sample_num=args.samples, grid_ratio=args.grid_ratio,
                  add_neighbours=args.neighbours)
        save_boundary_npz(out, rng=np.random.RandomState(i * 31 + 7), **kw)
        if args.flip:
            save_boundary_npz(out.replace(".npz", "_flip.npz"), flip=True,
                              rng=np.random.RandomState(i * 31 + 7), **kw)
        written += 1
    result = {"out": args.out, "frames": T, "written": written}
    print(json.dumps(result))
    return result


def run_train_smoothnet(args) -> dict:
    """`train-smoothnet --synthetic`: SmoothNet denoising windows of a
    smooth generated trajectory (rot6d pose [+ betas and translation for
    the smpl variant]) with Gaussian noise; prints and returns {out,
    steps, noisy_l1, denoised_l1} (the last two on the first 64
    windows)."""
    import torch
    from scipy.spatial.transform import Rotation

    from ..core.rotations import axis_angle_to_rot6d
    from ..data.datasets import PrefetchLoader
    from ..fit.trainer_loop import (LoopConfig, make_smoothnet_train_step,
                                    train_loop)
    from ..models.smoothnet import SmoothNet, SmoothNetSMPL
    from ..models.weights import init_random_
    from ..ops.window_ops import seq_to_windows
    from .real_track import resolve_device

    if not args.synthetic:
        raise SystemExit("real-data training needs packed GT; use --synthetic")
    device = resolve_device(args.device)
    rng = np.random.RandomState(0)
    T, W = args.frames, args.window
    t = np.linspace(0, 6 * np.pi, T)
    if args.variant == "smpl":
        pose = (0.3 * np.sin(t)[:, None]
                * rng.randn(72)[None]).astype(np.float32)
        rot6d = axis_angle_to_rot6d(torch.as_tensor(
            pose.reshape(-1, 3))).numpy().reshape(T, 144)
        feats = np.concatenate(
            [rot6d, np.zeros((T, 10), np.float32),
             np.stack([0.3 * np.sin(t), 0.1 * np.cos(t), 2.2 + 0 * t],
                      -1).astype(np.float32)], 1)
        model = SmoothNetSMPL(window_size=W, output_size=W)
    else:
        rots = Rotation.from_euler("y", (0.5 * t)[:, None]).as_matrix()
        feats = rots[:, :, :2].reshape(T, 6).astype(np.float32)
        model = SmoothNet(window_size=W, output_size=W)

    gt_w = seq_to_windows(torch.as_tensor(feats), W, 1).numpy()  # (N, W, D)
    gt_w = gt_w.transpose(0, 2, 1)                               # (N, D, W)
    noisy_w = gt_w + rng.randn(*gt_w.shape).astype(np.float32) * args.noise
    loader = PrefetchLoader(lambda i: dict(noisy=noisy_w[i], gt=gt_w[i]),
                            len(gt_w), args.batch_size, num_workers=2)
    model = init_random_(model, torch.Generator().manual_seed(0)).to(device)
    init_state, step_fn, val_fn = make_smoothnet_train_step(model, args.lr)
    state = train_loop(init_state(), step_fn, loader, val_loader=loader,
                       val_loss_fn=val_fn,
                       cfg=LoopConfig(num_epochs=args.epochs,
                                      out_dir=args.out, ck_period_min=1e9),
                       to_device=_to_device(device))
    model.eval()
    with torch.no_grad():
        pred = model(torch.as_tensor(noisy_w[:64], device=device))
    result = {"out": args.out, "steps": state.step,
              "noisy_l1": round(float(np.abs(noisy_w[:64]
                                             - gt_w[:64]).mean()), 5),
              "denoised_l1": round(float(np.abs(pred.cpu().numpy()
                                                - gt_w[:64]).mean()), 5)}
    print(json.dumps(result))
    return result


def infiller_synthetic_sequence(T: int) -> dict:
    """`train-infiller --synthetic`'s sequence: smooth generated SMPL
    poses and translations, an object turning about y."""
    from scipy.spatial.transform import Rotation
    rng = np.random.RandomState(0)
    t = np.linspace(0, 4 * np.pi, T)
    return dict(
        poses=(0.2 * np.sin(t)[:, None]
               * rng.randn(72)[None]).astype(np.float32),
        trans=np.stack([0.3 * np.sin(t), 0.1 * np.cos(t), 2.2 + 0 * t],
                       -1).astype(np.float32),
        obj_rot_real=Rotation.from_euler(
            "y", (0.5 * t)[:, None]).as_matrix().astype(np.float32))


def run_train_infiller(args) -> dict:
    """`train-infiller --synthetic`: HVOP-Net on clips of a generated
    sequence, with the whole autoregressive infill scored on the sequence
    (an occluded stretch, K4's chamfer on the card) at every validation
    point; the best model is picked by that v2v. Prints and returns
    {out, steps, downstream_chamfer_cm, downstream_v2v_cm}."""
    import torch

    from ..data.datasets import InfillerClips, PrefetchLoader
    from ..fit.infill import downstream_recon_eval, make_infiller
    from ..fit.trainer_loop import (LoopConfig, make_infiller_train_step,
                                    train_loop)
    from ..models.infiller import ConditionalMInfiller, InfillerConfig
    from ..models.weights import init_random_
    from .real_track import resolve_device
    from .synthetic import box_mesh

    if not args.synthetic:
        raise SystemExit("real-data training needs packed GT; use --synthetic")
    device = resolve_device(args.device)
    T = args.frames
    seq = infiller_synthetic_sequence(T)
    clips = InfillerClips([seq], clip_len=args.clip_len)
    cfg = InfillerConfig(clip_len=args.clip_len, window=10)
    model = init_random_(ConditionalMInfiller(cfg),
                         torch.Generator().manual_seed(0)).to(device)
    init_state, step_fn, val_fn = make_infiller_train_step(model, args.lr)
    loader = PrefetchLoader(clips.example, len(clips), args.batch_size,
                            num_workers=2)
    run = make_infiller(model, cfg)
    occ = np.ones(T, np.float32)
    occ[T // 3:T // 2] = 0.0  # an occluded stretch
    bv, bf = box_mesh()
    held_out = [dict(poses=seq["poses"], trans=seq["trans"],
                     obj_rot_real=seq["obj_rot_real"],
                     obj_rot_gt=seq["obj_rot_real"], occ=occ,
                     temp_verts=bv, temp_faces=bf)]

    def downstream(state, step):
        model.eval()
        return downstream_recon_eval(run, held_out, init_thres=0.0,
                                     samples=500, device=device)

    state = train_loop(init_state(), step_fn, loader, val_loader=loader,
                       val_loss_fn=val_fn,
                       cfg=LoopConfig(num_epochs=args.epochs,
                                      out_dir=args.out, ck_period_min=1e9),
                       to_device=_to_device(device),
                       downstream_fn=downstream,
                       select_on="downstream_v2v_cm")
    final = downstream(state, state.step)
    result = {"out": args.out, "steps": state.step,
              **{k: round(v, 4) for k, v in final.items()}}
    print(json.dumps(result))
    return result


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
    else:
        {"train-sifnet": run_train_sifnet,
         "boundary-sample": run_boundary_sample,
         "train-smoothnet": run_train_smoothnet,
         "train-infiller": run_train_infiller,
         "render": run_render}[args.cmd](args)


if __name__ == "__main__":
    main()
