"""Real-data (BEHAVE-layout) tracking, neural-only slice.

Port of the `--neural-only` branch of vistracker_tpu/cli/real_track.py
(the reference demo's stop after stage 4):
  stage 1  SMPL-T keypoint fit per chunk (fit/smplt.py)
  stage 3  triplane coverage masks of the fitted SMPL through kernel K1
           (ops/rasterizer.py -> ops/coverage.py)
  stage 4  SIF-Net encode + funnel surface harvest (models/sifnet.py,
           fit/generator.py)
  pack     neural_pca / neural_trans / neural_visibility + the stage-1
           SMPL parameters, as a pickle the JAX package's loader reads.
Stage 2 (SmoothNet) and stages 5-7 are not ported yet; `check_supported`
refuses the options that would need them.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

_NOT_PORTED = "not in the port yet (ROADMAP.md, Queue 1 item {})"
# Frames per SIF-Net encode call. The encode's peak device memory grows
# with its batch (release width on an H100: 22.6 GiB at 8 frames, 28.9 GiB
# at 16, chip_smoke.py) while the cache it leaves is small, so a chunk is
# encoded in slices of this many frames and the caches are joined.
ENCODE_FRAMES = 16


def _join_caches(parts: list):
    """Concatenate encode() caches (dicts / lists of (B, ...) maps)
    along the frame axis."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _join_caches([p[k] for p in parts]) for k in first}
    if isinstance(first, list):
        return [_join_caches([p[i] for p in parts])
                for i in range(len(first))]
    return torch.cat(parts, 0) if len(parts) > 1 else first


def check_supported(args):
    """Refuse what the neural-only slice cannot run, naming the ROADMAP
    item that will bring it."""
    from ..models.weights import is_torch_experiment_dir

    if not args.neural_only:
        raise SystemExit("track without --neural-only runs stages 5-7, "
                         + _NOT_PORTED.format("2 (slice 2)"))
    if args.smoothnet_smpl_ckpt:
        raise SystemExit("--smoothnet-smpl-ckpt runs stage 2, "
                         + _NOT_PORTED.format("2 (slice 2)"))
    if args.shard_frames:
        raise SystemExit("--shard-frames (multi-device frame sharding) is "
                         + _NOT_PORTED.format("5 (multi-device)"))
    ck = args.sifnet_ckpt
    if ck != "random" and os.path.isdir(ck) and not is_torch_experiment_dir(ck):
        raise SystemExit(f"{ck} looks like an orbax checkpoint of the JAX "
                         "trainer; orbax checkpoints are "
                         + _NOT_PORTED.format("3 (training)"))


def resolve_device(name: str) -> torch.device:
    """The requested device; a CUDA request without a GPU raises (the
    CPU is used only when asked for)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run on the CPU")
    return dev


def run_real_track(args, reader=None) -> dict:
    """Run the neural-only slice on one sequence. `reader` may be any
    object with the FrameDataReader interface (data/behave.py, e.g. a
    MemoryFrameReader); by default the sequence folder args.seq is read.
    Returns the summary printed as the last line (packed path, frames,
    seconds, fps, per-stage seconds, the harvest's host seconds in random
    draws and, on a GPU, per-stage peak device memory in GiB)."""
    from ..core.camera import PerspectiveCamera, intercap_camera
    from ..core.landmarks import load_landmarks
    from ..core.priors import load_body_prior, load_hand_prior, \
        mean_hand_pose
    from ..core.smpl import lbs_forward, load_smpl_pkl
    from ..core.smpl_generator import smplh_params
    from ..data.behave import FrameDataReader
    from ..data.images import prepare_input_crop
    from ..data.packed import save_packed
    from ..fit import generator as gen_mod
    from ..fit.smplt import SMPLTFitConfig, fit_smplt, init_trans_from_bbox
    from ..models.sifnet import SIFNet, cast_cache, sifnet_preset
    from ..models.weights import init_random_, load_checkpoint_state_dict
    from ..ops.rasterizer import render_triplane_masks_batch

    check_supported(args)
    device = resolve_device(args.device)
    # fp32 parity: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stage_s = dict.fromkeys(("setup", "stage1", "stage3", "inputs",
                             "stage4_encode", "stage4_harvest", "pack"), 0.0)
    stage_peak = dict.fromkeys(stage_s, 0.0)
    on_gpu = device.type == "cuda"
    if on_gpu:
        torch.cuda.reset_peak_memory_stats(device)

    def peak(stage):
        """Fold the device's peak allocation since the last call into
        the stage's (the max over chunks)."""
        if on_gpu:
            stage_peak[stage] = max(
                stage_peak[stage],
                torch.cuda.max_memory_allocated(device) / 2 ** 30)
            torch.cuda.reset_peak_memory_stats(device)

    draw_s = 0.0
    t_start = time.perf_counter()
    kid = args.kid
    reader = reader if reader is not None else FrameDataReader(args.seq)
    outfile = os.path.join(args.out, f"recon_{args.save_name}",
                           f"{reader.seq_name}_k{kid}.pkl")
    if os.path.isfile(outfile) and not args.redo:
        print(f"[vistracker] {outfile} exists, skipping (use --redo)")
        return {"packed": outfile, "skipped": True}
    end = reader.cvt_end(args.end)
    frames = list(range(args.start, end))
    print(f"[vistracker] sequence {reader.seq_name}: frames "
          f"{args.start}..{end} of {len(reader)} on {device}")

    smpl_model = load_smpl_pkl(args.smpl_model, device)
    landmarks = load_landmarks(args.assets, device)
    body_prior = load_body_prior(args.assets, device)
    hand_prior = load_hand_prior(args.assets, device)
    mean_hands = mean_hand_pose(args.assets)
    cam = (intercap_camera(kid=kid, crop_size=args.crop_size)
           if args.dataset == "intercap"
           else PerspectiveCamera(crop_size=args.crop_size))
    preset = "tiny" if args.tiny_nets else args.net_preset
    sifnet = SIFNet(sifnet_preset(preset, crop_size=args.crop_size), cam)
    if args.sifnet_ckpt == "random":  # untrained weights, smoke runs only
        init_random_(sifnet, torch.Generator().manual_seed(0))
    else:
        sifnet.load_state_dict(load_checkpoint_state_dict(args.sifnet_ckpt))
    sifnet.to(device).eval().requires_grad_(False)
    fit_cfg = SMPLTFitConfig()
    generate = gen_mod.make_generator(
        gen_mod.sifnet_query_fn(sifnet), gen_mod.GeneratorConfig(
            center_agg="median" if args.robust_centers else "mean",
            funnel=gen_mod.FUNNEL_DEFAULT if args.fast_gen else None))
    smpl_faces = torch.as_tensor(smpl_model.faces, device=device).long()
    T = len(frames)
    chunks = [frames[c0:c0 + args.chunk_size]
              for c0 in range(0, T, args.chunk_size)]
    bounds = np.cumsum([0] + [len(c) for c in chunks])
    stage_s["setup"] = time.perf_counter() - t_start
    peak("setup")

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    # ================= stage 1: per-chunk SMPL-T keypoint fits ============
    t0 = time.perf_counter()
    p1_pose = np.zeros((T, 156), np.float32)
    p1_betas = np.zeros((T, 10), np.float32)
    p1_trans = np.zeros((T, 3), np.float32)
    for ci, chunk in enumerate(chunks):
        B = len(chunk)
        sl = slice(bounds[ci], bounds[ci + 1])
        print(f"[vistracker] stage 1 chunk {chunk[0]}..{chunk[-1]} "
              f"({B} frames)")
        kpts, mocap_poses, bbox_centers = [], [], []
        for idx in chunk:
            # tol 0.1: the fitter's own keypoint threshold
            kpts.append(reader.get_body_kpts(idx, kid, tol=0.1))
            mocap_poses.append(reader.get_mocap_params(idx, kid)[0])
            pm = reader.get_mask(idx, kid, "person")
            ys, xs = np.nonzero(pm)
            if len(xs) < 10:  # detector miss: use the image center
                h, w = pm.shape
                print(f"[vistracker] warning: empty person mask at frame "
                      f"{reader.frames[idx]}, using image center")
                bbox_centers.append([w / 2, h / 2])
            else:
                bbox_centers.append([(xs.max() + xs.min()) / 2,
                                     (ys.max() + ys.min()) / 2])
        betas0 = np.zeros((B, 10), np.float32)
        betas0[:, 0] = 2.2  # fixed shape init of the reference fitter
        init = smplh_params(
            np.stack(mocap_poses), betas0,
            init_trans_from_bbox(np.asarray(bbox_centers, np.float32),
                                 fit_cfg),
            mean_hands=mean_hands, device=device)
        p1, _ = fit_smplt(smpl_model, landmarks, body_prior, hand_prior,
                          dev(np.stack(kpts)), init, fit_cfg)
        p1_pose[sl] = p1.pose.cpu().numpy()
        p1_betas[sl] = p1.betas.cpu().numpy()
        p1_trans[sl] = p1.trans.cpu().numpy()
    stage_s["stage1"] = time.perf_counter() - t0
    peak("stage1")

    # ============== stages 3 + 4 per chunk: masks, encode, harvest ========
    neural_pca = np.zeros((T, 3, 3), np.float32)
    neural_trans = np.zeros((T, 3), np.float32)
    occ_all = np.zeros(T, np.float32)
    for ci, chunk in enumerate(chunks):
        sl = slice(bounds[ci], bounds[ci + 1])
        print(f"[vistracker] stages 3-4 chunk {chunk[0]}..{chunk[-1]}")
        t0 = time.perf_counter()
        with torch.no_grad():
            verts = lbs_forward(smpl_model, dev(p1_pose[sl]),
                                dev(p1_betas[sl]), dev(p1_trans[sl]))[0]
            body_centers = landmarks.smpl_center(verts)
            tris = render_triplane_masks_batch(verts, smpl_faces,
                                               body_centers, args.net_size)
            tris = tris.cpu().numpy()
        t1 = time.perf_counter()
        peak("stage3")
        images, ccs = [], []
        for j, idx in enumerate(chunk):
            img5, cc = prepare_input_crop(
                reader.get_color(idx, kid), reader.get_mask(idx, kid, "person"),
                reader.get_mask(idx, kid, "obj"), args.crop_size,
                args.net_size)
            images.append(np.concatenate([img5, tris[j]], -1))
            ccs.append(cc)
        t2 = time.perf_counter()
        peak("inputs")
        with torch.no_grad():
            parts = []
            for f0 in range(0, len(images), ENCODE_FRAMES):
                part = sifnet.encode(dev(np.stack(
                    images[f0:f0 + ENCODE_FRAMES])))
                if args.cache_dtype == "bfloat16":
                    part = cast_cache(part, torch.bfloat16)
                parts.append(part)
            cache = _join_caches(parts)
            del parts
        if on_gpu:
            torch.cuda.synchronize(device)
        t3 = time.perf_counter()
        peak("stage4_encode")
        draws = gen_mod.TorchDraws(int(bounds[ci]), device)
        pc = generate(cache, dev(np.stack(ccs)), body_centers, draws)
        draw_s += getattr(draws, "seconds", 0.0)  # replayed draws: none
        obj = pc["object"]
        neural_pca[sl] = obj["pca_axis"].cpu().numpy()
        neural_trans[sl] = obj["centers"].cpu().numpy()
        occ_all[sl] = obj["visibility"][:, 0].cpu().numpy()
        del cache
        t4 = time.perf_counter()
        peak("stage4_harvest")
        stage_s["stage3"] += t1 - t0
        stage_s["inputs"] += t2 - t1
        stage_s["stage4_encode"] += t3 - t2
        stage_s["stage4_harvest"] += t4 - t3

    # ===================== pack (the reference's stage-4 pack) ============
    t0 = time.perf_counter()
    packed = dict(
        poses=p1_pose, betas=p1_betas, trans=p1_trans,
        obj_angles=np.broadcast_to(np.eye(3), (T, 3, 3)).copy(),
        obj_trans=np.zeros((T, 3)), obj_scales=np.ones(T),
        neural_pca=neural_pca, neural_trans=neural_trans,
        neural_visibility=occ_all, recon_exist=np.ones(T, bool),
        recon_name=args.save_name, frames=[reader.frames[i] for i in frames],
        gender=reader.seq_info.get_gender())
    save_packed(outfile, packed)
    stage_s["pack"] = time.perf_counter() - t0
    dt = time.perf_counter() - t_start
    summary = {"packed": outfile, "frames": T, "seconds": dt, "fps": T / dt,
               "stage_seconds": stage_s, "draw_seconds": draw_s}
    if on_gpu:
        summary["stage_peak_gib"] = stage_peak
    print(json.dumps(summary))
    return summary
