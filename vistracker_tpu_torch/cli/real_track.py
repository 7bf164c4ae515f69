"""Real-data (BEHAVE-layout) tracking: the whole `track` pipeline.

Port of vistracker_tpu/cli/real_track.py, in the same three passes:
  pass 1   stage 1, the SMPL-T keypoint fit per chunk (fit/smplt.py);
  stage 2  with --smoothnet-smpl-ckpt: SmoothNet over the WHOLE sequence
           (fit/smoothing.py), then a 30-iteration refit per chunk;
  pass 2   per chunk: stage 3 triplane masks through kernel K1
           (ops/rasterizer.py), stage 4 SIF-Net encode + surface harvest
           (models/sifnet.py, fit/generator.py) and, while the feature
           cache is resident, stage 6a, the SMPL phase of the joint
           optimization (fit/joint.py:make_smpl_optimizer);
  stage 5  over the whole sequence: object rotation init from the neural
           PCA axes, optional SmoothNet smoothing, HVOP-Net infill
           (fit/infill.py);
  pass 3   per chunk: the stage-3 inputs and the cache are rebuilt (not
           held across the sequence-wide stages) and stage 6b runs the
           object, silhouette and joint phases (make_object_optimizer;
           kernels K1 soft, K2 and K3);
  pack     SMPL and object parameters plus the neural outputs, as a
           pickle the JAX package's loader reads, and a _track.json
           summary beside it.
`--neural-only` stops after stage 4 and packs the neural outputs.
SmoothNet windows and the infiller's context cross chunk boundaries;
chunking only bounds device memory. `check_supported` refuses what the
port does not have yet.

`--shard-frames` under a launcher with more than one process (torchrun,
SLURM; parallel/mesh.py) splits each chunk's frames over the ranks as
the JAX package shards them over its devices: every rank reads, masks,
encodes, harvests and fits (stages 1, 2-refit, 3, 4, 6a, 6b) its own
block of frames, the fits exchange 2-frame halos and reduce their
losses, and each stage's results are gathered to every rank. Stage 5
and the SmoothNets run on the whole sequence on every rank, as JAX
replicates them. Rank 0 writes the pack. With one process the flag
changes nothing.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..utils import trace

# Frames per SIF-Net encode call. The encode's peak device memory grows
# with its batch (release width on an H100: 22.6 GiB at 8 frames, 28.9 GiB
# at 16, chip_smoke.py) while the cache it leaves is small, so a chunk is
# encoded in slices of this many frames and the caches are joined.
ENCODE_FRAMES = 16
SMOOTH_WINDOW = 64
# checkpoint flag -> scripts/orbax_to_torch.py --kind
ORBAX_KINDS = {"sifnet_ckpt": "sifnet", "infiller_ckpt": "infiller",
               "smoothnet_smpl_ckpt": "smoothnet-smpl",
               "smoothnet_objrot_ckpt": "smoothnet-objrot"}
STAGES = ("setup", "stage1", "stage2", "stage3", "inputs", "stage4_encode",
          "stage4_harvest", "stage6a", "stage5", "stage6b", "pack")


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
    """Refuse what the port cannot run yet, naming the ROADMAP item that
    will bring it."""
    from ..models.weights import is_torch_experiment_dir

    for need, name in ((args.smpl_model, "--smpl-model"),
                       (args.sifnet_ckpt, "--sifnet-ckpt")):
        if not need:
            raise SystemExit(f"track --seq requires {name}")
    if not args.neural_only:
        for need, name in ((args.objects_root, "--objects-root"),
                           (args.infiller_ckpt, "--infiller-ckpt")):
            if not need:
                raise SystemExit(f"track requires {name} unless "
                                 "--neural-only is given")
    for flag, kind in ORBAX_KINDS.items():
        ck = getattr(args, flag)
        if ck and ck != "random" and os.path.isdir(ck) \
                and not is_torch_experiment_dir(ck):
            raise SystemExit(
                f"{ck} looks like an orbax checkpoint of the JAX trainer, "
                "which the port does not read (orbax is a JAX package). "
                "Convert it where orbax and flax are installed: python "
                f"scripts/orbax_to_torch.py --kind {kind}"
                + (" --preset <tiny|small|release>" if kind == "sifnet"
                   else "")
                + f" --exp {ck} --out <dir>, then pass --"
                + flag.replace("_", "-") + " <dir>")


def resolve_device(name: str) -> torch.device:
    """The requested device; a CUDA request without a GPU raises (the
    CPU is used only when asked for). Every entry point calls this, so it
    also keeps fp32 parity there: no TF32 in matmuls or cuDNN
    convolutions."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def _load_net(model, ckpt: str, seed: int, device, smoothnet: bool = False):
    """Weights from a released torch checkpoint, or seeded random ones for
    "random" (smoke runs only); eval mode, no gradients, on `device`."""
    from ..models.weights import (find_checkpoint, init_random_,
                                  load_checkpoint_state_dict)

    if ckpt == "random":
        init_random_(model, torch.Generator().manual_seed(seed))
    else:
        if smoothnet:
            container = torch.load(find_checkpoint(ckpt), map_location="cpu",
                                   weights_only=False)
            if "epoch" in container and int(container["epoch"]) < 10:
                # the reference refuses under-trained SmoothNets
                raise ValueError("SmoothNet checkpoint only trained to "
                                 f"epoch {container['epoch']} (< 10)")
        sd = load_checkpoint_state_dict(ckpt)
        if smoothnet and "model.encoder.0.weight" in sd:
            sd = {k[len("model."):]: v for k, v in sd.items()}
        model.load_state_dict(sd)
    return model.to(device).eval().requires_grad_(False)


def run_real_track(args, reader=None) -> dict:
    """Run `track` on one sequence. `reader` may be any object with the
    FrameDataReader interface (data/behave.py, e.g. a MemoryFrameReader);
    by default the sequence folder args.seq is read. Returns the summary
    printed as the last line (packed path, frames, seconds, fps, chunk
    size, mean iterations of the stage-6 phases, per-stage seconds, the
    harvest's host seconds in random draws and, on a GPU, per-stage peak
    device memory in GiB; the number of ranks and, sharded, every rank's
    per-stage seconds and peaks)."""
    from ..core.camera import PerspectiveCamera, intercap_camera
    from ..core.landmarks import (load_landmarks, load_part_labels,
                                  part_labels_array)
    from ..core.priors import load_body_prior, load_hand_prior, \
        mean_hand_pose
    from ..core.smpl import lbs_forward, load_smpl_pkl
    from ..core.smpl_generator import smplh_params
    from ..data.behave import FrameDataReader, load_template
    from ..data.images import prepare_input_crop
    from ..data.packed import save_packed
    from ..data.silprep import prepare_sil_refs
    from ..fit import generator as gen_mod
    from ..fit import joint as joint_mod
    from ..fit.infill import make_infiller
    from ..fit.smoothing import smooth_objrot, smooth_smplt
    from ..fit.smplt import SMPLTFitConfig, fit_smplt, init_trans_from_bbox
    from ..models.infiller import ConditionalMInfiller, InfillerConfig
    from ..models.sifnet import SIFNet, cast_cache, sifnet_preset
    from ..models.smoothnet import SmoothNet, SmoothNetSMPL
    from ..ops.rasterizer import render_triplane_masks_batch
    from ..ops.sdf_grid import SDFGrid
    from ..parallel.mesh import (Dist, FrameShard, all_gather_cat,
                                 all_reduce_sum, init_distributed)
    from ..utils.mesh import (compute_pca_axes, decimate_faces,
                              sample_surface, signed_distance_grid)

    check_supported(args)
    ranks = (init_distributed(args.device, args.dist_backend)
             if args.shard_frames else Dist(device=torch.device(args.device)))
    device = resolve_device(str(ranks.device))
    lead = ranks.rank == 0  # writes the pack and prints the summary
    stage_s = dict.fromkeys(STAGES, 0.0)
    stage_peak = dict.fromkeys(STAGES, 0.0)
    on_gpu = device.type == "cuda"
    if on_gpu:
        torch.cuda.reset_peak_memory_stats(device)

    def lap(stage, t0):
        """Charge the time since t0 (time.time_ns()) to `stage`, close
        the tracer's stage span over that interval, and fold the device's
        peak allocation since the last call into the stage's (the max
        over chunks); returns the new t0."""
        if on_gpu:
            torch.cuda.synchronize(device)
            stage_peak[stage] = max(
                stage_peak[stage],
                torch.cuda.max_memory_allocated(device) / 2 ** 30)
            torch.cuda.reset_peak_memory_stats(device)
        now = time.time_ns()
        stage_s[stage] += (now - t0) / 1e9
        trace.close(stage, t0, now)
        return now

    draw_s = 0.0
    t_start = time.time_ns()
    kid = args.kid
    reader = reader if reader is not None else FrameDataReader(args.seq)
    outfile = os.path.join(args.out, f"recon_{args.save_name}",
                           f"{reader.seq_name}_k{kid}.pkl")
    skip = torch.tensor([float(lead and os.path.isfile(outfile)
                               and not args.redo)])
    if all_reduce_sum(skip, ranks)[0] > 0:  # rank 0 decides for all
        print(f"[vistracker] {outfile} exists, skipping (use --redo)")
        return {"packed": outfile, "skipped": True}
    end = reader.cvt_end(args.end)
    frames = list(range(args.start, end))
    print(f"[vistracker] sequence {reader.seq_name}: frames "
          f"{args.start}..{end} of {len(reader)} on {device}")
    neural_only = args.neural_only

    t_load = time.time_ns()
    smpl_model = load_smpl_pkl(args.smpl_model, device)
    landmarks = load_landmarks(args.assets, device)
    body_prior = load_body_prior(args.assets, device)
    hand_prior = load_hand_prior(args.assets, device)
    mean_hands = mean_hand_pose(args.assets)
    cam = (intercap_camera(kid=kid, crop_size=args.crop_size)
           if args.dataset == "intercap"
           else PerspectiveCamera(crop_size=args.crop_size))
    preset = "tiny" if args.tiny_nets else args.net_preset
    sifnet = _load_net(SIFNet(sifnet_preset(preset,
                                            crop_size=args.crop_size), cam),
                       args.sifnet_ckpt, 0, device)
    W = SMOOTH_WINDOW
    sn_smpl = sn_rot = None
    if args.smoothnet_smpl_ckpt:
        sn_smpl = _load_net(SmoothNetSMPL(window_size=W, output_size=W),
                            args.smoothnet_smpl_ckpt, 7, device, True)
    fit_cfg = SMPLTFitConfig()
    generate = gen_mod.make_generator(
        gen_mod.sifnet_query_fn(sifnet), gen_mod.GeneratorConfig(
            center_agg="median" if args.robust_centers else "mean",
            funnel=gen_mod.FUNNEL_DEFAULT if args.fast_gen else None))
    trace.close("models", t_load)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    if not neural_only:
        t_object = time.time_ns()
        part_labels = part_labels_array(
            load_part_labels(args.assets),
            num_verts=smpl_model.v_template.shape[0])
        temp_v, temp_f = load_template(args.objects_root,
                                       reader.seq_info.get_obj_name())
        pca_init = compute_pca_axes(temp_v)
        obj_points = sample_surface(temp_v, temp_f, 3000,
                                    np.random.RandomState(0))
        sil_faces = torch.as_tensor(
            decimate_faces(temp_f, 2500).astype(np.int64), device=device)
        inf_cfg = InfillerConfig()
        run_infill = make_infiller(
            _load_net(ConditionalMInfiller(inf_cfg), args.infiller_ckpt, 1,
                      device), inf_cfg)
        if args.smoothnet_objrot_ckpt:
            sn_rot = _load_net(SmoothNet(window_size=W, output_size=W),
                               args.smoothnet_objrot_ckpt, 7, device, True)
        # the fixed budget IS reference parity (the reference's own
        # early-stop gate does not fire); --early-stop turns the gates on
        jcfg = joint_mod.JointFitConfig(
            early_stop=args.early_stop, collision=args.collision,
            w_ocent=float(args.ocent or 0.0),
            smpl_query_points=args.smpl_query_points or 0)
        sdf_grid = None
        if args.collision:
            # template SDF grid built once per sequence on the host
            vals, bmin, bmax = signed_distance_grid(temp_v, temp_f,
                                                    int(args.sdf_res or 64))
            sdf_grid = SDFGrid(dev(vals), dev(bmin), dev(bmax))
            print(f"[vistracker] collision term ON (template SDF grid "
                  f"{vals.shape[0]}^3)")

        def query_fn(ctx, points):
            return sifnet.query(ctx["cache"], points, ctx["cc"],
                                ctx["bc"])[-1]

        # head-restricted per-step queries: the SMPL-phase loss reads df
        # and parts, the object-phase losses only df
        def query_smpl_step(ctx, points):
            return sifnet.query_heads(ctx["cache"], points, ctx["cc"],
                                      ctx["bc"], heads=("df", "parts"))

        def query_df_step(ctx, points):
            return sifnet.query_heads(ctx["cache"], points, ctx["cc"],
                                      ctx["bc"], heads=("df",))

        opt_smpl = joint_mod.make_smpl_optimizer(
            query_smpl_step,
            lambda ctx, j: cam.project_points(j, ctx["cc"])[..., :2],
            smpl_model, landmarks, body_prior, hand_prior, part_labels, jcfg,
            report_iters=True)
        opt_obj = joint_mod.make_object_optimizer(
            query_df_step, lambda ctx, p: cam.project_screen(p), jcfg,
            report_iters=True, contact_query_fn=query_fn)
        trace.close("object", t_object)
    iters_log = {"smpl": [], "joint": []}

    smpl_faces = torch.as_tensor(smpl_model.faces, device=device).long()
    T = len(frames)
    chunks = [frames[c0:c0 + args.chunk_size]
              for c0 in range(0, T, args.chunk_size)]
    bounds = np.cumsum([0] + [len(c) for c in chunks])
    if ranks.active:
        print(f"[vistracker] frame sharding: rank {ranks.rank} of "
              f"{ranks.world_size} ({ranks.backend}) on {device}")

    def shard_of(chunk):
        """(the chunk's FrameShard or None, this rank's frames)."""
        if not ranks.active:
            return None, chunk
        sh = FrameShard(len(chunk), ranks)
        return sh, [chunk[i] for i in sh.indices()]

    def local(sh, x):
        """This rank's rows of a chunk's array."""
        return x if sh is None else sh.local(x)

    def whole(sh, x):
        """This rank's rows (a tensor) -> the whole chunk, numpy."""
        with trace.span("to_host"):
            return (x if sh is None else sh.gather_frames(x)).cpu().numpy()

    t0 = lap("setup", t_start)

    def build_images(chunk, verts, body_centers, t0):
        """Stage-3 inputs of one chunk: the 5-channel crop stack plus the
        3 triplane masks. Rebuilt from the reader on each pass, which is
        cheaper than holding every chunk's feature cache across the
        sequence-wide stages."""
        with torch.no_grad():
            with trace.span("render"):
                tris = render_triplane_masks_batch(
                    verts, smpl_faces, body_centers, args.net_size)
            with trace.span("readback"):
                tris = tris.cpu().numpy()
        t0 = lap("stage3", t0)
        images, ccs = [], []
        for j, idx in enumerate(chunk):
            with trace.span("frame", {"frame": idx}):
                with trace.span("read"):
                    raw = (reader.get_color(idx, kid),
                           reader.get_mask(idx, kid, "person"),
                           reader.get_mask(idx, kid, "obj"))
                with trace.span("crop"):
                    img5, cc = prepare_input_crop(*raw, args.crop_size,
                                                  args.net_size)
            images.append(np.concatenate([img5, tris[j]], -1))
            ccs.append(cc)
        return np.stack(images), np.stack(ccs), lap("inputs", t0)

    def encode_chunk(images, t0):
        with torch.no_grad():
            parts = []
            for f0 in range(0, len(images), ENCODE_FRAMES):
                with trace.span("encode.slice", {"frame": f0}):
                    part = sifnet.encode(dev(images[f0:f0 + ENCODE_FRAMES]))
                    if args.cache_dtype == "bfloat16":
                        part = cast_cache(part, torch.bfloat16)
                parts.append(part)
            cache = _join_caches(parts)
        return cache, lap("stage4_encode", t0)

    def lbs_verts(pose, betas, trans):
        with torch.no_grad(), trace.span("lbs"):
            return lbs_forward(smpl_model, dev(pose), dev(betas),
                               dev(trans))[0]

    def norm_kpts(k, ccs):
        xy = 2.0 * (args.crop_size / 2 + k[..., :2]
                    - ccs[:, None, :]) / args.crop_size - 1.0
        return np.concatenate([xy, k[..., 2:]], -1).astype(np.float32)

    # ================= pass 1: per-chunk SMPL-T keypoint fits =============
    kpts_all = np.zeros((T, 25, 3), np.float32)
    p1_pose = np.zeros((T, 156), np.float32)
    p1_betas = np.zeros((T, 10), np.float32)
    p1_trans = np.zeros((T, 3), np.float32)
    for ci, chunk in enumerate(chunks):
        sl = slice(bounds[ci], bounds[ci + 1])
        print(f"[vistracker] stage 1 chunk {chunk[0]}..{chunk[-1]} "
              f"({len(chunk)} frames)")
        sh, mine = shard_of(chunk)
        kpts, mocap_poses, bbox_centers = [], [], []
        with trace.span("frame_inputs", {"chunk": ci}):
            for idx in mine:
                # tol 0.1: the fitter's own keypoint threshold
                kpts.append(reader.get_body_kpts(idx, kid, tol=0.1))
                mocap_poses.append(reader.get_mocap_params(idx, kid)[0])
                pm = reader.get_mask(idx, kid, "person")
                ys, xs = np.nonzero(pm)
                if len(xs) < 10:  # detector miss: use the image center
                    h, w = pm.shape
                    print(f"[vistracker] warning: empty person mask at "
                          f"frame {reader.frames[idx]}, using image center")
                    bbox_centers.append([w / 2, h / 2])
                else:
                    bbox_centers.append([(xs.max() + xs.min()) / 2,
                                         (ys.max() + ys.min()) / 2])
        kpts = dev(np.stack(kpts))
        kpts_all[sl] = whole(sh, kpts)
        betas0 = np.zeros((len(mine), 10), np.float32)
        betas0[:, 0] = 2.2  # fixed shape init of the reference fitter
        init = smplh_params(
            np.stack(mocap_poses), betas0,
            init_trans_from_bbox(np.asarray(bbox_centers, np.float32),
                                 fit_cfg),
            mean_hands=mean_hands, device=device)
        p1, _ = fit_smplt(smpl_model, landmarks, body_prior, hand_prior,
                          kpts, init, fit_cfg, shard=sh)
        p1_pose[sl] = whole(sh, p1.pose)
        p1_betas[sl] = whole(sh, p1.betas)
        p1_trans[sl] = whole(sh, p1.trans)
    t0 = lap("stage1", t0)

    # ============ stage 2: whole-sequence SmoothNet smooth + refit =========
    # the sliding windows span the whole sequence, crossing chunk
    # boundaries; only the refit streams in chunks
    p2_pose, p2_betas, p2_trans = p1_pose, p1_betas, p1_trans
    if sn_smpl is not None:
        print(f"[vistracker] stage 2: SmoothNet over all {T} frames + refit")
        with trace.span("smooth"):
            sm = smooth_smplt(sn_smpl, p1_pose, p1_betas, p1_trans, window=W)
        p2_pose = np.zeros_like(p1_pose)
        p2_betas = np.zeros_like(p1_betas)
        p2_trans = np.zeros_like(p1_trans)
        refit_cfg = SMPLTFitConfig(max_iters=30)
        for ci, chunk in enumerate(chunks):
            sl = slice(bounds[ci], bounds[ci + 1])
            sh, _ = shard_of(chunk)
            init2 = smplh_params(
                local(sh, sm["poses"][sl]), local(sh, sm["betas"][sl]),
                local(sh, sm["trans"][sl]), mean_hands=mean_hands,
                device=device)
            p2, _ = fit_smplt(smpl_model, landmarks, body_prior, hand_prior,
                              dev(local(sh, kpts_all[sl])), init2, refit_cfg,
                              skip_global_phase=True, shard=sh)
            p2_pose[sl] = whole(sh, p2.pose)
            p2_betas[sl] = whole(sh, p2.betas)
            p2_trans[sl] = whole(sh, p2.trans)
        t0 = lap("stage2", t0)

    # ====== pass 2: per-chunk stages 3 + 4 (+ stage 6a, the SMPL phase) ====
    body_centers_all = np.zeros((T, 3), np.float32)
    neural_pca = np.zeros((T, 3, 3), np.float32)
    neural_trans = np.zeros((T, 3), np.float32)
    occ_all = np.zeros(T, np.float32)
    smpl_pose = np.zeros_like(p1_pose)
    smpl_betas = np.zeros_like(p1_betas)
    smpl_trans = np.zeros_like(p1_trans)
    for ci, chunk in enumerate(chunks):
        sl = slice(bounds[ci], bounds[ci + 1])
        print(f"[vistracker] stages 3-4 chunk {chunk[0]}..{chunk[-1]}")
        sh, mine = shard_of(chunk)
        verts2 = lbs_verts(local(sh, p2_pose[sl]), local(sh, p2_betas[sl]),
                           local(sh, p2_trans[sl]))
        body_centers = landmarks.smpl_center(verts2)
        body_centers_all[sl] = whole(sh, body_centers)
        images, ccs, t0 = build_images(mine, verts2, body_centers, t0)
        cache, t0 = encode_chunk(images, t0)
        # the chunk's draws; a rank keeps those of its frames
        draws = gen_mod.TorchDraws(int(bounds[ci]), device)
        pc = generate(cache, dev(ccs), body_centers,
                      draws if sh is None else gen_mod.ShardDraws(draws, sh))
        draw_s += getattr(draws, "seconds", 0.0)  # replayed draws: none
        obj = pc["object"]
        neural_pca[sl] = whole(sh, obj["pca_axis"])
        neural_trans[sl] = whole(sh, obj["centers"])
        occ_all[sl] = whole(sh, obj["visibility"][:, 0])
        t0 = lap("stage4_harvest", t0)
        if neural_only:
            continue
        # stage 6a depends only on the smoothed SMPL-T init and this
        # chunk's neural fields, so it runs while the cache is resident
        ctx = dict(cache=cache, cc=dev(ccs), bc=body_centers)
        p2c = smplh_params(local(sh, p2_pose[sl]), local(sh, p2_betas[sl]),
                           local(sh, p2_trans[sl]), mean_hands=mean_hands,
                           device=device)
        smpl_final, _, it_s = opt_smpl(
            p2c, dev(norm_kpts(local(sh, kpts_all[sl]), ccs)), ctx,
            shard=sh)
        iters_log["smpl"].append(int(it_s["smpl"]))
        tag = ("early-stopped at" if it_s["smpl"] < it_s["smpl_max"]
               else "ran full")
        print(f"[vistracker]   optimize_smpl {tag} iter "
              f"{it_s['smpl']}/{it_s['smpl_max']}")
        smpl_pose[sl] = whole(sh, smpl_final.pose)
        smpl_betas[sl] = whole(sh, smpl_final.betas)
        smpl_trans[sl] = whole(sh, smpl_final.trans)
        del cache, ctx
        t0 = lap("stage6a", t0)

    packed = dict(neural_pca=neural_pca, neural_trans=neural_trans,
                  neural_visibility=occ_all, recon_exist=np.ones(T, bool),
                  obj_scales=np.ones(T), recon_name=args.save_name,
                  frames=[reader.frames[i] for i in frames],
                  gender=reader.seq_info.get_gender())
    if neural_only:
        # the reference's stage-4 pack: neural outputs only
        packed.update(
            poses=p2_pose, betas=p2_betas, trans=p2_trans,
            obj_angles=np.broadcast_to(np.eye(3), (T, 3, 3)).copy(),
            obj_trans=np.zeros((T, 3)))
    else:
        # ==== stage 5: whole-sequence object-rot smoothing + infill =====
        # the autoregressive 30-frame context carries across the whole
        # sequence, so occlusions spanning chunk boundaries are infilled
        # from real context
        print(f"[vistracker] stage 5: smoothing + infill over all {T} "
              "frames")
        with torch.no_grad():
            rot_init = joint_mod.init_object_orientation(
                torch.as_tensor(neural_pca),
                torch.as_tensor(pca_init).expand(T, 3, 3)).numpy()
        rot_real = rot_init.transpose(0, 2, 1)
        if sn_rot is not None:
            with trace.span("smooth"):
                rot_real = smooth_objrot(sn_rot, rot_real, window=W) \
                    .transpose(0, 2, 1)
        with trace.span("infill"):
            filled = run_infill(smpl_pose, smpl_trans, rot_real, occ_all)
        infilled = filled is not None  # None: too few visible seed frames
        rot_real = filled if infilled else rot_real
        t0 = lap("stage5", t0)

        # ============ pass 3: per-chunk stage-6b object fitting ==========
        obj_angles = np.zeros((T, 3, 3), np.float32)
        obj_trans = np.zeros((T, 3), np.float32)
        for ci, chunk in enumerate(chunks):
            sl = slice(bounds[ci], bounds[ci + 1])
            print(f"[vistracker] stage 6 chunk {chunk[0]}..{chunk[-1]}")
            sh, mine = shard_of(chunk)
            B = len(mine)
            # the triplanes come from the SMOOTHED SMPL as in pass 2
            verts2 = lbs_verts(local(sh, p2_pose[sl]),
                               local(sh, p2_betas[sl]),
                               local(sh, p2_trans[sl]))
            bc = dev(local(sh, body_centers_all[sl]))
            images, ccs, t0 = build_images(mine, verts2, bc, t0)
            cache, t0 = encode_chunk(images, t0)
            ctx = dict(cache=cache, cc=dev(ccs), bc=bc)
            verts_f = lbs_verts(local(sh, smpl_pose[sl]),
                                local(sh, smpl_betas[sl]),
                                local(sh, smpl_trans[sl]))
            with trace.span("sil_refs"):
                sil = prepare_sil_refs(images[..., 3], images[..., 4], ccs,
                                       args.crop_size, args.net_size,
                                       jcfg.sil_size, device=device)
            # obj_s is fixed to 1 (the release uses a single scale)
            r_fin, t_fin, _, it_o = opt_obj(
                dev(local(sh, rot_real[sl]).transpose(0, 2, 1)),
                dev(local(sh, neural_trans[sl] + body_centers_all[sl])),
                torch.ones(B, device=device),
                dev(obj_points).expand(B, -1, -1), verts_f, part_labels,
                dev(local(sh, occ_all[sl])), sil,
                dev(temp_v).expand(B, -1, -1), sil_faces, ctx,
                sdf_grid=sdf_grid, shard=sh)
            iters_log["joint"].append(int(it_o["joint"]))
            tag = ("early-stopped at" if it_o["joint"] < it_o["joint_max"]
                   else "ran full")
            print(f"[vistracker]   joint phase {tag} iter "
                  f"{it_o['joint']}/{it_o['joint_max']}")
            obj_angles[sl] = whole(sh, r_fin)
            obj_trans[sl] = whole(sh, t_fin)
            del cache, ctx
            t0 = lap("stage6b", t0)
        packed.update(poses=smpl_pose, betas=smpl_betas, trans=smpl_trans,
                      obj_angles=obj_angles, obj_trans=obj_trans)

    # ================================ pack =================================
    if lead:
        with trace.span("save"):
            save_packed(outfile, packed)
    t_end = lap("pack", t0)
    trace.close("track", t_start, t_end)
    dt = (t_end - t_start) / 1e9
    summary = {"packed": outfile, "frames": T, "seconds": dt, "fps": T / dt,
               "chunk_size": args.chunk_size,
               **{f"iters_{k}_mean": float(np.mean(v))
                  for k, v in iters_log.items() if v},
               "stage_seconds": stage_s, "draw_seconds": draw_s,
               "world_size": ranks.world_size}
    if not neural_only:
        summary["stage5_infilled"] = infilled
    if on_gpu:
        summary["stage_peak_gib"] = stage_peak
    if ranks.active:
        rows = all_gather_cat(torch.tensor(
            [[stage_s[k] for k in STAGES] + [stage_peak[k] for k in STAGES]],
            dtype=torch.float64), ranks).tolist()
        summary["rank_stage_seconds"] = [dict(zip(STAGES, r)) for r in rows]
        if on_gpu:
            summary["rank_peak_gib"] = [dict(zip(STAGES, r[len(STAGES):]))
                                        for r in rows]
    if lead:
        print(json.dumps(summary))
        if not neural_only:
            with open(outfile.replace(".pkl", "_track.json"), "w") as f:
                json.dump(summary, f, indent=2)
    return summary
