"""End-to-end accuracy evidence of the PyTorch port on the BEHAVE fixture.

The port's counterpart of scripts/run_fixture_eval.py, with the same
phases, options, folder layout and file conventions. It generates a
rendered BEHAVE-layout sequence (vistracker_tpu_torch/data/fixture.py),
trains the three model families on it (SIF-Net overfit on the sequence's
frames, the SmoothNet-SMPL and object-rotation denoisers, HVOP-Net at the
release clip config), tracks the sequence with the port's `track`
(cli/real_track.py, full budgets), evaluates the pack against the GT pack
with the windowed evaluator (W1, the CHORE protocol, and W300) and writes
the metrics JSON.

Differences from the JAX script: `--device` (cuda by default, through
cli/real_track.py:resolve_device) replaces `--cpu`; there is no
`--sil-backend` (the port has one silhouette path); the default results
are results/fixture_eval_torch[_PRESET].json and
results/fixture_eval_torch_heldout[_PRESET].json, beside the JAX
package's records, which it never writes. Checkpoints are the
reference's torch layout (fit/trainer_loop.py), which `track` loads.

With --train-seqs 1 (the default) the nets are trained on the sequence
they track: pipeline accuracy, not generalization. With N > 1 they train
on N motion-varied sequences (motion seeds 0, 101, ...) and the
--heldout phases measure generalization on a held-out motion.

Each phase runs in its own process by default (its own CUDA context and
memory peak); --single-process runs them in this one. Each phase's
seconds and peak device memory go to <out>/phases.jsonl. A phase whose
output folder holds a DONE marker (training) or whose pack exists
(track) is skipped, so a run cut short resumes.

Usage: python scripts/run_fixture_eval_torch.py --out fixture_run
       [--frames 90] [--train-seqs 4] [--net-preset release] [--heldout]
       [--device cpu --single-process]
"""
import argparse
import collections
import json
import os
import os.path as osp
import sys
import threading
import time

import numpy as np

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))


def log(msg):
    print(f"[fixture {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def _template(fx):
    """The fixture's object template, centred: (verts, faces)."""
    from vistracker_tpu_torch.utils.mesh import load_ply
    temp_v, temp_f = load_ply(osp.join(fx["objects_root"], "boxmedium",
                                       "boxmedium.ply"))
    return temp_v - temp_v.mean(0), temp_f


def build_training_frames(fx, model, landmarks, crop_size, net_size,
                          device="cuda"):
    """Per-frame SIF-Net training dicts from the fixture GT: the 5-channel
    crop plus the triplane masks of the GT body (all frames in one
    batched call of ops/rasterizer.py:render_triplane_masks_batch, kernel
    K1 hard on the card), the crop and body centers, the GT meshes in the
    camera frame and the occlusion ratio. Returns (frames, template
    verts, template faces)."""
    import torch

    from vistracker_tpu_torch.core.smpl import lbs_forward
    from vistracker_tpu_torch.data.behave import FrameDataReader
    from vistracker_tpu_torch.data.images import prepare_input_crop
    from vistracker_tpu_torch.ops.rasterizer import \
        render_triplane_masks_batch

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    reader = FrameDataReader(fx["seq_dir"])
    T = len(reader)
    with torch.no_grad():
        verts = lbs_forward(model, dev(fx["poses"]), dev(fx["betas"]),
                            dev(fx["trans"]))[0]
        bc = landmarks.smpl_center(verts)
        faces = torch.as_tensor(np.asarray(model.faces), device=device).long()
        tris = render_triplane_masks_batch(verts, faces, bc,
                                           net_size).cpu().numpy()
    verts, bc = verts.cpu().numpy(), bc.cpu().numpy()
    smpl_faces = np.asarray(model.faces)
    temp_v, temp_f = _template(fx)
    frames = []
    for i in range(T):
        img5, cc = prepare_input_crop(
            reader.get_color(i, 1), reader.get_mask(i, 1, "person"),
            reader.get_mask(i, 1, "obj"), crop_size, net_size)
        ov = temp_v @ fx["rot_gt"][i].T + fx["obj_trans_gt"][i]
        frames.append(dict(
            image=np.concatenate([img5, tris[i]], -1).astype(np.float32),
            crop_center=cc.astype(np.float32),
            body_center=bc[i].astype(np.float32),
            smpl_verts=verts[i].astype(np.float32),
            smpl_faces=smpl_faces,
            obj_verts=ov.astype(np.float32),
            obj_faces=temp_f,
            visibility=float(fx["occ_ratios"][i])))
    return frames, temp_v, temp_f


# --- SIF-Net sample-pool cache conventions -------------------------------
# The JAX script's, unchanged, so a cache folder written by either package
# reads in the other: POOL sets a frame, files f<frame>_p<slot>.npz, the
# seed i * 7919 + 13 + slot, and the example without its image.
SAMPLE_POOL = 8
_SAMPLE_IM_KEYS = ("images",)  # never cached; re-attached from memory


def sample_cache_dir(out_root, samples, grid_ratio):
    return osp.join(out_root, f"sample_cache_s{samples}_g{grid_ratio:g}")


def build_sample_set(frames, part_labels, i, slot, samples, grid_ratio,
                     cache_dir):
    """Load (or build and atomically persist) one slim cached sample set."""
    from vistracker_tpu_torch.data.datasets import sifnet_example
    path = osp.join(cache_dir, f"f{i:04d}_p{slot}.npz")
    if osp.exists(path):
        try:
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        except Exception:
            pass  # partial write from a killed process: rebuild
    built = sifnet_example(
        frames[i], part_labels, num_samples=samples, grid_ratio=grid_ratio,
        rng=np.random.RandomState(i * 7919 + 13 + slot))
    slim = {k: v for k, v in built.items() if k not in _SAMPLE_IM_KEYS}
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **slim)
    os.replace(tmp, path)
    return slim


def sifnet_examples(frames, part_labels, cache_dir, samples, grid_ratio):
    """(example(i), val_example(i)) over the sample pool. example cycles
    frame i through its POOL sets, one more each call; val_example always
    reads slot 0 and leaves the cycle alone, so validation never shifts
    which set trains when. Both return the frame index in place of the
    image, which the step gathers from the images held on the device."""
    calls = collections.defaultdict(int)
    lock = threading.Lock()
    memo = {}

    def load(i, slot):
        key = (i, slot)
        if key not in memo:
            slim = build_sample_set(frames, part_labels, i, slot, samples,
                                    grid_ratio, cache_dir)
            with lock:
                memo.setdefault(key, slim)
        out = dict(memo[key])
        out["frame_idx"] = np.int32(i)
        return out

    def example(i):
        with lock:
            c = calls[i]
            calls[i] += 1
        return load(i, c % SAMPLE_POOL)

    return example, lambda i: load(i, 0)


def make_gather_step(model, tcfg, images_all):
    """(step(state, batch), val_loss(state, batch)) over batches that carry
    frame_idx in place of images: each gathers its images from images_all
    (every frame's image, on the device) before the SIF-Net step of
    fit/train.py or the loss of the same training forward."""
    from vistracker_tpu_torch.fit.train import make_train_step, sifnet_loss

    inner = make_train_step(model, tcfg)

    def gather(batch):
        b = dict(batch)
        b["images"] = images_all[b.pop("frame_idx").long()]
        return b

    return (lambda state, batch: inner(state, gather(batch)),
            lambda state, batch: sifnet_loss(state.model, gather(batch),
                                             tcfg)[0])


def train_sifnet(frames, part_labels, out_dir, crop_size, net_size,
                 epochs, samples, lr=1e-3, grid_ratio=0.01, preset="tiny",
                 seed=0, device="cuda"):
    """Train the --net-preset SIF-Net (the network `track` builds for that
    preset, with remat) on the frames; checkpoints in out_dir."""
    import torch

    from vistracker_tpu_torch.core.camera import PerspectiveCamera
    from vistracker_tpu_torch.data.datasets import PrefetchLoader
    from vistracker_tpu_torch.fit import trainer_loop
    from vistracker_tpu_torch.fit.train import TrainConfig, init_train_state
    from vistracker_tpu_torch.models.sifnet import SIFNet, sifnet_preset
    from vistracker_tpu_torch.models.weights import init_random_

    cfg = sifnet_preset(preset, crop_size=crop_size, remat=True)
    model = init_random_(SIFNet(cfg, PerspectiveCamera(crop_size=crop_size)),
                         torch.Generator().manual_seed(seed)).to(device)
    cache_dir = sample_cache_dir(osp.dirname(out_dir), samples, grid_ratio)
    os.makedirs(cache_dir, exist_ok=True)
    example, val_example = sifnet_examples(frames, part_labels, cache_dir,
                                           samples, grid_ratio)
    n_workers = min(10, 2 * (os.cpu_count() or 1))
    loader = PrefetchLoader(example, len(frames), batch_size=4,
                            num_workers=n_workers, seed=seed)
    val_loader = PrefetchLoader(val_example, len(frames), batch_size=4,
                                num_workers=n_workers)
    # the df clamp at 1.0, not the release's 0.1: at this overfit scale the
    # weighted center and visibility losses push every df output above 0.1,
    # where the clamp's gradient is zero, and the df stops learning
    tcfg = TrainConfig(learning_rate=lr, max_dist=1.0)
    # every frame's image on the device once; a step gathers its batch's
    images_all = torch.as_tensor(np.stack([f["image"] for f in frames]),
                                 dtype=torch.float32, device=device)

    step, val_loss = make_gather_step(model, tcfg, images_all)
    # checkpoint and validate every 10 epochs: the epochs are a few steps
    lcfg = trainer_loop.LoopConfig(num_epochs=epochs, out_dir=out_dir,
                                   ck_period_min=1e9, max_val_batches=4,
                                   epoch_ck_period=10)
    trainer_loop.train_loop(
        init_train_state(model, tcfg), step, loader, val_loader=val_loader,
        val_loss_fn=val_loss, cfg=lcfg,
        to_device=lambda b: {k: torch.as_tensor(v, device=device)
                             for k, v in b.items()})
    return out_dir


def smoothnet_windows(fxs, W=64):
    """The SmoothNet training windows of every sequence, (N, C, W): SMPL
    (rot6d of the 24 SMPL joints, betas, translation) and object rotation
    (rot6d); windows never cross a sequence boundary, and a sequence
    shorter than W is padded with its last frame."""
    import torch

    from vistracker_tpu_torch.core.rotations import (axis_angle_to_rot6d,
                                                     rotmat_to_rot6d)
    from vistracker_tpu_torch.fit.smoothing import smplh_to_smpl_pose
    from vistracker_tpu_torch.ops.window_ops import (pad_to_window,
                                                     seq_to_windows)

    feats, rots = [], []
    for fx in fxs:
        T = len(fx["poses"])
        p72 = smplh_to_smpl_pose(np.asarray(fx["poses"]))
        rot6d = axis_angle_to_rot6d(torch.as_tensor(
            p72.reshape(-1, 3), dtype=torch.float32)).numpy().reshape(T, 144)
        feats.append(np.concatenate([rot6d, fx["betas"], fx["trans"]],
                                    1).astype(np.float32))
        rots.append(rotmat_to_rot6d(torch.as_tensor(
            np.asarray(fx["rot_gt"]), dtype=torch.float32)).numpy()
            .astype(np.float32))

    def windows(seqs):
        ws = []
        for s in seqs:
            padded, _ = pad_to_window(s, W)
            w = seq_to_windows(torch.as_tensor(padded), W, 1).numpy()
            ws.append(w.transpose(0, 2, 1))
        return np.concatenate(ws, 0)

    return windows(feats), windows(rots)


def train_smoothnets(fxs, out_smpl, out_rot, epochs=40, noise=0.03,
                     device="cuda"):
    import torch

    from vistracker_tpu_torch.data.datasets import PrefetchLoader
    from vistracker_tpu_torch.fit.trainer_loop import (
        LoopConfig, make_smoothnet_train_step, train_loop)
    from vistracker_tpu_torch.models.smoothnet import SmoothNet, SmoothNetSMPL
    from vistracker_tpu_torch.models.weights import init_random_

    W = 64
    rng = np.random.RandomState(0)
    smpl_w, rot_w = smoothnet_windows(fxs, W)
    for gt_w, model, out_dir in (
            (smpl_w, SmoothNetSMPL(window_size=W, output_size=W), out_smpl),
            (rot_w, SmoothNet(window_size=W, output_size=W), out_rot)):
        noisy = gt_w + rng.randn(*gt_w.shape).astype(np.float32) * noise

        def example(i, noisy=noisy, gt_w=gt_w):
            return dict(noisy=noisy[i], gt=gt_w[i])

        # batches of 8 windows, as the JAX script; a sequence too short for
        # 8 windows (under 71 frames) trains on what it has, where the JAX
        # loader, dropping the short batch, takes no step at all
        loader = PrefetchLoader(example, len(gt_w),
                                batch_size=min(8, len(gt_w)), num_workers=2)
        model = init_random_(model, torch.Generator().manual_seed(0)).to(
            device)
        init_state, step_fn, val_fn = make_smoothnet_train_step(model, 1e-3)
        train_loop(init_state(), step_fn, loader, val_loader=loader,
                   val_loss_fn=val_fn,
                   cfg=LoopConfig(num_epochs=epochs, out_dir=out_dir,
                                  ck_period_min=1e9, max_val_batches=2),
                   to_device=lambda b: {k: torch.as_tensor(v, device=device)
                                        for k, v in b.items()})
    return out_smpl, out_rot


def infiller_sequences(fxs, clip_len):
    """Each fixture sequence tiled to at least clip_len + 40 frames."""
    seqs = []
    for fx in fxs:
        reps = int(np.ceil((clip_len + 40) / len(fx["poses"])))
        seqs.append(dict(
            poses=np.tile(fx["poses"], (reps, 1)),
            trans=np.tile(fx["trans"], (reps, 1)),
            obj_rot_real=np.tile(fx["rot_gt"], (reps, 1, 1))))
    return seqs


def train_infiller(fxs, out_dir, epochs=60, device="cuda"):
    import torch

    from vistracker_tpu_torch.data.datasets import (InfillerClips,
                                                    PrefetchLoader)
    from vistracker_tpu_torch.fit.trainer_loop import (
        LoopConfig, make_infiller_train_step, train_loop)
    from vistracker_tpu_torch.models.infiller import (ConditionalMInfiller,
                                                      InfillerConfig)
    from vistracker_tpu_torch.models.weights import init_random_

    # the release config (clip 180, window 30): the one `track` builds
    cfg = InfillerConfig()
    clips = InfillerClips(infiller_sequences(fxs, cfg.clip_len),
                          clip_len=cfg.clip_len)
    model = init_random_(ConditionalMInfiller(cfg),
                         torch.Generator().manual_seed(0)).to(device)
    init_state, step_fn, val_fn = make_infiller_train_step(model, 1e-3)
    loader = PrefetchLoader(clips.example, len(clips), batch_size=8,
                            num_workers=2)
    train_loop(init_state(), step_fn, loader, val_loader=loader,
               val_loss_fn=val_fn,
               cfg=LoopConfig(num_epochs=epochs, out_dir=out_dir,
                              ck_period_min=1e9, max_val_batches=2),
               to_device=lambda b: {k: torch.as_tensor(v, device=device)
                                    for k, v in b.items()})
    return out_dir


def reference_assets():
    """The reference release's assets folder, whose real priors the
    fixture then uses, named by VISTRACKER_REFERENCE_ASSETS; None when
    that is unset or not a folder (the fixture synthesizes its own)."""
    path = os.environ.get("VISTRACKER_REFERENCE_ASSETS")
    return path if path and osp.isdir(path) else None


def _load_fx(args, heldout=False, k=0):
    """Load (or generate) the k-th training fixture, or the held-out one,
    and its assets folder. Training sequences k = 0.. use motion seeds 0,
    101, 102, ...; the held-out one --heldout-motion-seed. The humanoid,
    assets and object template are the same in all of them."""
    from vistracker_tpu_torch.data.fixture import generate_fixture_sequence
    if heldout:
        sub, meta, seed = "data_heldout", "fixture2_meta.npz", \
            args.heldout_motion_seed
    else:
        sub = "data" if k == 0 else f"data_s{k}"
        meta = "fixture_meta.npz" if k == 0 else f"fixture_meta_s{k}.npz"
        seed = 0 if k == 0 else 100 + k
    data_dir = osp.join(args.out, sub)
    meta_path = osp.join(args.out, meta)
    if osp.isfile(meta_path):
        m = np.load(meta_path)
        fx = {k_: m[k_] for k_ in m.files}
        fx.update({key: str(fx[key]) for key in (
            "seq_dir", "gt_pack", "model_pkl", "objects_root", "seq_name")})
    else:
        log(f"generating {'held-out ' if heldout else f'train-{k} '}fixture "
            f"({args.frames} frames, motion_seed {seed})...")
        fx = generate_fixture_sequence(
            data_dir, T=args.frames, raster=args.raster,
            real_assets=reference_assets(), motion_seed=seed,
            object_shape=args.object_shape, device=args.device)
        np.savez(meta_path, **fx)
    return fx, osp.join(data_dir, "assets")


def load_train_fixtures(args):
    """All training fixtures (a list of fx dicts) and sequence 0's assets."""
    fxs = []
    assets = None
    for k in range(getattr(args, "train_seqs", 1)):
        fx, a = _load_fx(args, k=k)
        fxs.append(fx)
        if k == 0:
            assets = a
    return fxs, assets


def _done(path):
    return osp.isfile(osp.join(path, "DONE"))


def _mark_done(path):
    with open(osp.join(path, "DONE"), "w") as f:
        f.write("ok\n")


def track_args(args, fx, assets, heldout, psuf, rsuf):
    """The port's `track` command line of the track phase: the JAX
    script's, plus --device."""
    return [
        "track", "--seq", fx["seq_dir"], "--out",
        # rsuf: a --recon-tag variant (a chunk size of the B ladder,
        # --collision) lands in its own recon folder, or track's resume
        # would skip it on the untagged folder's pack
        osp.join(args.out, ("recon_heldout" if heldout else "recon") + rsuf),
        "--smpl-model", fx["model_pkl"], "--assets", assets,
        "--objects-root", fx["objects_root"],
        "--sifnet-ckpt", osp.join(args.out, "sifnet" + psuf),
        "--infiller-ckpt", osp.join(args.out, "infiller"),
        "--smoothnet-smpl-ckpt", osp.join(args.out, "sn_smpl"),
        "--smoothnet-objrot-ckpt", osp.join(args.out, "sn_rot"),
        "--net-preset", args.net_preset,
        "--chunk-size", str(args.chunk_size),
        "--net-size", str(args.net_size),
        "--segment-iters", "5",
        # the median of the object centers and axes over the surface
        # points: robust to the tiny net's stray low-df pockets
        "--robust-centers",
        "--crop-size", str(args.crop_size), "--save-name", "fixture",
        "--device", args.device] \
        + (["--collision"] if args.collision else []) \
        + (["--fast-gen"] if args.fast_gen else ["--no-fast-gen"]) \
        + (["--ocent", str(args.ocent)] if args.ocent else [])


def recon_path(args, fx, heldout, rsuf):
    return osp.join(args.out, ("recon_heldout" if heldout else "recon")
                    + rsuf, "recon_fixture", f"{fx['seq_name']}_k1.pkl")


def run_phase(args):
    """One phase in this process."""
    from vistracker_tpu_torch.cli.real_track import resolve_device
    from vistracker_tpu_torch.core.landmarks import (load_landmarks,
                                                     load_part_labels,
                                                     part_labels_array)
    from vistracker_tpu_torch.core.smpl import load_smpl_pkl
    phase = args.phase
    heldout = phase.startswith("heldout")
    if heldout:
        fx, assets = _load_fx(args, heldout=True)
        fxs = [fx]
    else:
        fxs, assets = load_train_fixtures(args)
        fx = fxs[0]
    if phase in ("generate", "heldout-gen"):
        return  # _load_fx did the work

    device = resolve_device(args.device)
    # the sifnet checkpoint, recon and results paths carry the net preset
    # so runs of several presets share one --out; the recon and results
    # paths also carry --recon-tag while the checkpoints stay shared
    psuf = "" if args.net_preset == "tiny" else f"_{args.net_preset}"
    rsuf = psuf + (f"_{args.recon_tag}" if args.recon_tag else "")
    if phase == "train-sif":
        out = osp.join(args.out, "sifnet" + psuf)
        if _done(out):
            return log("train-sif already done")
        model = load_smpl_pkl(fx["model_pkl"], device)
        landmarks = load_landmarks(assets, device)
        part_labels = np.asarray(part_labels_array(
            load_part_labels(assets), num_verts=model.v_template.shape[0]))
        log(f"building SIF-Net training frames ({len(fxs)} sequence(s))...")
        frames = []
        for f in fxs:  # concatenated: sample-cache indices stay global
            fr, _, _ = build_training_frames(f, model, landmarks,
                                             args.crop_size, args.net_size,
                                             device)
            frames.extend(fr)
        log(f"training SIF-Net (preset {args.net_preset}, "
            f"{len(frames)} frames from {len(fxs)} sequence(s))...")
        train_sifnet(frames, part_labels, out, args.crop_size,
                     args.net_size, args.sif_epochs, args.sif_samples,
                     grid_ratio=args.grid_ratio, preset=args.net_preset,
                     seed=args.train_seed, device=device)
        return _mark_done(out)
    if phase == "train-sn":
        out_s = osp.join(args.out, "sn_smpl")
        out_r = osp.join(args.out, "sn_rot")
        if _done(out_s) and _done(out_r):
            return log("train-sn already done")
        log("training SmoothNets...")
        train_smoothnets(fxs, out_s, out_r, device=device)
        _mark_done(out_s)
        return _mark_done(out_r)
    if phase == "train-inf":
        out = osp.join(args.out, "infiller")
        if _done(out):
            return log("train-inf already done")
        log("training HVOP-Net...")
        train_infiller(fxs, out, device=device)
        return _mark_done(out)
    if phase in ("track", "heldout-track"):
        log("tracking with the port's track"
            + (" (held-out motion)..." if heldout else "..."))
        from vistracker_tpu_torch.cli import real_track
        from vistracker_tpu_torch.cli.main import build_parser
        targs = build_parser().parse_args(
            track_args(args, fx, assets, heldout, psuf, rsuf))
        real_track.run_real_track(targs)  # resumes: skips an existing pack
        return
    if phase in ("eval", "heldout-eval"):
        log("evaluating against GT...")
        from vistracker_tpu_torch.cli.main import eval_one
        from vistracker_tpu_torch.eval.evaluator import format_errors
        model = load_smpl_pkl(fx["model_pkl"], device)
        temp_v, temp_f = _template(fx)
        if heldout:
            note = ("HELD-OUT motion sequence (motion_seed="
                    f"{args.heldout_motion_seed}): tracked with nets "
                    "trained only on the training sequences -- "
                    "generalization evidence across body sway / object "
                    "orbit / occlusion phases")
        else:
            note = ("high-fidelity fixture (capsule-humanoid SMPL-H, "
                    "rendered masks/keypoints at Kinect geometry); "
                    "nets self-trained on the same sequence -- "
                    "pipeline accuracy evidence, not generalization")
        report = {"frames": int(args.frames),
                  "net_preset": args.net_preset,
                  "train_seqs": int(args.train_seqs),
                  "note": note}
        for wname, w in (("W1_chore_protocol", 1),
                         ("W300_video_protocol", 300)):
            errs = eval_one(model, recon_path(args, fx, heldout, rsuf),
                            fx["gt_pack"], temp_v, temp_f, window=w,
                            smpl_only=False, device=device)
            report[wname] = format_errors(errs)
        results = args.heldout_results if heldout else args.results
        os.makedirs(osp.dirname(results) or ".", exist_ok=True)
        with open(results, "w") as f:
            json.dump(report, f, indent=2)
        log(f"wrote {results}")
        print(json.dumps(
            {k: v for k, v in report["W1_chore_protocol"].items()
             if k in ("smpl_v2v", "obj_v2v")}, indent=1))
        return report
    raise SystemExit(f"unknown phase {phase}")


PHASES = ("generate", "train-sif", "train-sn", "train-inf", "track", "eval")
HELDOUT_PHASES = ("heldout-gen", "heldout-track", "heldout-eval")


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="fixture_run")
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--raster", type=int, default=512)
    ap.add_argument("--net-size", type=int, default=256)
    ap.add_argument("--crop-size", type=int, default=1200)
    ap.add_argument("--chunk-size", type=int, default=30)
    ap.add_argument("--recon-tag", default="",
                    help="extra suffix for the recon/results paths (keeps "
                         "checkpoints shared across e.g. chunk-size "
                         "variants)")
    ap.add_argument("--train-seqs", type=int, default=1,
                    help="number of training sequences (motion seeds 0, "
                         "101, 102, ...); nets train on the pool -- the "
                         "held-out eval then measures generalization "
                         "from a multi-sequence corpus")
    ap.add_argument("--sif-epochs", type=int, default=60)
    ap.add_argument("--train-seed", type=int, default=0,
                    help="SIF-Net init + loader shuffle seed")
    ap.add_argument("--sif-samples", type=int, default=2500)
    ap.add_argument("--grid-ratio", type=float, default=0.15,
                    help="uniform far-field sample fraction during SIF-Net "
                         "training (reference 0.01; the overfit-scale "
                         "fixture needs dense empty-space coverage)")
    ap.add_argument("--results", default=None,
                    help="output JSON (default results/fixture_eval_torch"
                         "[_PRESET].json)")
    ap.add_argument("--net-preset", choices=("tiny", "small", "release"),
                    default="tiny",
                    help="SIF-Net size preset for training AND tracking "
                         "(models/sifnet.py:sifnet_preset); non-tiny runs "
                         "suffix the sifnet/recon/results paths")
    ap.add_argument("--heldout", action="store_true",
                    help="run ONLY the held-out generalization phases "
                         "(generate a second motion sequence, track it "
                         "with the trained checkpoints, evaluate)")
    ap.add_argument("--heldout-motion-seed", type=int, default=1)
    ap.add_argument("--object-shape", choices=("box", "lbox"),
                    default="box",
                    help="fixture object template: 'box' (exact 180-deg "
                         "rotational self-symmetries) or 'lbox' "
                         "(asymmetric corner-flanged box, pose fully "
                         "observable). Use a fresh --out per shape")
    ap.add_argument("--heldout-results", default=None,
                    help="held-out output JSON (default results/"
                         "fixture_eval_torch_heldout[_PRESET].json)")
    ap.add_argument("--collision", action="store_true",
                    help="enable the stage-6 SDF collision term in the "
                         "track phases (pair with --recon-tag coll)")
    ap.add_argument("--fast-gen", action="store_true",
                    help="forward track --fast-gen (stage-4 funnel "
                         "harvest) to the track phases")
    ap.add_argument("--ocent", type=float, default=0.0,
                    help="stage-6 object-center anchor weight (see track "
                         "--ocent; pair with --recon-tag)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every phase; cpu only when asked "
                         "for")
    ap.add_argument("--phase", choices=PHASES + HELDOUT_PHASES, default=None)
    ap.add_argument("--single-process", action="store_true",
                    help="run all phases in this process")
    return ap


def default_results(args):
    """Fill in the default result paths, which are never the JAX
    package's."""
    psuf = "" if args.net_preset == "tiny" else f"_{args.net_preset}"
    if args.results is None:
        args.results = f"results/fixture_eval_torch{psuf}.json"
    if args.heldout_results is None:
        args.heldout_results = f"results/fixture_eval_torch_heldout{psuf}.json"
    return args


def timed_phase(args):
    """run_phase, then its seconds and, on a GPU, its peak device memory:
    logged and appended to <out>/phases.jsonl with the device's name."""
    import torch
    on_gpu = torch.device(args.device).type == "cuda"
    if on_gpu:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run_phase(args)
    rec = {"phase": args.phase, "frames": args.frames,
           "seconds": time.perf_counter() - t0, "peak_gib": None,
           "device": "cpu"}
    if on_gpu:
        torch.cuda.synchronize()
        rec.update(peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   device=torch.cuda.get_device_name())
    log(f"phase {args.phase}: {rec['seconds']:.3f} s"
        + (f", peak {rec['peak_gib']:.2f} GiB" if on_gpu else ""))
    os.makedirs(args.out, exist_ok=True)
    with open(osp.join(args.out, "phases.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")
    return out


def main(argv=None):
    args = default_results(build_parser().parse_args(argv))
    phases = HELDOUT_PHASES if args.heldout else PHASES
    if args.phase:
        return timed_phase(args)
    if args.single_process:
        for ph in phases:
            args.phase = ph
            timed_phase(args)
        return
    import subprocess
    base = [sys.executable, osp.abspath(__file__)]
    fwd = forwarded_args(args)
    for ph in phases:
        log(f"=== phase {ph} (subprocess) ===")
        rc = subprocess.run(base + fwd + ["--phase", ph]).returncode
        if rc != 0:
            raise SystemExit(f"phase {ph} failed rc={rc}")


def forwarded_args(args):
    """Command-line tokens that reproduce `args` in a phase subprocess,
    derived from build_parser() so that no option can be left out."""
    fwd = []
    for act in build_parser()._actions:
        if not act.option_strings or act.dest in ("help", "phase",
                                                  "single_process"):
            continue
        val = getattr(args, act.dest)
        if isinstance(act, argparse._StoreTrueAction):
            if val:
                fwd.append(act.option_strings[0])
        elif val is None:
            continue
        else:
            fwd += [act.option_strings[0], str(val)]
    return fwd


if __name__ == "__main__":
    main()
