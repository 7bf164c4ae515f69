"""Sequence-level validation probe for SIF-Net checkpoint selection.

The port's counterpart of scripts/select_seed_by_val.py. The fixture
trainer validates on frames of the sequences it trains on, where the
visibility head can memorize; a catastrophic training draw shows only on
an unseen motion. This probe scores a SIF-Net checkpoint on a dedicated
validation sequence (motion seed 2 by default: distinct from every
training seed 0, 101, ... and from the held-out evaluation seed 1, so
selecting on it is legitimate). It renders that sequence once into
<out>/data_val, runs the stage-4 neural pass (the encoder and the
surface harvest with the funnel, fit/generator.py) on the GT bodies and
reports
  * vis_corr: corr(predicted visibility, GT occlusion ratio) -- the
    primary selector;
  * center_m: mean |neural object center - GT object center|.
Select the training seed with the highest vis_corr (ties: the lowest
center_m).

Usage:
  python scripts/select_seed_by_val_torch.py --out fixture_run_ms8 \
      --ckpt fixture_run_ms8/sifnet_small [--net-preset small] \
      [--out-json results/...] [--device cpu]
"""
import argparse
import json
import os.path as osp
import sys

import numpy as np

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))
sys.path.insert(0, osp.dirname(osp.abspath(__file__)))


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="fixture_run_ms8")
    ap.add_argument("--ckpt", required=True,
                    help="SIF-Net checkpoint folder or file of the fixture "
                         "trainer (the port's torch layout)")
    ap.add_argument("--net-preset", default="small")
    ap.add_argument("--val-motion-seed", type=int, default=2)
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--raster", type=int, default=512)
    ap.add_argument("--crop-size", type=int, default=1200)
    ap.add_argument("--net-size", type=int, default=256)
    ap.add_argument("--object-shape", default="box")
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu only when asked for")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    import run_fixture_eval_torch as rf
    from vistracker_tpu_torch.cli.real_track import _load_net, resolve_device
    from vistracker_tpu_torch.core.camera import PerspectiveCamera
    from vistracker_tpu_torch.core.landmarks import load_landmarks
    from vistracker_tpu_torch.core.smpl import load_smpl_pkl
    from vistracker_tpu_torch.data.fixture import generate_fixture_sequence
    from vistracker_tpu_torch.fit.generator import (FUNNEL_DEFAULT,
                                                    GeneratorConfig,
                                                    TorchDraws,
                                                    make_generator,
                                                    sifnet_query_fn)
    from vistracker_tpu_torch.models.sifnet import SIFNet, sifnet_preset
    from vistracker_tpu_torch.models.weights import find_checkpoint

    device = resolve_device(args.device)
    # the validation sequence: generated once, shared by every probed seed
    data_dir = osp.join(args.out, "data_val")
    meta_path = osp.join(args.out, "fixture_val_meta.npz")
    if osp.isfile(meta_path):
        m = np.load(meta_path)
        fx = {k: m[k] for k in m.files}
        fx.update({key: str(fx[key]) for key in (
            "seq_dir", "model_pkl", "objects_root")})
    else:
        print(f"[val] generating val sequence (motion_seed "
              f"{args.val_motion_seed})...", flush=True)
        fx = generate_fixture_sequence(
            data_dir, T=args.frames, raster=args.raster,
            real_assets=rf.reference_assets(),
            motion_seed=args.val_motion_seed,
            object_shape=args.object_shape, device=device)
        np.savez(meta_path, **fx)

    model = load_smpl_pkl(str(fx["model_pkl"]), device)
    assets = osp.join(osp.dirname(str(fx["seq_dir"])), "assets")
    landmarks = load_landmarks(assets, device)
    frames, _, _ = rf.build_training_frames(fx, model, landmarks,
                                            args.crop_size, args.net_size,
                                            device)
    gt_occ = np.asarray([f["visibility"] for f in frames], np.float32)
    gt_center = np.asarray(fx["obj_trans_gt"], np.float32)

    net = _load_net(SIFNet(sifnet_preset(args.net_preset,
                                         crop_size=args.crop_size),
                           PerspectiveCamera(crop_size=args.crop_size)),
                    args.ckpt, 0, device)
    ck_file = find_checkpoint(args.ckpt)
    at_step = int(torch.load(ck_file, map_location="cpu",
                             weights_only=False).get("step", -1))
    print(f"[val] probing {ck_file} (step {at_step})", flush=True)
    gen = make_generator(sifnet_query_fn(net),
                         GeneratorConfig(funnel=FUNNEL_DEFAULT))

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    B, T = args.batch, len(frames)
    pred_vis = np.zeros(T, np.float32)
    pred_center = np.zeros((T, 3), np.float32)
    for s in range(0, T, B):
        e = min(T, s + B)
        pad = B - (e - s)
        img = np.stack([frames[i]["image"] for i in range(s, e)])
        cc = np.stack([frames[i]["crop_center"] for i in range(s, e)])
        bc = np.stack([frames[i]["body_center"] for i in range(s, e)])
        if pad:  # a full batch, the last frame repeated
            img = np.concatenate([img, np.repeat(img[-1:], pad, 0)])
            cc = np.concatenate([cc, np.repeat(cc[-1:], pad, 0)])
            bc = np.concatenate([bc, np.repeat(bc[-1:], pad, 0)])
        with torch.no_grad():
            cache = net.encode(dev(img))
        pc = gen(cache, dev(cc), dev(bc), TorchDraws(s, device))
        obj = pc["object"]
        pred_vis[s:e] = obj["visibility"].cpu().numpy()[:e - s, 0]
        # the neural centers are relative to the body center
        pred_center[s:e] = (obj["centers"].cpu().numpy() + bc)[:e - s]

    rep = dict(ckpt=args.ckpt, step=at_step,
               val_motion_seed=args.val_motion_seed, frames=T,
               vis_corr=float(np.corrcoef(pred_vis, gt_occ)[0, 1]),
               center_m=float(np.linalg.norm(pred_center - gt_center,
                                             axis=1).mean()))
    print(json.dumps(rep))
    if args.out_json:
        try:
            with open(args.out_json) as f:
                all_rep = json.load(f)
        except (OSError, ValueError):
            all_rep = {"note": ("sequence-level val probe (motion_seed 2, "
                                "disjoint from training seeds AND the "
                                "heldout eval seed 1): select the training "
                                "seed with the highest vis_corr"),
                       "probes": []}
        all_rep["probes"] = [p for p in all_rep.get("probes", [])
                             if p.get("ckpt") != args.ckpt] + [rep]
        with open(args.out_json, "w") as f:
            json.dump(all_rep, f, indent=1)
    return rep


if __name__ == "__main__":
    main()
