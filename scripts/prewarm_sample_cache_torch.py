"""Prewarm the SIF-Net sample-set pool of run_fixture_eval_torch.py.

The fixture trainer (scripts/run_fixture_eval_torch.py:train_sifnet)
builds its SAMPLE_POOL boundary-sample sets a frame lazily inside the
loader. This script builds the same npz files, with the conventions
imported from that script (build_sample_set, sample_cache_dir), in a
separate process on the CPU, in reverse slot and frame order so it meets
the trainer's forward pass in the middle. Run it beside the trainer at a
low priority: it uses the host cycles the trainer leaves idle.

A build that races the trainer's is safe: writers use a unique temporary
name and os.replace, and a corrupt read is rebuilt. The skinning runs on
the CPU here and on the card in the trainer, so a set built here can
differ from the trainer's in the last bits of the float32 vertices.

Usage: python scripts/prewarm_sample_cache_torch.py --out fixture_run
       [--sif-samples 2500] [--grid-ratio 0.15] [--pool 8]
"""
import argparse
import os
import os.path as osp
import sys

import numpy as np

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))
sys.path.insert(0, osp.dirname(osp.abspath(__file__)))


def training_metas(out: str) -> list:
    """fixture_meta.npz, then fixture_meta_s1.npz, ...: the order in which
    run_fixture_eval_torch.py's train-sif phase concatenates the frames,
    so the global frame indices (the cache keys and seeds) match."""
    metas = [osp.join(out, "fixture_meta.npz")]
    k = 1
    while osp.isfile(osp.join(out, f"fixture_meta_s{k}.npz")):
        metas.append(osp.join(out, f"fixture_meta_s{k}.npz"))
        k += 1
    return metas


def sample_frames(metas: list):
    """(frame dicts without images, part labels) of every training
    sequence: what build_sample_set reads."""
    import torch

    from vistracker_tpu_torch.core.landmarks import (load_landmarks,
                                                     load_part_labels,
                                                     part_labels_array)
    from vistracker_tpu_torch.core.smpl import lbs_forward, load_smpl_pkl
    from vistracker_tpu_torch.data.behave import FrameDataReader
    from vistracker_tpu_torch.data.images import crop_center_from_masks
    from run_fixture_eval_torch import _template

    frames, part_labels = [], None
    # the image is not in the cached sets (the trainer re-attaches it), so
    # a 1 x 1 stand-in satisfies sifnet_example
    dummy_img = np.zeros((1, 1, 8), np.float32)
    for meta in metas:
        m = np.load(meta)
        fx = {k: m[k] for k in m.files}
        seq_dir = str(fx["seq_dir"])
        fx["objects_root"] = str(fx["objects_root"])
        assets = osp.join(osp.dirname(seq_dir), "assets")
        model = load_smpl_pkl(str(fx["model_pkl"]))
        landmarks = load_landmarks(assets)
        if part_labels is None:
            part_labels = np.asarray(part_labels_array(
                load_part_labels(assets),
                num_verts=model.v_template.shape[0]))
        with torch.no_grad():
            verts = lbs_forward(
                model, *[torch.as_tensor(np.asarray(fx[k], np.float32))
                         for k in ("poses", "betas", "trans")])[0]
            bc = landmarks.smpl_center(verts).numpy()
        verts = verts.numpy()
        temp_v, temp_f = _template(fx)
        reader = FrameDataReader(seq_dir)
        smpl_faces = np.asarray(model.faces)
        for i in range(len(reader)):
            cc = crop_center_from_masks(reader.get_mask(i, 1, "person"),
                                        reader.get_mask(i, 1, "obj"))
            ov = temp_v @ fx["rot_gt"][i].T + fx["obj_trans_gt"][i]
            frames.append(dict(
                image=dummy_img, crop_center=np.asarray(cc),
                body_center=bc[i].astype(np.float32),
                smpl_verts=verts[i].astype(np.float32),
                smpl_faces=smpl_faces,
                obj_verts=ov.astype(np.float32), obj_faces=temp_f,
                visibility=float(fx["occ_ratios"][i])))
    return frames, part_labels


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="fixture_run",
                    help="run_fixture_eval_torch --out folder (holds "
                         "fixture_meta.npz and the sample cache)")
    ap.add_argument("--sif-samples", type=int, default=2500)
    ap.add_argument("--grid-ratio", type=float, default=0.15)
    ap.add_argument("--pool", type=int, default=8)
    args = ap.parse_args(argv)
    from run_fixture_eval_torch import build_sample_set, sample_cache_dir

    metas = training_metas(args.out)
    frames, part_labels = sample_frames(metas)
    T = len(frames)
    print(f"[prewarm] {T} frame dicts ready ({len(metas)} sequence(s))",
          flush=True)
    cache_dir = sample_cache_dir(args.out, args.sif_samples, args.grid_ratio)
    os.makedirs(cache_dir, exist_ok=True)
    built = skipped = 0
    for slot in range(args.pool - 1, -1, -1):
        for i in range(T - 1, -1, -1):
            if osp.exists(osp.join(cache_dir, f"f{i:04d}_p{slot}.npz")):
                skipped += 1
                continue
            build_sample_set(frames, part_labels, i, slot,
                             args.sif_samples, args.grid_ratio, cache_dir)
            built += 1
            if built % 25 == 0:
                print(f"[prewarm] built {built} skipped {skipped}",
                      flush=True)
    print(f"[prewarm] done: built {built} skipped {skipped}", flush=True)
    return {"built": built, "skipped": skipped, "cache_dir": cache_dir}


if __name__ == "__main__":
    main()
