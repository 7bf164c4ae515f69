"""Per-term translation attribution of stage 6 on a fixture run folder.

The port's counterpart of scripts/ablate_stage6_terms.py. It asks which
weighted loss term of the stage-6 object fit pulls the object translation
away from the ground truth. It rebuilds the stage-6 environment of a run
of scripts/run_fixture_eval_torch.py as cli/real_track.py builds it --
the triplane masks (ops/rasterizer.py:render_triplane_masks_batch, kernel
K1 hard on the card), the 8-channel crops, the SIF-Net feature cache, the
silhouette references, the stage-5 rotations (PCA init, SmoothNet,
HVOP-Net) and the contact masks, frozen under torch.no_grad -- and calls
fit/joint.py's term_probe (kernels K1 soft, K2 and K3 on the card) at the
stage-5/6 init point and at the final tracked pose.

For each term and frame, pull_toward_gt = <-d(term)/d(obj_t),
unit(t_gt - t)>: positive when the term's descent moves the translation
toward the ground truth. The report holds each term's mean pull over all,
visible and occluded frames, its value, and the net pull of all terms.

The run folder's checkpoints are the port's torch layout, found by
models/weights.py:find_checkpoint; a JAX run folder's orbax checkpoints
read after scripts/orbax_to_torch.py. The stage-6 inputs come from the
PACKED results: the pack keeps the stage-6a body, not the stage-2 one
that tracking used for the triplanes and body centers, so those carry the
cm-scale stage-6a change (fine for attribution).

Usage:
  python scripts/ablate_stage6_terms_torch.py --run fixture_run_ms \
      --net-preset small --heldout [--ocent 1.0] [--out results/...] \
      [--device cpu]
"""
import argparse
import json
import os
import os.path as osp
import sys

import numpy as np

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", default="fixture_run_ms")
    ap.add_argument("--net-preset", default="small")
    ap.add_argument("--recon-tag", default="")
    ap.add_argument("--heldout", action="store_true")
    ap.add_argument("--chunk-size", type=int, default=30)
    ap.add_argument("--net-size", type=int, default=256)
    ap.add_argument("--crop-size", type=int, default=1200)
    ap.add_argument("--ocent", type=float, default=0.0,
                    help="probe with this w_ocent (0 still reports the "
                         "ocent pull at weight 1, as term_probe does)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu only when asked for")
    ap.add_argument("--out", default=None,
                    help="report JSON (default results/ablate_terms_torch"
                         "[_heldout][_PRESET][_TAG].json)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from vistracker_tpu_torch.cli.real_track import _load_net, resolve_device
    from vistracker_tpu_torch.core.camera import PerspectiveCamera
    from vistracker_tpu_torch.core.landmarks import (load_landmarks,
                                                     load_part_labels,
                                                     part_labels_array)
    from vistracker_tpu_torch.core.smpl import lbs_forward, load_smpl_pkl
    from vistracker_tpu_torch.data.behave import FrameDataReader, \
        load_template
    from vistracker_tpu_torch.data.images import prepare_input_crop
    from vistracker_tpu_torch.data.packed import load_packed_recon
    from vistracker_tpu_torch.data.silprep import prepare_sil_refs
    from vistracker_tpu_torch.fit.infill import make_infiller
    from vistracker_tpu_torch.fit.joint import (JointFitConfig,
                                                init_object_orientation,
                                                make_object_optimizer)
    from vistracker_tpu_torch.fit.smoothing import smooth_objrot
    from vistracker_tpu_torch.models.infiller import (ConditionalMInfiller,
                                                      InfillerConfig)
    from vistracker_tpu_torch.models.sifnet import SIFNet, sifnet_preset
    from vistracker_tpu_torch.models.smoothnet import SmoothNet
    from vistracker_tpu_torch.ops.rasterizer import \
        render_triplane_masks_batch
    from vistracker_tpu_torch.utils.mesh import (compute_pca_axes,
                                                 decimate_faces,
                                                 sample_surface)

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
    T = recon.num_frames
    reader = FrameDataReader(str(fx["seq_dir"]))

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    model = load_smpl_pkl(str(fx["model_pkl"]), device)
    # the assets lie beside the sequence folder (one per data_* folder)
    assets = osp.join(osp.dirname(str(fx["seq_dir"])), "assets")
    lms = load_landmarks(assets, device)
    part_labels = part_labels_array(load_part_labels(assets),
                                    num_verts=model.v_template.shape[0])
    cam = PerspectiveCamera(crop_size=args.crop_size)
    temp_v, temp_f = load_template(str(fx["objects_root"]), "boxmedium")
    pca_init = compute_pca_axes(temp_v)
    obj_points = sample_surface(temp_v, temp_f, 3000,
                                np.random.RandomState(0))
    sil_faces = torch.as_tensor(
        decimate_faces(temp_f, 2500).astype(np.int64), device=device)

    sifnet = _load_net(SIFNet(sifnet_preset(args.net_preset,
                                            crop_size=args.crop_size), cam),
                       osp.join(args.run, "sifnet" + psuf), 0, device)
    jcfg = JointFitConfig(w_ocent=args.ocent)

    def query_fn(ctx, points):
        return sifnet.query(ctx["cache"], points, ctx["cc"], ctx["bc"])[-1]

    opt_obj = make_object_optimizer(query_fn,
                                    lambda ctx, p: cam.project_screen(p),
                                    jcfg)

    with torch.no_grad():
        verts_all = lbs_forward(model, dev(recon.poses), dev(recon.betas),
                                dev(recon.trans))[0]
        body_centers = lms.smpl_center(verts_all).cpu().numpy()
    occ_all = np.asarray(recon.neural_visibility, np.float32).reshape(-1)
    t_gt = np.asarray(fx["obj_trans_gt"])
    occ_gt = np.asarray(fx["occ_ratios"])
    occ_gt = occ_gt[:, 1] if occ_gt.ndim == 2 else occ_gt
    vis = occ_gt > 0.5

    # the stage-5 rotation chain as cli/real_track.py runs it: the PCA
    # init, SmoothNet over the sequence, HVOP-Net's infill
    with torch.no_grad():
        rot_init = init_object_orientation(
            torch.as_tensor(np.asarray(recon.neural_pca, np.float32)),
            torch.as_tensor(pca_init, dtype=torch.float32).expand(T, 3, 3)
        ).numpy()
    W = 64
    sn_rot = _load_net(SmoothNet(window_size=W, output_size=W),
                       osp.join(args.run, "sn_rot"), 7, device, True)
    rot_real = smooth_objrot(sn_rot, rot_init.transpose(0, 2, 1),
                             window=W).transpose(0, 2, 1)
    inf_cfg = InfillerConfig()
    run_infill = make_infiller(_load_net(
        ConditionalMInfiller(inf_cfg), osp.join(args.run, "infiller"), 1,
        device), inf_cfg)
    filled = run_infill(np.asarray(recon.poses), np.asarray(recon.trans),
                        rot_real, occ_all)
    if filled is not None:
        rot_real = filled
    t0_all = np.asarray(recon.neural_trans) + body_centers

    smpl_faces = torch.as_tensor(np.asarray(model.faces),
                                 device=device).long()
    pulls = {"init": {}, "final": {}}  # term -> [(B,) pull_toward_gt]
    raws = {"init": {}, "final": {}}   # term -> [value per chunk]
    chunks = [list(range(c, min(c + args.chunk_size, T)))
              for c in range(0, T, args.chunk_size)]
    for chunk in chunks:
        sl = slice(chunk[0], chunk[-1] + 1)
        B = len(chunk)
        print(f"[ablate] chunk {chunk[0]}..{chunk[-1]}", flush=True)
        with torch.no_grad():
            tris = render_triplane_masks_batch(
                verts_all[sl], smpl_faces, dev(body_centers[sl]),
                args.net_size).cpu().numpy()
        images, ccs = [], []
        for j, idx in enumerate(chunk):
            img5, cc = prepare_input_crop(
                reader.get_color(idx, 1), reader.get_mask(idx, 1, "person"),
                reader.get_mask(idx, 1, "obj"), args.crop_size,
                args.net_size)
            images.append(np.concatenate([img5, tris[j]], -1))
            ccs.append(cc)
        images, ccs = np.stack(images), np.stack(ccs)
        with torch.no_grad():
            cache = sifnet.encode(dev(images))
        ctx = dict(cache=cache, cc=dev(ccs), bc=dev(body_centers[sl]))
        sil = prepare_sil_refs(images[..., 3], images[..., 4], ccs,
                               args.crop_size, args.net_size, jcfg.sil_size,
                               device=device)
        env = dict(obj_points=dev(obj_points).expand(B, -1, -1),
                   obj_s=torch.ones(B, device=device), occ=dev(occ_all[sl]),
                   ctx=ctx, smpl_verts=verts_all[sl], labels_h=part_labels,
                   sil=sil, sil_verts=dev(temp_v).expand(B, -1, -1),
                   sil_faces=sil_faces, ocent_target=dev(t0_all[sl]))
        points = {
            "init": {"obj_r": dev(rot_real[sl].transpose(0, 2, 1)),
                     "obj_t": dev(t0_all[sl])},
            "final": {"obj_r": dev(recon.obj_angles[sl]),
                      "obj_t": dev(recon.obj_trans[sl])},
        }
        for pname, params in points.items():
            labels_o, mask_h, mask_o = opt_obj.contact_masks(params, env)
            res = opt_obj.term_probe(params, dict(
                env, labels_o=labels_o, mask_h=mask_h, mask_o=mask_o))
            d = t_gt[sl] - params["obj_t"].cpu().numpy()
            dn = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True),
                                1e-9)
            for term, (val, g) in res.items():
                pull = -(g.cpu().numpy() * dn).sum(1)  # (B,)
                pulls[pname].setdefault(term, []).append(pull)
                raws[pname].setdefault(term, []).append(float(val))
        del cache, ctx

    rep = {"run": args.run, "heldout": bool(args.heldout),
           "net_preset": args.net_preset, "recon_tag": args.recon_tag,
           "probe_w_ocent": max(args.ocent, 1.0), "frames": T,
           "note": ("pull_toward_gt = <-d(term)/d(obj_t), unit(t_gt - t)> "
                    "per frame; positive = the term's descent moves the "
                    "object translation toward GT. Probed at the stage-5/6 "
                    "init and at the final tracked pose.")}
    for pname in pulls:
        rep[pname] = {}
        for term in sorted(pulls[pname]):
            pl = np.concatenate(pulls[pname][term])
            rep[pname][term] = {
                "pull_all": float(pl.mean()),
                "pull_vis": float(pl[vis].mean()) if vis.any() else None,
                "pull_occ": float(pl[~vis].mean()) if (~vis).any() else None,
                "value": float(np.mean(raws[pname][term])),
            }
        net = np.sum([np.concatenate(pulls[pname][t])
                      for t in pulls[pname]
                      if t != "ocent" or args.ocent > 0], axis=0)
        rep[pname]["NET"] = {
            "pull_all": float(net.mean()),
            "pull_vis": float(net[vis].mean()) if vis.any() else None,
            "pull_occ": float(net[~vis].mean()) if (~vis).any() else None}
    out = args.out or osp.join(
        "results", f"ablate_terms_torch{'_heldout' if args.heldout else ''}"
        f"{rsuf}.json")
    os.makedirs(osp.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(rep, f, indent=2)
    print(json.dumps(rep, indent=1))
    print(f"[ablate] wrote {out}")
    return rep


if __name__ == "__main__":
    main()
