"""The tracker split of ROADMAP Queue 3 (k) on one fixture run folder: one set
of trained nets, a stage of the port and the same stage of the JAX package
on the same inputs, on the CPU (the port's stage 6 also on the card). Not
a test file: it reads a 90-frame run folder of
scripts/run_fixture_eval_torch.py and imports both packages (the port's
stage 6 alone imports nothing of JAX).

    python tests/torch_split_k.py stage4 --run <run> [--recon recon] \
        [--frames a:b] [--out <json>]
        Stages 3-4 of both packages on the same inputs, one frame at a
        time: the pack's SMPL (poses, betas, trans) in place of stage 2's,
        the triplane masks and the input crops of the run's frames, the
        run's SIF-Net, and the reference-budget harvest with median
        centers (--no-fast-gen --robust-centers) from PRNGKey(frame), the
        JAX draws replayed in the port. Per frame and over all, visible
        and occluded frames: the neural centers and predicted visibility
        port against JAX, the JAX harvest on the port's crop stack
        against JAX (its own sensitivity to float rounding), the rotation init from the neural PCA axes port
        against JAX, and each package's centers and rotation init against
        the ground truth.
    python tests/torch_split_k.py stage6 --run <run> --frames a:b \
        --package port|jax [--device cuda] --out <npz>
    python tests/torch_split_k.py stage6-compare --run <run> --frames a:b \
        --port <npz> --jax <npz> [--out <json>]
        Stage 6b of one package from the shared stage-5 outputs on frames
        a:b, one chunk: the port's stage-5 rotations over the whole pack
        (the two chains agree, see stage5), the pack's neural centers plus
        body centers, the pack's SMPL in place of stage 2's and stage
        6a's; the package's own crops, SIF-Net cache, silhouette
        references and object fit at the release budgets (the JAX one on
        the CPU, in segments of 5 steps as the harness runs it; the port's
        on --device, which imports nothing of JAX). stage6-compare: per
        frame and over all, visible and occluded frames, each package's
        final translation and rotation against the ground truth, the two
        against each other, and the fault rule of ROADMAP Queue 3 (k).
    python tests/torch_split_k.py stage5 --run <run> [--recon recon] \
        [--out <json>]
        From one pack's stage-4 outputs and its stage-6a body, both
        packages' stage-5 chain as cli/real_track.py runs it (the rotation
        init from the neural PCA axes, SmoothNet over the rotations, the
        HVOP-Net infill on predicted visibility < 0.5) with the run's
        sn_rot and infiller checkpoints: the two chains' rotations frame by
        frame after each step, and each package's infilled rotations
        against the ground truth on all, visible and occluded frames.
    python tests/torch_split_k.py orbax --run <run> --out <dir>
        A copy of the run folder for scripts/ablate_stage6_terms.py, which
        reads orbax checkpoints: the same fixture meta and recon, and the
        run's torch checkpoints of SIF-Net, the object-rotation SmoothNet
        and HVOP-Net carried into flax by the JAX package's
        models/torch_import.py (as its `track` reads them) and saved by its
        CheckpointIO.
    python tests/torch_split_k.py ablate --port <json> --jax <json> \
        [--out <json>]
        The reports of scripts/ablate_stage6_terms_torch.py and
        scripts/ablate_stage6_terms.py on the same run folder, term by
        term: each entry's difference against 1e-3 of its JAX row's
        largest entry (ROADMAP Queue 3 finding (j)).
"""
import argparse
import json
import os
import os.path as osp
import sys
import time

import numpy as np

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, osp.join(ROOT, "tests"))


# the harness's `track`: crop, net input size, SIF-Net preset
CROP, SIZE, PRESET = 1200, 256, "tiny"


def _angles_deg(a, b):
    c = (np.einsum("tij,tij->t", np.asarray(a, np.float64),
                   np.asarray(b, np.float64)) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def _split(err, vis):
    return {"all": float(err.mean()),
            "visible": float(err[vis].mean()) if vis.any() else None,
            "occluded": float(err[~vis].mean()) if (~vis).any() else None}


def stage4(run, recon="recon", frames=None):
    import jax
    import jax.numpy as jnp
    import torch
    from test_torch_fit import _ScanDraws
    from vistracker_tpu.core.camera import PerspectiveCamera as JCam
    from vistracker_tpu.core.landmarks import load_landmarks as jlandmarks
    from vistracker_tpu.core.smpl import lbs_forward as jlbs
    from vistracker_tpu.core.smpl import load_smpl_pkl as jsmpl
    from vistracker_tpu.data.behave import FrameDataReader as JReader
    from vistracker_tpu.data.behave import load_template as jtemplate
    from vistracker_tpu.data.images import prepare_input_crop as jcrop
    from vistracker_tpu.data.sampling import compute_pca_axes as jpca
    from vistracker_tpu.fit import generator as jgen
    from vistracker_tpu.fit.joint import init_object_orientation as jinit
    from vistracker_tpu.models import torch_import as TI
    from vistracker_tpu.models.sifnet import SIFNet as JNet
    from vistracker_tpu.models.sifnet import pack_cache
    from vistracker_tpu.models.sifnet import sifnet_preset as jpreset
    from vistracker_tpu.ops.rasterizer import \
        render_triplane_masks_batch as jtri
    from vistracker_tpu_torch.cli.real_track import _load_net
    from vistracker_tpu_torch.core.camera import PerspectiveCamera
    from vistracker_tpu_torch.core.landmarks import load_landmarks
    from vistracker_tpu_torch.core.smpl import lbs_forward, load_smpl_pkl
    from vistracker_tpu_torch.data.behave import FrameDataReader, \
        load_template
    from vistracker_tpu_torch.data.images import prepare_input_crop
    from vistracker_tpu_torch.data.packed import load_packed_recon
    from vistracker_tpu_torch.fit import generator as tgen
    from vistracker_tpu_torch.fit.joint import init_object_orientation
    from vistracker_tpu_torch.models.sifnet import SIFNet, sifnet_preset
    from vistracker_tpu_torch.ops.rasterizer import \
        render_triplane_masks_batch
    from vistracker_tpu_torch.utils.mesh import compute_pca_axes

    m = np.load(osp.join(run, "fixture_meta.npz"))
    fx = {k: m[k] for k in m.files}
    pack = load_packed_recon(osp.join(run, recon, "recon_fixture",
                                      f"{fx['seq_name']}_k1.pkl"))
    T = pack.num_frames
    a, b = (0, T) if frames is None else frames
    occ_gt = np.asarray(fx["occ_ratios"])
    occ_gt = occ_gt[:, 1] if occ_gt.ndim == 2 else occ_gt
    gt = np.asarray(fx["obj_trans_gt"], np.float64)
    rot_gt = np.asarray(fx["rot_gt"])
    poses = np.asarray(pack.poses, np.float32)
    betas = np.asarray(pack.betas, np.float32)
    trans = np.asarray(pack.trans, np.float32)
    gcfg = dict(center_agg="median", funnel=None)

    jmodel = jsmpl(str(fx["model_pkl"]))
    jlm = jlandmarks(str(fx["assets_root"]))
    jreader = JReader(str(fx["seq_dir"]))
    jcfg = jpreset(PRESET, crop_size=CROP)
    jnet = JNet(jcfg, JCam(crop_size=CROP))
    jparams = TI.sifnet_params(osp.join(run, "sifnet"), jcfg)
    jgenerate = jgen.make_generator(jgen.sifnet_query_fn(jnet),
                                    jgen.GeneratorConfig(**gcfg))
    jbox = jnp.asarray(jpca(jtemplate(str(fx["objects_root"]),
                                      "boxmedium")[0]))[None]

    tmodel = load_smpl_pkl(str(fx["model_pkl"]), "cpu")
    tlm = load_landmarks(str(fx["assets_root"]), "cpu")
    treader = FrameDataReader(str(fx["seq_dir"]))
    tnet = _load_net(SIFNet(sifnet_preset(PRESET, crop_size=CROP),
                            PerspectiveCamera(crop_size=CROP)),
                     osp.join(run, "sifnet"), 0, "cpu")
    tgenerate = tgen.make_generator(tgen.sifnet_query_fn(tnet),
                                    tgen.GeneratorConfig(**gcfg))
    tbox = torch.as_tensor(compute_pca_axes(load_template(
        str(fx["objects_root"]), "boxmedium")[0]), dtype=torch.float32)[None]

    def inputs(reader, tris, t):
        img5, cc = (jcrop if reader is jreader else prepare_input_crop)(
            reader.get_color(t, 1), reader.get_mask(t, 1, "person"),
            reader.get_mask(t, 1, "obj"), CROP, SIZE)
        return (np.concatenate([img5, tris[0]], -1)[None].astype(np.float32),
                np.asarray(cc, np.float32)[None])

    rows = []
    for t in range(a, b):
        sl = slice(t, t + 1)
        # the JAX package's stages 3-4 as its cli/real_track.py runs them
        v = jlbs(jmodel, jnp.asarray(poses[sl]), jnp.asarray(betas[sl]),
                 jnp.asarray(trans[sl]))[0]
        bc = jlm.smpl_center(v)
        img, cc = inputs(jreader, np.asarray(
            jtri(v, jnp.asarray(jmodel.faces), bc, SIZE)), t)
        jbc = np.asarray(bc)[0]

        def jharvest(img, cc=jnp.asarray(cc), bc=bc):
            cache = pack_cache(jnet.apply(jparams, jnp.asarray(img),
                                          method=JNet.encode),
                               pack_tmpx=True, pack_hg=True)
            out = jgenerate(jparams, cache, cc, bc,
                            jax.random.PRNGKey(t))["object"]
            return {k: np.asarray(v) for k, v in out.items()}

        jo, jimg = jharvest(img), img
        jrot = np.asarray(jinit(jnp.asarray(jo["pca_axis"]), jbox))
        # the port's, on the same SMPL and the same draws
        with torch.no_grad():
            v = lbs_forward(tmodel, torch.from_numpy(poses[sl]),
                            torch.from_numpy(betas[sl]),
                            torch.from_numpy(trans[sl]))[0]
            bc = tlm.smpl_center(v)
            tbc = bc.numpy()[0]
            img, cc = inputs(treader, render_triplane_masks_batch(
                v, torch.as_tensor(np.asarray(tmodel.faces).astype(np.int64)),
                bc, SIZE).numpy(), t)
            to = tgenerate(tnet.encode(torch.from_numpy(img)),
                           torch.from_numpy(cc), bc,
                           _ScanDraws(t, num_rounds=3))["object"]
            to = {k: v.numpy() for k, v in to.items()}
            trot = init_object_orientation(torch.from_numpy(to["pca_axis"]),
                                           tbox).numpy()
        # the noise floor: the JAX harvest again, on the port's crop stack
        # (it differs from JAX's by float rounding only); the validity
        # threshold and the resampling of the survivors amplify such
        # differences, so this is how far the JAX harvest itself moves
        jo2 = jharvest(img)
        rows.append({
            "frame": t, "visible": bool(occ_gt[t] > 0.5),
            "image_max_abs": float(np.abs(img - jimg).max()),
            "center_port_vs_jax_m": float(np.linalg.norm(
                to["centers"][0] - jo["centers"][0])),
            "center_jax_on_port_image_vs_jax_m": float(np.linalg.norm(
                jo2["centers"][0] - jo["centers"][0])),
            "visibility_port": float(to["visibility"][0, 0]),
            "visibility_jax_on_port_image": float(jo2["visibility"][0, 0]),
            "visibility_jax": float(jo["visibility"][0, 0]),
            "rot_init_port_vs_jax_deg": float(_angles_deg(trot, jrot)[0]),
            # the centers are offsets from the body center, as in the
            # pack and scripts/diagnose_fixture_torch.py
            "center_vs_gt_m": {
                "port": float(np.linalg.norm(to["centers"][0] + tbc - gt[t])),
                "jax": float(np.linalg.norm(jo["centers"][0] + jbc - gt[t]))},
            "rot_init_vs_gt_deg": {
                "port": float(_angles_deg(trot.transpose(0, 2, 1),
                                          rot_gt[sl])[0]),
                "jax": float(_angles_deg(jrot.transpose(0, 2, 1),
                                         rot_gt[sl])[0])},
            "valid_points": {"port": int(to["valid"].sum()),
                             "jax": int(np.asarray(jo["valid"]).sum())}})
        print(json.dumps(rows[-1]), flush=True)

    vis = np.array([r["visible"] for r in rows])

    def col(key, sub=None):
        return np.array([r[key] if sub is None else r[key][sub]
                         for r in rows])

    dvis = np.abs(col("visibility_port") - col("visibility_jax"))
    dvis2 = np.abs(col("visibility_jax_on_port_image")
                   - col("visibility_jax"))
    rep = {"run": run, "recon": recon, "frames": [a, b],
           "inputs": "the pack's SMPL in place of stage 2's; draws from "
                     "PRNGKey(frame), one frame at a time",
           "limits": {"center_m": 2e-3, "visibility": 2e-3,
                      "rot_init_deg": 0.5},
           "image_max_abs": float(col("image_max_abs").max()),
           "center_port_vs_jax_m": {"max": float(col(
               "center_port_vs_jax_m").max()), **_split(
               col("center_port_vs_jax_m"), vis)},
           "visibility_port_vs_jax": {"max": float(dvis.max()),
                                      **_split(dvis, vis)},
           "noise_floor_jax_on_port_image": {
               "center_vs_jax_m": {"max": float(col(
                   "center_jax_on_port_image_vs_jax_m").max()), **_split(
                   col("center_jax_on_port_image_vs_jax_m"), vis)},
               "visibility_vs_jax": {"max": float(dvis2.max()),
                                     **_split(dvis2, vis)}},
           "rot_init_port_vs_jax_deg": {"max": float(col(
               "rot_init_port_vs_jax_deg").max()), **_split(
               col("rot_init_port_vs_jax_deg"), vis)},
           "center_vs_gt_m": {
               "port": _split(col("center_vs_gt_m", "port"), vis),
               "jax": _split(col("center_vs_gt_m", "jax"), vis)},
           "rot_init_vs_gt_deg": {
               "port": _split(col("rot_init_vs_gt_deg", "port"), vis),
               "jax": _split(col("rot_init_vs_gt_deg", "jax"), vis)},
           "frames_detail": rows}
    rep["agree"] = bool(
        rep["center_port_vs_jax_m"]["max"] <= 2e-3
        and rep["visibility_port_vs_jax"]["max"] <= 2e-3
        and rep["rot_init_port_vs_jax_deg"]["max"] <= 0.5)
    return rep


def _stage6_setup(run, frames, recon="recon"):
    """The shared inputs of stage 6b on frames a:b (port only, CPU)."""
    import torch
    from vistracker_tpu_torch.cli.real_track import _load_net
    from vistracker_tpu_torch.core.landmarks import load_landmarks
    from vistracker_tpu_torch.core.smpl import lbs_forward, load_smpl_pkl
    from vistracker_tpu_torch.data.behave import load_template
    from vistracker_tpu_torch.data.packed import load_packed_recon
    from vistracker_tpu_torch.fit import joint as tjoint
    from vistracker_tpu_torch.fit.infill import make_infiller
    from vistracker_tpu_torch.fit.smoothing import smooth_objrot
    from vistracker_tpu_torch.models.infiller import (ConditionalMInfiller,
                                                      InfillerConfig)
    from vistracker_tpu_torch.models.smoothnet import SmoothNet
    from vistracker_tpu_torch.utils.mesh import (compute_pca_axes,
                                                 decimate_faces,
                                                 sample_surface)

    m = np.load(osp.join(run, "fixture_meta.npz"))
    fx = {k: m[k] for k in m.files}
    pack = load_packed_recon(osp.join(run, recon, "recon_fixture",
                                      f"{fx['seq_name']}_k1.pkl"))
    T = pack.num_frames
    a, b = frames
    sl = slice(a, b)
    poses = np.asarray(pack.poses, np.float32)
    betas = np.asarray(pack.betas, np.float32)
    trans = np.asarray(pack.trans, np.float32)
    occ = np.asarray(pack.neural_visibility, np.float32).reshape(-1)
    temp_v, temp_f = load_template(str(fx["objects_root"]), "boxmedium")
    # the port's stage-5 chain over the whole pack (the two chains agree,
    # see stage5)
    model = load_smpl_pkl(str(fx["model_pkl"]), "cpu")
    with torch.no_grad():
        verts = lbs_forward(model, torch.from_numpy(poses),
                            torch.from_numpy(betas),
                            torch.from_numpy(trans))[0]
        bc = load_landmarks(str(fx["assets_root"]), "cpu") \
            .smpl_center(verts).numpy()
        rot = tjoint.init_object_orientation(
            torch.as_tensor(np.asarray(pack.neural_pca, np.float32)),
            torch.as_tensor(compute_pca_axes(temp_v),
                            dtype=torch.float32).expand(T, 3, 3)).numpy()
    W = 64
    rot = smooth_objrot(_load_net(SmoothNet(window_size=W, output_size=W),
                                  osp.join(run, "sn_rot"), 7, "cpu", True),
                        rot.transpose(0, 2, 1), window=W).transpose(0, 2, 1)
    icfg = InfillerConfig()
    filled = make_infiller(_load_net(ConditionalMInfiller(icfg),
                                     osp.join(run, "infiller"), 1, "cpu"),
                           icfg)(poses, trans, rot, occ)
    rot_real = rot if filled is None else filled
    occ_gt = np.asarray(fx["occ_ratios"])
    occ_gt = occ_gt[:, 1] if occ_gt.ndim == 2 else occ_gt
    return dict(
        fx=fx, frames=(a, b), infilled=filled is not None,
        poses=poses[sl], betas=betas[sl], trans=trans[sl], occ=occ[sl],
        bc=bc[sl].astype(np.float32),
        r0=np.ascontiguousarray(rot_real[sl].transpose(0, 2, 1), np.float32),
        t0=(np.asarray(pack.neural_trans) + bc)[sl].astype(np.float32),
        pack_t=np.asarray(pack.obj_trans)[sl],
        vis=occ_gt[sl] > 0.5,
        t_gt=np.asarray(fx["obj_trans_gt"], np.float64)[sl],
        rot_gt=np.asarray(fx["rot_gt"])[sl],
        temp_v=temp_v,
        obj_points=sample_surface(temp_v, temp_f, 3000,
                                  np.random.RandomState(0)),
        sil_faces=decimate_faces(temp_f, 2500).astype(np.int64))


def _crops(s, reader, crop_fn, tris, crop, size):
    images, ccs = [], []
    for j, t in enumerate(range(*s["frames"])):
        img5, cc = crop_fn(reader.get_color(t, 1),
                           reader.get_mask(t, 1, "person"),
                           reader.get_mask(t, 1, "obj"), crop, size)
        images.append(np.concatenate([img5, tris[j]], -1))
        ccs.append(cc)
    return (np.stack(images).astype(np.float32),
            np.stack(ccs).astype(np.float32))


def stage6_jax(run, s):
    """The JAX package's stage 6b on the shared inputs, as its
    cli/real_track.py runs it (segments of 5 steps, as the harness asks);
    -> (obj_r, obj_t, joint iterations)."""
    import jax.numpy as jnp
    from vistracker_tpu.core.camera import PerspectiveCamera
    from vistracker_tpu.core.landmarks import (load_part_labels,
                                               part_labels_array)
    from vistracker_tpu.core.smpl import lbs_forward, load_smpl_pkl
    from vistracker_tpu.data.behave import FrameDataReader
    from vistracker_tpu.data.images import prepare_input_crop
    from vistracker_tpu.data.silprep import prepare_sil_refs
    from vistracker_tpu.fit import joint
    from vistracker_tpu.models import torch_import as TI
    from vistracker_tpu.models.sifnet import SIFNet, pack_cache, \
        sifnet_preset
    from vistracker_tpu.ops.rasterizer import render_triplane_masks_batch

    fx, B = s["fx"], len(s["r0"])
    model = load_smpl_pkl(str(fx["model_pkl"]))
    cfg = joint.JointFitConfig()
    cam = PerspectiveCamera(crop_size=CROP)
    net = SIFNet(sifnet_preset(PRESET, crop_size=CROP), cam)
    params = TI.sifnet_params(osp.join(run, "sifnet"),
                              sifnet_preset(PRESET, crop_size=CROP))

    def query(ctx, points):
        return net.apply(ctx["params"], ctx["cache"], points, ctx["cc"],
                         ctx["bc"], method=SIFNet.query)[-1]

    def query_df(ctx, points):
        return net.apply(ctx["params"], ctx["cache"], points, ctx["cc"],
                         ctx["bc"], method=SIFNet.query_heads, heads=("df",))

    opt = joint.make_object_optimizer(
        query_df, lambda ctx, p: cam.project_screen(p), cfg,
        segment_iters=5, report_iters=True, contact_query_fn=query)
    v = lbs_forward(model, jnp.asarray(s["poses"]), jnp.asarray(s["betas"]),
                    jnp.asarray(s["trans"]))[0]
    bc = jnp.asarray(s["bc"])
    images, ccs = _crops(s, FrameDataReader(str(fx["seq_dir"])),
                         prepare_input_crop, np.asarray(
                             render_triplane_masks_batch(
                                 v, jnp.asarray(model.faces), bc, SIZE)),
                         CROP, SIZE)
    ctx = dict(params=params, cache=pack_cache(net.apply(
        params, jnp.asarray(images), method=SIFNet.encode)),
        cc=jnp.asarray(ccs), bc=bc)
    r, t, _, it = opt(
        jnp.asarray(s["r0"]), jnp.asarray(s["t0"]), jnp.ones(B),
        jnp.broadcast_to(jnp.asarray(s["obj_points"]),
                         (B,) + s["obj_points"].shape),
        v, jnp.asarray(part_labels_array(
            load_part_labels(str(fx["assets_root"])),
            num_verts=model.v_template.shape[0])),
        jnp.asarray(s["occ"]),
        prepare_sil_refs(images[..., 3], images[..., 4], ccs, CROP, SIZE,
                         cfg.sil_size),
        jnp.broadcast_to(jnp.asarray(s["temp_v"]),
                         (B,) + s["temp_v"].shape),
        jnp.asarray(s["sil_faces"]), ctx)
    return np.asarray(r), np.asarray(t), int(it["joint"])


def stage6_port(run, s, device):
    """The port's stage 6b on the shared inputs, as its cli/real_track.py
    runs it; -> (obj_r, obj_t, joint iterations)."""
    import torch
    from vistracker_tpu_torch.cli.real_track import _load_net
    from vistracker_tpu_torch.core.camera import PerspectiveCamera
    from vistracker_tpu_torch.core.landmarks import (load_part_labels,
                                                     part_labels_array)
    from vistracker_tpu_torch.core.smpl import lbs_forward, load_smpl_pkl
    from vistracker_tpu_torch.data.behave import FrameDataReader
    from vistracker_tpu_torch.data.images import prepare_input_crop
    from vistracker_tpu_torch.data.silprep import prepare_sil_refs
    from vistracker_tpu_torch.fit import joint
    from vistracker_tpu_torch.models.sifnet import SIFNet, sifnet_preset
    from vistracker_tpu_torch.ops.rasterizer import \
        render_triplane_masks_batch

    fx, B = s["fx"], len(s["r0"])

    def dev(x):
        return torch.as_tensor(np.asarray(x), device=device)

    model = load_smpl_pkl(str(fx["model_pkl"]), device)
    cfg = joint.JointFitConfig()
    cam = PerspectiveCamera(crop_size=CROP)
    net = _load_net(SIFNet(sifnet_preset(PRESET, crop_size=CROP), cam),
                    osp.join(run, "sifnet"), 0, device)
    opt = joint.make_object_optimizer(
        lambda ctx, p: net.query_heads(ctx["cache"], p, ctx["cc"],
                                       ctx["bc"], heads=("df",)),
        lambda ctx, p: cam.project_screen(p), cfg, report_iters=True,
        contact_query_fn=lambda ctx, p: net.query(
            ctx["cache"], p, ctx["cc"], ctx["bc"])[-1])
    with torch.no_grad():
        v = lbs_forward(model, dev(s["poses"]), dev(s["betas"]),
                        dev(s["trans"]))[0]
        bc = dev(s["bc"])
        images, ccs = _crops(s, FrameDataReader(str(fx["seq_dir"])),
                             prepare_input_crop, render_triplane_masks_batch(
                                 v, dev(np.asarray(model.faces)).long(), bc,
                                 SIZE).cpu().numpy(), CROP, SIZE)
        ctx = dict(cache=net.encode(dev(images)), cc=dev(ccs), bc=bc)
    r, t, _, it = opt(
        dev(s["r0"]), dev(s["t0"]), torch.ones(B, device=device),
        dev(s["obj_points"]).float().expand(B, -1, -1), v,
        part_labels_array(load_part_labels(str(fx["assets_root"])),
                          num_verts=model.v_template.shape[0]),
        dev(s["occ"]),
        prepare_sil_refs(images[..., 3], images[..., 4], ccs, CROP, SIZE,
                         cfg.sil_size, device=device),
        dev(s["temp_v"]).float().expand(B, -1, -1), dev(s["sil_faces"]),
        ctx)
    return (r.detach().cpu().numpy(), t.detach().cpu().numpy(),
            int(it["joint"]))


def stage6_compare(run, frames, fits, recon="recon"):
    """fits: {package: npz path of its stage-6 result}."""
    s = _stage6_setup(run, frames, recon)
    vis, t_gt, rot_gt = s["vis"], s["t_gt"], s["rot_gt"]
    rep = {"run": run, "recon": recon, "frames": list(frames),
           "occluded_frames": (np.flatnonzero(~vis) + frames[0]).tolist(),
           "stage5_infilled": s["infilled"],
           "inputs": "the port's stage-5 rotations over the whole pack; the "
                     "pack's neural centers plus body centers; the pack's "
                     "SMPL in place of stage 2's and stage 6a's",
           "init_t_vs_gt_m": _split(np.linalg.norm(s["t0"] - t_gt, axis=1),
                                    vis),
           "init_rot_vs_gt_deg": _split(_angles_deg(
               s["r0"].transpose(0, 2, 1), rot_gt), vis),
           "pack_t_final_vs_gt_m": _split(np.linalg.norm(
               s["pack_t"] - t_gt, axis=1), vis)}
    out = {}
    for name, path in fits.items():
        f = np.load(path)
        out[name] = (f["obj_r"], f["obj_t"])
        rep[name] = {
            "device": str(f["device"]), "seconds": float(f["seconds"]),
            "joint_iters": int(f["joint_iters"]),
            "t_final_m": _split(np.linalg.norm(f["obj_t"] - t_gt, axis=1),
                                vis),
            "rot_final_deg": _split(_angles_deg(
                f["obj_r"].transpose(0, 2, 1), rot_gt), vis),
            "t_final_per_frame_m": np.linalg.norm(
                f["obj_t"] - t_gt, axis=1).tolist()}
    dt = np.linalg.norm(out["port"][1] - out["jax"][1], axis=1)
    rep["t_port_vs_jax_m"] = {"max": float(dt.max()), **_split(dt, vis)}
    rep["rot_port_vs_jax_deg"] = _split(
        _angles_deg(out["port"][0], out["jax"][0]), vis)
    p_occ = rep["port"]["t_final_m"]["occluded"]
    j_occ = rep["jax"]["t_final_m"]["occluded"]
    rep["fault_rule"] = {
        "port_occluded_t_final_m": p_occ, "jax_occluded_t_final_m": j_occ,
        "more_than_twice": bool(p_occ > 2 * j_occ),
        "more_than_5cm_apart": bool(abs(p_occ - j_occ) > 0.05)}
    rep["fault_rule"]["fault"] = (rep["fault_rule"]["more_than_twice"]
                                  and rep["fault_rule"]["more_than_5cm_apart"])
    return rep


def stage5(run, recon="recon"):
    import jax.numpy as jnp
    import torch
    from vistracker_tpu.data.behave import load_template as jtemplate
    from vistracker_tpu.data.sampling import compute_pca_axes as jpca
    from vistracker_tpu.fit.infill import make_infiller as jmake
    from vistracker_tpu.fit.joint import init_object_orientation as jinit
    from vistracker_tpu.fit.smoothing import smooth_objrot as jsmooth
    from vistracker_tpu.models import torch_import as TI
    from vistracker_tpu.models.infiller import ConditionalMInfiller as JInf
    from vistracker_tpu.models.infiller import InfillerConfig as JCfg
    from vistracker_tpu_torch.cli.real_track import _load_net
    from vistracker_tpu_torch.data.behave import load_template
    from vistracker_tpu_torch.data.packed import load_packed_recon
    from vistracker_tpu_torch.fit.infill import make_infiller
    from vistracker_tpu_torch.fit.joint import init_object_orientation
    from vistracker_tpu_torch.fit.smoothing import smooth_objrot
    from vistracker_tpu_torch.models.infiller import (ConditionalMInfiller,
                                                      InfillerConfig)
    from vistracker_tpu_torch.models.smoothnet import SmoothNet
    from vistracker_tpu_torch.utils.mesh import compute_pca_axes

    m = np.load(osp.join(run, "fixture_meta.npz"))
    fx = {k: m[k] for k in m.files}
    pack = load_packed_recon(osp.join(run, recon, "recon_fixture",
                                      f"{fx['seq_name']}_k1.pkl"))
    T = pack.num_frames
    occ_gt = np.asarray(fx["occ_ratios"])
    occ_gt = occ_gt[:, 1] if occ_gt.ndim == 2 else occ_gt
    vis = occ_gt > 0.5
    rot_gt = np.asarray(fx["rot_gt"])
    pca = np.asarray(pack.neural_pca, np.float32)
    occ = np.asarray(pack.neural_visibility, np.float32).reshape(-1)
    poses, trans = np.asarray(pack.poses), np.asarray(pack.trans)
    W = 64

    # the JAX chain, its nets read from the torch checkpoints as its track
    # reads them
    temp_v, _ = jtemplate(str(fx["objects_root"]), "boxmedium")
    j = {"init": np.asarray(jinit(
        jnp.asarray(pca), jnp.broadcast_to(jnp.asarray(jpca(temp_v)),
                                           (T, 3, 3)))).transpose(0, 2, 1)}
    j["smoothed"] = jsmooth(TI.smoothnet_params(osp.join(run, "sn_rot"),
                                                smpl=False),
                            j["init"], window=W).transpose(0, 2, 1)
    jcfg = JCfg()
    j["infilled"] = jmake(JInf(jcfg), jcfg)(
        TI.infiller_params(osp.join(run, "infiller"), jcfg), poses, trans,
        j["smoothed"], occ)

    temp_v, _ = load_template(str(fx["objects_root"]), "boxmedium")
    with torch.no_grad():
        t = {"init": init_object_orientation(
            torch.as_tensor(pca),
            torch.as_tensor(compute_pca_axes(temp_v),
                            dtype=torch.float32).expand(T, 3, 3)
        ).numpy().transpose(0, 2, 1)}
    sn_rot = _load_net(SmoothNet(window_size=W, output_size=W),
                       osp.join(run, "sn_rot"), 7, "cpu", True)
    t["smoothed"] = smooth_objrot(sn_rot, t["init"], window=W) \
        .transpose(0, 2, 1)
    tcfg = InfillerConfig()
    t["infilled"] = make_infiller(_load_net(
        ConditionalMInfiller(tcfg), osp.join(run, "infiller"), 1, "cpu"),
        tcfg)(poses, trans, t["smoothed"], occ)

    rep = {"run": run, "recon": recon, "frames": T,
           "occluded_frames": np.flatnonzero(~vis).tolist(),
           "predicted_occluded": np.flatnonzero(occ < 0.5).tolist(),
           "infilled": {"port": t["infilled"] is not None,
                        "jax": j["infilled"] is not None}}
    for step in ("init", "smoothed", "infilled"):
        if t[step] is None or j[step] is None:
            continue
        d = _angles_deg(t[step], j[step])
        rep[f"{step}_port_vs_jax_deg"] = {"max": float(d.max()),
                                          **_split(d, vis)}
        rep[f"{step}_vs_gt_deg"] = {
            "port": _split(_angles_deg(t[step], rot_gt), vis),
            "jax": _split(_angles_deg(j[step], rot_gt), vis)}
    rep["pack_final_vs_gt_deg"] = _split(_angles_deg(
        np.asarray(pack.obj_angles).transpose(0, 2, 1), rot_gt), vis)
    return rep


def orbax(run, out, net_preset="tiny", crop_size=1200):
    import shutil
    from vistracker_tpu.fit.trainer_loop import CheckpointIO
    from vistracker_tpu.models import torch_import as TI
    from vistracker_tpu.models.infiller import InfillerConfig as JCfg
    from vistracker_tpu.models.sifnet import sifnet_preset
    os.makedirs(out, exist_ok=True)
    shutil.copy(osp.join(run, "fixture_meta.npz"), out)
    shutil.copytree(osp.join(run, "recon"), osp.join(out, "recon"),
                    dirs_exist_ok=True)
    nets = {"sifnet": TI.sifnet_params(
                osp.join(run, "sifnet"),
                sifnet_preset(net_preset, crop_size=crop_size)),
            "sn_rot": TI.smoothnet_params(osp.join(run, "sn_rot"),
                                          smpl=False),
            "infiller": TI.infiller_params(osp.join(run, "infiller"),
                                           JCfg())}
    for name, params in nets.items():
        CheckpointIO(osp.join(out, name)).save(1, {"params": params})
    return {"out": out, "nets": sorted(nets)}


def _missing(v):
    return v is None or not np.isfinite(v)


def ablate(port, jax_rep, rel=1e-3):
    rows, worst = {}, 0.0
    for point in ("init", "final"):
        for term, want in jax_rep[point].items():
            got = port[point].get(term)
            if got is None:
                rows[f"{point}.{term}"] = "missing in the port"
                worst = np.inf
                continue
            scale = max(abs(v) for v in want.values() if not _missing(v))
            for k, v in want.items():
                g = got.get(k)
                if _missing(g) or _missing(v):
                    # a mean over no frames: None in one, nan in the other
                    if _missing(g) != _missing(v):
                        rows[f"{point}.{term}.{k}"] = {"port": g, "jax": v}
                        worst = np.inf
                    continue
                share = abs(g - v) / max(scale, 1e-30)
                rows[f"{point}.{term}.{k}"] = {
                    "port": g, "jax": v, "share_of_row_max": share}
                worst = max(worst, share)
    return {"rows": rows, "worst_share": worst, "limit": rel,
            "agree": bool(worst <= rel)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    s4 = sub.add_parser("stage4")
    s4.add_argument("--run", required=True)
    s4.add_argument("--recon", default="recon")
    s4.add_argument("--frames", default=None,
                    help="a:b, the pack's frames to run (default: all)")
    s4.add_argument("--out", default=None)
    s6 = sub.add_parser("stage6")
    s6.add_argument("--run", required=True)
    s6.add_argument("--recon", default="recon")
    s6.add_argument("--frames", required=True, help="a:b, one chunk")
    s6.add_argument("--package", choices=("port", "jax"), required=True)
    s6.add_argument("--device", default="cuda",
                    help="the port's device; the JAX package runs on the CPU")
    s6.add_argument("--out", required=True, help="npz of the fit")
    c6 = sub.add_parser("stage6-compare")
    c6.add_argument("--run", required=True)
    c6.add_argument("--recon", default="recon")
    c6.add_argument("--frames", required=True)
    c6.add_argument("--port", required=True)
    c6.add_argument("--jax", required=True)
    c6.add_argument("--out", default=None)
    s5 = sub.add_parser("stage5")
    s5.add_argument("--run", required=True)
    s5.add_argument("--recon", default="recon")
    s5.add_argument("--out", default=None)
    ob = sub.add_parser("orbax")
    ob.add_argument("--run", required=True)
    ob.add_argument("--out", required=True)
    ab = sub.add_parser("ablate")
    ab.add_argument("--port", required=True)
    ab.add_argument("--jax", required=True)
    ab.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.cmd in ("stage4", "stage5", "orbax") or (
            args.cmd == "stage6" and args.package == "jax"):
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_default_matmul_precision", "highest")
    if args.cmd == "stage4":
        rep = stage4(args.run, args.recon, None if args.frames is None
                     else tuple(int(x) for x in args.frames.split(":")))
    elif args.cmd == "stage6":
        frames = tuple(int(x) for x in args.frames.split(":"))
        st = _stage6_setup(args.run, frames, args.recon)
        t0 = time.perf_counter()
        r, t, it = (stage6_jax(args.run, st) if args.package == "jax"
                    else stage6_port(args.run, st, args.device))
        sec = time.perf_counter() - t0
        np.savez(args.out, obj_r=r, obj_t=t, joint_iters=it, seconds=sec,
                 device="cpu" if args.package == "jax" else args.device)
        rep = {"package": args.package, "seconds": sec, "joint_iters": it,
               "out": args.out}
        args.out = None      # the npz, not the report
    elif args.cmd == "stage6-compare":
        rep = stage6_compare(args.run, tuple(
            int(x) for x in args.frames.split(":")),
            {"port": args.port, "jax": args.jax}, args.recon)
    elif args.cmd == "stage5":
        rep = stage5(args.run, args.recon)
    elif args.cmd == "orbax":
        rep = orbax(args.run, args.out)
        args.out = None
    else:
        with open(args.port) as f:
            port = json.load(f)
        with open(args.jax) as f:
            jrep = json.load(f)
        rep = ablate(port, jrep)
    print(json.dumps(rep, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=2)
    return rep


if __name__ == "__main__":
    main()
