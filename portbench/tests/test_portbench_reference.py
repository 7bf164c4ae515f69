"""The plain reference agrees with the port on the CPU at small sizes,
with the same inputs and the same weights."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import weights as W
from portbench.reference import kernels as RK
from portbench.reference import sifnet as RS
from portbench.tests import cells
from portbench.traffic.sifnet_batch import sifnet_batch

CFG = cells.tiny("train.b8")[1]["sifnet"]


def _planes(views=3, size=64, seed=0):
    from vistracker_tpu_torch.core.camera import triplane_project
    from vistracker_tpu_torch.ops.coverage import _planes, _strip_active_bbox
    from portbench.traffic.fabricate import sphere_mesh
    g = torch.Generator().manual_seed(seed)
    sv, faces = sphere_mesh(12, 10)
    verts = torch.as_tensor(sv)[None] * (1 + 0.05 * torch.randn(
        views, 1, 3, generator=g)) + torch.tensor([0.0, 0.3, 2.4])
    ndc = triplane_project(verts, verts.mean(1))
    cpl, *b = _planes(ndc.reshape(3 * views, -1, 2),
                      torch.as_tensor(faces).long(), True)
    return cpl.contiguous(), _strip_active_bbox(*b, size).contiguous(), size


def test_k1_k2_reference_equal_the_port():
    from vistracker_tpu_torch.ops.coverage import (max_logit_bwd_plain,
                                                   max_logit_fwd_plain)
    cpl, active, size = _planes()
    m, c = RK.max_logit_fwd(cpl, active, size)
    m_p, c_p = max_logit_fwd_plain(cpl, active, size)
    assert torch.equal(m, m_p) and torch.equal(c, c_p)
    assert bool((m >= 0).any())
    gw = torch.rand(m.shape, generator=torch.Generator().manual_seed(1))
    dc = RK.max_logit_bwd(cpl, active, m, gw, size)
    assert torch.equal(dc, max_logit_bwd_plain(cpl, active, m, gw, size))
    # the control: TF32 planes move the max
    m_t, _ = RK.max_logit_fwd(RK.tf32(cpl), active, size)
    assert int((m_t != m).sum()) > 0


def test_k3_reference_equals_the_port():
    from vistracker_tpu_torch.ops.label_nn import label_nn_plain
    g = torch.Generator().manual_seed(2)
    x, y = torch.randn(2, 50, 3, generator=g), torch.randn(2, 40, 3,
                                                           generator=g)
    lx = torch.randint(0, 4, (2, 50), generator=g)
    ly = torch.randint(0, 4, (2, 40), generator=g)
    yv = torch.rand(2, 40, generator=g) < 0.7
    d, i = RK.label_nn(x, lx, y, ly, yv)
    d_p, i_p = label_nn_plain(x, lx, y, ly, yv)
    assert torch.equal(d, d_p) and torch.equal(i, i_p)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -9,
                      float("inf")])
    assert RK.tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -9, -1.0 - 2 ** -9,
                                   float("inf")]


def _program(cfg, seed):
    from vistracker_tpu_torch.core.camera import PerspectiveCamera
    from vistracker_tpu_torch.models.sifnet import SIFNet, sifnet_preset
    p = W.make(RS.param_spec(cfg), seed, "cpu")
    net = SIFNet(sifnet_preset("tiny"), PerspectiveCamera())
    net.load_state_dict({**p, **{a: p[n] for a, n in
                                 RS.aliases(list(p)).items()}})
    return net, p


def test_sifnet_reference_equals_the_port():
    from vistracker_tpu_torch.models.sifnet import sifnet_losses
    net, p = _program(CFG, 5)
    batch = sifnet_batch(torch.Generator().manual_seed(1), 2, 300, 32, 14,
                         "cpu")
    with torch.no_grad():
        got = net(batch["images"], batch["points"], batch["crop_center"],
                  batch["body_center"], train=True)
        cache = RS.encode(p, CFG, batch["images"], train=True)
        ref = RS.query(p, CFG, cache, batch["points"],
                       batch["crop_center"], batch["body_center"])
    assert len(got) == len(ref) == CFG["num_stack"]
    for g, r in zip(got, ref):
        for h in RS.HEADS:
            assert torch.allclose(g[h], r[h], atol=1e-6, rtol=0)
    assert float(sifnet_losses(got, batch)[0]) == pytest.approx(
        float(RS.losses(ref, batch)[0]), rel=1e-6)


def test_reference_adam_equals_torch_adam():
    g = torch.Generator().manual_seed(3)
    w = torch.randn(50, generator=g)
    grads = [torch.randn(50, generator=g) for _ in range(3)]
    ours = {"w": w.clone()}
    adam = RS.Adam(ours, 1e-3)
    theirs = w.clone().requires_grad_(True)
    opt = torch.optim.Adam([theirs], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for gr in grads:
        adam.step({"w": gr})
        theirs.grad = gr.clone()
        opt.step()
    assert torch.allclose(ours["w"], theirs.detach(), atol=1e-7, rtol=0)


def test_weights_follow_the_seed():
    spec = RS.param_spec(CFG)
    a, b = W.make(spec, 7, "cpu"), W.make(spec, 7, "cpu")
    c = W.make(spec, 8, "cpu")
    k = "image_filter.conv1.weight"
    assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    assert float(a[k].abs().max()) <= 1 / (5 * 49) ** 0.5
    assert bool((a["image_filter.bn1.weight"] == 1).all())
    assert bool((a["image_filter.bn1.bias"] == 0).all())


def _sequence(tmp_path, frames=6):
    from portbench.traffic.fabricate import fabricate
    return fabricate(str(tmp_path), frames, 2 ** 31 + 5, "cpu", (12, 10),
                     (8, 12))


def test_body_and_stage1_reference_equal_the_port(tmp_path):
    """The body model, the SMPL-T fit's start and its first four losses
    (both phases' Adam, at a one-iteration global phase) agree."""
    import dataclasses

    from vistracker_tpu_torch.core.landmarks import load_landmarks
    from vistracker_tpu_torch.core.priors import (load_body_prior,
                                                  load_hand_prior,
                                                  mean_hand_pose)
    from vistracker_tpu_torch.core.smpl import lbs_forward, load_smpl_pkl
    from vistracker_tpu_torch.core.smpl_generator import smplh_params
    from vistracker_tpu_torch.fit.smplt import (SMPLTFitConfig, fit_smplt,
                                                init_trans_from_bbox)
    from portbench.reference import fits as RF
    fab = _sequence(tmp_path)
    fit = dict(dataclasses.asdict(SMPLTFitConfig()), global_iters=1,
               max_iters=2, steps_per_iter=2)
    body = RF.load_body(fab["smpl_pkl"], fab["assets"], "cpu")
    model = load_smpl_pkl(fab["smpl_pkl"])
    g = torch.Generator().manual_seed(4)
    pose = torch.randn(3, 156, generator=g) * 0.3
    pose[:, 66:] = 0.0
    betas, trans = torch.randn(3, 10, generator=g), torch.randn(3, 3,
                                                                generator=g)
    assert torch.allclose(RF.skin(body, pose, betas, trans),
                          lbs_forward(model, pose, betas, trans)[0],
                          atol=2e-6, rtol=0)
    leaves, kpts, _ = RF.stage1_start(fab, fit, 6, "cpu")
    centres = np.asarray([[(np.nonzero(m)[1].max() + np.nonzero(m)[1].min())
                           / 2, (np.nonzero(m)[0].max()
                                 + np.nonzero(m)[0].min()) / 2]
                          for m in fab["person_mask"]], np.float32)
    cfg = SMPLTFitConfig(**fit)
    betas0 = np.zeros((6, 10), np.float32)
    betas0[:, 0] = 2.2
    init = smplh_params(fab["mocap_pose"], betas0,
                        init_trans_from_bbox(centres, cfg),
                        mean_hands=mean_hand_pose(fab["assets"]))
    for name, t in zip(RF.SMPLT_LEAVES, init.leaves()):
        assert torch.equal(leaves[name], t), name
    _, trace = fit_smplt(model, load_landmarks(fab["assets"]),
                         load_body_prior(fab["assets"]),
                         load_hand_prior(fab["assets"]), kpts, init, cfg)
    start = RF.stage1_start(fab, fit, 6, "cpu")
    ref = RF.follow_stage1(body, start, fit, 4)
    assert RF.trace_gap(trace[:4].tolist(), ref) < 1e-5
    frozen = RF.follow_stage1(body, start, fit, 4, update=False)
    assert RF.trace_gap(frozen, ref) > 1e-3


def test_object_phase_reference_equals_the_port():
    """The object phase's first four losses from one start, the port's
    optimizer on the port's SIF-Net against the reference on its own
    encode of the same images."""
    import dataclasses

    from vistracker_tpu_torch.fit import joint
    from portbench.reference import fits as RF
    net, p = _program(CFG, 6)
    batch = sifnet_batch(torch.Generator().manual_seed(2), 5, 10, 32, 14,
                         "cpu")
    g = torch.Generator().manual_seed(7)
    B = 5
    bc = batch["body_center"]
    start = dict(obj_r=torch.eye(3).expand(B, 3, 3)
                 + 0.05 * torch.randn(B, 3, 3, generator=g),
                 obj_t=bc + 0.05 * torch.randn(B, 3, generator=g),
                 obj_s=torch.ones(B),
                 points=(0.1 * torch.randn(1, 60, 3, generator=g)).expand(
                     B, -1, -1).contiguous(),
                 occ=torch.rand(B, generator=g), cc=batch["crop_center"],
                 bc=bc)
    jc = dict(dataclasses.asdict(joint.JointFitConfig()), iter_obj=1,
              steps_per_iter=4)
    with torch.no_grad():
        cache_p = net.encode(batch["images"])
    ctx = dict(cache=cache_p, cc=start["cc"], bc=bc)
    opt = joint.make_object_optimizer(
        lambda c, pts: net.query_heads(c["cache"], pts, c["cc"], c["bc"],
                                       heads=("df",)),
        lambda c, pts: pts[..., :2], joint.JointFitConfig(**jc))
    env = dict(obj_points=start["points"], obj_s=start["obj_s"],
               occ=start["occ"], ocent_target=start["obj_t"], ctx=ctx)
    _, trace, _ = joint._adam_phase(
        lambda q, d: opt.loss_obj(q, d, env),
        {"obj_r": start["obj_r"], "obj_t": start["obj_t"]},
        {"obj_r": jc["lr_obj_r"], "obj_t": jc["lr_obj_t"]}, 1, 4,
        lambda s: 1.0)
    tie = torch.tensor([[0.31, 0.74, 0.17], [0.58, 0.09, 0.93],
                        [0.42, 0.66, 0.25]])
    with torch.no_grad():
        cache_r = RS.encode(p, CFG, batch["images"])
    ref = RF.follow_object(p, CFG, cache_r, start, jc, tie, 4)
    assert RF.trace_gap(trace.tolist(), ref) < 1e-5
    half = RF.follow_object(p, CFG, cache_r, start, jc, tie, 4,
                            slice(0, 2))
    assert RF.trace_gap(half, ref) > 1e-3


@pytest.mark.parametrize("query_points", [0, 50])
def test_smpl_phase_reference_equals_the_port(tmp_path, query_points):
    """The first four losses of stage 6's first SMPL phase from one
    start, the port's optimizer on the port's SIF-Net and body model
    against the reference on its own encode of the same images, with
    every vertex queried or an evenly strided share."""
    import dataclasses

    from vistracker_tpu_torch.core.landmarks import (load_landmarks,
                                                     load_part_labels,
                                                     part_labels_array)
    from vistracker_tpu_torch.core.priors import (load_body_prior,
                                                  load_hand_prior)
    from vistracker_tpu_torch.core.smpl import load_smpl_pkl
    from vistracker_tpu_torch.fit import joint
    from vistracker_tpu_torch.fit.smplt import SMPLTParams
    from portbench.reference import fits as RF
    fab = _sequence(tmp_path, frames=5)
    model = load_smpl_pkl(fab["smpl_pkl"])
    body = RF.load_body(fab["smpl_pkl"], fab["assets"], "cpu")
    V = body["v_template"].shape[0]
    net, p = _program(CFG, 8)
    batch = sifnet_batch(torch.Generator().manual_seed(3), 5, 10, 32, 14,
                         "cpu")
    g = torch.Generator().manual_seed(9)
    B, bc = 5, batch["body_center"]
    start = dict(global_pose=0.2 * torch.randn(B, 3, generator=g),
                 body_pose=0.2 * torch.randn(B, 63, generator=g),
                 hand_pose=0.1 * torch.randn(B, 90, generator=g),
                 top_betas=torch.randn(B, 2, generator=g),
                 other_betas=torch.randn(B, 8, generator=g),
                 trans=bc + 0.05 * torch.randn(B, 3, generator=g),
                 cc=batch["crop_center"], bc=bc)
    jc = dict(dataclasses.asdict(joint.JointFitConfig()), iter_betas=1,
              steps_per_iter=4, smpl_query_points=query_points)
    with torch.no_grad():
        cache_p = net.encode(batch["images"])
    opt = joint.make_smpl_optimizer(
        lambda c, pts: net.query_heads(c["cache"], pts, c["cc"], c["bc"],
                                       heads=("df", "parts")),
        lambda c, j: j[..., :2], model, load_landmarks(fab["assets"]),
        load_body_prior(fab["assets"]), load_hand_prior(fab["assets"]),
        part_labels_array(load_part_labels(fab["assets"]), num_verts=V),
        joint.JointFitConfig(**jc))
    smpl = SMPLTParams(**{k: start[k] for k in RF.SMPLT_LEAVES})
    env = dict(aux=dict(pose_init=smpl.body_pose,
                        body_kpts=torch.zeros(B, 25, 3)),
               ctx=dict(cache=cache_p, cc=start["cc"], bc=bc))
    lrs = {k: (jc["lr_betas"] if k in RF.SMPL_PHASE1 else 0.0)
           for k in RF.SMPLT_LEAVES}
    _, trace, _ = joint._adam_phase(
        lambda q, d: opt.loss1(q, d, env),
        {k: start[k] for k in RF.SMPLT_LEAVES}, lrs, 1, 4, lambda s: 1.0)
    with torch.no_grad():
        cache_r = RS.encode(p, CFG, batch["images"])
    labels = RF.part_labels(fab["assets"], V, "cpu")
    ref = RF.follow_smpl_phase(p, CFG, body, labels, cache_r, start, jc, 4)
    assert RF.trace_gap(trace.tolist(), ref) < 1e-5
    half = RF.follow_smpl_phase(p, CFG, body, labels, cache_r, start, jc, 4,
                                slice(0, 2))
    assert RF.trace_gap(half, ref) > 1e-3
    frozen = RF.follow_smpl_phase(p, CFG, body, labels, cache_r, start, jc,
                                  4, update=False)
    assert RF.trace_gap(frozen, ref) > 1e-4


@pytest.mark.parametrize("x0", [40, 218])
def test_crop_reference_equals_the_port(x0):
    """The host input's crop, also where the square leaves the frame
    (zero outside, the last column counted as outside)."""
    from vistracker_tpu_torch.data.images import prepare_input_crop
    from portbench.reference import crop as RC
    g = np.random.RandomState(x0)
    rgb = g.randint(0, 256, (180, 260, 3)).astype(np.uint8)
    pm = np.zeros((180, 260), bool)
    om = np.zeros((180, 260), bool)
    pm[30:150, x0:x0 + 30] = True
    om[70:110, x0 + 10:x0 + 41] = True
    got, cc = prepare_input_crop(rgb, pm, om, 150, 64)
    want, tie, centre = RC.input_crop(rgb, pm, om, 150, 64)
    assert np.array_equal(centre, cc)
    assert RC.crop_gap(torch.as_tensor(got), want, tie) < 1e-5
    low, _, _ = RC.input_crop(rgb, pm, om, 150, 64, control=True)
    assert RC.crop_gap(low, want, tie) > 1e-3
