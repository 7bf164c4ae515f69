"""The port's stage-6 modules (fit/joint.py and what it stands on:
project_so3, the mesh and silhouette-reference helpers, the SDF grid)
against the JAX package's, on an analytic scene: spheres stand in for the
neural distance fields, as in tests/test_joint_fit.py. The JAX side runs
its "xla" silhouette and contact backends."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fit import _toy
from vistracker_tpu.core import rotations as j_rot
from vistracker_tpu.data import sampling as j_sampling
from vistracker_tpu.data import silprep as j_silprep
from vistracker_tpu.fit import joint as j_joint
from vistracker_tpu.fit.smplt import SMPLTParams as JParams
from vistracker_tpu.ops import sdf_grid as j_sdf
from vistracker_tpu.utils import mesh as j_mesh
from vistracker_tpu_torch.core import rotations as t_rot
from vistracker_tpu_torch.data import silprep as t_silprep
from vistracker_tpu_torch.data.behave import load_template
from vistracker_tpu_torch.fit import joint as t_joint
from vistracker_tpu_torch.fit.smplt import SMPLTParams as TParams
from vistracker_tpu_torch.ops import sdf_grid as t_sdf
from vistracker_tpu_torch.utils import mesh as t_mesh

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

B = 4
OBJ_CENTER = np.array([0.4, 0.1, 2.3], np.float32)
OBJ_RADIUS = 0.25
HUM_CENTER = np.array([-0.1, 0.0, 2.2], np.float32)
HUM_RADIUS = 0.4
PART_W = np.random.RandomState(5).randn(3, 14).astype(np.float32)
FX, FY, CX, CY = 979.7844, 979.840, 1018.952, 779.486
SHORT = dict(iter_betas=1, iter_pose=1, iter_kpts=1, smpl_max_iter=3,
             iter_obj=2, iter_sil=2, joint_max_iter=3, sil_size=32,
             sil_sigma=2.0 / 32)


def j_query(ctx, points):
    d_h = jnp.abs(jnp.linalg.norm(points - HUM_CENTER, axis=-1) - HUM_RADIUS)
    d_o = jnp.abs(jnp.linalg.norm(points - OBJ_CENTER, axis=-1) - OBJ_RADIUS)
    return dict(df=jnp.stack([d_h, d_o], -1),
                parts=jnp.matmul(points - HUM_CENTER, jnp.asarray(PART_W)))


def t_query(ctx, points):
    hc, oc = torch.as_tensor(HUM_CENTER), torch.as_tensor(OBJ_CENTER)
    d_h = (torch.linalg.norm(points - hc, dim=-1) - HUM_RADIUS).abs()
    d_o = (torch.linalg.norm(points - oc, dim=-1) - OBJ_RADIUS).abs()
    return dict(df=torch.stack([d_h, d_o], -1),
                parts=(points - hc) @ torch.as_tensor(PART_W))


def _project(xp, points):
    z = points[..., 2:3]
    return xp([points[..., 0:1] * FX / z + CX, points[..., 1:2] * FY / z + CY],
              -1)


def j_project_px(ctx, points):
    return _project(jnp.concatenate, points)


def t_project_px(ctx, points):
    return _project(torch.cat, points)


def j_project_norm(ctx, joints):
    cc = jnp.asarray([[CX, CY]])
    return 2.0 * (600.0 + j_project_px(ctx, joints) - cc[:, None, :]) \
        / 1200.0 - 1.0


def t_project_norm(ctx, joints):
    cc = torch.tensor([[CX, CY]])
    return 2.0 * (600.0 + t_project_px(ctx, joints) - cc[:, None, :]) \
        / 1200.0 - 1.0


def _ellipsoid(n_lat=8, n_lon=12):
    """A closed UV mesh with half-axes 0.25, 0.18, 0.12."""
    vs, fs = [], []
    for i in range(n_lat + 1):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            vs.append([np.sin(th) * np.cos(ph), np.cos(th),
                       np.sin(th) * np.sin(ph)])
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + (j + 1) % n_lon
            fs += [[a, b, c], [b, d, c]]
    return (np.asarray(vs, np.float32) * np.array([0.25, 0.18, 0.12],
                                                   np.float32),
            np.asarray(fs, np.int32))


def _rotations(rng, n, scale=0.3):
    from scipy.spatial.transform import Rotation
    return Rotation.from_rotvec(rng.randn(n, 3) * scale).as_matrix() \
        .astype(np.float32)


def _closure(fn):
    """The free variables of a (jitted) closure by name: the JAX
    package's own per-phase loss functions."""
    fn = getattr(fn, "__wrapped__", fn)
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def _object_problem(rng, cfg):
    """numpy inputs of optimize_object: (obj_r, obj_t, obj_s, obj_points,
    smpl_verts, labels_h, occ, sil parts, sil_verts, sil_faces)."""
    verts_t, faces_t = _ellipsoid()
    pts = np.repeat(verts_t[None], B, 0)
    roi = np.tile(np.array([[700.0, 500.0, 700.0]], np.float32), (B, 1))
    ndc = 2.0 * (np.asarray(j_project_px(None, jnp.asarray(
        verts_t + OBJ_CENTER)[None]))[0] - roi[0, :2]) / roi[0, 2] - 1.0
    ref = np.asarray(j_joint.soft_silhouette(
        jnp.asarray(ndc), jnp.asarray(faces_t), cfg["sil_size"],
        cfg["sil_sigma"]))
    keep = (rng.rand(B, cfg["sil_size"], cfg["sil_size"]) > 0.1) \
        .astype(np.float32)
    obj_t = (OBJ_CENTER + np.array([0.1, -0.05, 0.05], np.float32)
             + rng.randn(B, 3).astype(np.float32) * 0.02)
    hum = _ellipsoid()[0] / np.array([0.25, 0.18, 0.12], np.float32)
    smpl_verts = (HUM_CENTER + HUM_RADIUS * hum[None].repeat(B, 0)
                  + rng.randn(B, len(hum), 3) * 0.01).astype(np.float32)
    return dict(obj_r=_rotations(rng, B), obj_t=obj_t,
                obj_s=np.ones(B, np.float32), obj_points=pts,
                smpl_verts=smpl_verts,
                labels_h=rng.randint(0, 14, smpl_verts.shape[1]),
                occ=(0.5 + 0.5 * rng.rand(B)).astype(np.float32),
                image_ref=np.repeat(ref[None], B, 0), keep_mask=keep,
                roi_xyb=roi, sil_verts=pts, sil_faces=faces_t)


def _j_obj_args(p):
    a = {k: jnp.asarray(v) for k, v in p.items()}
    sil = j_joint.SilRefs(a["image_ref"], a["keep_mask"], a["roi_xyb"])
    return (a["obj_r"], a["obj_t"], a["obj_s"], a["obj_points"],
            a["smpl_verts"], p["labels_h"], a["occ"], sil, a["sil_verts"],
            a["sil_faces"])


def _t_obj_args(p):
    a = {k: torch.as_tensor(v) for k, v in p.items()}
    sil = t_joint.SilRefs(a["image_ref"], a["keep_mask"], a["roi_xyb"])
    return (a["obj_r"], a["obj_t"], a["obj_s"], a["obj_points"],
            a["smpl_verts"], p["labels_h"], a["occ"], sil, a["sil_verts"],
            a["sil_faces"].long())


def _cfgs(**kw):
    kw = {**SHORT, **kw}
    return (j_joint.JointFitConfig(sil_backend="xla", contact_backend="xla",
                                   **kw), t_joint.JointFitConfig(**kw))


def test_config_defaults_match():
    """Every field the port keeps has the JAX package's default."""
    jd = {f.name: f.default for f in dataclasses.fields(j_joint.JointFitConfig)}
    td = {f.name: f.default for f in dataclasses.fields(t_joint.JointFitConfig)}
    assert set(jd) - set(td) == {"sil_face_chunk", "sil_backend",
                                 "contact_backend"}
    assert all(jd[k] == v for k, v in td.items())
    np.testing.assert_array_equal(t_joint._TIE_BREAK, j_joint._TIE_BREAK)


def test_project_so3_and_angle_match(rng):
    """U diag(1, 1, det) Vt agrees though the two SVDs may pick other
    signs for U; reflections are fixed; 1e-5."""
    m = rng.randn(6, 3, 3).astype(np.float32)
    m[1] = _rotations(rng, 1)[0]
    m[2] = m[2] * np.array([1, 1, -1], np.float32)   # some negative dets
    got = t_rot.project_so3(torch.as_tensor(m)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(j_rot.project_so3(jnp.asarray(m))), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)
    r1, r2 = _rotations(rng, 5, 1.0), _rotations(rng, 5, 1.0)
    np.testing.assert_allclose(
        t_rot.rotation_angle_deg(torch.as_tensor(r1),
                                 torch.as_tensor(r2)).numpy(),
        np.asarray(j_rot.rotation_angle_deg(jnp.asarray(r1),
                                            jnp.asarray(r2))), atol=1e-3)


def test_decopose_axis_value_and_gradient_match(rng):
    """The tie-break keeps the singular values about 1e-4 apart, so the
    SVD's gradient carries factors 1 / (s_i^2 - s_j^2) of 1e4 and more:
    against a float64 evaluation the float32 gradients of BOTH packages
    are off by up to 8e-3 of the largest entry (measured: JAX 7.9e-3,
    the port 3.9e-3 over 8 rotations). Held to 2e-2 against each other
    and the port to 1e-2 against its own float64."""
    r = _rotations(rng, 3)
    w = rng.randn(3, 3, 3).astype(np.float32)
    jv, jg = jax.value_and_grad(
        lambda x: (j_joint.decopose_axis(x) * w).sum())(jnp.asarray(r))
    x = torch.as_tensor(r).requires_grad_(True)
    tv = (t_joint.decopose_axis(x) * torch.as_tensor(w)).sum()
    tv.backward()
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    np.testing.assert_allclose(
        t_joint.decopose_axis(x).detach().numpy(),
        np.asarray(j_joint.decopose_axis(jnp.asarray(r))), atol=1e-6)
    jg = np.asarray(jg)
    np.testing.assert_allclose(x.grad.numpy(), jg,
                               atol=2e-2 * np.abs(jg).max())
    x64 = torch.as_tensor(r).double().requires_grad_(True)
    (t_rot.project_so3(x64 + 1e-4 * torch.as_tensor(t_joint._TIE_BREAK)
                       .double()) * torch.as_tensor(w).double()).sum() \
        .backward()
    np.testing.assert_allclose(x.grad.numpy(), x64.grad.numpy(),
                               atol=1e-2 * np.abs(jg).max())


def test_transform_and_orientation_match(rng):
    v = rng.randn(B, 7, 3).astype(np.float32)
    r, t = _rotations(rng, B), rng.randn(B, 3).astype(np.float32)
    s = (1 + 0.1 * rng.rand(B)).astype(np.float32)
    np.testing.assert_allclose(
        t_joint.transform_obj_verts(*map(torch.as_tensor, (v, r, t, s))),
        np.asarray(j_joint.transform_obj_verts(*map(jnp.asarray,
                                                    (v, r, t, s)))),
        atol=1e-6)
    src = j_sampling.compute_pca_axes(rng.randn(50, 3) * [3, 2, 1])
    tgt = np.einsum("ij,bjk->bik", src, _rotations(rng, B, 1.0)) \
        .astype(np.float32)
    tgt[0] = 0.0   # an empty harvest: the SVD of zeros must stay finite
    srcb = np.repeat(src[None], B, 0)
    got = t_joint.init_object_orientation(torch.as_tensor(tgt),
                                          torch.as_tensor(srcb)).numpy()
    want = np.asarray(j_joint.init_object_orientation(jnp.asarray(tgt),
                                                      jnp.asarray(srcb)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)
    np.testing.assert_allclose(got[1:], want[1:], atol=1e-5)


def test_mesh_helpers_match(rng, tmp_path):
    verts, faces = _ellipsoid(10, 14)
    np.testing.assert_array_equal(t_mesh.compute_pca_axes(verts),
                                  j_sampling.compute_pca_axes(verts))
    np.testing.assert_array_equal(
        t_mesh.sample_surface(verts, faces, 300, np.random.RandomState(0)),
        j_mesh.sample_surface(verts, faces, 300, np.random.RandomState(0)))
    np.testing.assert_array_equal(t_mesh.decimate_faces(faces, 100),
                                  j_mesh.decimate_faces(faces, 100))
    assert t_mesh.decimate_faces(faces, 10 ** 6) is faces
    np.testing.assert_array_equal(t_mesh.face_areas(verts, faces),
                                  j_mesh.face_areas(verts, faces))
    for got, want in zip(t_mesh.signed_distance_grid(verts, faces, 8),
                         j_mesh.signed_distance_grid(verts, faces, 8)):
        np.testing.assert_array_equal(got, want)
    # PLY round trips, either package writing
    os.makedirs(tmp_path / "box")
    j_mesh.save_ply(str(tmp_path / "box" / "box.ply"), verts + 1.0, faces)
    t_mesh.save_ply(str(tmp_path / "flat.ply"), verts, faces)
    v1, f1 = load_template(str(tmp_path), "box")
    np.testing.assert_allclose(v1, verts - verts.mean(0), atol=1e-6)
    np.testing.assert_array_equal(f1, faces)
    v2, f2 = j_mesh.load_ply(str(tmp_path / "flat.ply"))
    np.testing.assert_array_equal(v2, verts)
    np.testing.assert_array_equal(f2, faces)
    with pytest.raises(FileNotFoundError):
        load_template(str(tmp_path), "chair")


def test_load_ply_ascii(tmp_path):
    path = tmp_path / "a.ply"
    path.write_text("ply\nformat ascii 1.0\nelement vertex 3\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "element face 1\nproperty list uchar int vertex_indices\n"
                    "end_header\n0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
    for load in (t_mesh.load_ply, j_mesh.load_ply):
        v, f = load(str(path))
        assert v.shape == (3, 3) and f.tolist() == [[0, 1, 2]]


def test_prepare_sil_refs_match(rng):
    n = 48
    pm = np.zeros((3, n, n), np.float32)
    om = np.zeros((3, n, n), np.float32)
    pm[:, 10:40, 8:22] = 1.0
    om[0, 20:30, 18:34] = 1.0
    om[1, 5:12, 30:46] = 1.0     # the bbox leaves the image; frame 2 empty
    ccs = rng.rand(3, 2).astype(np.float32) * 500 + 700
    want = j_silprep.prepare_sil_refs(pm, om, ccs, 1200, n, 32)
    got = t_silprep.prepare_sil_refs(pm, om, ccs, 1200, n, 32)
    for k in ("image_ref", "keep_mask", "roi_xyb"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
    assert got.keep_mask.min() == 0 and got.image_ref.max() == 1


def test_sdf_grid_matches(rng):
    vals = rng.randn(6, 6, 6).astype(np.float32)
    bmin, bmax = np.float32([-1, -1, -1]), np.float32([1, 2, 1.5])
    pts = (rng.rand(2, 40, 3) * 3.4 - 1.2).astype(np.float32)  # some outside
    jg = j_sdf.SDFGrid(*map(jnp.asarray, (vals, bmin, bmax)))
    tg = t_sdf.SDFGrid(*map(torch.as_tensor, (vals, bmin, bmax)))
    np.testing.assert_allclose(
        t_sdf.sample_sdf(tg, torch.as_tensor(pts)).numpy(),
        np.asarray(j_sdf.sample_sdf(jg, jnp.asarray(pts))), atol=1e-6)
    jl, jgrad = jax.value_and_grad(
        lambda p: j_sdf.penetration_loss(jg, p))(jnp.asarray(pts))
    p = torch.as_tensor(pts).requires_grad_(True)
    tl = t_sdf.penetration_loss(tg, p)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), atol=1e-6)


# ---------------------------------------------------------------------------
# per-phase loss and gradient at step 0
# ---------------------------------------------------------------------------

def _smpl_problem(rng):
    j, p, kpts, (pose, betas, trans) = _toy(rng, B=B)
    kp = np.concatenate([rng.randn(B, 25, 2) * 0.3, rng.rand(B, 25, 1)],
                        -1).astype(np.float32)
    labels = rng.randint(0, 14, 96).astype(np.int32)
    trans = np.tile(HUM_CENTER + np.float32([0.1, 0.0, 0.3]), (B, 1)) \
        .astype(np.float32)
    return j, p, kp, labels, pose, betas, trans


def _assert_grads(tg: dict, jg: dict, tol=1e-4):
    for k, g in jg.items():
        g = np.asarray(g)
        if np.abs(g).max() == 0:
            assert tg[k] is None or float(tg[k].abs().max()) == 0, k
            continue
        np.testing.assert_allclose(tg[k].numpy(), g,
                                   atol=tol * np.abs(g).max(), err_msg=k)


@pytest.mark.parametrize("phase, query_points", [
    ("smpl1", 0), ("smpl23_pose", 0), ("smpl23_kpts", 0), ("smpl23_kpts", 40)])
def test_smpl_phase_loss_and_gradient_match(rng, phase, query_points):
    """Loss and gradient w.r.t. every SMPL leaf at step 0, 1e-4 relative
    (of the leaf's largest gradient entry)."""
    j, p, kp, labels, pose, betas, trans = _smpl_problem(rng)
    jcfg, tcfg = _cfgs(smpl_query_points=query_points)
    jopt = j_joint.make_smpl_optimizer(j_query, j_project_norm, *j, labels,
                                       jcfg)
    topt = t_joint.make_smpl_optimizer(t_query, t_project_norm, *p, labels,
                                       tcfg)
    jp = JParams.from_full(*map(jnp.asarray, (pose, betas, trans)))
    tp = TParams.from_full(*map(torch.as_tensor, (pose, betas, trans)))
    jd = dataclasses.asdict(jp)
    td = {k: getattr(tp, k).clone().requires_grad_(True) for k in jd}
    pinit = pose[:, 3:66] + 0.01
    jenv = dict(aux=dict(pose_init=jnp.asarray(pinit),
                         body_kpts=jnp.asarray(kp)), ctx=None)
    tenv = dict(aux=dict(pose_init=torch.as_tensor(pinit),
                         body_kpts=torch.as_tensor(kp)), ctx=None)
    cells = _closure(jopt)
    if phase == "smpl1":
        jl, jg = jax.value_and_grad(cells["loss1_env"])(jd, 1.0, jenv)
        tl = topt.loss1(td, 1.0, tenv)
    else:
        decay = (1.0, 0.0) if phase == "smpl23_pose" else (4.0 / 3.0, 1.0)
        jl, jg = jax.value_and_grad(cells["loss23_env"])(
            jd, (jnp.float32(decay[0]), jnp.float32(decay[1])), jenv)
        tl = topt.loss23(td, decay, tenv)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    _assert_grads({k: v.grad for k, v in td.items()}, jg)


@pytest.mark.parametrize("phase", [
    "object", "sil", "joint", "joint_collide", "object_ocent", "object_nosvd",
    "sil_nosvd", "joint_nosvd"])
def test_object_phase_loss_and_gradient_match(rng, monkeypatch, phase):
    """Loss and gradient w.r.t. obj_r and obj_t at step 0, 1e-4 relative
    -- except obj_r at 2e-2 where its gradient passes through the SVD of
    decopose_axis, whose float32 noise is that large in both packages
    (test_decopose_axis_value_and_gradient_match). The *_nosvd cases
    replace decopose_axis by the identity in both packages and hold obj_r
    to 1e-4 too, so everything behind the projection is compared
    tightly."""
    nosvd = phase.endswith("_nosvd")
    if nosvd:
        phase = phase[:-len("_nosvd")]
        monkeypatch.setattr(j_joint, "decopose_axis", lambda r: r)
        monkeypatch.setattr(t_joint, "decopose_axis", lambda r: r)
    kw = {}
    if phase == "joint_collide":
        kw["collision"] = True
    if phase == "object_ocent":
        kw["w_ocent"] = 100.0
    jcfg, tcfg = _cfgs(**kw)
    prob = _object_problem(rng, SHORT)
    jopt = j_joint.make_object_optimizer(j_query, j_project_px, jcfg)
    topt = t_joint.make_object_optimizer(t_query, t_project_px, tcfg)
    ja, ta = _j_obj_args(prob), _t_obj_args(prob)
    jp = {"obj_r": ja[0], "obj_t": ja[1]}
    tp = {"obj_r": ta[0].clone().requires_grad_(True),
          "obj_t": ta[1].clone().requires_grad_(True)}
    jenv = dict(obj_points=ja[3], obj_s=ja[2], occ=ja[6],
                ocent_target=ja[1] + 0.03, ctx=None)
    tenv = dict(obj_points=ta[3], obj_s=ta[2], occ=ta[6],
                ocent_target=ta[1] + 0.03, ctx=None)
    cells = _closure(jopt)
    if phase.startswith("object"):
        jl, jg = jax.value_and_grad(cells["loss_obj_env"])(jp, 1.0, jenv)
        tl = topt.loss_obj(tp, 1.0, tenv)
    elif phase == "sil":
        jenv.update(sil=ja[7], sil_verts=ja[8], sil_faces=ja[9],
                    trans_init=ja[1] - 0.02)
        tenv.update(sil=ta[7], sil_verts=ta[8], sil_faces=ta[9],
                    trans_init=ta[1] - 0.02)
        jl, jg = jax.value_and_grad(cells["loss_sil_env"])(jp, 2.0, jenv)
        tl = topt.loss_sil(tp, 2.0, tenv)
    else:
        jenv.update(smpl_verts=ja[4], labels_h=jnp.asarray(prob["labels_h"]))
        tenv.update(smpl_verts=ta[4],
                    labels_h=torch.as_tensor(prob["labels_h"]).long())
        if phase == "joint_collide":
            vals, bmin, bmax = t_mesh.signed_distance_grid(
                prob["sil_verts"][0], prob["sil_faces"], 12, padding=0.4)
            jenv["sdf_grid"] = j_sdf.SDFGrid(*map(jnp.asarray,
                                                  (vals, bmin, bmax)))
            tenv["sdf_grid"] = t_sdf.SDFGrid(*map(torch.as_tensor,
                                                  (vals, bmin, bmax)))
        jm = cells["contact_masks"](jp, jenv)
        tm = topt.contact_masks({k: v.detach() for k, v in tp.items()}, tenv)
        for a, b in zip(tm, jm):   # labels and both contact masks
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert tm[1].any() and tm[2].any() and not tm[1].all()
        jenv.update(labels_o=jm[0], mask_h=jm[1], mask_o=jm[2])
        tenv.update(labels_o=tm[0], mask_h=tm[1], mask_o=tm[2],
                    nn_plans=topt.contact_plans(ta[4], tenv["labels_h"],
                                                *tm))
        jl, jg = jax.value_and_grad(cells["loss_joint_env"])(jp, 5.0, jenv)
        tl = topt.loss_joint(tp, 5.0, tenv)
    tl.backward()
    assert float(jnp.abs(jg["obj_r"]).max()) > 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    _assert_grads({"obj_t": tp["obj_t"].grad}, {"obj_t": jg["obj_t"]})
    _assert_grads({"obj_r": tp["obj_r"].grad}, {"obj_r": jg["obj_r"]},
                  1e-4 if nosvd else 2e-2)


# ---------------------------------------------------------------------------
# the optimizers at short budgets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("early_stop", [False, True])
def test_smpl_optimizer_matches(rng, early_stop):
    """50 Adam steps. Outputs to 1e-4, far below steps x lr (0.3); with
    early_stop both stop at the same iteration (a loose tolerance makes
    the gate fire inside the budget)."""
    j, p, kp, labels, pose, betas, trans = _smpl_problem(rng)
    kw = dict(early_stop=early_stop, smpl_rel_tol=0.5 if early_stop else 1e-3,
              early_stop_min_frac=0.0, smpl_max_iter=6 if early_stop else 3)
    jcfg, tcfg = _cfgs(**kw)
    jopt = j_joint.make_smpl_optimizer(j_query, j_project_norm, *j, labels,
                                       jcfg, report_iters=True)
    topt = t_joint.make_smpl_optimizer(t_query, t_project_norm, *p, labels,
                                       tcfg, report_iters=True)
    jp, jl, jit = jopt(JParams.from_full(*map(jnp.asarray,
                                              (pose, betas, trans))),
                       jnp.asarray(kp))
    tp, tl, tit = topt(TParams.from_full(*map(torch.as_tensor,
                                              (pose, betas, trans))),
                       torch.as_tensor(kp))
    assert tit["smpl"] == int(jit["smpl"]) and tit["smpl_max"] == jit["smpl_max"]
    if early_stop:
        assert tit["smpl"] < tit["smpl_max"]
        np.testing.assert_allclose(float(tl[-1]), float(jl[-1]), rtol=1e-4)
    else:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    for f in dataclasses.fields(TParams):
        np.testing.assert_allclose(getattr(tp, f.name).numpy(),
                                   np.asarray(getattr(jp, f.name)), atol=1e-4,
                                   err_msg=f.name)
    np.testing.assert_array_equal(tp.hand_pose.numpy(), pose[:, 66:])


@pytest.mark.parametrize("variant", ["plain", "early_stop", "collision"])
def test_object_optimizer_matches(rng, variant):
    """70 Adam steps over the three object phases. Translations to 1e-4;
    the rotation's gradient carries the SVD's ~1e-3 relative noise, which
    Adam's normalized steps pass on, so rotations are held to 1e-3 (0.06
    degrees), far below steps x lr (0.16)."""
    kw = {}
    if variant == "early_stop":
        kw = dict(early_stop=True, joint_rel_tol=5e-2, joint_max_iter=8)
    if variant == "collision":
        kw = dict(collision=True)
    jcfg, tcfg = _cfgs(**kw)
    prob = _object_problem(rng, SHORT)
    grids = (None, None)
    if variant == "collision":
        vals, bmin, bmax = t_mesh.signed_distance_grid(
            prob["sil_verts"][0], prob["sil_faces"], 12, padding=0.4)
        grids = (j_sdf.SDFGrid(*map(jnp.asarray, (vals, bmin, bmax))),
                 t_sdf.SDFGrid(*map(torch.as_tensor, (vals, bmin, bmax))))
    jopt = j_joint.make_object_optimizer(j_query, j_project_px, jcfg,
                                         report_iters=True)
    topt = t_joint.make_object_optimizer(t_query, t_project_px, tcfg,
                                         report_iters=True)
    jr, jt, jl, jit = jopt(*_j_obj_args(prob), None, grids[0])
    tr, tt, tl, tit = topt(*_t_obj_args(prob), None, grids[1])
    assert tit["joint"] == int(jit["joint"])
    assert tit["joint_max"] == jit["joint_max"]
    if variant == "early_stop":
        assert tit["joint"] < tit["joint_max"]
    else:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-3)
    assert np.abs(tt.numpy() - prob["obj_t"]).max() > 1e-3
    np.testing.assert_allclose(np.linalg.det(tr.numpy()), 1.0, atol=1e-5)


def test_frozen_leaves_and_fresh_moments(rng):
    """A leaf with rate 0 carries no gradient and does not move; each
    phase starts from zero moments (its first step is lr * sign)."""
    p = {"a": torch.tensor([1.0, -2.0]), "b": torch.tensor([3.0])}
    seen = []

    def loss(leaves, decay):
        seen.append(leaves["b"].requires_grad)
        return (leaves["a"] ** 2).sum() * decay + (leaves["b"] ** 2).sum()

    out, trace, iters = t_joint._adam_phase(loss, p, {"a": 0.1, "b": 0.0}, 2,
                                            3, lambda s: 1.0 + s)
    assert seen == [False] * 6 and iters == 2 and trace.shape == (6,)
    assert torch.equal(out["b"], p["b"])
    out1, _, _ = t_joint._adam_phase(loss, p, {"a": 0.1, "b": 0.0}, 1, 1,
                                     lambda s: 1.0)
    np.testing.assert_allclose(out1["a"].numpy(), [0.9, -1.9], atol=1e-6)


# ---------------------------------------------------------------------------
# the stage-6 diagnostic: term_probe
# ---------------------------------------------------------------------------

TERMS = ("contact", "mask", "object", "ocent", "otemp", "ovtemp")


@pytest.fixture(scope="module")
def probes():
    """Both packages' term_probe on one analytic problem with silhouette
    refs and frozen contact masks (from contact_masks, as the joint phase
    freezes them), w_ocent = 0 and an ocent target 3 cm off; once without
    and once with an SDF grid (the collision term) and the body partly
    inside the object. Returns
    {variant: (port probe, JAX probe)}."""
    rng = np.random.RandomState(7)
    jcfg, tcfg = _cfgs()
    assert tcfg.w_ocent == 0
    prob = _object_problem(rng, SHORT)
    jopt = j_joint.make_object_optimizer(j_query, j_project_px, jcfg)
    topt = t_joint.make_object_optimizer(t_query, t_project_px, tcfg)
    ja, ta = _j_obj_args(prob), _t_obj_args(prob)
    jp = {"obj_r": ja[0], "obj_t": ja[1]}
    tp = {"obj_r": ta[0], "obj_t": ta[1]}
    jenv = dict(obj_points=ja[3], obj_s=ja[2], occ=ja[6], ctx=None,
                ocent_target=ja[1] + 0.03, smpl_verts=ja[4],
                labels_h=jnp.asarray(prob["labels_h"]), sil=ja[7],
                sil_verts=ja[8], sil_faces=ja[9])
    tenv = dict(obj_points=ta[3], obj_s=ta[2], occ=ta[6], ctx=None,
                ocent_target=ta[1] + 0.03, smpl_verts=ta[4],
                labels_h=prob["labels_h"], sil=ta[7], sil_verts=ta[8],
                sil_faces=ta[9])
    jm = _closure(jopt)["contact_masks"](jp, jenv)
    tm = topt.contact_masks(tp, dict(tenv, labels_h=torch.as_tensor(
        prob["labels_h"]).long()))
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jenv.update(labels_o=jm[0], mask_h=jm[1], mask_o=jm[2])
    tenv.update(labels_o=tm[0], mask_h=tm[1], mask_o=tm[2])
    out = {"plain": (topt.term_probe(tp, tenv), jopt.term_probe(jp, jenv))}
    # the collision variant: the body pulled around the object, partly
    # inside it, so that the penetration term has a gradient
    inside = (0.3 * (prob["smpl_verts"] - HUM_CENTER)
              + prob["obj_t"][:, None]).astype(np.float32)
    jenv["smpl_verts"], tenv["smpl_verts"] = (jnp.asarray(inside),
                                              torch.as_tensor(inside))
    vals, bmin, bmax = t_mesh.signed_distance_grid(
        prob["sil_verts"][0], prob["sil_faces"], 12, padding=0.4)
    jenv["sdf_grid"] = j_sdf.SDFGrid(*map(jnp.asarray, (vals, bmin, bmax)))
    tenv["sdf_grid"] = t_sdf.SDFGrid(*map(torch.as_tensor,
                                          (vals, bmin, bmax)))
    out["collide"] = (topt.term_probe(tp, tenv), jopt.term_probe(jp, jenv))
    return out


@pytest.mark.parametrize("variant, name", [
    *[("plain", n) for n in TERMS], ("collide", "collide")])
def test_term_probe_matches_jax(probes, variant, name):
    """Each weighted term's value (1e-4 relative) and its gradient w.r.t.
    every frame's obj_t (1e-4 of its largest entry), as JAX's
    value_and_grad gives them; ocent is probed at weight 1 although the
    run's w_ocent is 0."""
    tout, jout = probes[variant]
    want = set(TERMS) | ({"collide"} if variant == "collide" else set())
    assert set(tout) == set(jout) == want
    assert list(tout) == sorted(tout)
    tv, tg = tout[name]
    jv, jg = jout[name]
    assert tg.shape == (B, 3) and tv.ndim == 0
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-4)
    assert float(np.abs(np.asarray(jg)).max()) > 0, name
    _assert_grads({"obj_t": tg}, {"obj_t": jg})
