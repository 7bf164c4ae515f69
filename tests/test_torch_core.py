"""The port's core modules (rotations, SMPL-H LBS, landmarks, priors,
camera, SMPL-H batch construction) against the JAX package on the same
numpy inputs. Tolerance 1e-5 absolute unless stated: both sides compute
in float32 and differ only in summation order and FMA contraction."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vistracker_tpu.core import rotations as JR
from vistracker_tpu_torch.core import rotations as TR

ATOL = 1e-5


def _cmp(jax_out, torch_out, atol=ATOL):
    np.testing.assert_allclose(torch_out.detach().numpy(),
                               np.asarray(jax_out), atol=atol, rtol=0)


@pytest.mark.parametrize("name, make", [
    ("axis_angle_to_quat", lambda r: r.randn(64, 3)),
    ("quat_to_rotmat", lambda r: r.randn(64, 4)),
    ("axis_angle_to_rotmat", lambda r: r.randn(7, 5, 3)),
    ("rot6d_to_rotmat", lambda r: r.randn(64, 6)),
    ("rotmat_to_rot6d", lambda r: r.randn(64, 3, 3)),
    ("rotmat_to_quat", lambda r: np.asarray(
        JR.axis_angle_to_rotmat(jnp.asarray(r.randn(64, 3) * 1.5)))),
    ("quat_to_axis_angle", lambda r: r.randn(64, 4)),
    ("rotmat_to_axis_angle", lambda r: np.asarray(
        JR.axis_angle_to_rotmat(jnp.asarray(r.randn(64, 3))))),
    ("axis_angle_to_rot6d", lambda r: r.randn(64, 3)),
    ("rot6d_to_axis_angle", lambda r: r.randn(64, 6)),
])
def test_rotation_converters(name, make, rng):
    x = make(rng).astype(np.float32)
    _cmp(getattr(JR, name)(jnp.asarray(x)),
         getattr(TR, name)(torch.from_numpy(x)),
         atol=1e-4 if name == "rotmat_to_axis_angle" else ATOL)


@pytest.mark.parametrize("num_joints", [24, 52])
def test_lbs_matches_jax(rng, num_joints):
    """LBS on the model of tests/test_smpl.py (same seed, same arrays)."""
    from vistracker_tpu.core import smpl as JS
    from vistracker_tpu_torch.core import smpl as TS
    jm = JS.random_smpl_model(0, num_joints=num_joints, num_verts=128)
    tm = TS.random_smpl_model(0, num_joints=num_joints, num_verts=128)
    for f in ("v_template", "shapedirs", "posedirs", "j_regressor",
              "weights"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)))
    assert tm.parents == jm.parents
    B = 3
    pose = (rng.randn(B, 3 * num_joints) * 0.4).astype(np.float32)
    betas = rng.randn(B, 8).astype(np.float32)
    trans = rng.randn(B, 3).astype(np.float32)
    ref = JS.lbs_forward(jm, jnp.asarray(pose), jnp.asarray(betas),
                         jnp.asarray(trans))
    out = TS.lbs_forward(tm, torch.from_numpy(pose), torch.from_numpy(betas),
                         torch.from_numpy(trans))
    for r, o in zip(ref, out):
        _cmp(r, o)


def test_smpl_pkl_loaders_match(tmp_path, rng):
    """The port's chumpy-free pkl loader, landmarks, part labels and
    priors read the fabricated assets of tests/test_real_track.py exactly
    as the JAX package does."""
    from test_real_track import _make_fake_assets, _make_fake_smplh_pkl
    from vistracker_tpu.core import landmarks as JL, priors as JP, smpl as JS
    from vistracker_tpu_torch.core import landmarks as TL, priors as TP, \
        smpl as TS
    pkl = str(tmp_path / "smplh.pkl")
    _make_fake_smplh_pkl(pkl, rng)
    assets = str(tmp_path / "assets")
    _make_fake_assets(assets, rng)
    jm, tm = JS.load_smpl_pkl(pkl), TS.load_smpl_pkl(pkl)
    for f in ("v_template", "shapedirs", "posedirs", "j_regressor",
              "weights"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)))
    assert tm.parents == jm.parents and tm.gender == jm.gender
    np.testing.assert_array_equal(tm.faces, np.asarray(jm.faces))

    jl, tl = JL.load_landmarks(assets), TL.load_landmarks(assets)
    np.testing.assert_array_equal(tl.body25.numpy(), np.asarray(jl.body25))
    verts = rng.randn(2, 128, 3).astype(np.float32)
    _cmp(jl.smpl_center(jnp.asarray(verts)),
         tl.smpl_center(torch.from_numpy(verts)))
    np.testing.assert_array_equal(tl.face.numpy(), np.asarray(jl.face))
    np.testing.assert_array_equal(tl.hand.numpy(), np.asarray(jl.hand))
    np.testing.assert_array_equal(
        TL.part_labels_array(TL.load_part_labels(assets), 128),
        JL.part_labels_array(JL.load_part_labels(assets), 128))

    pose = rng.randn(4, 156).astype(np.float32)
    _cmp(JP.load_body_prior(assets)(jnp.asarray(pose)),
         TP.load_body_prior(assets)(torch.from_numpy(pose)), atol=1e-4)
    _cmp(JP.load_hand_prior(assets)(jnp.asarray(pose)),
         TP.load_hand_prior(assets)(torch.from_numpy(pose)), atol=1e-4)
    np.testing.assert_array_equal(TP.mean_hand_pose(assets),
                                  JP.mean_hand_pose(assets))


def test_camera_projections(rng):
    from vistracker_tpu.core import camera as JC
    from vistracker_tpu_torch.core import camera as TC
    pts = (rng.randn(2, 40, 3) * 0.3 + [0, 0, 2.3]).astype(np.float32)
    cc = rng.rand(2, 2).astype(np.float32) * 1000
    bc = rng.randn(2, 3).astype(np.float32)
    for jc, tc in ((JC.PerspectiveCamera(crop_size=1200),
                    TC.PerspectiveCamera(crop_size=1200)),
                   (JC.intercap_camera(kid=2, crop_size=800),
                    TC.intercap_camera(kid=2, crop_size=800))):
        # pixel coordinates are O(1000): float32 spacing there is 6e-5
        _cmp(jc.project_screen(jnp.asarray(pts)),
             tc.project_screen(torch.from_numpy(pts)), atol=2e-4)
        _cmp(jc.project_points(jnp.asarray(pts), jnp.asarray(cc)),
             tc.project_points(torch.from_numpy(pts), torch.from_numpy(cc)))
    _cmp(JC.triplane_project(jnp.asarray(pts), jnp.asarray(bc)),
         TC.triplane_project(torch.from_numpy(pts), torch.from_numpy(bc)),
         atol=0)


def test_smplh_params_padding(rng):
    from vistracker_tpu.core.smpl_generator import smplh_params as js
    from vistracker_tpu_torch.core.smpl_generator import smplh_params as ts
    pose72 = rng.randn(3, 72).astype(np.float32)
    betas = rng.randn(3, 8).astype(np.float32)
    trans = rng.randn(3, 3).astype(np.float32)
    hands = rng.randn(90).astype(np.float32)
    a = js(pose72, betas, trans, mean_hands=hands)
    b = ts(pose72, betas, trans, mean_hands=hands)
    for f in ("global_pose", "body_pose", "hand_pose", "top_betas",
              "other_betas", "trans"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)))
    with pytest.raises(ValueError):
        ts(pose72, betas, trans)
