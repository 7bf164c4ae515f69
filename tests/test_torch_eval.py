"""The port's evaluation (eval/metrics.py, eval/evaluator.py), slerp
infilling (fit/interpolate.py, core/rotations.py:quat_slerp) and the
infiller's downstream evaluation (fit/infill.py:downstream_recon_eval)
against the JAX package on the same numpy inputs. The chamfer runs
through the plain version of kernel K4 on the CPU."""
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from vistracker_tpu.core import rotations as jax_rot
from vistracker_tpu.eval import evaluator as jax_ev
from vistracker_tpu.eval import metrics as jax_metrics
from vistracker_tpu.fit import interpolate as jax_interp
from vistracker_tpu.fit.infill import downstream_recon_eval as jax_downstream
from vistracker_tpu_torch.core.rotations import quat_slerp
from vistracker_tpu_torch.eval import evaluator, metrics
from vistracker_tpu_torch.fit import interpolate
from vistracker_tpu_torch.fit.infill import downstream_recon_eval

torch.set_num_threads(1)

# Eval errors and chamfer means, relative: the two packages take the same
# samples and differ only in the rounding of the squared distances
# (a few ulp, see test_torch_chamfer.py), far below 1e-4 of a mean.
REL = 1e-4
# float32 quaternion chains (rotmat -> quat -> slerp -> rotmat) in two
# orders of rounding: a few ulp of unit entries
ROT_TOL = 1e-5


def _mesh(rng, v=60, f=100):
    return (rng.randn(v, 3) * 0.3).astype(np.float32), \
        rng.randint(0, v, (f, 3)).astype(np.int32)


def test_alignment_and_vertex_metrics_are_the_jax_numbers(rng):
    """compute_transform, apply_transform, v2v and acceleration stay numpy
    float64 copies: the same numbers as the JAX package."""
    src = rng.randn(200, 3)
    R_gt = Rotation.from_rotvec([0.4, -0.3, 0.8]).as_matrix()
    dst = 1.7 * src @ R_gt.T + [0.5, -1.0, 2.0] + rng.randn(200, 3) * 1e-3
    got, want = metrics.compute_transform(src, dst), \
        jax_metrics.compute_transform(src, dst)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[0], R_gt, atol=1e-3)
    seq = rng.randn(5, 30, 3)
    np.testing.assert_array_equal(metrics.apply_transform(seq, *got),
                                  jax_metrics.apply_transform(seq, *want))
    gt, rec = rng.randn(6, 30, 3), rng.randn(6, 30, 3)
    assert metrics.v2v_error(gt[0], rec[0]) == \
        jax_metrics.v2v_error(gt[0], rec[0])
    assert metrics.accel_error(gt, rec) == jax_metrics.accel_error(gt, rec)
    assert metrics.accel_error(gt[:2], rec[:2]) == 0.0


@pytest.mark.parametrize("n", [500, 2000])
def test_chamfer_error_matches_jax(rng, n):
    v1, f = _mesh(rng)
    v2 = v1 + (rng.randn(*v1.shape) * 0.02).astype(np.float32)
    got = metrics.chamfer_error(v1, f, v2, f, n, seed=3, device="cpu")
    want = jax_metrics.chamfer_error(v1, f, v2, f, n, seed=3)
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=REL)


def _sequence(rng, T=40, hole_frames=(3, 17, 18, 33)):
    """GT SMPL and object verts over T frames and a recon that is a
    similarity transform of them plus noise; recon_exist False at
    hole_frames."""
    sv, sf = _mesh(rng, 50, 90)
    ov, of = _mesh(rng, 30, 50)
    t = np.arange(T, dtype=np.float32)[:, None, None]
    motion = np.concatenate([np.sin(0.2 * t), np.cos(0.1 * t), 0.05 * t], -1)
    sgt = (sv[None] + 0.1 * motion).astype(np.float32)
    ogt = (ov[None] * 0.5 + 0.1 * motion + [0.2, 0.0, 0.0]) \
        .astype(np.float32)
    R = Rotation.from_rotvec([0.1, 0.2, -0.1]).as_matrix()
    srec = (1.1 * sgt @ R.T + [0.3, 0.0, 0.1]
            + rng.randn(*sgt.shape) * 0.01).astype(np.float32)
    orec = (1.1 * ogt @ R.T + [0.3, 0.0, 0.1]
            + rng.randn(*ogt.shape) * 0.02).astype(np.float32)
    exist = np.ones(T, bool)
    exist[[h for h in hole_frames if h < T]] = False
    return sgt, ogt, srec, orec, sf, of, exist


@pytest.mark.parametrize("T, window, smpl_only, samples",
                         [(40, 16, False, 500), (40, 16, True, 500),
                          (20, 8, False, 2000)])
def test_eval_sequence_matches_jax(rng, T, window, smpl_only, samples):
    """Window refits (three windows each), recon_exist holes, SMPL-only
    alignment."""
    sgt, ogt, srec, orec, sf, of, exist = _sequence(rng, T)
    got = evaluator.eval_sequence(sgt, ogt, srec, orec, sf, of, exist, window,
                                  smpl_only=smpl_only,
                                  chamfer_samples=samples, device="cpu")
    want = jax_ev.eval_sequence(sgt, ogt, srec, orec, sf, of, exist, window,
                                smpl_only=smpl_only, chamfer_samples=samples)
    assert got.shape == want.shape == (exist.sum(), 6)
    assert np.isfinite(got).all() and (got[:, :4] > 0).all()
    np.testing.assert_allclose(got, want, rtol=REL)


def test_eval_sequence_identity_is_zero_v2v(rng):
    sgt, ogt, _, _, sf, of, _ = _sequence(rng, T=6, hole_frames=())
    err = evaluator.eval_sequence(sgt, ogt, sgt, ogt, sf, of, window=4,
                                  chamfer_samples=300, device="cpu")
    assert err.shape == (6, 6)
    np.testing.assert_allclose(err[:, 2:], 0.0, atol=1e-4)


def test_smpl_verts_from_packed_matches_jax(rng):
    from vistracker_tpu.core.smpl import random_smpl_model as jax_model
    from vistracker_tpu_torch.core.smpl import random_smpl_model

    T = 7
    poses = (rng.randn(T, 156) * 0.2).astype(np.float32)
    betas = (rng.randn(T, 10) * 0.5).astype(np.float32)
    trans = rng.randn(T, 3).astype(np.float32)
    got = evaluator.smpl_verts_from_packed(random_smpl_model(4), poses, betas,
                                           trans, batch=3)
    want = jax_ev.smpl_verts_from_packed(jax_model(4), poses, betas, trans,
                                         batch=3)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_collect_results_json_matches_jax(rng, tmp_path):
    errs = {"Date01_Sub01_boxsmall": rng.rand(5, 6),
            "Date02_Sub02_chairwood": rng.rand(3, 6),
            "Date03_Sub03_boxsmall": rng.rand(4, 6)}
    extra = {"rot_error": {"mean": 1.0, "std": 0.5}}
    with open(evaluator.collect_results(errs, str(tmp_path / "p"), "tr",
                                        "split_", extra)) as f:
        got = json.load(f)
    with open(jax_ev.collect_results(errs, str(tmp_path / "j"), "tr",
                                     "split_", extra)) as f:
        want = json.load(f)
    assert got.pop("time") and want.pop("time")
    assert got == want
    assert set(got["separate"]) == set(errs)
    assert got["boxsmall"]["total"] == 9 and got["chairwood"]["total"] == 3
    assert list(evaluator.ERROR_KEYS) == list(jax_ev.ERROR_KEYS)
    assert evaluator.format_errors(errs["Date01_Sub01_boxsmall"]) == \
        jax_ev.format_errors(errs["Date01_Sub01_boxsmall"])
    assert evaluator.object_name_of("Date01_Sub01_boxsmall") == "boxsmall"
    assert evaluator.object_name_of("plain") == "plain"


def test_rotation_errors_deg_matches_jax(rng):
    a = Rotation.from_rotvec(rng.randn(10, 3)).as_matrix()
    b = Rotation.from_rotvec(rng.randn(10, 3)).as_matrix()
    got = evaluator.rotation_errors_deg(a, b)
    np.testing.assert_array_equal(got, jax_ev.rotation_errors_deg(a, b))
    np.testing.assert_allclose(evaluator.rotation_errors_deg(a, a), 0.0,
                               atol=1e-5)


def test_quat_slerp_matches_jax(rng):
    """Random pairs (both signs of the dot product), near-parallel pairs
    (the lerp branch) and per-pair and broadcast t."""
    q0 = rng.randn(64, 4).astype(np.float32)
    q1 = rng.randn(64, 4).astype(np.float32)
    q1[:8] = q0[:8] + 1e-3 * rng.randn(8, 4).astype(np.float32)
    t = rng.rand(64).astype(np.float32)
    got = quat_slerp(torch.as_tensor(q0), torch.as_tensor(q1),
                     torch.as_tensor(t)).numpy()
    want = np.asarray(jax_rot.quat_slerp(jnp.asarray(q0), jnp.asarray(q1),
                                         jnp.asarray(t)))
    np.testing.assert_allclose(got, want, atol=ROT_TOL)
    half = quat_slerp(torch.as_tensor(q0), torch.as_tensor(q1),
                      torch.tensor([0.5])).numpy()
    np.testing.assert_allclose(half, np.asarray(jax_rot.quat_slerp(
        jnp.asarray(q0), jnp.asarray(q1), jnp.asarray([0.5]))), atol=ROT_TOL)


@pytest.mark.parametrize("pattern", ["middle", "edges", "all", "none"])
def test_slerp_fill_matches_jax(rng, pattern):
    T = 24
    rots = Rotation.from_rotvec(rng.randn(T, 3) * 0.8).as_matrix()
    trans = rng.randn(T, 3)
    occ = np.ones(T)
    if pattern == "middle":
        occ[[4, 5, 6, 12, 20]] = 0.1
    elif pattern == "edges":
        occ[[0, 1, 2, 9, 22, 23]] = 0.2
    elif pattern == "none":
        occ[:] = 0.0
    vis = occ >= 0.5
    assert interpolate.occluded_intervals(vis) == \
        jax_interp.occluded_intervals(vis)
    got_r, got_t = interpolate.slerp_fill(rots, trans, occ)
    want_r, want_t = jax_interp.slerp_fill(rots, trans, occ)
    np.testing.assert_allclose(got_r, want_r, atol=ROT_TOL)
    np.testing.assert_allclose(got_t, want_t, atol=1e-6)
    if pattern == "edges":
        np.testing.assert_allclose(got_t[:3], trans[[3, 3, 3]])
        np.testing.assert_allclose(got_t[22:], trans[[21, 21]])
        assert interpolate.occluded_intervals(vis) == [(0, 3), (9, 10),
                                                       (22, 24)]


def _stub_infill(params, poses, trans, obj_rot_real, occ, occ_thres=0.5,
                 init_thres=0.5):
    """A deterministic stand-in for the infiller: None (pass-through) when
    fewer than 3 frames are visible, else the input rotations turned by a
    small rotation that grows with the occlusion."""
    if (np.asarray(occ) >= init_thres).sum() < 3:
        return None
    turn = Rotation.from_rotvec(np.outer(1.0 - np.asarray(occ),
                                         [0.1, -0.05, 0.2])).as_matrix()
    return np.einsum("tij,tjk->tik", turn, obj_rot_real).astype(np.float32)


def test_downstream_recon_eval_matches_jax(rng):
    """The same stub infill for both packages: object chamfer and v2v on the
    occluded frames, a pass-through sequence skipped, and {} when no
    sequence has an occluded frame."""
    tv, tf = _mesh(rng, 40, 70)
    seqs = []
    for k, n_vis in enumerate((12, 2, 10)):
        T = 12
        occ = np.where(np.arange(T) < n_vis, 0.9, 0.2)
        if k == 2:
            occ = rng.rand(T)
        seqs.append(dict(
            poses=rng.randn(T, 72).astype(np.float32),
            trans=rng.randn(T, 3).astype(np.float32),
            obj_rot_real=Rotation.from_rotvec(rng.randn(T, 3)).as_matrix(),
            obj_rot_gt=Rotation.from_rotvec(rng.randn(T, 3)).as_matrix(),
            occ=occ, temp_verts=tv, temp_faces=tf))
    got = downstream_recon_eval(functools.partial(_stub_infill, None), seqs,
                                samples=600, device="cpu")
    want = jax_downstream(_stub_infill, None, seqs, samples=600)
    assert set(got) == {"downstream_chamfer_cm", "downstream_v2v_cm"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=REL)
    assert downstream_recon_eval(functools.partial(_stub_infill, None),
                                 seqs[:1], device="cpu") == {}
