"""Stages 4 and 5 of `track` chained, the port against the JAX package with
the same weights, on a sequence where more than a quarter of the frames
are occluded (predicted visibility < 0.5).

Stage 4 is the surface harvest of the tiny SIF-Net as the fixture harness
runs it (the scan harvest of --no-fast-gen, median centers of
--robust-centers), with the JAX draws replayed. Stage 5 is what
cli/real_track.py does over the whole sequence: the rotation init from the
neural PCA axes, SmoothNet over the rotations, then the HVOP-Net infill on
the occlusion stretches, behind its seed gate.

The limits are those of the tracker split of ROADMAP Queue 3 (k)
(tests/torch_split_k.py): neural centers within 2 mm, predicted
visibilities within 0.002, the rotation init and the infilled rotations
within 0.5 degrees."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from test_torch_fit import _ScanDraws
from test_torch_sifnet import S, _nets
from test_torch_temporal import _conditional_pair, _smoothnet_pair
from vistracker_tpu.fit import infill as j_infill
from vistracker_tpu.fit import joint as j_joint
from vistracker_tpu.fit import smoothing as j_smoothing
from vistracker_tpu.models import smoothnet as j_smoothnet
from vistracker_tpu_torch.fit import infill as t_infill
from vistracker_tpu_torch.fit import joint as t_joint
from vistracker_tpu_torch.fit import smoothing as t_smoothing

torch.set_num_threads(1)

CENTER_M, VIS, DEG = 2e-3, 2e-3, 0.5
B, T = 6, 48
# frames 12-19 and 32-39 occluded: 16 of 48, and 32 visible frames pass
# the infiller's seed gate (30 of the first clip)
OCCLUDED = np.r_[12:20, 32:40]


def _angles_deg(a, b):
    c = (np.einsum("tij,tij->t", np.asarray(a, np.float64),
                   np.asarray(b, np.float64)) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def _stage4(rng):
    """Both packages' harvest on B frames: (jax object dict, port's)."""
    from vistracker_tpu.fit.generator import GeneratorConfig as JG
    from vistracker_tpu.fit.generator import make_generator as jmake
    from vistracker_tpu.fit.generator import sifnet_query_fn as jqf
    from vistracker_tpu.models.sifnet import SIFNet as JNet
    from vistracker_tpu_torch.fit.generator import GeneratorConfig as TG
    from vistracker_tpu_torch.fit.generator import make_generator as tmake
    from vistracker_tpu_torch.fit.generator import sifnet_query_fn as tqf
    kw = dict(num_steps=5, num_rounds=2, samples_per_round=512,
              num_points=64, filter_val=10.0, funnel=None,
              center_agg="median")
    jnet, params, tnet = _nets("tiny")
    img = rng.rand(B, S, S, 8).astype(np.float32)
    cc = (rng.rand(B, 2) * 16 + 40).astype(np.float32)
    bc = (rng.randn(B, 3) * 0.05 + [0, 0, 2.2]).astype(np.float32)
    cj = jnet.apply(params, jnp.asarray(img), method=JNet.encode)
    ref = jmake(jqf(jnet), JG(**kw))(params, cj, jnp.asarray(cc),
                                     jnp.asarray(bc), jax.random.PRNGKey(0))
    out = tmake(tqf(tnet), TG(**kw))(
        tnet.encode(torch.from_numpy(img)), torch.from_numpy(cc),
        torch.from_numpy(bc), _ScanDraws(0, num_rounds=2))
    return ({k: np.asarray(v) for k, v in ref["object"].items()},
            {k: v.numpy() for k, v in out["object"].items()})


def test_stage4_then_stage5_match_jax_with_a_third_occluded(rng,
                                                            monkeypatch):
    jobj, tobj = _stage4(rng)
    # stage 4: the outputs the diagnostics read
    assert np.asarray(jobj["valid"]).any(1).all()
    np.testing.assert_allclose(tobj["centers"], jobj["centers"],
                               atol=CENTER_M)
    np.testing.assert_allclose(tobj["visibility"], jobj["visibility"],
                               atol=VIS)
    box = np.diag([0.3, 0.2, 0.1]).astype(np.float32)  # template PCA axes
    jinit = np.asarray(j_joint.init_object_orientation(
        jnp.asarray(jobj["pca_axis"]), jnp.broadcast_to(box, (B, 3, 3))))
    tinit = t_joint.init_object_orientation(
        torch.from_numpy(tobj["pca_axis"]),
        torch.from_numpy(box).expand(B, 3, 3)).numpy()
    assert _angles_deg(tinit, jinit).max() <= DEG

    # stage 5 over T frames: frame t carries harvest t % B turned by a
    # slow drift, and each package runs on its own stage-4 axes
    drift = Rotation.from_rotvec(
        np.outer(np.arange(T), [0.01, 0.02, -0.015])).as_matrix()

    def neural_pca(pca):
        return (drift @ np.asarray(pca)[np.arange(T) % B]).astype(np.float32)

    occ = np.full(T, 0.8, np.float32)
    occ[OCCLUDED] = 0.2
    assert (occ < 0.5).mean() >= 0.25
    poses = (rng.randn(T, 72) * 0.2).astype(np.float32)
    trans = (rng.randn(T, 3) * 0.1).astype(np.float32)
    sn_params, sn, sn_kw = _smoothnet_pair(rng, False)
    monkeypatch.setattr(
        j_smoothing, "SmoothNet",
        lambda window_size, output_size: j_smoothnet.SmoothNet(**sn_kw))
    jm, jcfg, inf_params, tm, tcfg = _conditional_pair(rng)

    jrot = np.asarray(j_joint.init_object_orientation(
        jnp.asarray(neural_pca(jobj["pca_axis"])),
        jnp.broadcast_to(box, (T, 3, 3)))).transpose(0, 2, 1)
    jrot = j_smoothing.smooth_objrot(sn_params, jrot, window=8) \
        .transpose(0, 2, 1)
    jfill = j_infill.make_infiller(jm, jcfg)(inf_params, poses, trans, jrot,
                                             occ)
    with torch.no_grad():
        trot = t_joint.init_object_orientation(
            torch.from_numpy(neural_pca(tobj["pca_axis"])),
            torch.from_numpy(box).expand(T, 3, 3)).numpy().transpose(0, 2, 1)
    trot = t_smoothing.smooth_objrot(sn, trot, window=8).transpose(0, 2, 1)
    tfill = t_infill.make_infiller(tm, tcfg)(poses, trans, trot, occ)

    assert jfill is not None and tfill is not None   # the gate let it run
    assert _angles_deg(trot, jrot).max() <= DEG
    err = _angles_deg(tfill, jfill)
    print(f"infilled rotations, port vs JAX: max {err.max():.2e} degrees "
          f"({err[OCCLUDED].max():.2e} on the occluded frames)")
    assert err.max() <= DEG
    # the infill moved the occluded frames away from their smoothed init
    assert _angles_deg(jfill, jrot)[OCCLUDED].min() > 1.0


@pytest.mark.parametrize("visible", [29, 30])
def test_stage5_seed_gate_matches_jax(rng, visible):
    """The seed gate on the same occlusion stretches: with one visible
    frame too few in the first clip both packages pass the rotations
    through (None), with exactly enough both infill."""
    jm, jcfg, params, tm, tcfg = _conditional_pair(rng)
    poses = (rng.randn(T, 72) * 0.2).astype(np.float32)
    trans = (rng.randn(T, 3) * 0.1).astype(np.float32)
    rots = Rotation.from_rotvec(rng.randn(T, 3) * 0.3).as_matrix() \
        .astype(np.float32)
    occ = np.full(T, 0.2, np.float32)
    occ[:visible] = 0.8
    want = j_infill.make_infiller(jm, jcfg)(params, poses, trans, rots, occ)
    got = t_infill.make_infiller(tm, tcfg)(poses, trans, rots, occ)
    assert (want is None) == (got is None) == (visible < 30)
    if got is not None:
        assert _angles_deg(got, want).max() <= DEG
