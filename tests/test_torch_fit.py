"""The port's stage-1 SMPL-T fit and stage-4 generator against the JAX
package: fit_smplt at reduced budgets on the toy model of
tests/test_smplt_fit.py, and the generator with the JAX draws replayed
(analytic sphere UDF and a tiny SIF-Net)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_track import JaxDraws


def _toy(rng, B=6, V=96):
    from vistracker_tpu.core import smpl as JS
    from vistracker_tpu.core.landmarks import BodyLandmarks as JL
    from vistracker_tpu.core.priors import HandPrior as JH, \
        MahalanobisPrior as JM
    from vistracker_tpu_torch.core import smpl as TS
    from vistracker_tpu_torch.core.landmarks import BodyLandmarks as TL
    from vistracker_tpu_torch.core.priors import HandPrior as TH, \
        MahalanobisPrior as TM
    reg = rng.rand(25, V).astype(np.float32)
    reg /= reg.sum(1, keepdims=True)
    mean63 = rng.randn(63).astype(np.float32) * 0.05
    prec63 = (np.eye(63) * 0.1).astype(np.float32)
    prec45 = (np.eye(45) * 0.1).astype(np.float32)
    j = (JS.random_smpl_model(0, num_joints=52, num_verts=V),
         JL(body25=jnp.asarray(reg), face=jnp.asarray(reg[:1]),
            hand=jnp.asarray(reg[:1])),
         JM(mean=jnp.asarray(mean63), prec=jnp.asarray(prec63)),
         JH(mean=jnp.zeros(90), lhand_prec=jnp.asarray(prec45),
            rhand_prec=jnp.asarray(prec45)))
    t = torch.from_numpy
    p = (TS.random_smpl_model(0, num_joints=52, num_verts=V),
         TL(body25=t(reg), face=t(reg[:1]), hand=t(reg[:1])),
         TM(mean=t(mean63), prec=t(prec63)),
         TH(mean=torch.zeros(90), lhand_prec=t(prec45),
            rhand_prec=t(prec45)))
    # keypoints from a perturbed pose, with varied confidence
    pose = (rng.randn(B, 156) * 0.2).astype(np.float32)
    pose[:, 66:] = 0.0
    trans = np.tile([0.1, -0.2, 2.2], (B, 1)).astype(np.float32)
    verts = JS.lbs_forward(j[0], jnp.asarray(pose), jnp.zeros((B, 10)),
                           jnp.asarray(trans))[0]
    from vistracker_tpu.fit.smplt import SMPLTFitConfig, project_pixels
    kp = np.asarray(project_pixels(j[1].body_joints(verts),
                                   SMPLTFitConfig()))
    kpts = np.concatenate([kp + rng.randn(B, 25, 2) * 2.0,
                           rng.rand(B, 25, 1)], -1).astype(np.float32)
    init_pose = (pose + rng.randn(B, 156) * 0.1).astype(np.float32)
    init_pose[:, 66:] = 0.0
    betas = np.zeros((B, 10), np.float32)
    betas[:, 0] = 2.2
    init_trans = (trans + rng.randn(B, 3) * 0.05).astype(np.float32)
    return j, p, kpts, (init_pose, betas, init_trans)


@pytest.mark.parametrize("skip_global", [False, True])
def test_fit_smplt_matches_jax(rng, skip_global):
    """20 Adam steps (2 iterations): the loss trace agrees to 1e-5
    relative (float32 losses of O(1e3) summed in another order) and the
    parameters to 1e-4 -- Adam moves each component ~lr per step whatever
    its gradient, so the bound sits far below lr x steps (0.11) while a
    wrong step rule, decay or freeze would exceed it."""
    from vistracker_tpu.fit.smplt import SMPLTFitConfig as JCfg, \
        SMPLTParams as JP, fit_smplt as jfit
    from vistracker_tpu_torch.fit.smplt import SMPLTFitConfig as TCfg, \
        SMPLTParams as TP, fit_smplt as tfit
    j, p, kpts, (pose, betas, trans) = _toy(rng)
    kw = dict(global_iters=1, max_iters=2)
    pj, lj = jfit(*j, jnp.asarray(kpts), JP.from_full(
        jnp.asarray(pose), jnp.asarray(betas), jnp.asarray(trans)),
        JCfg(**kw), skip_global_phase=skip_global)
    pt, lt = tfit(*p, torch.from_numpy(kpts), TP.from_full(
        torch.from_numpy(pose), torch.from_numpy(betas),
        torch.from_numpy(trans)), TCfg(**kw), skip_global_phase=skip_global)
    assert lt.shape == np.asarray(lj).shape
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5)
    for f in ("global_pose", "body_pose", "hand_pose", "top_betas",
              "other_betas", "trans"):
        np.testing.assert_allclose(getattr(pt, f).numpy(),
                                   np.asarray(getattr(pj, f)), atol=1e-4,
                                   err_msg=f)
    # frozen leaves: hand pose never moves; phase 1 keeps body pose
    np.testing.assert_array_equal(pt.hand_pose.numpy(), pose[:, 66:])


def test_fit_helpers_match(rng):
    from vistracker_tpu.fit import smplt as J
    from vistracker_tpu_torch.fit import smplt as T
    bb = rng.rand(5, 2).astype(np.float32) * 1000
    np.testing.assert_array_equal(
        T.init_trans_from_bbox(bb, T.SMPLTFitConfig()),
        J.init_trans_from_bbox(bb, J.SMPLTFitConfig()))
    np.testing.assert_array_equal(T.JOINT_ACCEL_WEIGHTS,
                                  J.JOINT_ACCEL_WEIGHTS)
    pts = (rng.randn(2, 25, 3) + [0, 0, 3]).astype(np.float32)
    np.testing.assert_allclose(
        T.project_pixels(torch.from_numpy(pts), T.SMPLTFitConfig()).numpy(),
        np.asarray(J.project_pixels(jnp.asarray(pts), J.SMPLTFitConfig())),
        atol=2e-4)  # pixels are O(1000): float32 spacing 6e-5


CENTER = np.array([0.1, -0.2, 2.4], np.float32)


def _sphere_fns():
    """Analytic sphere UDF for both packages (tests/test_generator.py),
    with heads that depend on where each point lands."""
    def heads(df, pts, lib):
        B, N = df.shape
        return dict(df=lib.stack([df, df], -1), parts=lib.stack(
            [pts[..., 0]] * 14, -1), pca=lib.stack([pts] * 3, -2),
            centers=pts * 2.0, vis=pts[..., 2:3] * 0.1)

    def jq(params, cache, pts, cc, bc):
        d = jnp.abs(jnp.linalg.norm(pts - jnp.asarray(CENTER), axis=-1) - 0.5)
        return heads(d, pts, jnp)

    def tq(cache, pts, cc, bc):
        d = torch.abs(torch.linalg.norm(pts - torch.from_numpy(CENTER),
                                        dim=-1) - 0.5)
        return heads(d, pts, torch)
    return jq, tq


@pytest.mark.parametrize("funnel, agg", [
    (((512, 256, 4), (256, 128, 3)), "mean"),
    (None, "mean"), (((512, 256, 4), (256, 128, 3)), "median")])
def test_generator_replayed_draws_match(funnel, agg):
    """Funnel and scan harvests, mean and median aggregation: with the JAX
    draws replayed, the aggregates agree to 1e-4 (float32 projection
    steps in another order). On the sphere every surface point projects
    to df ~1e-7, so which of them a top-k keeps is decided by rounding;
    num_points is the whole pool, which makes the check independent of
    that order."""
    from vistracker_tpu.fit.generator import GeneratorConfig as JG, \
        make_generator as jmake
    from vistracker_tpu_torch.fit.generator import GeneratorConfig as TG, \
        make_generator as tmake
    pool = 512 if funnel is None else sum(f[1] for f in funnel)
    kw = dict(num_steps=5, num_rounds=2, samples_per_round=256,
              num_points=pool, noise_sigma=0.05, funnel=funnel,
              center_agg=agg)
    jq, tq = _sphere_fns()
    B = 2
    bc = np.tile(CENTER, (B, 1))
    ref = jmake(jq, JG(**kw))(None, None, jnp.zeros((B, 2)), jnp.asarray(bc),
                              jax.random.PRNGKey(5))
    if funnel is not None:
        draws = JaxDraws(5, "cpu", funnel=funnel)
    else:
        draws = _ScanDraws(5, num_rounds=2)
    out = tmake(tq, TG(**kw))(None, torch.zeros(B, 2), torch.from_numpy(bc),
                              draws)
    for target in ("human", "object"):
        r, o = ref[target], out[target]
        assert np.asarray(r["valid"]).mean() > 0.5
        np.testing.assert_array_equal(o["valid"].numpy().sum(1),
                                      np.asarray(r["valid"]).sum(1))
        for k in ("pca_axis", "centers", "visibility"):
            np.testing.assert_allclose(o[k].numpy(), np.asarray(r[k]),
                                       atol=1e-4, err_msg=f"{target} {k}")


class _ScanDraws(JaxDraws):
    """JAX key order of the scan harvest: per target split(key) ->
    (k_init, k_loop), split(k_loop, R) rounds, split(round, 3) ->
    categorical, normal, uniform."""

    def __init__(self, seed, num_rounds):
        self.device = "cpu"
        self.keys = []
        for k in jax.random.split(jax.random.PRNGKey(seed)):
            k_init, k_loop = jax.random.split(k)
            self.keys.append(k_init)
            for kr in jax.random.split(k_loop, num_rounds):
                self.keys += list(jax.random.split(kr, 3))


def test_generator_on_tiny_sifnet(rng):
    """The generator through the port's tiny SIF-Net (same weights as the
    JAX net, JAX draws replayed, a wide surface threshold so the random
    net yields surface points): object outputs agree to 1e-4."""
    from test_torch_sifnet import _inputs, _nets
    from vistracker_tpu.fit.generator import GeneratorConfig as JG, \
        make_generator as jmake, sifnet_query_fn as jqf
    from vistracker_tpu.models.sifnet import SIFNet as JNet
    from vistracker_tpu_torch.fit.generator import GeneratorConfig as TG, \
        make_generator as tmake, sifnet_query_fn as tqf
    funnel = ((256, 128, 2), (128, 64, 2))
    kw = dict(num_points=32, filter_val=10.0, funnel=funnel)
    jnet, params, tnet = _nets("tiny")
    img, _, cc, bc = _inputs(rng)
    cj = jnet.apply(params, jnp.asarray(img), method=JNet.encode)
    ref = jmake(jqf(jnet), JG(**kw))(params, cj, jnp.asarray(cc),
                                     jnp.asarray(bc), jax.random.PRNGKey(0))
    out = tmake(tqf(tnet), TG(**kw))(
        tnet.encode(torch.from_numpy(img)), torch.from_numpy(cc),
        torch.from_numpy(bc), JaxDraws(0, "cpu", funnel=funnel))
    for k in ("pca_axis", "centers", "visibility"):
        np.testing.assert_allclose(out["object"][k].numpy(),
                                   np.asarray(ref["object"][k]), atol=1e-4,
                                   err_msg=k)


def test_torch_draws_are_device_independent():
    """The default draw source is a seeded CPU generator: the same seed
    gives the same draws wherever the results go."""
    from vistracker_tpu_torch.fit.generator import TorchDraws
    a, b = TorchDraws(7, "cpu"), TorchDraws(7, "cpu")
    logits = torch.where(torch.rand(2, 50) > 0.5, 0.0, -1e9)
    for d in (a, b):
        d.out = (d.uniform((2, 5, 3)), d.categorical(logits, 20),
                 d.normal((2, 5)))
    assert all(torch.equal(x, y) for x, y in zip(a.out, b.out))
    assert bool((logits.gather(1, a.out[1]) == 0).all())
