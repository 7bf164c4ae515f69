"""The port's `track --synthetic` (cli/main.py:run_synthetic_track, on
cli/synthetic.py:make_scene) against the JAX package's, at --frames 4 and
the JAX command line's defaults otherwise: the JAX run's networks carried
over (models/weights.py) and its generator's draws replayed. Both runs are
recorded; each port stage is then fed the JAX stage's inputs and held to
it (1e-4, as tests/test_torch_track.py::test_whole_track_matches_jax
does), and the summary's v2v numbers are compared end to end."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_track import Recorder, _angle, _fields, _np, _t

FRAMES = 4


class JaxScanDraws:
    """Replays the JAX generator's scan-mode draws from PRNGKey(seed): per
    target (human, object), the box init from k_init, then per round the
    categorical, normal and uniform draws from split(k_round, 3)."""

    def __init__(self, seed, device, num_rounds=2):
        self.device = device
        self.keys = []
        for k in jax.random.split(jax.random.PRNGKey(seed)):
            k_init, k_loop = jax.random.split(k)
            self.keys.append(k_init)
            for kr in jax.random.split(k_loop, num_rounds):
                self.keys += list(jax.random.split(kr, 3))

    def _next(self):
        return self.keys.pop(0)

    def _t(self, x):
        return torch.as_tensor(np.array(x), device=self.device)

    def uniform(self, shape):
        return self._t(jax.random.uniform(self._next(), tuple(shape)))

    def normal(self, shape):
        return self._t(jax.random.normal(self._next(), tuple(shape)))

    def categorical(self, logits, n):
        lg = jnp.asarray(logits.cpu().numpy())[:, None, :]
        return self._t(jax.random.categorical(
            self._next(), lg, axis=-1, shape=(lg.shape[0], n))).long()


def _carried_weights(args):
    """The networks the JAX run initializes (its PRNG keys and shapes), as
    the port's state dicts."""
    from vistracker_tpu.core.camera import PerspectiveCamera
    from vistracker_tpu.models.infiller import (ConditionalMInfiller,
                                                InfillerConfig)
    from vistracker_tpu.models.sifnet import SIFNet, SIFNetConfig
    from vistracker_tpu.models.smoothnet import SmoothNet, SmoothNetSMPL
    from vistracker_tpu_torch.models import sifnet as tsif
    from vistracker_tpu_torch.models.weights import (
        infiller_state_dict_from_flax, sifnet_state_dict_from_flax,
        smoothnet_state_dict_from_flax)

    T, S = args.frames, args.image_size
    W = min(64, T)
    kw = dict(num_stack=args.sif_stacks, num_hourglass=1, hourglass_dim=32,
              tmpx_dim=32, triplane_stack=args.sif_stacks,
              triplane_hg_dim=32, triplane_tmpx_dim=32, hidden_dim=16)
    sif = SIFNet(SIFNetConfig(**kw), PerspectiveCamera(crop_size=1200)).init(
        jax.random.PRNGKey(2), jnp.zeros((1, S, S, 8)), jnp.zeros((1, 8, 3)),
        jnp.zeros((1, 2)), jnp.zeros((1, 3)))
    icfg = InfillerConfig(clip_len=min(180, max(4, T)),
                          window=max(1, min(30, T // 3)))
    L = icfg.clip_len
    inf = ConditionalMInfiller(icfg).init(
        jax.random.PRNGKey(5), jnp.zeros((1, L, 147)),
        jnp.zeros((1, L), bool), jnp.zeros((1, L, 6)),
        jnp.zeros((1, L), bool))
    return {
        "sifnet": sifnet_state_dict_from_flax(_np(sif),
                                              tsif.SIFNetConfig(**kw)),
        "smoothnet_smpl": smoothnet_state_dict_from_flax(_np(
            SmoothNetSMPL(window_size=W, output_size=W).init(
                jax.random.PRNGKey(1), jnp.zeros((1, 157, W)))), smpl=True),
        "smoothnet_objrot": smoothnet_state_dict_from_flax(_np(
            SmoothNet(window_size=W, output_size=W).init(
                jax.random.PRNGKey(4), jnp.zeros((1, 6, W))))),
        "infiller": infiller_state_dict_from_flax(_np(inf)),
    }


def _record(rec, gen, infill, joint, smooth, smplt, rast, evaluator, viz):
    for mod, name in ((smooth, "smooth_smplt"), (smooth, "smooth_objrot"),
                      (smplt, "fit_smplt"), (rast, "render_triplane_masks_batch"),
                      (evaluator, "eval_sequence"), (viz, "save_video")):
        rec.function(mod, name)
    # the stage-4 input masks; JAX also calls rasterize_mask inside traced
    # code, whose calls are not stage 4's and are not kept
    orig = rast.rasterize_mask

    def rasterize_mask(*a, **k):
        out = orig(*a, **k)
        if not isinstance(out, jax.core.Tracer):
            rec.calls.setdefault("rasterize_mask", []).append((a, k, out))
        return out
    rec.mp.setattr(rast, "rasterize_mask", rasterize_mask)
    for mod, name in ((gen, "make_generator"), (infill, "make_infiller"),
                      (joint, "make_smpl_optimizer"),
                      (joint, "make_object_optimizer")):
        rec.factory(mod, name)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' `track --synthetic --frames 4 --render`, recorded;
    the port's
    run draws what the JAX run drew and rasterizes nothing of its own
    into the network inputs: it encodes the JAX run's masks (its own are
    recorded and compared below), as the whole-track test does."""
    import vistracker_tpu.eval.evaluator as jeval
    import vistracker_tpu.fit.generator as jgen
    import vistracker_tpu.fit.infill as jinfill
    import vistracker_tpu.fit.joint as jjoint
    import vistracker_tpu.fit.smoothing as jsmooth
    import vistracker_tpu.fit.smplt as jsmplt
    import vistracker_tpu.ops.rasterizer as jrast
    import vistracker_tpu.render.viz as jviz
    import vistracker_tpu_torch.eval.evaluator as teval
    import vistracker_tpu_torch.fit.generator as tgen
    import vistracker_tpu_torch.fit.infill as tinfill
    import vistracker_tpu_torch.fit.joint as tjoint
    import vistracker_tpu_torch.fit.smoothing as tsmooth
    import vistracker_tpu_torch.fit.smplt as tsmplt
    import vistracker_tpu_torch.ops.rasterizer as trast
    import vistracker_tpu_torch.render.viz as tviz
    from vistracker_tpu.cli.main import build_parser as jax_parser
    from vistracker_tpu.cli.main import run_synthetic_track as jax_run
    from vistracker_tpu_torch.cli.main import build_parser, run_synthetic_track

    root = tmp_path_factory.mktemp("synthetic")
    with pytest.MonkeyPatch.context() as mp:
        jrec, trec = Recorder(mp), Recorder(mp)
        _record(jrec, jgen, jinfill, jjoint, jsmooth, jsmplt, jrast, jeval,
                jviz)
        jres = jax_run(jax_parser().parse_args(
            ["track", "--synthetic", "--cpu", "--frames", str(FRAMES),
             "--render", "--out", str(root / "jax")]))
        args = build_parser().parse_args(
            ["track", "--synthetic", "--device", "cpu", "--frames",
             str(FRAMES), "--render", "--out", str(root / "port")])
        _record(trec, tgen, tinfill, tjoint, tsmooth, tsmplt, trast, teval,
                tviz)
        for name in ("rasterize_mask", "render_triplane_masks_batch"):
            theirs = iter([o for _, _, o in jrec.calls[name]])
            mp.setattr(trast, name, lambda *a, _o=getattr(trast, name), _j=
                       theirs, **k: torch.as_tensor(np.asarray(next(_j)))
                       .to(_o(*a, **k)))
        # the harvest's top-k is the other discrete step: its own output
        # is recorded (test_stage4_harvest_matches_jax), the JAX one goes on
        (_, _, jpc), = jrec.calls["make_generator"]
        made = tgen.make_generator
        mp.setattr(tgen, "make_generator", lambda *a, **k: (
            lambda *b, _g=made(*a, **k): (_g(*b), {
                t: {n: torch.as_tensor(np.asarray(v)) for n, v in d.items()}
                for t, d in jpc.items()})[1]))
        tres = run_synthetic_track(args, weights=_carried_weights(args),
                                   draws=JaxScanDraws(3, "cpu"))
    return jres, jrec, tres, trec


def test_every_stage_ran_alike(runs):
    jres, jrec, tres, trec = runs
    counts = {k: len(v) for k, v in jrec.calls.items()}
    assert counts == {k: len(v) for k, v in trec.calls.items()}
    assert counts == dict(
        fit_smplt=2, smooth_smplt=1, render_triplane_masks_batch=1,
        rasterize_mask=2 * FRAMES, make_generator=1, smooth_objrot=1,
        make_infiller=1, make_smpl_optimizer=1, make_object_optimizer=1,
        eval_sequence=1, save_video=1)
    assert set(tres) == set(jres)
    assert set(tres["timings"]) == set(jres["timings"])


def test_masks_match_jax(runs):
    """The port's own masks (recorded; the JAX ones were encoded): stage 3
    triplanes through K1's plain version and the crop-space person and
    object masks; at most 2 pixels of a frame may flip on the 1e-5
    differences of the stage-2 fits."""
    jc, tc = runs[1].calls, runs[3].calls
    for name in ("render_triplane_masks_batch", "rasterize_mask"):
        for (_, _, jo), (_, _, to) in zip(jc[name], tc[name]):
            jo = np.asarray(jo)
            assert to.shape == jo.shape and jo.any()
            assert (jo != to.numpy()).sum() <= 2 * (jo.ndim - 1), name


def _jax_cfg(port_cls, jax_cfg):
    return port_cls(**{f.name: getattr(jax_cfg, f.name)
                       for f in dataclasses.fields(port_cls)})


def test_stage1_and_2_match_jax(runs):
    """Stage 1 (SMPL-T fit), stage 2a (SmoothNet) and 2b (the refit), each
    on the JAX stage's inputs: 1e-4 absolute plus 1e-4 relative."""
    from vistracker_tpu_torch.fit import smoothing as tsmooth
    from vistracker_tpu_torch.fit import smplt as tsmplt

    _, jrec, _, trec = runs
    for (ja, jk, jo), (ta, _, _) in zip(jrec.calls["fit_smplt"],
                                        trec.calls["fit_smplt"]):
        init = tsmplt.SMPLTParams(**{k: _t(v)
                                     for k, v in _fields(ja[5]).items()})
        tp, _ = tsmplt.fit_smplt(*ta[:4], _t(ja[4]), init,
                                       _jax_cfg(tsmplt.SMPLTFitConfig, ja[6]),
                                       **jk)
        for k, v in _fields(jo[0]).items():
            np.testing.assert_allclose(_fields(tp)[k], v, atol=1e-4,
                                       rtol=1e-4, err_msg=k)
    (ja, jk, jo), = jrec.calls["smooth_smplt"]
    (ta, _, _), = trec.calls["smooth_smplt"]
    to = tsmooth.smooth_smplt(ta[0], *ja[1:], **jk)
    for k in ("poses", "betas", "trans"):
        np.testing.assert_allclose(to[k], jo[k], atol=1e-4, err_msg=k)


def _kept_share(a, b, tol=1e-4):
    """Share of the rows of a (N, 3) that some row of b matches to tol."""
    d = np.abs(a[:, None, :] - b[None, :, :]).max(-1).min(1)
    return float((d <= tol).mean())


def test_stage4_harvest_matches_jax(runs):
    """The surface harvest on the port's own cache of the same images, the
    JAX stage's crop and body centers and the replayed draws. Its last
    step keeps the 256 lowest-df points of 2,048, many of them clamped or
    a few 1e-6 apart, so float32 rounding swaps some of the kept points
    (a discrete step, as finding (f)'s triplane pixel; ROADMAP finding
    (h)). Held: the same valid counts, at least 80% of each frame's kept
    points equal to 1e-4 (measured 96-100%), and the means over them
    within 3e-3 (measured 1.3e-3); the end-to-end run goes on from the
    JAX harvest."""
    _, jrec, _, trec = runs
    (ja, _, jo), = jrec.calls["make_generator"]
    (ta, _, _), = trec.calls["make_generator"]
    with torch.no_grad():
        got = trec.made["make_generator"].inner(
            ta[0], _t(ja[2]), _t(ja[3]), JaxScanDraws(3, "cpu"))
    shares = []
    for tgt in ("human", "object"):
        np.testing.assert_array_equal(got[tgt]["valid"].numpy().sum(1),
                                      np.asarray(jo[tgt]["valid"]).sum(1))
        gp, jp = got[tgt]["points"].numpy(), np.asarray(jo[tgt]["points"])
        shares += [_kept_share(gp[b], jp[b]) for b in range(len(gp))]
        for k in ("pca_axis", "centers", "visibility"):
            np.testing.assert_allclose(got[tgt][k].numpy(),
                                       np.asarray(jo[tgt][k]), atol=3e-3,
                                       err_msg=f"{tgt} {k}")
        assert np.abs(np.asarray(jo[tgt]["centers"])).max() > 1e-3
    print("stage 4: share of kept points equal per frame:", shares)
    assert min(shares) >= 0.8, shares


def test_stage5_matches_jax(runs):
    """Rotation smoothing and HVOP-Net on the JAX stage's inputs."""
    from vistracker_tpu_torch.fit import smoothing as tsmooth

    _, jrec, _, trec = runs
    (ja, jk, jo), = jrec.calls["smooth_objrot"]
    (ta, _, _), = trec.calls["smooth_objrot"]
    np.testing.assert_allclose(
        tsmooth.smooth_objrot(ta[0], ja[1], **jk), jo, atol=1e-4)
    (ja, jk, jo), = jrec.calls["make_infiller"]
    filled = trec.made["make_infiller"].inner(*ja[1:], **jk)
    if jo is None:
        assert filled is None
    else:
        np.testing.assert_allclose(filled, jo, atol=1e-4)


def test_stage6_matches_jax(runs):
    """The SMPL phase and the object phases (object, silhouette, joint)
    with the port's own feature cache on the JAX stage's other inputs:
    loss traces 1e-4 relative, parameters 1e-4."""
    from vistracker_tpu_torch.fit import joint as tjoint
    from vistracker_tpu_torch.fit import smplt as tsmplt

    _, jrec, _, trec = runs
    (ja, _, jo), = jrec.calls["make_smpl_optimizer"]
    (ta, _, _), = trec.calls["make_smpl_optimizer"]
    init = tsmplt.SMPLTParams(**{k: _t(v) for k, v in _fields(ja[0]).items()})
    # the port's feature cache (same images), the JAX run's centers
    ctx = dict(ta[2], cc=_t(ja[2]["cc"]), bc=_t(ja[2]["bc"]))
    tp, tl = trec.made["make_smpl_optimizer"].inner(init, _t(ja[1]), ctx)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jo[1]), rtol=1e-4)
    for k, v in _fields(jo[0]).items():
        np.testing.assert_allclose(_fields(tp)[k], v, atol=1e-4, err_msg=k)
    (ja, _, jo), = jrec.calls["make_object_optimizer"]
    (ta, _, _), = trec.calls["make_object_optimizer"]
    sil = tjoint.SilRefs(_t(ja[7].image_ref), _t(ja[7].keep_mask),
                         _t(ja[7].roi_xyb))
    ctx = dict(ta[10], cc=_t(ja[10]["cc"]), bc=_t(ja[10]["bc"]))
    args = [_t(a) for a in ja[:5]] + [np.asarray(ja[5]), _t(ja[6]), sil,
                                      _t(ja[8]), _t(ja[9]).long(), ctx]
    tr, tt, tl = trec.made["make_object_optimizer"].inner(*args)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jo[2]), rtol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jo[1]), atol=1e-4)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jo[0]), atol=1e-4)


def test_evaluation_matches_jax(runs):
    """eval_sequence on the JAX run's vertices: v2v and acceleration 1e-4
    relative; chamfers 1e-3 relative (ROADMAP finding (g): the float32
    expansion at camera distance keeps a few bits of a mm)."""
    from vistracker_tpu_torch.eval import evaluator as teval

    _, jrec, _, _ = runs
    (ja, jk, jo), = jrec.calls["eval_sequence"]
    to = teval.eval_sequence(*[np.asarray(a) for a in ja],
                                   device="cpu", **jk)
    np.testing.assert_allclose(to[:, 2:], np.asarray(jo)[:, 2:], rtol=1e-4)
    np.testing.assert_allclose(to[:, :2], np.asarray(jo)[:, :2], rtol=1e-3)


def test_summary_v2v_matches_jax(runs):
    """End to end, the port's whole chain against the JAX one (same masks,
    harvest, weights and draws). The chains part by float32 rounding of
    ~1e-5 after stage 2, which the short stage-6 budgets carry on; the
    stages hold their parameters to 1e-4, and a 1e-4 parameter
    difference moves vertices by ~1e-4 m = 0.01 cm, so 0.05 cm on mean
    v2v values of 15-50 cm allows 5 such steps (measured 0.0015 cm SMPL,
    4e-5 cm object); the final rotations within 0.1 degree (measured
    0.001)."""
    jres, jrec, tres, trec = runs
    d = {k: abs(tres[k] - jres[k]) for k in ("smpl_v2v_cm", "obj_v2v_cm")}
    print("summary v2v, port vs JAX, |diff| in cm:", d, tres, jres)
    (ja, _, jo), = jrec.calls["make_object_optimizer"]
    (ta, _, to), = trec.calls["make_object_optimizer"]
    print("stage 6b inputs/outputs end to end:",
          {i: float(np.abs(np.asarray(ta[i].cpu() if torch.is_tensor(ta[i])
                                      else ta[i], np.float64)
                           - np.asarray(ja[i], np.float64)).max())
           for i in (0, 1, 4, 6)},
          "rot deg", _angle(to[0].numpy(), np.asarray(jo[0])),
          "trans", float(np.abs(to[1].numpy() - np.asarray(jo[1])).max()))
    assert all(np.isfinite([tres["smpl_v2v_cm"], tres["obj_v2v_cm"]]))
    assert max(d.values()) <= 0.05, d
    (_, _, jo), = jrec.calls["make_object_optimizer"]
    (_, _, to), = trec.calls["make_object_optimizer"]
    assert _angle(to[0].numpy(), np.asarray(jo[0])) < 0.1


def test_render_gifs_match_jax(runs):
    """`--render`: both packages write side_by_side.gif, T frames of
    128 x 256, GT | recon. The frames given to save_video: the GT half
    under tests/test_torch_render.py's image tolerance (at most 0.1% of
    pixels apart by more than 1e-5), and so is the port's render of the
    JAX run's own recon meshes against the JAX recon half. The port's
    recon half renders the port's stage-6 result (1e-4 m from JAX's,
    test_stage6_matches_jax), which moves flat shades by up to 1e-4 and
    flips the winning face where the toy mesh's crossing faces lie that
    close: at most 2% of its pixels may be apart by more than 1e-4
    (measured 0.02% in one process, 0.5% in a pytest-xdist worker, whose
    torch runs on one thread). The decoded GIFs have the same size,
    frame count, durations and loop and agree within 2 x the stated mean
    median-cut error."""
    from test_torch_render import GIF_MEAN, _decode, assert_images_agree
    from vistracker_tpu_torch.core.camera import PerspectiveCamera
    from vistracker_tpu_torch.render.viz import render_meshes_perspective
    jres, jrec, tres, trec = runs
    (ja, _, jpath), = jrec.calls["save_video"]
    (ta, _, tpath), = trec.calls["save_video"]
    assert os.path.basename(tpath) == os.path.basename(jpath) \
        == "side_by_side.gif"
    jf, tf = np.asarray(ja[0]), np.asarray(ta[0])
    assert tf.shape == jf.shape == (FRAMES, 128, 256, 3)
    (ea, _, _), = jrec.calls["eval_sequence"]
    (gen_args, _, _), = jrec.calls["make_generator"]
    sverts_rc, overts_rc, smpl_faces, temp_faces = ea[2:6]
    crop_centers = np.asarray(gen_args[2])
    cam = PerspectiveCamera(crop_size=1200)
    for i, (t, j) in enumerate(zip(tf, jf)):
        assert (t[:, :128] > 0).any() and (t[:, 128:] > 0).any()
        assert_images_agree(t[:, :128], j[:, :128])
        assert_images_agree(render_meshes_perspective(
            [(sverts_rc[i], smpl_faces[:256], (0.4, 0.6, 0.9)),
             (overts_rc[i], temp_faces, (0.9, 0.4, 0.4))], cam,
            crop_centers[i], size=128), j[:, 128:])
        assert_images_agree(t[:, 128:], j[:, 128:], tol=1e-4, share=0.02)
    got, want = _decode(tpath), _decode(jpath)
    assert got[1:] == want[1:] and got[0].shape == want[0].shape
    assert np.abs(got[0].astype(int) - want[0].astype(int)).mean() \
        <= 2 * GIF_MEAN


def test_track_needs_synthetic_or_seq():
    from vistracker_tpu_torch.cli.main import main
    with pytest.raises(SystemExit, match="--synthetic or --seq"):
        main(["track", "--device", "cpu"])


@pytest.mark.parametrize("missing", ["--smpl-model", "--sifnet-ckpt"])
def test_seq_track_names_what_it_needs(tmp_path, missing):
    from vistracker_tpu_torch.cli.main import main
    have = {"--smpl-model": "x", "--sifnet-ckpt": "random"}
    del have[missing]
    with pytest.raises(SystemExit, match=missing):
        main(["track", "--seq", str(tmp_path), "--device", "cpu",
              "--objects-root", "x", "--infiller-ckpt", "random",
              *[v for kv in have.items() for v in kv]])
