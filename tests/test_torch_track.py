"""The port's `track` against the JAX package's -- the neural-only slice
and the whole pipeline -- stage by stage and end to end, on the
fabricated BEHAVE folder of tests/test_real_track.py, with the same
weights for every network and the JAX generator's random draws
replayed."""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_real_track import (_make_fake_assets, _make_fake_sequence,
                             _make_fake_smplh_pkl)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_FUNNEL = ((256, 128, 2), (128, 64, 2))
# the random tiny net's df field never drops below the release surface
# threshold (0.004), which would leave every mean empty (all zeros); a
# wide threshold keeps surface points so the stage-4 outputs are compared
GEN_KW = dict(num_points=32, filter_val=10.0)


class JaxDraws:
    """Draw source that replays what the JAX generator draws from
    PRNGKey(seed): per target, the box init, then per resampling round the
    categorical, normal and uniform draws, in the JAX key order."""

    def __init__(self, seed, device, funnel=SMALL_FUNNEL):
        self.device = device
        self.keys = []
        for k in jax.random.split(jax.random.PRNGKey(seed)):
            ks = jax.random.split(k, 3 * len(funnel) + 1)
            self.keys += [ks[i] for i in range(3 * (len(funnel) - 1) + 1)]

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


class Recorder:
    """Wraps functions and factories of a package's modules so that every
    call's (args, kwargs, result) is kept under a key."""

    def __init__(self, monkeypatch):
        self.mp, self.calls, self.made = monkeypatch, {}, {}

    def _keep(self, key, fn):
        def call(*a, **k):
            out = fn(*a, **k)
            self.calls.setdefault(key, []).append((a, k, out))
            return out
        call.inner = fn
        return call

    def function(self, mod, name):
        self.mp.setattr(mod, name, self._keep(name, getattr(mod, name)))

    def factory(self, mod, name, adapt=lambda fn: fn):
        """The factory's product is wrapped (after `adapt`) and kept in
        self.made[name]; its .inner is the unrecorded product."""
        orig = getattr(mod, name)

        def make(*a, **k):
            self.made[name] = self._keep(name, adapt(orig(*a, **k)))
            return self.made[name]
        self.mp.setattr(mod, name, make)


def _fixture(tmp_path, rng, T=3):
    seq = str(tmp_path / "Date09_Sub95_boxsmall")
    _make_fake_sequence(seq, rng, T=T)
    assets = str(tmp_path / "assets")
    _make_fake_assets(assets, rng)
    smpl_pkl = str(tmp_path / "SMPLH_male.pkl")
    _make_fake_smplh_pkl(smpl_pkl, rng)
    return seq, assets, smpl_pkl


def _run_jax(tmp_path, seq, assets, smpl_pkl, monkeypatch):
    from vistracker_tpu.cli.main import build_parser
    from vistracker_tpu.cli.real_track import run_real_track
    from vistracker_tpu.cli.synthetic import box_mesh
    from vistracker_tpu.utils.mesh import save_ply
    import functools
    import vistracker_tpu.fit.generator as gen_mod
    import vistracker_tpu.fit.smplt as smplt_mod

    obj_root = str(tmp_path / "objects")
    os.makedirs(os.path.join(obj_root, "boxsmall"), exist_ok=True)
    bv, bf = box_mesh()
    save_ply(os.path.join(obj_root, "boxsmall", "boxsmall.ply"), bv, bf)
    args = build_parser().parse_args([
        "track", "--seq", seq, "--out", str(tmp_path / "out_jax"),
        "--smpl-model", smpl_pkl, "--assets", assets,
        "--objects-root", obj_root, "--sifnet-ckpt", "random",
        "--infiller-ckpt", "random", "--tiny-nets", "--neural-only",
        "--chunk-size", "2", "--net-size", "32", "--crop-size", "96",
        "--save-name", "neural"])
    orig = smplt_mod.SMPLTFitConfig
    monkeypatch.setattr(smplt_mod, "SMPLTFitConfig",
                        lambda *a, **k: orig(global_iters=1, max_iters=2))
    monkeypatch.setattr(gen_mod, "GeneratorConfig", functools.partial(
        gen_mod.GeneratorConfig, **GEN_KW))
    monkeypatch.setattr(gen_mod, "FUNNEL_DEFAULT", SMALL_FUNNEL)
    return run_real_track(args)


def _jax_sifnet_state_dict(path):
    """The tiny SIF-Net the JAX run initializes from PRNGKey(0), saved as
    a reference-layout torch checkpoint for the port."""
    from vistracker_tpu.core.camera import PerspectiveCamera
    from vistracker_tpu.models.sifnet import SIFNet, sifnet_preset
    from vistracker_tpu_torch.models.sifnet import sifnet_preset as tp
    from vistracker_tpu_torch.models.weights import \
        sifnet_state_dict_from_flax

    net = SIFNet(sifnet_preset("tiny", crop_size=96),
                 PerspectiveCamera(crop_size=96))
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 8)),
                      jnp.zeros((1, 8, 3)), jnp.zeros((1, 2)),
                      jnp.zeros((1, 3)))
    sd = sifnet_state_dict_from_flax(jax.tree.map(np.asarray, params),
                                     tp("tiny", crop_size=96))
    torch.save({"model_state_dict": {"module." + k: v
                                     for k, v in sd.items()}}, path)


def test_neural_only_track_matches_jax(tmp_path, rng, monkeypatch):
    from vistracker_tpu.core.smpl import load_smpl_pkl, lbs_forward
    from vistracker_tpu.core.landmarks import load_landmarks
    from vistracker_tpu.data.packed import load_packed as load_jax
    from vistracker_tpu.ops.rasterizer import \
        render_triplane_masks_batch as render_jax
    import vistracker_tpu_torch.fit.generator as tgen
    import vistracker_tpu_torch.fit.smplt as tsmplt
    from vistracker_tpu_torch.cli.main import build_parser
    from vistracker_tpu_torch.cli.real_track import run_real_track
    from vistracker_tpu_torch.data.packed import load_packed
    from vistracker_tpu_torch.ops.rasterizer import \
        render_triplane_masks_batch

    seq, assets, smpl_pkl = _fixture(tmp_path, rng)
    ref = load_jax(_run_jax(tmp_path, seq, assets, smpl_pkl, monkeypatch))

    ck = str(tmp_path / "sifnet_tiny.tar")
    _jax_sifnet_state_dict(ck)
    orig = tsmplt.SMPLTFitConfig
    monkeypatch.setattr(tsmplt, "SMPLTFitConfig",
                        lambda *a, **k: orig(global_iters=1, max_iters=2))
    import functools
    monkeypatch.setattr(tgen, "GeneratorConfig", functools.partial(
        tgen.GeneratorConfig, **GEN_KW))
    monkeypatch.setattr(tgen, "FUNNEL_DEFAULT", SMALL_FUNNEL)
    monkeypatch.setattr(tgen, "TorchDraws", JaxDraws)
    args = build_parser().parse_args([
        "track", "--seq", seq, "--out", str(tmp_path / "out_torch"),
        "--smpl-model", smpl_pkl, "--assets", assets, "--sifnet-ckpt", ck,
        "--tiny-nets", "--neural-only", "--device", "cpu",
        "--chunk-size", "2", "--net-size", "32", "--crop-size", "96",
        "--save-name", "neural"])
    summary = run_real_track(args)
    out = load_packed(summary["packed"])
    assert load_jax(summary["packed"]).keys() == out.keys()  # joblib reads it
    assert set(out) == set(ref)
    assert out["frames"] == ref["frames"] and out["gender"] == ref["gender"]

    # stage 1: 20 Adam steps (10 at lr 0.01, 10 at lr 0.001). Adam's
    # per-step move is ~lr whatever the gradient size, so a rounding
    # difference could move a near-zero-gradient component by O(lr) per
    # step (lr x steps = 0.11); measured differences are ~4e-6, and 1e-4
    # keeps a 25x margin while still catching any real step difference
    for k in ("poses", "betas", "trans"):
        np.testing.assert_allclose(out[k], ref[k], atol=1e-4, err_msg=k)

    # stage 3: bit-equal masks on the same (JAX) vertices; on each
    # package's own stage-1 vertices at most 1% of pixels may flip
    model = load_smpl_pkl(smpl_pkl)
    lm = load_landmarks(assets)

    def verts_of(pack):
        v = lbs_forward(model, jnp.asarray(pack["poses"]),
                        jnp.asarray(pack["betas"]),
                        jnp.asarray(pack["trans"]))[0]
        return v, lm.smpl_center(v)

    v_ref, bc_ref = verts_of(ref)
    m_ref = np.asarray(render_jax(v_ref, jnp.asarray(model.faces), bc_ref,
                                  32))
    for pack, exact in ((ref, True), (out, False)):
        v, bc = verts_of(pack)
        m_out = render_triplane_masks_batch(
            torch.from_numpy(np.asarray(v)), torch.from_numpy(model.faces),
            torch.from_numpy(np.asarray(bc)), 32).numpy()
        flipped = float((m_out != m_ref).mean())
        assert flipped == 0.0 if exact else flipped <= 0.01, flipped

    # stage 4: same weights, same draws, ties broken alike; the inputs
    # differ by the stage-1 rounding above and the nets' fp32 sums by
    # ~1e-6 (measured <= 4e-6), so 1e-4
    for k in ("neural_pca", "neural_trans", "neural_visibility"):
        assert np.abs(ref[k]).max() > 0.01, k  # surface points were kept
        np.testing.assert_allclose(out[k], ref[k], atol=1e-4, err_msg=k)


def test_memory_reader_serves_the_folder(tmp_path, rng):
    """MemoryFrameReader over a folder's arrays answers every reader call
    of the slice exactly as FrameDataReader does on the folder."""
    from vistracker_tpu_torch.data.behave import (FrameDataReader,
                                                  MemoryFrameReader)
    seq, _, _ = _fixture(tmp_path, rng)
    disk = FrameDataReader(seq)
    T = len(disk)
    mem = MemoryFrameReader(
        disk.seq_name, disk.seq_info.info,
        np.stack([disk.get_color(i, 1) for i in range(T)]),
        np.stack([disk.get_mask(i, 1, "person") for i in range(T)]),
        np.stack([disk.get_mask(i, 1, "obj") for i in range(T)]),
        np.stack([disk.get_body_kpts(i, 1, tol=0.0) for i in range(T)]),
        np.stack([disk.get_mocap_params(i, 1)[0] for i in range(T)]),
        np.stack([disk.get_mocap_params(i, 1)[1] for i in range(T)]))
    assert mem.frames == disk.frames and len(mem) == T == 3
    assert mem.cvt_end(None) == disk.cvt_end(None) and mem.cvt_end(2) == 2
    assert mem.seq_info.get_gender() == disk.seq_info.get_gender()
    for i in range(T):
        np.testing.assert_array_equal(mem.get_color(i, 1),
                                      disk.get_color(i, 1))
        for cat in ("person", "obj"):
            np.testing.assert_array_equal(mem.get_mask(i, 1, cat),
                                          disk.get_mask(i, 1, cat))
        np.testing.assert_array_equal(mem.get_body_kpts(i, 1, tol=0.5),
                                      disk.get_body_kpts(i, 1, tol=0.5))
        for a, b in zip(mem.get_mocap_params(i, 1),
                        disk.get_mocap_params(i, 1)):
            np.testing.assert_array_equal(a, b)


def test_import_leaves_jax_out():
    """The port imports no JAX: checked in a fresh interpreter, since this
    test process has JAX loaded already."""
    code = ("import sys, vistracker_tpu_torch, vistracker_tpu_torch.cli.main,"
            " vistracker_tpu_torch.cli.real_track,"
            " vistracker_tpu_torch.ops.coverage,"
            " vistracker_tpu_torch.models.weights,"
            " vistracker_tpu_torch.fit.generator,"
            " vistracker_tpu_torch.data.images,"
            " vistracker_tpu_torch.data.behave,"
            " vistracker_tpu_torch.data.silprep,"
            " vistracker_tpu_torch.utils.mesh,"
            " vistracker_tpu_torch.utils.cuda_build,"
            " vistracker_tpu_torch.ops.label_nn,"
            " vistracker_tpu_torch.ops.sdf_grid,"
            " vistracker_tpu_torch.ops.window_ops,"
            " vistracker_tpu_torch.models.smoothnet,"
            " vistracker_tpu_torch.models.transformer,"
            " vistracker_tpu_torch.models.infiller,"
            " vistracker_tpu_torch.fit.smoothing,"
            " vistracker_tpu_torch.fit.infill,"
            " vistracker_tpu_torch.fit.joint,"
            " vistracker_tpu_torch.fit.interpolate,"
            " vistracker_tpu_torch.ops.chamfer,"
            " vistracker_tpu_torch.eval.metrics,"
            " vistracker_tpu_torch.eval.evaluator,"
            " vistracker_tpu_torch.data.packed,"
            " vistracker_tpu_torch.data.imageio,"
            " vistracker_tpu_torch.data.fixture,"
            " vistracker_tpu_torch.render.viz,"
            " vistracker_tpu_torch.cli.synthetic,"
            " vistracker_tpu_torch.config,"
            " vistracker_tpu_torch.native.pointmesh,"
            " vistracker_tpu_torch.data.sampling,"
            " vistracker_tpu_torch.data.offline,"
            " vistracker_tpu_torch.data.datasets,"
            " vistracker_tpu_torch.fit.train,"
            " vistracker_tpu_torch.fit.trainer_loop,"
            " vistracker_tpu_torch.ops.marching,"
            " vistracker_tpu_torch.data.gif,"
            " vistracker_tpu_torch.models.hourglass, chip_smoke;"
            " bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'flax', 'optax', 'orbax', 'vistracker_tpu', 'PIL',"
            " 'joblib', 'cv2')];"
            " print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("extra, needle", [
    (["--neural-only", "--shard-frames"], "multi-device"),
    (["--shard-frames", "--objects-root", "x", "--infiller-ckpt", "random"],
     "multi-device"),
])
def test_cli_refuses_unported_paths(tmp_path, extra, needle):
    from vistracker_tpu_torch.cli.main import main
    with pytest.raises(SystemExit) as e:
        main(["track", "--seq", str(tmp_path), "--smpl-model", "x",
              "--sifnet-ckpt", "random", "--device", "cpu", *extra])
    assert "ROADMAP.md" in str(e.value) and needle in str(e.value)


@pytest.mark.parametrize("missing", ["--objects-root", "--infiller-ckpt"])
def test_cli_names_what_the_whole_track_needs(tmp_path, missing):
    from vistracker_tpu_torch.cli.main import main
    have = {"--objects-root": "x", "--infiller-ckpt": "random"}
    del have[missing]
    with pytest.raises(SystemExit, match=missing):
        main(["track", "--seq", str(tmp_path), "--smpl-model", "x",
              "--sifnet-ckpt", "random", "--device", "cpu",
              *[v for kv in have.items() for v in kv]])


@pytest.mark.parametrize("flag", ["--sifnet-ckpt", "--infiller-ckpt",
                                  "--smoothnet-smpl-ckpt",
                                  "--smoothnet-objrot-ckpt"])
def test_orbax_dir_refused(tmp_path, flag):
    from vistracker_tpu_torch.cli.main import main
    ck = tmp_path / "orbax_exp"
    ck.mkdir()
    cks = {"--sifnet-ckpt": "random", "--infiller-ckpt": "random"}
    cks[flag] = str(ck)
    with pytest.raises(SystemExit, match="orbax"):
        main(["track", "--seq", str(tmp_path), "--smpl-model", "x",
              "--objects-root", "x", "--device", "cpu",
              *[v for kv in cks.items() for v in kv]])


def test_cli_flags_match_the_jax_track():
    """The port's `track` has the JAX package's flags with the same
    defaults, `--synthetic` and its sizes included. The differences:
    --device is the port's own, standing in for the JAX --cpu, and
    --sil-backend is not carried over (one silhouette path here)."""
    from vistracker_tpu.cli.main import build_parser as jax_parser
    from vistracker_tpu_torch.cli.main import build_parser

    def track_defaults(parser):
        sub = next(a for a in parser._actions
                   if isinstance(a, __import__("argparse")._SubParsersAction))
        return {a.dest: a.default for a in sub.choices["track"]._actions}

    port, ref = track_defaults(build_parser()), track_defaults(jax_parser())
    assert set(port) - set(ref) == {"device"}
    assert set(ref) - set(port) == {"cpu", "sil_backend"}
    for k, v in port.items():
        if k != "device":
            assert ref[k] == v, k
    for k in ("synthetic", "frames", "verts", "image_size", "eval_window",
              "render", "objects_root", "infiller_ckpt", "smoothnet_smpl_ckpt",
              "smoothnet_objrot_ckpt", "early_stop", "ocent",
              "smpl_query_points", "segment_iters", "collision", "sdf_res"):
        assert k in port


def test_cuda_default_raises_without_gpu(tmp_path, monkeypatch):
    """No silent CPU fallback: the default device is cuda, and without a
    GPU the entry point raises."""
    from vistracker_tpu_torch.cli.real_track import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


# ---------------------------------------------------------------------------
# the whole `track`
# ---------------------------------------------------------------------------

T_FULL, CHUNK = 32, 16
SHORT_JOINT = dict(smpl_max_iter=1, iter_obj=1, iter_sil=1, joint_max_iter=1,
                   sil_size=32, sil_sigma=2.0 / 32)
FULL_FLAGS = ["--tiny-nets", "--chunk-size", str(CHUNK), "--net-size", "32",
              "--crop-size", "96", "--save-name", "full"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _carried_checkpoints(tmp_path):
    """The networks the JAX run initializes for "random" checkpoints
    (same PRNG keys and shapes as its run_real_track), saved as
    reference-layout torch checkpoints for the port."""
    from vistracker_tpu.models.infiller import (ConditionalMInfiller,
                                                InfillerConfig)
    from vistracker_tpu.models.smoothnet import SmoothNet, SmoothNetSMPL
    from vistracker_tpu_torch.models.weights import (
        infiller_state_dict_from_flax, smoothnet_state_dict_from_flax)

    cks = {k: str(tmp_path / f"{k}.tar")
           for k in ("sifnet", "infiller", "sn_smpl", "sn_rot")}
    _jax_sifnet_state_dict(cks["sifnet"])
    cfg = InfillerConfig()
    L = cfg.clip_len
    inf = ConditionalMInfiller(cfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, L, 147)),
        jnp.zeros((1, L), bool), jnp.zeros((1, L, 6)),
        jnp.zeros((1, L), bool))
    torch.save({"model_state_dict": infiller_state_dict_from_flax(_np(inf))},
               cks["infiller"])
    for key, cls, smpl in (("sn_smpl", SmoothNetSMPL, True),
                           ("sn_rot", SmoothNet, False)):
        params = cls(window_size=64, output_size=64).init(
            jax.random.PRNGKey(7), jnp.zeros((1, 157 if smpl else 6, 64)))
        torch.save({"epoch": 20, "state_dict": smoothnet_state_dict_from_flax(
            _np(params), smpl=smpl)}, cks[key])
    return cks


def _few_occluded(run, thr_box):
    """The untrained net's visibility sits near the infiller's 0.5
    threshold. The first run (JAX) places the threshold between its 2nd
    and 3rd lowest visibility and the second (port) reuses it, so both
    see the same 2 occluded frames, 30 visible ones pass the seed gate
    and HVOP-Net really infills."""
    def call(*args):
        occ = np.sort(np.asarray(args[-1]).reshape(-1))
        thr_box.setdefault("thr", float(occ[1] + occ[2]) / 2)
        return run(*args, occ_thres=thr_box["thr"],
                   init_thres=thr_box["thr"])
    return call


def _run_whole_track(tmp_path, rng, monkeypatch):
    """Both packages' whole `track` on one fabricated 32-frame sequence;
    returns (jax packed, jax recorder, port packed, port recorder,
    paths and the port's summary)."""
    import vistracker_tpu.fit.generator as jgen
    import vistracker_tpu.fit.infill as jinfill
    import vistracker_tpu.fit.joint as jjoint
    import vistracker_tpu.fit.smoothing as jsmooth
    import vistracker_tpu.fit.smplt as jsmplt
    import vistracker_tpu.ops.rasterizer as jrast
    import vistracker_tpu_torch.ops.rasterizer as trast
    import vistracker_tpu_torch.fit.generator as tgen
    import vistracker_tpu_torch.fit.infill as tinfill
    import vistracker_tpu_torch.fit.joint as tjoint
    import vistracker_tpu_torch.fit.smoothing as tsmooth
    import vistracker_tpu_torch.fit.smplt as tsmplt
    from vistracker_tpu.cli.main import build_parser as jax_parser
    from vistracker_tpu.cli.real_track import run_real_track as jax_track
    from vistracker_tpu.cli.synthetic import box_mesh
    from vistracker_tpu.data.packed import load_packed as load_jax
    from vistracker_tpu.utils.mesh import save_ply
    from vistracker_tpu_torch.cli.main import build_parser
    from vistracker_tpu_torch.cli.real_track import run_real_track
    from vistracker_tpu_torch.data.packed import load_packed

    seq, assets, smpl_pkl = _fixture(tmp_path, rng, T=T_FULL)
    obj_root = str(tmp_path / "objects")
    os.makedirs(os.path.join(obj_root, "boxsmall"), exist_ok=True)
    save_ply(os.path.join(obj_root, "boxsmall", "boxsmall.ply"), *box_mesh())
    common = ["track", "--seq", seq, "--smpl-model", smpl_pkl, "--assets",
              assets, "--objects-root", obj_root, *FULL_FLAGS]
    thr_box = {}
    recs = []
    for mods in ((jgen, jinfill, jjoint, jsmooth, jsmplt, jrast),
                 (tgen, tinfill, tjoint, tsmooth, tsmplt, trast)):
        gen, infill, joint, smooth, smplt, rast = mods
        monkeypatch.setattr(
            smplt, "SMPLTFitConfig", lambda *a, _o=smplt.SMPLTFitConfig,
            **k: _o(global_iters=1, max_iters=2))
        monkeypatch.setattr(gen, "GeneratorConfig", functools.partial(
            gen.GeneratorConfig, **GEN_KW))
        monkeypatch.setattr(gen, "FUNNEL_DEFAULT", SMALL_FUNNEL)
        monkeypatch.setattr(joint, "JointFitConfig", functools.partial(
            joint.JointFitConfig, **SHORT_JOINT))
        rec = Recorder(monkeypatch)
        rec.function(smooth, "smooth_smplt")
        rec.function(smooth, "smooth_objrot")
        rec.function(smplt, "fit_smplt")
        rec.function(rast, "render_triplane_masks_batch")
        rec.factory(infill, "make_infiller",
                    lambda run: _few_occluded(run, thr_box))
        rec.factory(joint, "make_smpl_optimizer")
        rec.factory(joint, "make_object_optimizer")
        recs.append(rec)
    ref = load_jax(jax_track(jax_parser().parse_args(
        common + ["--out", str(tmp_path / "out_jax"), "--sifnet-ckpt",
                  "random", "--infiller-ckpt", "random",
                  "--smoothnet-smpl-ckpt", "random",
                  "--smoothnet-objrot-ckpt", "random"])))
    cks = _carried_checkpoints(tmp_path)
    monkeypatch.setattr(tgen, "TorchDraws", JaxDraws)
    # the port encodes the JAX run's triplane masks; its own are recorded
    # and compared in test_whole_track_matches_jax
    jtris = iter([o for _, _, o in recs[0].calls[
        "render_triplane_masks_batch"]])
    monkeypatch.setattr(
        trast, "render_triplane_masks_batch",
        lambda *a, _o=trast.render_triplane_masks_batch, **k:
        torch.as_tensor(np.asarray(next(jtris))).to(_o(*a, **k)))
    summary = run_real_track(build_parser().parse_args(
        common + ["--out", str(tmp_path / "out_torch"), "--device", "cpu",
                  "--sifnet-ckpt", cks["sifnet"], "--infiller-ckpt",
                  cks["infiller"], "--smoothnet-smpl-ckpt", cks["sn_smpl"],
                  "--smoothnet-objrot-ckpt", cks["sn_rot"]]))
    out = load_packed(summary["packed"])
    paths = dict(cks, assets=assets, smpl_pkl=smpl_pkl,
                 summary=summary)
    return ref, recs[0], out, recs[1], paths


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _angle(r1, r2):
    """Largest angle in degrees between paired rotations, from the chord
    |R1 - R2|_F = 2 sqrt(2) sin(angle / 2): unlike arccos of the trace it
    keeps its precision near 0."""
    chord = np.linalg.norm(np.asarray(r1, np.float64)
                           - np.asarray(r2, np.float64), axis=(1, 2))
    return np.degrees(2 * np.arcsin(np.clip(chord / np.sqrt(8), 0, 1))).max()


def _fields(p) -> dict:
    return {f.name: np.asarray(getattr(p, f.name))
            for f in dataclasses.fields(p)}


def test_whole_track_matches_jax(tmp_path, rng, monkeypatch):
    import json
    from vistracker_tpu_torch.cli.real_track import _load_net
    from vistracker_tpu_torch.core.landmarks import load_landmarks
    from vistracker_tpu_torch.core.priors import (load_body_prior,
                                                  load_hand_prior)
    from vistracker_tpu_torch.core.smpl import load_smpl_pkl
    from vistracker_tpu_torch.fit import joint as tjoint
    from vistracker_tpu_torch.fit import smoothing as tsmooth
    from vistracker_tpu_torch.fit import smplt as tsmplt
    from vistracker_tpu_torch.models.smoothnet import SmoothNet, SmoothNetSMPL
    from vistracker_tpu_torch.utils.mesh import compute_pca_axes

    ref, jrec, out, trec, paths = _run_whole_track(tmp_path, rng, monkeypatch)
    jc, tc, summary = jrec.calls, trec.calls, paths["summary"]
    assert set(out) == set(ref) and out["frames"] == ref["frames"]
    assert summary["stage5_infilled"] and summary["chunk_size"] == CHUNK
    assert summary["iters_smpl_mean"] == 3 and summary["iters_joint_mean"] == 1
    with open(summary["packed"].replace(".pkl", "_track.json")) as f:
        assert json.load(f)["frames"] == T_FULL
    # every stage ran the same number of times in both packages
    assert {k: len(v) for k, v in jc.items()} \
        == {k: len(v) for k, v in tc.items()} \
        == dict(render_triplane_masks_batch=4, fit_smplt=4, smooth_smplt=1, make_smpl_optimizer=2,
                smooth_objrot=1, make_infiller=1, make_object_optimizer=2)

    # ---- the one discrete step between the two chains. The stage-2
    # results of the two packages are 1e-4 apart, and a triplane mask
    # (stage 3, 16 x 32 x 32 x 3 values a chunk) can flip a pixel on that
    # (measured: 1 pixel in the second chunk, which alone moved that
    # frame's neural_pca by 3.5e-3 and stage 6a's betas by 9e-4). So the
    # port's run encodes the JAX run's masks (_run_whole_track) and its own
    # masks, recorded here, may differ from them in at most 4 pixels a
    # chunk; everything after is continuous and held tightly below.
    for (_, _, jo), (_, _, to) in zip(jc["render_triplane_masks_batch"],
                                      tc["render_triplane_masks_batch"]):
        assert to.shape == np.asarray(jo).shape
        assert (np.asarray(jo) != to.numpy()).sum() <= 4
    # ---- stage by stage: each port stage on the JAX stage's inputs, 1e-4
    # absolute plus 1e-4 relative (a global rotation near pi has entries
    # of 3); stage 6a's parameters: 2e-4, see there
    # stage 2a: SmoothNet over the whole sequence (windows cross the seam)
    (ja, _, jo), = jc["smooth_smplt"]
    sn = _load_net(SmoothNetSMPL(window_size=64, output_size=64),
                   paths["sn_smpl"], 7, "cpu", True)
    to = tsmooth.smooth_smplt.inner(sn, *ja[1:], window=64)
    for k in ("poses", "betas", "trans"):
        np.testing.assert_allclose(to[k], jo[k], atol=1e-4, err_msg=k)
    # stage 2b: the refit from the JAX smoothed parameters
    model = load_smpl_pkl(paths["smpl_pkl"], "cpu")
    lm = load_landmarks(paths["assets"], "cpu")
    bp = load_body_prior(paths["assets"], "cpu")
    hp = load_hand_prior(paths["assets"], "cpu")
    for ja, jk, jo in jc["fit_smplt"][2:]:
        assert jk == dict(skip_global_phase=True)
        init = tsmplt.SMPLTParams(**{k: _t(v)
                                     for k, v in _fields(ja[5]).items()})
        tp, _ = tsmplt.fit_smplt.inner(model, lm, bp, hp, _t(ja[4]), init,
                                       tsmplt.SMPLTFitConfig(),
                                       skip_global_phase=True)
        for k, v in _fields(jo[0]).items():
            np.testing.assert_allclose(_fields(tp)[k], v, atol=1e-4,
                                       rtol=1e-4, err_msg=k)
    # stage 5: rotation init, SmoothNet, HVOP-Net on the JAX inputs
    (ja, _, jo), = jc["smooth_objrot"]
    temp_v = np.asarray(jc["make_object_optimizer"][0][0][8][0])
    rot_init = tjoint.init_object_orientation(
        _t(ref["neural_pca"]),
        _t(compute_pca_axes(temp_v)).expand(T_FULL, 3, 3)).numpy()
    np.testing.assert_allclose(rot_init.transpose(0, 2, 1), ja[1], atol=1e-4)
    sr = _load_net(SmoothNet(window_size=64, output_size=64),
                   paths["sn_rot"], 7, "cpu", True)
    np.testing.assert_allclose(
        tsmooth.smooth_objrot.inner(sr, ja[1], window=64), jo, atol=1e-4)
    (ja, _, jo), = jc["make_infiller"]
    filled = trec.made["make_infiller"].inner(*ja[1:])
    np.testing.assert_allclose(filled, jo, atol=1e-4)
    assert np.abs(jo - ja[3]).max() > 1e-3   # the net changed the rotations
    # stages 6a and 6b: the port's optimizers, with the port's own feature
    # cache of the chunk, on the JAX stage's other inputs
    for (ja, _, jo), (ta, _, _) in zip(jc["make_smpl_optimizer"],
                                       tc["make_smpl_optimizer"]):
        init = tsmplt.SMPLTParams(**{k: _t(v)
                                     for k, v in _fields(ja[0]).items()})
        tp, tl, tit = trec.made["make_smpl_optimizer"].inner(
            init, _t(ja[1]), ta[2])
        assert tit["smpl"] == int(jo[2]["smpl"])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jo[1]), rtol=1e-4)
        # 2e-4 here (the loss trace above agrees to 1e-4): the two
        # feature caches differ by float32 rounding and 40 Adam steps
        # carry that on; measured 1.4e-4 on a beta, 1.0e-4 on trans
        for k, v in _fields(jo[0]).items():
            np.testing.assert_allclose(_fields(tp)[k], v, atol=2e-4,
                                       err_msg=k)
    for (ja, jk, jo), (ta, _, _) in zip(jc["make_object_optimizer"],
                                        tc["make_object_optimizer"]):
        sil = tjoint.SilRefs(_t(ja[7].image_ref), _t(ja[7].keep_mask),
                             _t(ja[7].roi_xyb))
        args = [_t(a) for a in ja[:5]] + [np.asarray(ja[5]), _t(ja[6]), sil,
                                          _t(ja[8]), _t(ja[9]).long(), ta[10]]
        tr, tt, tl, _ = trec.made["make_object_optimizer"].inner(*args)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jo[2]), rtol=2e-4)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jo[1]), atol=1e-4)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jo[0]), atol=1e-4)

    # ---- end to end, the port's whole chain against the JAX one (same
    # triplane masks, see above). Measured: neural outputs 6e-6, obj_trans
    # 7e-6, obj_angles 0.006 degrees, SMPL parameters 1e-4 to 4.5e-4 (the
    # chain of stages 1, 2 and 6a: 20 + 20 + 40 Adam steps, whose moves
    # are ~lr whatever the gradient's size). The bounds sit far below
    # steps x lr (0.2 rad = 11 degrees, 0.2 m).
    diffs = {k: float(np.abs(np.asarray(out[k], np.float64)
                             - np.asarray(ref[k], np.float64)).max())
             for k in ("neural_pca", "neural_trans", "neural_visibility",
                       "poses", "betas", "trans", "obj_trans")}
    diffs["obj_angles_deg"] = float(_angle(out["obj_angles"],
                                           ref["obj_angles"]))
    print("whole track, port vs JAX max |diff|:", diffs)
    limits = dict(neural_pca=1e-4, neural_trans=1e-4, neural_visibility=1e-4,
                  poses=1e-3, betas=1e-3, trans=1e-3, obj_trans=1e-3,
                  obj_angles_deg=0.1)
    assert not {k: v for k, v in diffs.items() if not v <= limits[k]}, diffs
    for k in ("neural_pca", "neural_trans", "neural_visibility"):
        assert np.abs(ref[k]).max() > 0.01, k
    np.testing.assert_array_equal(out["obj_scales"], np.ones(T_FULL))
    assert np.abs(out["obj_trans"]).max() > 0.1
