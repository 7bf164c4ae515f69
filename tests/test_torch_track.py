"""The port's neural-only `track` slice against the JAX package's, stage by
stage, on the fabricated BEHAVE folder of tests/test_real_track.py, with
the same SIF-Net weights and the JAX generator's random draws replayed."""
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
            " vistracker_tpu_torch.data.behave;"
            " bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'flax', 'optax', 'vistracker_tpu', 'PIL', 'joblib')];"
            " print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("extra, needle", [
    ([], "--neural-only"),
    (["--neural-only", "--smoothnet-smpl-ckpt", "x"], "stage 2"),
    (["--neural-only", "--shard-frames"], "multi-device"),
])
def test_cli_refuses_unported_paths(tmp_path, extra, needle):
    from vistracker_tpu_torch.cli.main import main
    with pytest.raises(SystemExit) as e:
        main(["track", "--seq", str(tmp_path), "--smpl-model", "x",
              "--sifnet-ckpt", "random", "--device", "cpu", *extra])
    assert "ROADMAP.md" in str(e.value) and (needle in str(e.value)
                                             or needle in " ".join(extra))


def test_orbax_dir_refused(tmp_path):
    from vistracker_tpu_torch.cli.main import main
    ck = tmp_path / "orbax_exp"
    ck.mkdir()
    with pytest.raises(SystemExit, match="orbax"):
        main(["track", "--seq", str(tmp_path), "--smpl-model", "x",
              "--sifnet-ckpt", str(ck), "--neural-only", "--device", "cpu"])


def test_cuda_default_raises_without_gpu(tmp_path, monkeypatch):
    """No silent CPU fallback: the default device is cuda, and without a
    GPU the entry point raises."""
    from vistracker_tpu_torch.cli.real_track import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
