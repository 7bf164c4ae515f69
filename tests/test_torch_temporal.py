"""The port's temporal modules (window ops, SmoothNet, the transformer,
the infillers, the smoothing and infill runners) against the JAX
package's, on numpy inputs from a seed and with the flax weights carried
into the port by models/weights.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vistracker_tpu.fit import infill as j_infill
from vistracker_tpu.fit import smoothing as j_smoothing
from vistracker_tpu.models import infiller as j_infiller
from vistracker_tpu.models import smoothnet as j_smoothnet
from vistracker_tpu.models import transformer as j_transformer
from vistracker_tpu.ops import window_ops as j_window
from vistracker_tpu_torch.fit import infill as t_infill
from vistracker_tpu_torch.fit import smoothing as t_smoothing
from vistracker_tpu_torch.models import infiller as t_infiller
from vistracker_tpu_torch.models import smoothnet as t_smoothnet
from vistracker_tpu_torch.models import transformer as t_transformer
from vistracker_tpu_torch.models.weights import (
    infiller_state_dict_from_flax, init_random_,
    smoothnet_state_dict_from_flax)
from vistracker_tpu_torch.ops import window_ops as t_window

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

TOL = 1e-5  # float32 forward passes of small nets: rounding only


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _randomize(params, rng):
    """Flax init leaves biases and norms at 0 / 1; give every leaf random
    values so that a swapped or dropped leaf shows."""
    return jax.tree.map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)
                              * 0.1 + (1.0 if a.ndim == 1 else 0.0)), params)


@pytest.mark.parametrize("L, window, step", [(10, 4, 1), (11, 4, 3),
                                             (64, 64, 1)])
def test_window_ops_match(rng, L, window, step):
    x = rng.randn(L, 5).astype(np.float32)
    jw = np.asarray(j_window.seq_to_windows(jnp.asarray(x), window, step))
    tw = t_window.seq_to_windows(torch.as_tensor(x), window, step)
    np.testing.assert_array_equal(tw.numpy(), jw)
    w = rng.randn(*jw.shape).astype(np.float32)
    js = np.asarray(j_window.windows_to_seq(jnp.asarray(w), step))
    ts = t_window.windows_to_seq(torch.as_tensor(w), step).numpy()
    np.testing.assert_allclose(ts, js, atol=1e-6)
    assert t_window.windows_to_seq(torch.as_tensor(w), step, 3).shape[0] == 3


def test_pad_to_window_matches(rng):
    x = rng.randn(5, 3).astype(np.float32)
    for window in (4, 9):
        jp, jl = j_window.pad_to_window(x, window)
        tp, tl = t_window.pad_to_window(x, window)
        np.testing.assert_array_equal(tp, jp)
        assert tl == jl


@pytest.mark.parametrize("smpl", [False, True])
def test_smoothnet_matches(rng, smpl):
    W, C = 16, 157 if smpl else 6
    kw = dict(window_size=W, output_size=W, hidden_size=32,
              res_hidden_size=8, num_blocks=2)
    jm = (j_smoothnet.SmoothNetSMPL if smpl else j_smoothnet.SmoothNet)(**kw)
    x = rng.randn(3, C, W).astype(np.float32)
    params = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    tm = (t_smoothnet.SmoothNetSMPL if smpl else t_smoothnet.SmoothNet)(**kw)
    tm.load_state_dict(smoothnet_state_dict_from_flax(_np(params), smpl=smpl))
    tm.eval()
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = tm(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_smoothnet_rejects_wrong_window():
    with pytest.raises(ValueError):
        t_smoothnet.SmoothNet(window_size=8, output_size=8)(torch.zeros(1, 2, 9))


@pytest.mark.parametrize("dim", [8, 7])
def test_sine_embedding_matches(dim):
    np.testing.assert_array_equal(
        t_transformer.sine_position_embedding(12, dim),
        j_transformer.sine_position_embedding(12, dim))


@pytest.mark.parametrize("final_norm, activation", [
    (False, "gelu"), (True, "leaky_relu"), (False, "relu")])
def test_transformer_matches(rng, final_norm, activation):
    kw = dict(num_layers=2, d_model=16, num_heads=2, dim_feedforward=24,
              dropout=0.1, final_norm=final_norm, activation=activation)
    jm = j_transformer.TransformerV2(**kw)
    x = rng.randn(2, 9, 16).astype(np.float32)
    mask = rng.rand(2, 9) < 0.3
    mask[1] = True  # a row with every key masked attends to nothing
    params = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    tm = t_transformer.TransformerV2(**kw).eval()
    sd = {}
    from vistracker_tpu_torch.models.weights import _put_transformer
    _put_transformer(sd, "t", _np(params)["params"])
    tm.load_state_dict({k[len("t."):]: v for k, v in sd.items()})
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(mask)))
    got = tm(torch.as_tensor(x), torch.as_tensor(mask)).detach().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL)


def _small_infiller_cfgs():
    kw = dict(d_model_smpl=16, num_heads_smpl=2, dim_forward_smpl=24,
              d_model_obj=8, num_heads_obj=2, dim_forward_obj=12,
              num_layers_joint=2, dim_forward_joint=24, hidden_dims=(8,),
              clip_len=180, window=30)
    return j_infiller.InfillerConfig(**kw), t_infiller.InfillerConfig(**kw)


def _conditional_pair(rng):
    jcfg, tcfg = _small_infiller_cfgs()
    jm = j_infiller.ConditionalMInfiller(jcfg)
    L = 12
    params = _randomize(jm.init(
        jax.random.PRNGKey(1), jnp.zeros((1, L, 147)), jnp.zeros((1, L), bool),
        jnp.zeros((1, L, 6)), jnp.zeros((1, L), bool)), rng)
    tm = t_infiller.ConditionalMInfiller(tcfg).eval()
    tm.load_state_dict(infiller_state_dict_from_flax(_np(params)))
    return jm, jcfg, params, tm, tcfg


def test_conditional_infiller_matches(rng):
    jm, _, params, tm, _ = _conditional_pair(rng)
    L = 12
    ds = rng.randn(2, L, 147).astype(np.float32)
    do = rng.randn(2, L, 6).astype(np.float32)
    ms = np.zeros((2, L), bool)
    mo = rng.rand(2, L) < 0.4
    want = np.asarray(jm.apply(params, jnp.asarray(ds), jnp.asarray(ms),
                               jnp.asarray(do), jnp.asarray(mo)))
    got = tm(torch.as_tensor(ds), torch.as_tensor(ms), torch.as_tensor(do),
             torch.as_tensor(mo)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_motion_infiller_matches(rng):
    kw = dict(input_dim=153, d_model=16, num_layers=2, num_heads=2,
              dim_forward=24, hidden_dims=(8,))
    jm = j_infiller.MotionInfiller(**kw)
    src = rng.randn(2, 10, 153).astype(np.float32)
    mask = rng.rand(2, 10) < 0.3
    params = _randomize(jm.init(jax.random.PRNGKey(2), jnp.asarray(src),
                                jnp.asarray(mask)), rng)
    tm = t_infiller.MotionInfiller(**kw).eval()
    tm.load_state_dict(infiller_state_dict_from_flax(_np(params)))
    want = np.asarray(jm.apply(params, jnp.asarray(src), jnp.asarray(mask)))
    got = tm(torch.as_tensor(src), torch.as_tensor(mask)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_state_dicts_cover_every_parameter(rng):
    """The converters fill every key of the port's modules (strict load)
    and init_random_ touches every parameter."""
    _, _, _, tm, _ = _conditional_pair(rng)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    init_random_(tm, torch.Generator().manual_seed(3))
    after = tm.state_dict()
    same = [k for k in before if torch.equal(before[k], after[k])]
    assert not same, same
    again = t_infiller.ConditionalMInfiller(tm.cfg)
    init_random_(again, torch.Generator().manual_seed(3))
    for k, v in again.state_dict().items():
        assert torch.equal(v, after[k]), k


def _smoothnet_pair(rng, smpl, W=8):
    kw = dict(window_size=W, output_size=W, hidden_size=16,
              res_hidden_size=4)
    jm = (j_smoothnet.SmoothNetSMPL if smpl else j_smoothnet.SmoothNet)(**kw)
    params = _randomize(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 157 if smpl else 6, W))), rng)
    tm = (t_smoothnet.SmoothNetSMPL if smpl else t_smoothnet.SmoothNet)(**kw)
    tm.load_state_dict(smoothnet_state_dict_from_flax(_np(params), smpl=smpl))
    return params, tm.eval(), kw


@pytest.mark.parametrize("T, dim", [(13, 156), (5, 72)])
def test_smooth_smplt_matches(rng, monkeypatch, T, dim):
    """T = 5 is shorter than the window (padded by repeating the last
    frame). 1e-4: axis-angle <-> rot6d conversions around the net."""
    params, tm, kw = _smoothnet_pair(rng, True)
    monkeypatch.setattr(
        j_smoothing, "SmoothNetSMPL",
        lambda window_size, output_size: j_smoothnet.SmoothNetSMPL(**kw))
    poses = (rng.randn(T, dim) * 0.3).astype(np.float32)
    betas = rng.randn(T, 10).astype(np.float32)
    trans = rng.randn(T, 3).astype(np.float32)
    want = j_smoothing.smooth_smplt(params, poses, betas, trans, window=8)
    got = t_smoothing.smooth_smplt(tm, poses, betas, trans, window=8)
    for k in ("poses", "betas", "trans"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], atol=1e-4)
    assert np.isnan(got["obj_angles"]).all()


def test_smooth_objrot_matches(rng, monkeypatch):
    from scipy.spatial.transform import Rotation
    params, tm, kw = _smoothnet_pair(rng, False)
    monkeypatch.setattr(
        j_smoothing, "SmoothNet",
        lambda window_size, output_size: j_smoothnet.SmoothNet(**kw))
    rots = Rotation.from_rotvec(rng.randn(11, 3)).as_matrix() \
        .astype(np.float32)
    want = j_smoothing.smooth_objrot(params, rots, window=8)
    got = t_smoothing.smooth_objrot(tm, rots, window=8)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_smplh_to_smpl_pose_and_streams_match(rng):
    from scipy.spatial.transform import Rotation
    poses = rng.randn(4, 156).astype(np.float32)
    np.testing.assert_array_equal(t_smoothing.smplh_to_smpl_pose(poses),
                                  j_smoothing.smplh_to_smpl_pose(poses))
    trans = rng.randn(4, 3).astype(np.float32)
    rots = Rotation.from_rotvec(rng.randn(4, 3)).as_matrix() \
        .astype(np.float32)
    for got, want in zip(t_infill.prepare_streams(poses, trans, rots),
                         j_infill.prepare_streams(poses, trans, rots)):
        np.testing.assert_allclose(got, want, atol=1e-6)


# T = 40: seed clip only; 170: seed + the truncated tail; 215: seed, two
# full clips and the tail. 1e-4: up to four chained transformer passes.
@pytest.mark.parametrize("T", [40, 170, 215])
def test_infiller_run_matches(rng, T):
    from scipy.spatial.transform import Rotation
    jm, jcfg, params, tm, tcfg = _conditional_pair(rng)
    poses = (rng.randn(T, 72) * 0.2).astype(np.float32)
    trans = (rng.randn(T, 3) * 0.1).astype(np.float32)
    rots = Rotation.from_rotvec(rng.randn(T, 3)).as_matrix() \
        .astype(np.float32)
    occ = (rng.rand(T) > 0.15).astype(np.float32)
    assert 30 <= occ[:180].sum() < min(T, 180)  # infills, some occluded
    want = j_infill.make_infiller(jm, jcfg)(params, poses, trans, rots, occ)
    got = t_infill.make_infiller(tm, tcfg)(poses, trans, rots, occ)
    assert got.shape == (T, 3, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_infiller_run_passes_through(rng):
    """Fewer than 30 visible frames in the first clip: both return None."""
    jm, jcfg, params, tm, tcfg = _conditional_pair(rng)
    T = 40
    poses = np.zeros((T, 72), np.float32)
    trans = np.zeros((T, 3), np.float32)
    rots = np.broadcast_to(np.eye(3, dtype=np.float32), (T, 3, 3)).copy()
    occ = np.zeros(T, np.float32)
    occ[:29] = 1.0
    assert j_infill.make_infiller(jm, jcfg)(params, poses, trans, rots,
                                            occ) is None
    assert t_infill.make_infiller(tm, tcfg)(poses, trans, rots, occ) is None


def test_motion_infiller_run_matches(rng):
    """The unconditional variant through the same clip schedule."""
    from scipy.spatial.transform import Rotation
    kw = dict(input_dim=153, d_model=16, num_layers=1, num_heads=2,
              dim_forward=24, hidden_dims=(8,))
    jm = j_infiller.MotionInfiller(**kw)
    params = _randomize(jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 6, 153)),
                                jnp.zeros((1, 6), bool)), rng)
    tm = t_infiller.MotionInfiller(**kw).eval()
    tm.load_state_dict(infiller_state_dict_from_flax(_np(params)))
    T = 50
    poses = (rng.randn(T, 72) * 0.2).astype(np.float32)
    trans = (rng.randn(T, 3) * 0.1).astype(np.float32)
    rots = Rotation.from_rotvec(rng.randn(T, 3)).as_matrix() \
        .astype(np.float32)
    occ = (rng.rand(T) > 0.2).astype(np.float32)
    want = j_infill.make_infiller(jm)(params, poses, trans, rots, occ)
    got = t_infill.make_infiller(tm)(poses, trans, rots, occ)
    np.testing.assert_allclose(got, want, atol=1e-4)
