"""The port's nearest-neighbour and chamfer distances (ops/chamfer.py; on
the CPU the plain version of kernel K4) against the JAX package: the
Pallas kernel nn_min_sqdist_pallas in interpret mode, the XLA path of
ops/chamfer.py, and a float64 brute force."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vistracker_tpu.ops import chamfer as jax_chamfer
from vistracker_tpu.ops.pallas_nn import chamfer_pallas, nn_min_sqdist_pallas
from vistracker_tpu_torch.ops import chamfer
from vistracker_tpu_torch.ops.chamfer import (nn_min_sqdist_fwd,
                                              nn_min_sqdist_plain)

torch.set_num_threads(1)

# Squared distances of unit-scale clouds (coordinates in [-1, 1)):
# |x|^2 + |y|^2 - 2 x.y cancels values up to 6 in float32, whose ulp is
# 4.8e-7, and the packages round it in different orders (the JAX matmul
# against the port's fixed order), so they agree to a few ulp of 6.
SQ_TOL = 2e-6
# chamfer means and eval errors: relative
REL = 1e-4


def _cloud(rng, *shape):
    return (rng.rand(*shape) * 2.0 - 1.0).astype(np.float32)


def _brute(x, y, valid):
    d = ((x[:, :, None].astype(np.float64) - y[:, None]) ** 2).sum(-1)
    return np.where(valid[:, None], d, 1e10)


@pytest.mark.parametrize("N, M, masked", [(300, 257, False), (300, 257, True),
                                          (1100, 400, True)])
def test_plain_matches_pallas_and_bruteforce(rng, N, M, masked):
    """N = 1100 crosses the plain version's 1024-row blocks (and the
    Pallas kernel's 1024-row x tiles); M = 257 is no multiple of its
    512-point y tiles."""
    x, y = _cloud(rng, 1, N, 3), _cloud(rng, 1, M, 3)
    valid = rng.rand(1, M) < 0.6 if masked else np.ones((1, M), bool)
    d, idx = nn_min_sqdist_plain(torch.as_tensor(x), torch.as_tensor(y),
                                 torch.as_tensor(valid))
    assert d.dtype == torch.float32 and idx.dtype == torch.int64
    full = _brute(x, y, valid)
    np.testing.assert_allclose(d.numpy(), full.min(-1), rtol=0, atol=SQ_TOL)
    jd = nn_min_sqdist_pallas(jnp.asarray(x[0]), jnp.asarray(y[0]),
                              jnp.asarray(valid[0]) if masked else None,
                              interpret=True)
    np.testing.assert_allclose(d.numpy()[0], np.asarray(jd), rtol=0,
                               atol=SQ_TOL)
    # the argmin wherever the runner-up is clear of the rounding
    srt = np.sort(full, -1)
    clear = srt[..., 1] - srt[..., 0] > 10 * SQ_TOL
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(idx.numpy()[clear], full.argmin(-1)[clear])


def test_all_masked_and_ties(rng):
    """No valid y point: 1e10 and index 0 (the Pallas kernel's value);
    exact ties (duplicated y points) go to the least valid index."""
    x, y0 = _cloud(rng, 2, 50, 3), _cloud(rng, 2, 20, 3)
    none = torch.zeros((2, 20), dtype=torch.bool)
    d, idx = nn_min_sqdist_plain(torch.as_tensor(x), torch.as_tensor(y0), none)
    assert (d == 1e10).all() and (idx == 0).all()
    jd = nn_min_sqdist_pallas(jnp.asarray(x[0]), jnp.asarray(y0[0]),
                              jnp.zeros(20, bool), interpret=True)
    np.testing.assert_array_equal(np.asarray(jd), d.numpy()[0])
    y = np.concatenate([y0, y0, y0], 1)
    valid = np.ones((2, 60), bool)
    valid[:, :5] = False
    _, idx = nn_min_sqdist_plain(torch.as_tensor(x), torch.as_tensor(y),
                                 torch.as_tensor(valid))
    np.testing.assert_array_equal(idx.numpy(), _brute(x, y, valid).argmin(-1))
    assert idx.max() < 40


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("sqrt, w1, w2", [(True, 1.0, 1.0),
                                          (False, 0.5, 2.0)])
def test_chamfer_distance_matches_jax(rng, masks, sqrt, w1, w2):
    s1, s2 = _cloud(rng, 3, 200, 3), _cloud(rng, 3, 150, 3)
    m1 = (rng.rand(3, 200) < 0.7) if masks else None
    m2 = (rng.rand(3, 150) < 0.7) if masks else None
    j = jax_chamfer.chamfer_distance(
        jnp.asarray(s1), jnp.asarray(s2),
        None if m1 is None else jnp.asarray(m1),
        None if m2 is None else jnp.asarray(m2), w1=w1, w2=w2, sqrt=sqrt)
    got = chamfer.chamfer_distance(
        torch.as_tensor(s1), torch.as_tensor(s2),
        None if m1 is None else torch.as_tensor(m1),
        None if m2 is None else torch.as_tensor(m2), w1=w1, w2=w2, sqrt=sqrt)
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(j), rtol=REL)
    if not masks and sqrt and w1 == w2 == 1.0:
        jp = chamfer_pallas(jnp.asarray(s1), jnp.asarray(s2), interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(jp), rtol=REL)


def test_nn_helpers_match_jax(rng):
    """nn_distances (unbatched, with and without the index), one_way_sq and
    nearest_index against the JAX functions; chunk only blocks the plain
    version, so every chunk gives the same bits."""
    x, y = _cloud(rng, 2, 130, 3), _cloud(rng, 2, 90, 3)
    m = rng.rand(2, 90) < 0.5
    xt, yt, mt = map(torch.as_tensor, (x, y, m))
    d = chamfer.nn_distances(xt[0], yt[0], mt[0])
    jd = jax_chamfer.nn_distances(jnp.asarray(x[0]), jnp.asarray(y[0]),
                                  jnp.asarray(m[0]))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=SQ_TOL)
    d2, i2 = chamfer.nn_distances(xt[0], yt[0], mt[0], chunk=7,
                                  with_idx=True)
    assert torch.equal(d2, d)
    full = _brute(x, y, m)
    srt = np.sort(full, -1)
    clear = srt[..., 1] - srt[..., 0] > 10 * SQ_TOL
    np.testing.assert_array_equal(i2.numpy()[clear[0]],
                                  full.argmin(-1)[0][clear[0]])
    ow = chamfer.one_way_sq(xt, yt)
    jow = jax_chamfer.one_way_sq(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(ow.numpy(), np.asarray(jow), rtol=0,
                               atol=SQ_TOL)
    nd, ni = chamfer.nearest_index(xt, yt, mt)
    jnd, jni = jax_chamfer.nearest_index(jnp.asarray(x), jnp.asarray(y),
                                         jnp.asarray(m))
    np.testing.assert_allclose(nd.numpy(), np.asarray(jnd), rtol=0,
                               atol=SQ_TOL)
    np.testing.assert_array_equal(ni.numpy()[clear], np.asarray(jni)[clear])


def test_label_compatible_nn_is_k3(rng):
    """The labelled variant is re-exported from ops/label_nn.py (batched)
    and agrees with the JAX function on one cloud."""
    x, y = _cloud(rng, 1, 80, 3), _cloud(rng, 1, 60, 3)
    lx, ly = rng.randint(0, 3, (1, 80)), rng.randint(0, 3, (1, 60))
    v = rng.rand(1, 60) < 0.8
    got = chamfer.label_compatible_nn(*map(torch.as_tensor, (x, lx, y, ly, v)))
    want = jax_chamfer.label_compatible_nn(
        *map(jnp.asarray, (x[0], lx[0], y[0], ly[0], v[0])))
    np.testing.assert_allclose(got.numpy()[0], np.asarray(want), rtol=0,
                               atol=SQ_TOL)


def test_chamfer_at_camera_distance_against_float64(rng):
    """The evaluation's clouds sit about 2.3 m from the origin (camera
    frame), where the float32 expansion |x|^2 + |y|^2 - 2 x.y loses the
    low bits of mm-scale distances; the reference computed the chamfer
    with a float64 k-d tree. The port (as the JAX package) stays within
    1e-3 of the float64 chamfer of the same samples."""
    a = _cloud(rng, 1, 2000, 3) * [0.2, 0.1, 0.05] + [0.2, 0.0, 2.3]
    b = a + rng.randn(1, 2000, 3) * 0.003
    a, b = a.astype(np.float32), b.astype(np.float32)
    got = float(chamfer.chamfer_distance(torch.as_tensor(a),
                                         torch.as_tensor(b))[0])
    full = np.sqrt(((a[0, :, None].astype(np.float64) - b[0, None]) ** 2)
                   .sum(-1))
    exact = full.min(1).mean() + full.min(0).mean()
    np.testing.assert_allclose(got, exact, rtol=1e-3)


@pytest.mark.parametrize("bad", ["dtype", "shape", "valid", "batch"])
def test_wrapper_rejects_bad_inputs(rng, bad):
    x, y = torch.as_tensor(_cloud(rng, 1, 8, 3)), \
        torch.as_tensor(_cloud(rng, 1, 6, 3))
    v = torch.ones((1, 6), dtype=torch.bool)
    if bad == "dtype":
        x = x.double()
    elif bad == "shape":
        y = y[0]
    elif bad == "valid":
        v = v.long()
    else:
        x, y, v = (t.expand(65536, *t.shape[1:]) for t in (x, y, v))
    with pytest.raises((TypeError, ValueError)):
        nn_min_sqdist_fwd(x, y, v)


@pytest.mark.cuda
def test_kernel_bit_equal_on_the_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x, y = (torch.as_tensor(_cloud(rng, 2, n, 3)).cuda() for n in (700, 500))
    v = torch.as_tensor(rng.rand(2, 500) < 0.5).cuda()
    v[1] = False
    dk, ik = nn_min_sqdist_fwd(x, y, v)
    dp, ip = nn_min_sqdist_plain(x, y, v)
    assert torch.equal(dk, dp) and torch.equal(ik, ip)
