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


def _merge_in_order(x, y, valid, splits, warps=8):
    """K4's cut and merge written out in PyTorch: y cut into `splits`
    contiguous ranges, each into `warps` slices; each slice's (min, least
    index) by the plain version, (1e10, 0) where it has no valid point, as
    the kernel's warps keep; merged in ascending y order with a strict <."""
    M = y.shape[1]
    best_d = best_j = None
    for s in range(splits):
        lo, hi = M * s // splits, M * (s + 1) // splits
        for w in range(warps):
            a = lo + (hi - lo) * w // warps
            b = lo + (hi - lo) * (w + 1) // warps
            if a == b:
                d = torch.full(x.shape[:2], 1e10)
                j = torch.zeros(x.shape[:2], dtype=torch.int64)
            else:
                d, j = nn_min_sqdist_plain(x, y[:, a:b], valid[:, a:b])
                j = torch.where(d < 1e10, j + a, 0)
            if best_d is None:
                best_d, best_j = d, j
            else:
                take = d < best_d
                best_d = torch.where(take, d, best_d)
                best_j = torch.where(take, j, best_j)
    return best_d, best_j


@pytest.mark.parametrize("copies, splits", [(5, 5), (40, 3), (7, 1)])
def test_split_merge_rule_equals_plain_on_exact_ties(rng, copies, splits):
    """y made of copies of one cloud: every nearest point is tied with its
    copies, far apart in index, in other splits and other warps' slices.
    The kernel's merge rule (ascending y order, strict <) gives the plain
    version's min and least index, also with a mask that leaves a
    slice without a valid point."""
    x = torch.as_tensor(_cloud(rng, 2, 60, 3))
    y = torch.as_tensor(_cloud(rng, 2, 23, 3)).repeat(1, copies, 1)
    for valid in (torch.ones(y.shape[:2], dtype=torch.bool),
                  torch.as_tensor(rng.rand(*y.shape[:2]) < 0.4)):
        d, j = _merge_in_order(x, y, valid, splits)
        d_p, j_p = nn_min_sqdist_plain(x, y, valid)
        assert torch.equal(d, d_p) and torch.equal(j, j_p)
        assert bool((j_p < 23).all()) or not bool(valid.all())


def test_distances_never_negative_zero(rng):
    """d = max((|x|^2 + |y|^2) - 2 x.y, 0) is +0 or positive, never -0, so
    the float bits of d order like its values (the order a packed-key
    merge would need): |v|^2 is a sum of squares (+0 at least), so the
    subtraction's left operand is never -0, and a rounded difference of
    equal values is +0. Coincident points, points whose expansion rounds
    below 0 and exact zeros."""
    x = _cloud(rng, 1, 400, 3) + np.float32(2.2)
    y = np.concatenate([x, x + np.float32(1e-7), np.zeros((1, 5, 3),
                                                          np.float32),
                        -x], 1)
    x = np.concatenate([x, np.zeros((1, 3, 3), np.float32)], 1)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    xx = (xt[..., 0] * xt[..., 0] + xt[..., 1] * xt[..., 1]) \
        + xt[..., 2] * xt[..., 2]
    yy = (yt[..., 0] * yt[..., 0] + yt[..., 1] * yt[..., 1]) \
        + yt[..., 2] * yt[..., 2]
    xy = (xt[:, :, None, 0] * yt[:, None, :, 0]
          + xt[:, :, None, 1] * yt[:, None, :, 1]) \
        + xt[:, :, None, 2] * yt[:, None, :, 2]
    raw = (xx[:, :, None] + yy[:, None, :]) - 2.0 * xy
    assert bool((raw < 0).any()) and bool((raw == 0).any())
    assert not bool(torch.signbit(raw[raw == 0]).any())
    d, _ = nn_min_sqdist_plain(xt, yt, torch.ones(yt.shape[:2], dtype=bool))
    assert bool((d == 0).any()) and not bool(torch.signbit(d).any())


def test_splits_fill_the_card_from_shapes():
    """The kernel's y split (ops/chamfer.py:_splits): at the evaluate shape
    (79 blocks of x on 132 SMs) at least two blocks an SM, each range at
    least 256 points; one range where y is short."""
    s = chamfer._splits(79, 10000, 132)
    assert 79 * s >= 2 * 132 and 10000 // s >= 256
    assert chamfer._splits(79, 100, 132) == 1
    assert chamfer._splits(1, 10000, 132) == 39
    assert chamfer._splits(2000, 10000, 132) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ties across blocks", "ties across warps",
                                  "M under one split", "N = 1", "two runs"])
def test_kernel_edge_cases_on_the_card(rng, case):
    """K4 on the card where its cut of y could go wrong: exact ties between
    y copies in other blocks' ranges and other warps' slices (the least
    index wins), fewer y points than a split, one x point, and the same
    bits on two runs; each bit-equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x = torch.as_tensor(_cloud(rng, 1, 3000, 3)).cuda()
    y = torch.as_tensor(_cloud(rng, 1, 8000, 3)).cuda()
    if case == "ties across blocks":
        y = y[:, :1600].repeat(1, 5, 1)
    elif case == "ties across warps":
        y = y[:, :100].repeat(1, 80, 1)
    elif case == "M under one split":
        y = y[:, :7]
    elif case == "N = 1":
        x = x[:, :1]
    v = torch.ones(y.shape[:2], dtype=torch.bool, device="cuda")
    dk, ik = nn_min_sqdist_fwd(x, y, v)
    dp, ip = nn_min_sqdist_plain(x, y, v)
    assert torch.equal(dk, dp) and torch.equal(ik, ip)
    if case.startswith("ties"):
        assert int(ik.max()) < (1600 if case.endswith("blocks") else 100)
    if case == "two runs":
        d2, i2 = nn_min_sqdist_fwd(x, y, v)
        assert torch.equal(dk, d2) and torch.equal(ik, i2)
