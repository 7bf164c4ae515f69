"""The port's labelled nearest neighbour (ops/label_nn.py; on the CPU the
plain version of kernel K3) against the JAX package's Pallas kernel in
interpret mode and against a brute force: distances, first-occurrence
argmin, rows without a compatible point, gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vistracker_tpu.ops.pallas_nn import _labelnn_call, label_nn_pallas_batched
from vistracker_tpu_torch.ops.label_nn import (_SENTINEL, label_nn,
                                               label_nn_fwd, label_nn_plain,
                                               label_nn_plan,
                                               label_nn_plan_plain,
                                               masked_min_plain)

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

# unit-scale clouds in float32: |x|^2 + |y|^2 - 2 x.y loses a few ulp of
# values around 10 to cancellation, in a different order in each package
TOL = 1e-5


def _brute(x, lx, y, ly, yv):
    d = ((x[:, :, None].astype(np.float64) - y[:, None]) ** 2).sum(-1)
    compat = (lx[:, :, None] == ly[:, None]) & yv[:, None]
    return np.where(compat, d, 1e10)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _case(rng, B, N, M, labels, p_valid=0.7):
    return (rng.randn(B, N, 3).astype(np.float32), rng.randint(0, labels, (B, N)),
            rng.randn(B, M, 3).astype(np.float32), rng.randint(0, labels, (B, M)),
            rng.rand(B, M) < p_valid)


@pytest.mark.parametrize("B, N, M, labels", [(1, 300, 250, 14), (3, 100, 80, 4),
                                             (2, 1100, 40, 3)])
def test_plain_matches_pallas_and_bruteforce(rng, B, N, M, labels):
    """N = 1100 crosses the plain version's 1024-row blocks."""
    x, lx, y, ly, yv = _case(rng, B, N, M, labels)
    d, idx = label_nn_plain(*_t(x, lx, y, ly, yv))
    full = _brute(x, lx, y, ly, yv)
    np.testing.assert_allclose(d.numpy(), full.min(-1), rtol=TOL, atol=TOL)
    jd, jidx = _labelnn_call(jnp.asarray(x), jnp.asarray(lx), jnp.asarray(y),
                             jnp.asarray(ly), jnp.asarray(yv), 1024, 128, True)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=TOL, atol=TOL)
    # the argmin is pinned wherever the runner-up is farther than the
    # tolerance (and a compatible point exists at all)
    srt = np.sort(full, -1)
    clear = (srt[..., 1] - srt[..., 0] > 10 * TOL) & (srt[..., 0] < 1e9)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(idx.numpy()[clear], full.argmin(-1)[clear])
    np.testing.assert_array_equal(idx.numpy()[clear], np.asarray(jidx)[clear])
    assert idx.dtype == torch.int64 and d.dtype == torch.float32


def test_no_compatible_rows(rng):
    """Rows whose label has no valid counterpart read 1e10, index 0 and
    get zero gradient, as in the Pallas kernel."""
    x = rng.randn(1, 40, 3).astype(np.float32)
    y = rng.randn(1, 30, 3).astype(np.float32)
    lx = np.concatenate([np.zeros(20, np.int64), np.ones(20, np.int64)])[None]
    ly = np.zeros((1, 30), np.int64)   # label 1 has no counterpart
    yv = np.ones((1, 30), bool)
    xt, lxt, yt, lyt, yvt = _t(x, lx, y, ly, yv)
    xt.requires_grad_(True)
    yt.requires_grad_(True)
    d = label_nn(xt, lxt, yt, lyt, yvt)
    assert (d[0, 20:] == 1e10).all() and (d[0, :20] < 1e9).all()
    assert (label_nn_plain(xt.detach(), lxt, yt.detach(), lyt, yvt)[1][0, 20:]
            == 0).all()
    d.sum().backward()
    assert (xt.grad[0, 20:] == 0).all() and xt.grad[0, :20].abs().min() > 0
    jd = label_nn_pallas_batched(jnp.asarray(x), jnp.asarray(lx), jnp.asarray(y),
                                 jnp.asarray(ly), jnp.asarray(yv), 1024, 128, True)
    np.testing.assert_array_equal(np.asarray(jd)[0, 20:],
                                  d.detach().numpy()[0, 20:])
    # nothing valid at all
    d0, i0 = label_nn_plain(xt.detach(), lxt, yt.detach(), lyt, ~yvt)
    assert (d0 == 1e10).all() and (i0 == 0).all()


def test_first_occurrence_argmin(rng):
    """Duplicated y points tie exactly; the least index wins."""
    x = rng.randn(2, 50, 3).astype(np.float32)
    y0 = rng.randn(2, 20, 3).astype(np.float32)
    y = np.concatenate([y0, y0, y0], 1)          # j, j + 20, j + 40 tie
    lx = np.zeros((2, 50), np.int64)
    ly = np.zeros((2, 60), np.int64)
    yv = np.ones((2, 60), bool)
    yv[:, :5] = False                            # then j + 20 is the first
    _, idx = label_nn_plain(*_t(x, lx, y, ly, yv))
    want = _brute(x, lx, y, ly, yv).argmin(-1)   # numpy: first occurrence
    np.testing.assert_array_equal(idx.numpy(), want)
    assert idx.max() < 40
    _, jidx = _labelnn_call(jnp.asarray(x), jnp.asarray(lx), jnp.asarray(y),
                            jnp.asarray(ly), jnp.asarray(yv), 1024, 128, True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_gradients_match_pallas_vjp(rng):
    """Both gradients against the JAX custom vjp through a weighted sum
    (general position: no distance ties). 1e-5: the same gather/scatter
    of 2 (x - y[idx]) g in float32."""
    B = 3
    x, lx, y, ly, yv = _case(rng, B, 200, 150, 5, 0.8)
    w = rng.rand(B, 200).astype(np.float32)

    def j_loss(a, b):
        d = label_nn_pallas_batched(a, jnp.asarray(lx), b, jnp.asarray(ly),
                                    jnp.asarray(yv), 1024, 128, True)
        return (jnp.where(d < 1e9, d, 0.0) * w).sum()

    jgx, jgy = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt, lxt, yt, lyt, yvt = _t(x, lx, y, ly, yv)
    xt.requires_grad_(True)
    yt.requires_grad_(True)
    d = label_nn(xt, lxt, yt, lyt, yvt)
    (torch.where(d < 1e9, d, torch.zeros_like(d)) * torch.as_tensor(w)) \
        .sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=TOL)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(jgy), atol=TOL)


def test_gradient_only_where_asked(rng):
    """The joint phase differentiates only the object side."""
    x, lx, y, ly, yv = _t(*_case(rng, 2, 30, 20, 2))
    y.requires_grad_(True)
    label_nn(x, lx, y, ly, yv).clamp(max=100.0).sum().backward()
    assert x.grad is None and y.grad.abs().max() > 0
    gy = y.grad.clone()
    x2 = x.clone().requires_grad_(True)
    y2 = y.detach().clone().requires_grad_(True)
    label_nn(x2, lx, y2, ly, yv).clamp(max=100.0).sum().backward()
    assert torch.equal(y2.grad, gy)


@pytest.mark.parametrize("bad", ["dtype", "shape", "labels", "valid"])
def test_wrapper_rejects_bad_inputs(rng, bad):
    x, lx, y, ly, yv = _t(*_case(rng, 1, 8, 6, 2))
    if bad == "dtype":
        x = x.double()
    elif bad == "shape":
        y = y[0]
    elif bad == "labels":
        lx = lx.float()
    else:
        yv = yv.long()
    with pytest.raises((TypeError, ValueError)):
        label_nn_fwd(x, lx, y, ly, yv)


def _grid_case(rng, B, N, M, labels):
    """Small-integer coordinates: every product and sum is exact in
    float32, so any order of the arithmetic gives the same bits and exact
    distance ties are common. Labels 0..labels-1 on x, 1..labels on y (x
    label 0 has no bucket); batch element 1 has no valid y point."""
    x = rng.randint(-4, 5, (B, N, 3)).astype(np.float32)
    y = rng.randint(-4, 5, (B, M, 3)).astype(np.float32)
    yv = rng.rand(B, M) < 0.7
    yv[1] = False
    return (x, rng.randint(0, labels, (B, N)), y,
            rng.randint(1, labels + 1, (B, M)), yv)


@pytest.mark.parametrize("B, N, M, labels", [(3, 200, 150, 5),
                                             (2, 130, 700, 1),
                                             (2, 1, 1, 1)])
def test_plan_orders_and_ranges(rng, B, N, M, labels):
    """K3's plan: y sorted by key with ascending j inside a key, invalid
    points under the sentinel after every label, x sorted by label, and
    each x's [lo, hi) holding exactly the valid y points of its label --
    every compatible y once."""
    _, lx, _, ly, yv = _grid_case(rng, max(B, 2), N, M, labels)
    lx, ly, yv = _t(lx, ly, yv)
    plan = label_nn_plan(lx, ly, yv)
    assert all(t.dtype == torch.int64 for t in plan)
    for b in range(lx.shape[0]):
        key, perm = plan.key_y[b], plan.perm_y[b]
        assert sorted(perm.tolist()) == list(range(M))
        want = torch.where(yv[b], ly[b], _SENTINEL)
        assert torch.equal(key, want[perm])
        assert bool((key[1:] >= key[:-1]).all())
        same = key[1:] == key[:-1]
        assert bool((perm[1:][same] > perm[:-1][same]).all())
        assert bool((key[~yv[b][perm]] == _SENTINEL).all())
        assert sorted(plan.perm_x[b].tolist()) == list(range(N))
        assert torch.equal(plan.key_x[b], lx[b][plan.perm_x[b]])
        for p in range(N):
            i = int(plan.perm_x[b, p])
            got = perm[int(plan.lo[b, p]):int(plan.hi[b, p])].tolist()
            compat = [j for j in range(M)
                      if bool(yv[b, j]) and int(ly[b, j]) == int(lx[b, i])]
            assert got == compat


def _pair_d(xi, ys):
    """The plain version's distance, operation by operation, from one x
    point (3,) to the points ys (K, 3)."""
    xy = (xi[0] * ys[:, 0] + xi[1] * ys[:, 1]) + xi[2] * ys[:, 2]
    xx = (xi[0] * xi[0] + xi[1] * xi[1]) + xi[2] * xi[2]
    yy = (ys[:, 0] * ys[:, 0] + ys[:, 1] * ys[:, 1]) + ys[:, 2] * ys[:, 2]
    return torch.clamp((xx + yy) - 2.0 * xy, min=0.0)


def _bucket_search(x, y, plan, slices=3):
    """K3's algorithm written out: each sorted x point against its range
    of sorted y only (its label's, or all of y where the plan keeps the
    index order: there a label test), the range cut into `slices` parts
    (the kernel's warp slices), each part keeping its least position on a
    strict <, the parts merged by (distance, position); (1e10, 0) where
    no point of the range counts."""
    B, N = plan.key_x.shape
    dmin = torch.full((B, N), 1e10, dtype=torch.float32)
    idx = torch.zeros((B, N), dtype=torch.int64)
    for b in range(B):
        for p in range(N):
            i = int(plan.perm_x[b, p])
            rng_q = np.arange(int(plan.lo[b, p]), int(plan.hi[b, p]))
            best, best_q = 1e10, -1
            for part in np.array_split(rng_q, slices):
                d = _pair_d(x[b, i], y[b, plan.perm_y[b, part]])
                same = plan.key_y[b, part] == plan.key_x[b, p]
                d = torch.where(same, d, 1e10).tolist()
                part_d, part_q = 1e10, -1
                for q, v in zip(part.tolist(), d):
                    if v < part_d:
                        part_d, part_q = v, q
                if part_d < best or (part_d == best and part_q < best_q):
                    best, best_q = part_d, part_q
            if best_q >= 0:
                dmin[b, i] = best
                idx[b, i] = plan.perm_y[b, best_q]
    return dmin, idx


@pytest.mark.parametrize("coords", ["grid", "unit"])
def test_bucket_search_bit_equal(rng, coords):
    """Searching only each label's bucket from the plan gives the plain
    version's min and argmin bit for bit: exact ties (integer grid) go to
    the least j across slices, empty buckets and the element without
    valid y read (1e10, 0). On the grid every operation is exact, so the
    JAX Pallas kernel (interpret mode) agrees bit for bit too."""
    x, lx, y, ly, yv = _grid_case(rng, 3, 200, 150, 5)
    if coords == "unit":
        x = rng.randn(*x.shape).astype(np.float32)
        y = rng.randn(*y.shape).astype(np.float32)
    xt, lxt, yt, lyt, yvt = _t(x, lx, y, ly, yv)
    d, idx = _bucket_search(xt, yt, label_nn_plan(lxt, lyt, yvt))
    dp, ip = masked_min_plain(xt, yt, yvt, lxt, lyt)
    assert torch.equal(d, dp) and torch.equal(idx, ip)
    assert bool((d[1] == 1e10).all()) and bool((d[0] == 1e10).any())
    if coords == "grid":
        full = _brute(x, lx, y, ly, yv)
        assert (np.sort(full, -1)[..., 1] == full.min(-1))[full.min(-1)
                                                           < 1e9].any()
        jd, jidx = _labelnn_call(jnp.asarray(x), jnp.asarray(lx),
                                 jnp.asarray(y), jnp.asarray(ly),
                                 jnp.asarray(yv), 1024, 128, True)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("spread", [32, 1000])
def test_plan_keeps_index_order_for_a_wide_label_span(rng, spread):
    """An element whose labels (x, and valid y) span 32 values or more
    keeps the index order: perm the identity, keys the labels (the
    sentinel for invalid y), every range all of y; an element of narrow
    span in the same batch is sorted. The search over that plan, label
    test included, is bit-equal to the plain version."""
    x, lx, y, ly, yv = _grid_case(rng, 3, 120, 90, 5)
    lx[0] *= spread // 4   # element 0: labels 0..spread (or more)
    ly[0] *= spread // 4
    xt, lxt, yt, lyt, yvt = _t(x, lx, y, ly, yv)
    plan = label_nn_plan_plain(lxt, lyt, yvt)
    assert torch.equal(plan.perm_x[0], torch.arange(120))
    assert torch.equal(plan.perm_y[0], torch.arange(90))
    assert torch.equal(plan.key_x[0], lxt[0])
    assert torch.equal(plan.key_y[0], torch.where(yvt[0], lyt[0], _SENTINEL))
    assert bool((plan.lo[0] == 0).all()) and bool((plan.hi[0] == 90).all())
    assert bool((plan.key_x[2][1:] >= plan.key_x[2][:-1]).all())
    assert bool((plan.hi[2] - plan.lo[2] < 90).all())
    d, idx = _bucket_search(xt, yt, plan)
    dp, ip = masked_min_plain(xt, yt, yvt, lxt, lyt)
    assert torch.equal(d, dp) and torch.equal(idx, ip)


def test_plan_does_not_change_the_result(rng):
    """A plan made once and passed in (the joint phase's way) gives what
    the wrapper gives alone, forward and backward."""
    x, lx, y, ly, yv = _t(*_case(rng, 2, 60, 40, 3))
    plan = label_nn_plan(lx, ly, yv)
    assert all(torch.equal(a, b) for a, b in
               zip(label_nn_fwd(x, lx, y, ly, yv, plan),
                   label_nn_fwd(x, lx, y, ly, yv)))
    y1 = y.clone().requires_grad_(True)
    y2 = y.clone().requires_grad_(True)
    label_nn(x, lx, y1, ly, yv, plan).clamp(max=100.0).sum().backward()
    label_nn(x, lx, y2, ly, yv).clamp(max=100.0).sum().backward()
    assert torch.equal(y1.grad, y2.grad)


def _adversarial(rng, labels):
    """The card's adversarial rows (chip_smoke.py:k3_adversarial): exact
    ties at j, j + 500, j + 1000 (different 512-point tiles and warp
    slices), N = 777 and M = 1500 (multiples of no tile), batch element 1
    without a valid y point."""
    y0 = rng.randn(3, 500, 3).astype(np.float32)
    yv = rng.rand(3, 1500) < 0.9
    yv[1] = False
    return (rng.randn(3, 777, 3).astype(np.float32),
            rng.randint(0, labels, (3, 777)), np.tile(y0, (1, 3, 1)),
            np.tile(rng.randint(0, labels, (3, 500)), (1, 3)), yv)


@pytest.mark.cuda
def test_kernel_bit_equal_on_the_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    args = [a.cuda() for a in _t(*_case(rng, 2, 700, 500, 14, 0.4))]
    dk, ik = label_nn_fwd(*args)
    dp, ip = label_nn_plain(*args)
    assert torch.equal(dk, dp) and torch.equal(ik, ip)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ties 1 label", "ties 3 labels",
                                  "ties 1000 labels", "dense", "grid",
                                  "one point"])
def test_kernel_bit_equal_on_adversarial_rows(rng, case):
    """Ties across tiles and warp slices, an element without valid y,
    ragged sizes, 1,000 labels (a span the plan leaves in index order:
    the search tests labels over all pairs), the dense case
    (one label, all valid), exact grid ties and single points: the plan
    equal to the plain plan, min and argmin bit-equal to the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    if case.startswith("ties"):
        arrays = _adversarial(rng, int(case.split()[1]))
    elif case == "dense":
        x, _, y, _, _ = _case(rng, 2, 1000, 1300, 1)
        arrays = (x, np.zeros((2, 1000), np.int64), y,
                  np.zeros((2, 1300), np.int64), np.ones((2, 1300), bool))
    elif case == "grid":
        arrays = _grid_case(rng, 3, 777, 1500, 5)
    else:
        arrays = _case(rng, 2, 1, 1, 1, 1.0)
    args = [a.cuda() for a in _t(*arrays)]
    labels = (args[1], args[3], args[4])
    plan = label_nn_plan(*labels)
    assert all(torch.equal(a, b) for a, b in
               zip(plan, label_nn_plan_plain(*labels)))
    dk, ik = label_nn_fwd(*args, plan)
    dp, ip = label_nn_plain(*args)
    assert torch.equal(dk, dp) and torch.equal(ik, ip)
