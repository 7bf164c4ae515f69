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
from vistracker_tpu_torch.ops.label_nn import (label_nn, label_nn_fwd,
                                               label_nn_plain)

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


@pytest.mark.cuda
def test_kernel_bit_equal_on_the_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    args = [a.cuda() for a in _t(*_case(rng, 2, 700, 500, 14, 0.4))]
    dk, ik = label_nn_fwd(*args)
    dp, ip = label_nn_plain(*args)
    assert torch.equal(dk, dp) and torch.equal(ik, ip)
