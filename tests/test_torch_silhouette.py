"""The port's soft silhouette (ops/coverage.py: strip liveness, K1 in its
soft use, K2's plain version, the autograd pair) against the JAX
package's Pallas kernels in interpret mode and against the plain dense
soft_silhouette of both packages, on the tie and culling scenes of
tests/test_pallas_raster.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vistracker_tpu.ops import pallas_raster as pr
from vistracker_tpu.ops import rasterizer as j_rast
from vistracker_tpu_torch.ops import coverage as cov
from vistracker_tpu_torch.ops.rasterizer import soft_silhouette

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)


def _random_scene(rng):
    """Random faces incl. a zero-area one; 37 faces pad to one block."""
    v2d = rng.randn(2, 24, 2).astype(np.float32) * 0.5
    faces = rng.randint(0, 24, (37, 3)).astype(np.int32)
    faces[5] = [3, 3, 7]
    return v2d, faces, 32, 2.0 / 32


def _tie_scene(rng):
    """Faces duplicated across face-block boundaries: exact max ties in
    different 128-face blocks."""
    v2d = rng.randn(1, 24, 2).astype(np.float32) * 0.5
    base = rng.randint(0, 24, (150, 3)).astype(np.int32)
    return v2d, np.concatenate([base, base]), 32, 2.0 / 32


def _culling_centers(rng):
    centers = rng.uniform(-0.3, 0.3, (40, 1, 2)).astype(np.float32)
    centers[..., 1] = centers[..., 1] * 0.25 - 0.75
    return centers


def _culling_scene(rng):
    """Small sliver faces near the image top: most strips are culled."""
    tri = rng.randn(40, 3, 2).astype(np.float32) * 0.03
    v2d = (_culling_centers(rng) + tri).reshape(1, 120, 2)
    return v2d, np.arange(120, dtype=np.int32).reshape(40, 3), 64, 1.0 / 64


def _compact_scene(rng):
    """Equilateral faces at the same spot: cells really are culled."""
    ang = np.deg2rad([90.0, 210.0, 330.0]).astype(np.float32)
    eq = 0.03 * np.stack([np.cos(ang), np.sin(ang)], -1)[None]
    v2d = (_culling_centers(rng) + eq).reshape(1, 120, 2)
    return v2d, np.arange(120, dtype=np.int32).reshape(40, 3), 64, 1.0 / 64


SCENES = {"random": _random_scene, "ties": _tie_scene,
          "culling": _culling_scene, "compact": _compact_scene}
scenes = pytest.mark.parametrize("scene", sorted(SCENES))


def _jax_kernel_inputs(v2d, faces, size, sigma):
    cpl = pr._planes(jnp.asarray(v2d), jnp.asarray(faces))
    return cpl, pr._strip_active(cpl, size, sigma)


@scenes
def test_strip_active_equals_jax(rng, scene):
    v2d, faces, size, sigma = SCENES[scene](rng)
    cpl, want = _jax_kernel_inputs(v2d, faces, size, sigma)
    got = cov._strip_active(torch.as_tensor(np.asarray(cpl)), size, sigma)
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if scene == "compact":
        assert (got == 0).any() and (got == 1).any()


@scenes
def test_soft_forward_bit_equal_to_pallas(rng, scene):
    """The same planes and liveness through the Pallas kernel (interpret
    mode) and the port's plain K1: m and the tie count bit-equal; the
    whole function's sigmoid image within 1e-6 of the JAX one (plane
    coefficients of the two packages differ by up to 2 ulp) and within
    1e-5 of the dense soft_silhouette."""
    v2d, faces, size, sigma = SCENES[scene](rng)
    cpl, active = _jax_kernel_inputs(v2d, faces, size, sigma)
    jm, (_, _, _, jcnt) = pr._ml_fwd(cpl, active, size, True)
    m, cnt = cov.max_logit_fwd(torch.as_tensor(np.asarray(cpl)),
                               torch.as_tensor(np.asarray(active)), size)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    img = cov.soft_silhouette_batch(torch.as_tensor(v2d),
                                    torch.as_tensor(faces), size, sigma)
    jimg = pr.soft_silhouette_batch(jnp.asarray(v2d), jnp.asarray(faces),
                                    size, sigma, interpret=True)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-6)
    dense = torch.stack([soft_silhouette(v, torch.as_tensor(faces).long(),
                                         size, sigma)
                         for v in torch.as_tensor(v2d)])
    np.testing.assert_allclose(img.numpy(), dense.numpy(), atol=1e-5)


@scenes
def test_bwd_plain_matches_pallas_bwd(rng, scene):
    """K2's plain version against the Pallas backward kernel (interpret
    mode) on the same saved tensors and cotangent. The two sum a face's
    pixels in another order (Pallas: row sums, rows, strips; the plain
    version: one reduction over the block's rectangle), so they agree to
    float32 summation error: 1e-5 of the largest entry; dead and padding
    rows are exactly zero in both."""
    v2d, faces, size, sigma = SCENES[scene](rng)
    cpl, active = _jax_kernel_inputs(v2d, faces, size, sigma)
    jm, res = pr._ml_fwd(cpl, active, size, True)
    prob = jax.nn.sigmoid(jm / sigma)
    g = jnp.asarray(rng.randn(*jm.shape).astype(np.float32)) \
        * prob * (1 - prob) / sigma
    want = np.asarray(pr._ml_bwd(size, True, res, g)[0])
    cnt = torch.as_tensor(np.asarray(res[3]))
    gw = torch.as_tensor(np.asarray(g)) / torch.clamp(cnt, min=1.0)
    got = cov.max_logit_bwd(torch.as_tensor(np.asarray(cpl)),
                            torch.as_tensor(np.asarray(active)),
                            torch.as_tensor(np.asarray(jm)), gw, size).numpy()
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=1e-5 * scale)
    dead = np.asarray(cpl)[..., 2] == -1e9
    assert dead.any() and (got[dead] == 0).all() and (want[dead] == 0).all()


@scenes
def test_gradient_matches_dense_autograd_and_jax(rng, scene):
    """d loss / d v2d of the kernel path against autograd of the dense
    soft_silhouette and against the JAX kernel path, tolerances as in
    tests/test_pallas_raster.py (1e-3 relative; 1e-4 absolute on the
    sliver scenes, where a 1-ulp difference flips which plane of a face
    is its min and moves a pixel's cotangent between planes)."""
    v2d, faces, size, sigma = SCENES[scene](rng)
    target = (rng.rand(len(v2d), size, size) > 0.5).astype(np.float32)
    atol = 1e-4 if scene in ("culling", "compact") else 1e-5
    tf = torch.as_tensor(faces).long()

    def grad_of(fn):
        v = torch.as_tensor(v2d).clone().requires_grad_(True)
        loss = ((fn(v) - torch.as_tensor(target)) ** 2).sum()
        loss.backward()
        return float(loss), v.grad.numpy()

    l1, g1 = grad_of(lambda v: cov.soft_silhouette_batch(v, tf, size, sigma))
    l0, g0 = grad_of(lambda v: torch.stack(
        [soft_silhouette(vi, tf, size, sigma) for vi in v]))
    assert np.abs(g1).max() > 0
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    np.testing.assert_allclose(g1, g0, rtol=1e-3, atol=atol)

    def j_loss(v):
        imgs = pr.soft_silhouette_batch(v, jnp.asarray(faces), size, sigma,
                                        interpret=True)
        return ((imgs - target) ** 2).sum()

    lj, gj = jax.value_and_grad(j_loss)(jnp.asarray(v2d))
    np.testing.assert_allclose(l1, float(lj), rtol=1e-5)
    np.testing.assert_allclose(g1, np.asarray(gj), rtol=1e-3, atol=atol)


def test_dense_soft_silhouette_matches_jax(rng):
    v2d, faces, size, sigma = _random_scene(rng)
    want = j_rast.soft_silhouette(jnp.asarray(v2d[0]), jnp.asarray(faces),
                                  size, sigma, chunk=64)
    got = soft_silhouette(torch.as_tensor(v2d[0]),
                          torch.as_tensor(faces).long(), size, sigma, chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_gradient_descends(rng):
    """The kernel path's gradient moves a shifted mesh back to its mask."""
    v2d, faces, size, sigma = _random_scene(rng)
    tf = torch.as_tensor(faces).long()
    v = torch.as_tensor(v2d[:1])
    target = cov.soft_silhouette_batch(v, tf, size, sigma)
    v0 = (v + 0.08).requires_grad_(True)
    l0 = ((cov.soft_silhouette_batch(v0, tf, size, sigma) - target) ** 2).sum()
    l0.backward()
    step = 0.01 * v0.grad / (v0.grad.abs().max() + 1e-9)
    l1 = ((cov.soft_silhouette_batch((v0 - step).detach(), tf, size, sigma)
           - target) ** 2).sum()
    assert float(l1) < float(l0)


@pytest.mark.parametrize("bad", ["m_shape", "gw_dtype"])
def test_bwd_wrapper_rejects_bad_inputs(rng, bad):
    v2d, faces, size, sigma = _random_scene(rng)
    cpl = cov._planes(torch.as_tensor(v2d), torch.as_tensor(faces))
    active = cov._strip_active(cpl, size, sigma)
    m, cnt = cov.max_logit_fwd(cpl, active, size)
    gw = torch.ones_like(m)
    if bad == "m_shape":
        m = m[:, :-1]
    else:
        gw = gw.double()
    with pytest.raises(ValueError):
        cov.max_logit_bwd(cpl, active, m, gw, size)


def test_soft_launch_count_stays_zero_on_cpu(rng):
    """The counters count kernel launches only; the CPU path makes none."""
    v2d, faces, size, sigma = _random_scene(rng)
    before = (cov.max_logit_fwd.launches, cov._MaxLogit.fwd_launches,
              cov.max_logit_bwd.launches)
    v = torch.as_tensor(v2d).requires_grad_(True)
    cov.soft_silhouette_batch(v, torch.as_tensor(faces), size,
                              sigma).sum().backward()
    assert before == (cov.max_logit_fwd.launches,
                      cov._MaxLogit.fwd_launches,
                      cov.max_logit_bwd.launches)


@pytest.mark.cuda
def test_kernels_against_plain_on_the_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    v2d, faces, size, sigma = _tie_scene(rng)
    cpl = cov._planes(torch.as_tensor(v2d).cuda(),
                      torch.as_tensor(faces).cuda()).contiguous()
    active = cov._strip_active(cpl, size, sigma)
    m, cnt = cov.max_logit_fwd(cpl, active, size)
    mp, cp = cov.max_logit_fwd_plain(cpl, active, size)
    assert torch.equal(m, mp) and torch.equal(cnt, cp)
    gw = torch.rand_like(m) / torch.clamp(cnt, min=1.0)
    dk = cov.max_logit_bwd(cpl, active, m, gw, size)
    dp = cov.max_logit_bwd_plain(cpl, active, m, gw, size)
    assert float((dk - dp).abs().max()) <= 1e-5 * float(dp.abs().max())


def test_bwd_plain_dead_cells_and_single_views(rng):
    """K2's plain version with every cell dead gives dc 0 everywhere; on
    one view's slices it gives that view's rows of the batched call, bit
    for bit (the views are independent: the kernel's one-view case)."""
    v2d, faces, size, sigma = _random_scene(rng)
    cpl = cov._planes(torch.as_tensor(v2d), torch.as_tensor(faces))
    active = cov._strip_active(cpl, size, sigma)
    m, cnt = cov.max_logit_fwd(cpl, active, size)
    gw = torch.as_tensor(rng.randn(*m.shape).astype(np.float32)) \
        / torch.clamp(cnt, min=1.0)
    assert (cov.max_logit_bwd(cpl, torch.zeros_like(active), m, gw, size)
            == 0).all()
    dc = cov.max_logit_bwd(cpl, active, m, gw, size)
    assert dc.abs().max() > 0
    rows = size // cov._RBLK
    for b in range(len(v2d)):
        one = cov.max_logit_bwd(cpl[b:b + 1], active[b * rows:(b + 1) * rows],
                                m[b:b + 1], gw[b:b + 1], size)
        assert torch.equal(one[0], dc[b])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one view", "every cell dead", "two runs"])
def test_bwd_kernel_edge_cases_on_the_card(rng, case):
    """K2 on one view, with no live cell (dc all 0), and twice on the same
    inputs (the same bits: no atomics), within 1e-5 of the plain
    version's largest entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    v2d, faces, size, sigma = _random_scene(rng)
    cpl = cov._planes(torch.as_tensor(v2d).cuda(),
                      torch.as_tensor(faces).cuda()).contiguous()
    active = cov._strip_active(cpl, size, sigma)
    m, cnt = cov.max_logit_fwd(cpl, active, size)
    gw = torch.rand_like(m) / torch.clamp(cnt, min=1.0)
    if case == "one view":
        cpl, active, m, gw = cpl[:1], active[:size // cov._RBLK], m[:1], gw[:1]
    elif case == "every cell dead":
        active = torch.zeros_like(active)
    dk = cov.max_logit_bwd(cpl, active, m, gw, size)
    dp = cov.max_logit_bwd_plain(cpl, active, m, gw, size)
    assert float((dk - dp).abs().max()) <= 1e-5 * float(dp.abs().max())
    if case == "every cell dead":
        assert bool((dk == 0).all())
    if case == "two runs":
        assert torch.equal(dk, cov.max_logit_bwd(cpl, active, m, gw, size))


@scenes
def test_bwd_chunk_bound_skips_no_winner(rng, scene):
    """K2's skip test (csrc/max_logit_bwd.cu: a face's plane min over a
    16-column chunk of a row is at most min_j max(e_j at the chunk's two
    end pixels); below the chunk's least m the chunk is skipped), in the
    kernel's single-rounded arithmetic: the bound is never below a plane
    min inside its chunk, and no winning (pixel, face) of a live cell lies
    in a skipped chunk -- so the skip leaves dc as the full walk gives
    it -- while the test does skip most chunks."""
    v2d, faces, size, sigma = SCENES[scene](rng)
    cpl = cov._planes(torch.as_tensor(v2d), torch.as_tensor(faces))
    active = cov._strip_active(cpl, size, sigma)
    m, _ = cov.max_logit_fwd(cpl, active, size)
    chunk, skipped, total = 16, 0, 0
    for b, fsl, rows, cols, planes, px, py, cells in cov._live_blocks(
            cpl, active, size):
        mins = planes[0]
        for e in planes[1:]:
            mins = torch.minimum(mins, e)                # (128, R, C)
        win = (mins == m[b, rows, cols]) & cells
        for s in range(0, mins.shape[2], chunk):
            ends = [torch.maximum(e[:, :, s], e[:, :, min(s + chunk,
                                                        mins.shape[2]) - 1])
                    for e in planes]
            bound = ends[0]
            for e in ends[1:]:
                bound = torch.minimum(bound, e)          # (128, R)
            part = mins[:, :, s:s + chunk]
            assert bool((bound[..., None] >= part).all())
            skip = bound < m[b, rows, cols][None, :, s:s + chunk].amin(-1)
            assert not bool((skip[..., None] & win[:, :, s:s + chunk]).any())
            live = cells[None, :, s]
            skipped += int((skip & live).sum())
            total += int(live.sum()) * len(skip)
    assert total > 0 and skipped > total // 2
