"""Kernel K1 (the coverage max-logit raster) and the stage-3 triplane
render: the port's plain version against the Pallas kernel run in
interpret mode, on the scenes of tests/test_pallas_raster.py. Exact
equality throughout: both evaluate each plane as single-rounded FMAs
(XLA:CPU contracts the kernel body; the port emulates it), so m, cnt
and the masks are bit-equal."""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vistracker_tpu.ops import pallas_raster as PR
from vistracker_tpu_torch.ops import coverage as C


def _scene_random(rng, B=2, V=24, F=37, scale=0.5):
    """tests/test_pallas_raster.py:_scene: random faces incl. a
    degenerate one; F=37 pads to the 128-face block."""
    v2d = rng.randn(B, V, 2).astype(np.float32) * scale
    faces = rng.randint(0, V, (F, 3)).astype(np.int32)
    faces[5] = [3, 3, 7]
    return v2d, faces


def _scene_offscreen(rng):
    """test_coverage_mask_matches_xla: offscreen verts, 150 faces."""
    v2d = rng.randn(7, 40, 2).astype(np.float32) * 0.6
    v2d[:, 30:] += 3.0
    faces = rng.randint(0, 40, (150, 3)).astype(np.int32)
    faces[5] = [3, 3, 7]
    return v2d, faces


def _scene_compact(rng, n=300):
    """Small compact faces (more than 2 blocks, so the banded sort runs)."""
    centers = rng.uniform(-0.8, 0.8, (n, 1, 2)).astype(np.float32)
    tri = rng.randn(n, 3, 2).astype(np.float32) * 0.05
    v2d = (centers + tri).reshape(1, 3 * n, 2)
    return np.repeat(v2d, 2, 0), np.arange(3 * n, dtype=np.int32) \
        .reshape(n, 3)


SCENES = {"random": _scene_random, "offscreen": _scene_offscreen,
          "compact": _scene_compact}


@pytest.mark.parametrize("scene, size", [
    ("random", 32), ("offscreen", 32), ("compact", 64), ("compact", 384),
    ("random", 384)])
def test_k1_plain_matches_pallas_interpret(rng, scene, size):
    """Same planes and liveness into both: m and cnt bit-equal, including
    culled cells (384 px exercises three 128-px x tiles)."""
    v2d, faces = SCENES[scene](rng)
    cpl, *bounds = PR._planes(jnp.asarray(v2d), jnp.asarray(faces),
                              want_bounds=True)
    active = PR._strip_active_bbox(*bounds, size)
    m_ref, (_, _, _, cnt_ref) = PR._ml_fwd(cpl, active, size, True)
    m, cnt = C.max_logit_fwd(torch.from_numpy(np.array(cpl)),
                             torch.from_numpy(np.array(active)), size)
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_ref))
    assert (np.asarray(active) == 0).any() or scene == "random"


@pytest.mark.parametrize("scene, size", [("offscreen", 32),
                                         ("compact", 384)])
def test_planes_and_liveness_match(rng, scene, size):
    """The port's plane build agrees with the JAX one to 2 ulp (XLA
    contracts some products into FMAs); face order, padding and the
    liveness mask are identical."""
    v2d, faces = SCENES[scene](rng)
    ref = PR._planes(jnp.asarray(v2d), jnp.asarray(faces), want_bounds=True)
    out = C._planes(torch.from_numpy(v2d), torch.from_numpy(faces),
                    want_bounds=True)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]),
                               rtol=3e-7, atol=3e-7)
    for r, o in zip(ref[1:], out[1:]):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    np.testing.assert_array_equal(
        C._strip_active_bbox(*out[1:], size).numpy(),
        np.asarray(PR._strip_active_bbox(*ref[1:], size)))


def test_coverage_masks_match_jax(rng):
    v2d, faces = _scene_offscreen(rng)
    ref = PR.coverage_mask_batch(jnp.asarray(v2d), jnp.asarray(faces), 32,
                                 interpret=True)
    out = C.coverage_mask_batch(torch.from_numpy(v2d),
                                torch.from_numpy(faces), 32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed, size, n_faces", [(0, 32, 25), (1, 64, 300)])
def test_triplane_masks_match_jax(seed, size, n_faces):
    """Stage 3 end to end on shared vertices: bit-equal to the JAX
    render through the Pallas kernel (interpret) and through XLA."""
    from vistracker_tpu.ops.rasterizer import render_triplane_masks_batch \
        as render_jax
    from vistracker_tpu_torch.ops.rasterizer import \
        render_triplane_masks_batch
    rng = np.random.RandomState(seed)
    verts = (rng.randn(3, 30, 3) * 0.3 + [0, 0.3, 2.4]).astype(np.float32)
    faces = rng.randint(0, 30, (n_faces, 3)).astype(np.int32)
    bc = verts.mean(1)
    out = render_triplane_masks_batch(torch.from_numpy(verts),
                                      torch.from_numpy(faces),
                                      torch.from_numpy(bc), size).numpy()
    for backend in ("pallas", "xla"):
        ref = render_jax(jnp.asarray(verts), jnp.asarray(faces),
                         jnp.asarray(bc), size, backend=backend,
                         interpret=True)
        np.testing.assert_array_equal(out, np.asarray(ref))
    assert 0.0 < out.mean() < 1.0


def test_rasterize_mask_matches_jax(rng):
    from vistracker_tpu.ops.rasterizer import rasterize_mask as rm_jax
    from vistracker_tpu_torch.ops.rasterizer import rasterize_mask
    v2d, faces = _scene_random(rng, B=1, F=60, scale=0.6)
    ref = rm_jax(jnp.asarray(v2d[0]), jnp.asarray(faces), 32, chunk=64)
    out = rasterize_mask(torch.from_numpy(v2d[0]),
                         torch.from_numpy(faces).long(), 32, chunk=16)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _round_f32(x: Fraction) -> np.float32:
    """Exact rational -> nearest float32, ties to even."""
    lo = np.float32(float(x))
    if Fraction(float(lo)) > x:
        lo = np.nextafter(lo, np.float32(-np.inf))
    hi = np.nextafter(lo, np.float32(np.inf))
    d_lo, d_hi = x - Fraction(float(lo)), Fraction(float(hi)) - x
    if d_lo != d_hi:
        return lo if d_lo < d_hi else hi
    return lo if int(lo.view(np.int32)) % 2 == 0 else hi


def test_fma32_is_single_rounded(rng):
    """fma32(a, b, c) is a*b + c rounded once to float32, checked against
    exact rational arithmetic on random operands and on constructed cases
    where the float64 sum lands exactly on a float32 midpoint (p just above
    or below 2^-24 with c = 1), where a second rounding would go wrong."""
    a = rng.randn(2000).astype(np.float32)
    b = rng.randn(2000).astype(np.float32)
    c = rng.randn(2000).astype(np.float32)
    mids = []
    for av in np.float32(1.0) + rng.rand(4000).astype(np.float32) * 0.01:
        bv = np.float32(2.0 ** -24 / float(av))
        dev = Fraction(float(av)) * Fraction(float(bv)) - Fraction(2) ** -24
        if dev != 0 and abs(dev) < Fraction(2) ** -53:
            mids.append((av, bv))
    assert len(mids) > 20
    a = np.concatenate([a, [m[0] for m in mids]]).astype(np.float32)
    b = np.concatenate([b, [m[1] for m in mids]]).astype(np.float32)
    c = np.concatenate([c, np.ones(len(mids))]).astype(np.float32)
    got = C.fma32(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive != want).any()  # the midpoint cases do need the fix


def test_wrapper_dispatch_and_checks():
    """CPU tensors run the plain version and count no kernel launch; bad
    inputs raise instead of falling back."""
    rng = np.random.RandomState(0)
    v2d, faces = _scene_random(rng)
    cpl, *b = C._planes(torch.from_numpy(v2d), torch.from_numpy(faces), True)
    active = C._strip_active_bbox(*b, 32)
    before = C.max_logit_fwd.launches
    C.max_logit_fwd(cpl, active, 32)
    assert C.max_logit_fwd.launches == before
    with pytest.raises(TypeError):
        C.max_logit_fwd(cpl.double(), active, 32)
    with pytest.raises(ValueError):
        C.max_logit_fwd(cpl, active[:-1], 32)
    with pytest.raises(ValueError):
        C.max_logit_fwd(cpl.to("meta"), active.to("meta"), 32)


@pytest.mark.cuda
def test_k1_kernel_matches_plain_on_cuda():
    """The hand-written CUDA kernel against the plain version on the card
    (bit-equal m and cnt) at a reduced stage-3 shape; the sizes cover each
    pixels-per-thread instance of the kernel (1, 2, 4, 8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.RandomState(0)
    v2d, faces = _scene_compact(rng, n=600)
    dev = torch.device("cuda")
    cpl, *b = C._planes(torch.from_numpy(v2d).to(dev),
                        torch.from_numpy(faces).to(dev), True)
    for size in (32, 64, 128, 256, 512):
        active = C._strip_active_bbox(*b, size)
        before = C.max_logit_fwd.launches
        m, cnt = C.max_logit_fwd(cpl.contiguous(), active.contiguous(), size)
        assert C.max_logit_fwd.launches == before + 1
        m_p, cnt_p = C.max_logit_fwd_plain(cpl, active, size)
        assert torch.equal(m, m_p) and torch.equal(cnt, cnt_p)


def _inputs(rng, scene, size):
    v2d, faces = SCENES[scene](rng)
    cpl, *b = C._planes(torch.from_numpy(v2d), torch.from_numpy(faces), True)
    return cpl, C._strip_active_bbox(*b, size)


@pytest.mark.parametrize("scene, size", [("random", 32), ("offscreen", 64),
                                         ("compact", 64)])
def test_split_and_merge_over_face_blocks_equals_plain(rng, scene, size):
    """The (m, cnt) of any split of the face blocks, merged pixel by pixel
    with "greater replaces, equal adds", is the whole input's: max is
    exact and integer counts add exactly, so a kernel may cut its face
    blocks into units in any order and keep bit-equality. Here the even
    and the odd blocks (each with its own liveness, the rest dead), merged
    both ways round, on scenes whose ties cross blocks."""
    cpl, active = _inputs(rng, scene, size)
    m, cnt = C.max_logit_fwd_plain(cpl, active, size)
    blocks = torch.arange(active.shape[1]) % (cpl.shape[1] // C._FBLK)
    parts = [C.max_logit_fwd_plain(cpl, active * (blocks % 2 == k), size)
             for k in (0, 1)]
    for (m1, c1), (m2, c2) in (parts, parts[::-1]):
        mm = torch.maximum(m1, m2)
        cc = torch.where(m2 > m1, c2, torch.where(m2 == m1, c1 + c2, c1))
        assert torch.equal(mm, m) and torch.equal(cc, cnt)
    # the same inputs with every face repeated in a second set of blocks:
    # every tie then spans two blocks
    n_x = size // C._xblk(size)
    act = active.reshape(active.shape[0], n_x, -1)
    m2, c2 = C.max_logit_fwd_plain(
        torch.cat([cpl, cpl], 1),
        torch.cat([act, act], 2).reshape(active.shape[0], -1), size)
    assert torch.equal(m2, m) and torch.equal(c2, 2 * cnt)


def _tile_ranges(cpl, size, b, r, x, start, last):
    """The kernel's per-face (least, greatest) corner values over the tile
    of columns start..last of x tile x, rows of strip r, in fma32."""
    f32 = C.fma32
    coord = f32(torch.arange(size, dtype=torch.float32),
                torch.full((size,), 2.0 / (size - 1)),
                torch.full((size,), -1.0))
    xb = C._xblk(size)
    a, bb, c = (cpl[b, :, k::3] for k in range(3))
    py = coord[[r * C._RBLK, r * C._RBLK + C._RBLK - 1]]
    i0, i1 = f32(bb, py[0].expand_as(bb), c), f32(bb, py[1].expand_as(bb), c)
    px = coord[[x * xb + start, x * xb + last]]
    e = [[f32(a, p.expand_as(a), i) for p in px]
         for i in (torch.minimum(i0, i1), torch.maximum(i0, i1))]
    return (torch.minimum(*e[0]).amin(-1), torch.maximum(*e[1]).amin(-1))


@pytest.mark.parametrize("scene, size", [("random", 32), ("offscreen", 40),
                                         ("compact", 64)])
def test_fwd_tile_bound_skips_no_winner(rng, scene, size):
    """The forward twin of K2's chunk bound (csrc/max_logit_fwd.cu): over
    an 8 x 16 tile each face's value lies between its least and greatest
    corner values, in the kernel's single-rounded arithmetic; so the
    tile's T0 (max of the least) is at most m at every pixel and no face
    that wins or ties a pixel of the tile has its greatest below the
    tile's least m. Then the kernel's whole algorithm
    (max_logit_fwd_walks_plain: T0, batches of 32, the running threshold)
    gives max_logit_fwd_plain's m and cnt, skipping some pairs. 40 px has
    a ragged last tile."""
    cpl, active = _inputs(rng, scene, size)
    m, cnt = C.max_logit_fwd_plain(cpl, active, size)
    xb = C._xblk(size)
    n_x, n_fblk = size // xb, cpl.shape[1] // C._FBLK
    live = active.reshape(cpl.shape[0], size // C._RBLK, n_x, n_fblk) != 0
    checked = 0
    for b, r, x in torch.nonzero(live.any(-1)).tolist():
        faces = torch.cat([torch.arange(f * C._FBLK, (f + 1) * C._FBLK)
                           for f in torch.nonzero(live[b, r, x]).flatten()])
        for start in range(0, xb, 16):
            last = min(start + 16, xb) - 1
            low, high = (t[faces] for t in _tile_ranges(
                cpl, size, b, r, x, start, last))
            cols = slice(x * xb + start, x * xb + last + 1)
            rows = slice(r * C._RBLK, (r + 1) * C._RBLK)
            tile_m = m[b, rows, cols]
            assert float(low.max()) <= float(tile_m.min())
            # every face's plane min over the tile, as the plain version
            px = torch.arange(size, dtype=torch.float32)
            coord = C.fma32(px, torch.full_like(px, 2.0 / (size - 1)),
                            torch.full_like(px, -1.0))
            fc = cpl[b, faces]
            inner = C.fma32(fc[:, 1::3, None, None],
                            coord[rows][None, None, :, None],
                            fc[:, 2::3, None, None])
            vals = C.fma32(fc[:, 0::3, None, None].expand_as(
                inner.expand(-1, -1, -1, last + 1 - start)),
                coord[cols][None, None, None, :].expand(
                    len(faces), 5, C._RBLK, -1),
                inner.expand(-1, -1, -1, last + 1 - start)).amin(1)
            assert bool((high[:, None, None] >= vals).all())
            assert bool((low[:, None, None] <= vals).all())
            wins = (vals == tile_m[None]).any(-1).any(-1)
            assert bool((high[wins] >= float(tile_m.min())).all())
            checked += 1
    assert checked > 0
    m_w, c_w, tested, walked = C.max_logit_fwd_walks_plain(cpl, active, size)
    assert torch.equal(m_w, m) and torch.equal(c_w, cnt)
    assert 0 < walked < tested


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["every cell dead", "one view",
                                  "ties across blocks", "skip counts",
                                  "misaligned planes"])
def test_k1_kernel_edge_cases_on_cuda(case):
    """K1 on the card where a cut of its work could go wrong, bit-equal
    to the plain version: no live cell (m = -1e9, cnt = 0 everywhere), one
    view, every face repeated in a second block (cnt doubles), and the
    kernel's skip counts equal to max_logit_fwd_walks_plain's, at 40 px
    (a ragged tile) and 384 px (three x tiles); planes that do not start
    on 16 bytes (the kernel stages float4) raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.RandomState(0)
    v2d, faces = _scene_compact(rng, n=600)
    dev = torch.device("cuda")
    cpl, *b = C._planes(torch.from_numpy(v2d).to(dev),
                        torch.from_numpy(faces).to(dev), True)
    cpl = cpl.contiguous()
    for size in (40, 384):
        active = C._strip_active_bbox(*b, size).contiguous()
        rows = size // C._RBLK
        if case == "every cell dead":
            m, cnt = C.max_logit_fwd(cpl, torch.zeros_like(active), size)
            assert bool((m == -1e9).all()) and bool((cnt == 0).all())
        elif case == "one view":
            m, cnt = C.max_logit_fwd(cpl[:1], active[:rows], size)
            m_p, c_p = C.max_logit_fwd_plain(cpl[:1], active[:rows], size)
            assert torch.equal(m, m_p) and torch.equal(cnt, c_p)
        elif case == "ties across blocks":
            act = active.reshape(active.shape[0], size // C._xblk(size), -1)
            twice = torch.cat([cpl, cpl], 1).contiguous()
            act2 = torch.cat([act, act], 2).reshape(active.shape[0], -1)
            m2, c2 = C.max_logit_fwd(twice, act2.contiguous(), size)
            m_p, c_p = C.max_logit_fwd_plain(twice, act2, size)
            m, cnt = C.max_logit_fwd(cpl, active, size)
            assert torch.equal(m2, m_p) and torch.equal(c2, c_p)
            assert torch.equal(m2, m) and torch.equal(c2, 2 * cnt)
        elif case == "misaligned planes":
            flat = torch.empty(cpl.numel() + 1, device=dev)
            shifted = flat[1:].view(cpl.shape)
            shifted.copy_(cpl)
            with pytest.raises(ValueError):
                C.max_logit_fwd(shifted, active, size)
        else:
            got = C.max_logit_fwd_walks(cpl, active, size)
            want = C.max_logit_fwd_walks_plain(cpl, active, size)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
            assert got[2:] == want[2:]
