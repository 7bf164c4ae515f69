"""The port's SIF-Net stack against the JAX package with the same weights
(carried by sifnet_state_dict_from_flax): hourglass encode, the query
heads, the weight round trip through the JAX package's torch importer,
and the ops under it (bicubic upsample, grid sampling, image crops).
Tolerances: encoder maps 1e-4 (a 3x3-conv + GroupNorm stack summed in
another order; flax computes the variance as E[x^2] - E[x]^2), heads and
samples 1e-5 (a few fp32 matmuls)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vistracker_tpu.core.camera import PerspectiveCamera as JCam
from vistracker_tpu.models import torch_import as TI
from vistracker_tpu.models.sifnet import SIFNet as JNet
from vistracker_tpu.models.sifnet import sifnet_preset as jpreset
from vistracker_tpu_torch.core.camera import PerspectiveCamera as TCam
from vistracker_tpu_torch.models.sifnet import SIFNet as TNet
from vistracker_tpu_torch.models.sifnet import cast_cache
from vistracker_tpu_torch.models.sifnet import sifnet_preset as tpreset
from vistracker_tpu_torch.models.weights import (
    init_random_, load_checkpoint_state_dict, sifnet_state_dict_from_flax)

S = 32


def _nets(preset="tiny"):
    jnet = JNet(jpreset(preset, crop_size=96), JCam(crop_size=96))
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 8)),
                       jnp.zeros((1, 8, 3)), jnp.zeros((1, 2)),
                       jnp.zeros((1, 3)))
    params = jax.tree.map(np.asarray, params)
    tnet = TNet(tpreset(preset, crop_size=96), TCam(crop_size=96))
    tnet.load_state_dict(sifnet_state_dict_from_flax(
        params, tpreset(preset, crop_size=96)))
    return jnet, params, tnet.eval().requires_grad_(False)


def _inputs(rng, B=2, N=64):
    img = rng.rand(B, S, S, 8).astype(np.float32)
    pts = (rng.randn(B, N, 3) * 0.3 + [0, 0, 2.2]).astype(np.float32)
    cc = np.array([[48, 48], [40, 50]], np.float32)[:B]
    bc = np.array([[0, 0, 2.2], [0.1, 0, 2.3]], np.float32)[:B]
    return img, pts, cc, bc


@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_encode_and_query_match(rng, preset):
    jnet, params, tnet = _nets(preset)
    img, pts, cc, bc = _inputs(rng)
    cj = jnet.apply(params, jnp.asarray(img), method=JNet.encode)
    ct = tnet.encode(torch.from_numpy(img))
    pairs = [(cj["rgb_feats"][-1], ct["rgb_feats"][-1]),
             (cj["tmpx"], ct["tmpx"])]
    pairs += [(cj["tp_feats"][p][-1], ct["tp_feats"][p][-1])
              for p in range(3)]
    pairs += list(zip(cj["tp_tmpx"], ct["tp_tmpx"]))
    for r, o in pairs:
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4)

    # queries from the SAME cache values isolate the query path
    cache = {"rgb_feats": [torch.from_numpy(np.asarray(cj["rgb_feats"][-1]))],
             "tmpx": torch.from_numpy(np.asarray(cj["tmpx"])),
             "tp_feats": [[torch.from_numpy(np.asarray(f[-1]))]
                          for f in cj["tp_feats"]],
             "tp_tmpx": [torch.from_numpy(np.asarray(t))
                         for t in cj["tp_tmpx"]]}
    args_j = (jnp.asarray(pts), jnp.asarray(cc), jnp.asarray(bc))
    args_t = (torch.from_numpy(pts), torch.from_numpy(cc),
              torch.from_numpy(bc))
    ref = jnet.apply(params, cj, *args_j, method=JNet.query)[-1]
    out = tnet.query(cache, *args_t)[-1]
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(
        tnet.query_df(cache, *args_t).numpy(),
        np.asarray(jnet.apply(params, cj, *args_j, method=JNet.query_df)),
        atol=1e-5)
    heads = ("df", "parts", "pca")
    ref_h = jnet.apply(params, cj, *args_j, method=JNet.query_heads,
                       heads=heads)
    out_h = tnet.query_heads(cache, *args_t, heads=heads)
    for k in heads:
        np.testing.assert_allclose(out_h[k].numpy(), np.asarray(ref_h[k]),
                                   atol=1e-5, err_msg=k)


def test_weights_round_trip_through_torch_import():
    """port state_dict -> the JAX package's importer -> the original flax
    params, exactly (names and layouts agree both ways)."""
    _, params, tnet = _nets("tiny")
    sd = {k: v.numpy() for k, v in tnet.state_dict().items()}
    back = TI.sifnet_params(sd, jpreset("tiny", crop_size=96))
    same = jax.tree.map(lambda a, b: np.array_equal(np.asarray(a),
                                                    np.asarray(b)),
                        back, params)
    assert all(jax.tree.leaves(same))


def test_checkpoint_loading_and_seeded_init(tmp_path):
    """A reference-layout tar (DDP "module." prefixes, experiment folder)
    loads with load_state_dict; the random init is a function of the
    seed only."""
    from vistracker_tpu_torch.models.weights import is_torch_experiment_dir
    _, _, tnet = _nets("tiny")
    exp = tmp_path / "exp"
    (exp / "checkpoints").mkdir(parents=True)
    torch.save({"model_state_dict": {"module." + k: v for k, v in
                                     tnet.state_dict().items()}},
               exp / "checkpoints" / "checkpoint_0h:0m:5s_5.0.tar")
    assert is_torch_experiment_dir(str(exp))
    fresh = TNet(tpreset("tiny", crop_size=96), TCam(crop_size=96))
    fresh.load_state_dict(load_checkpoint_state_dict(str(exp)))
    for (k, a), b in zip(tnet.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    a, b = (init_random_(TNet(tpreset("tiny")), torch.Generator()
                         .manual_seed(3)) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in
               zip(a.state_dict().values(), b.state_dict().values()))


def test_sliced_encode_joins_to_whole_cache(rng):
    """track encodes a chunk in slices of ENCODE_FRAMES frames and joins
    the caches: per-sample GroupNorm and convolutions make that the cache
    of one call. Tolerance 1e-5 on O(1) features: a convolution of another
    batch size may sum in another order (seen: 2.7e-6 after the stacks)."""
    from vistracker_tpu_torch.cli.real_track import _join_caches
    _, _, tnet = _nets("tiny")
    img = torch.from_numpy(rng.rand(3, S, S, 8).astype(np.float32))
    whole = tnet.encode(img)
    joined = _join_caches([tnet.encode(img[:2]), tnet.encode(img[2:])])
    flat_w, flat_j = [], []

    def leaves(tree, out):
        if isinstance(tree, dict):
            tree = [tree[k] for k in sorted(tree)]
        if isinstance(tree, list):
            for t in tree:
                leaves(t, out)
        else:
            out.append(tree)

    leaves(whole, flat_w)
    leaves(joined, flat_j)
    assert len(flat_w) == len(flat_j) == 8
    for w, j in zip(flat_w, flat_j):
        assert w.shape == j.shape and w.shape[0] == 3
        np.testing.assert_allclose(j.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_bf16_cache_query_close(rng):
    """bfloat16 cache: features stored in bf16 (3 significant digits),
    blend and heads in fp32 -- the JAX package's cast_cache contract."""
    from vistracker_tpu.models.sifnet import cast_cache as jcast
    jnet, params, tnet = _nets("tiny")
    img, pts, cc, bc = _inputs(rng)
    cj = jcast(jnet.apply(params, jnp.asarray(img), method=JNet.encode),
               jnp.bfloat16)
    ct = cast_cache(tnet.encode(torch.from_numpy(img)), torch.bfloat16)
    assert ct["tmpx"].dtype == torch.bfloat16
    ref = jnet.apply(params, cj, jnp.asarray(pts), jnp.asarray(cc),
                     jnp.asarray(bc), method=JNet.query)[-1]
    out = tnet.query(ct, torch.from_numpy(pts), torch.from_numpy(cc),
                     torch.from_numpy(bc))[-1]
    for k in ref:  # a bf16 rounding flip in one cached value moves ~1e-2
        np.testing.assert_allclose(out[k].float().numpy(),
                                   np.asarray(ref[k], np.float32),
                                   atol=2e-2, err_msg=k)


def test_resize_and_grid_sample_match(rng):
    from vistracker_tpu.ops.grid_sample import grid_sample_points as gs_jax
    from vistracker_tpu.ops.resize import avg_pool2x as ap_jax
    from vistracker_tpu.ops.resize import upsample2x_bicubic as up_jax
    from vistracker_tpu_torch.ops.grid_sample import grid_sample_points
    from vistracker_tpu_torch.ops.resize import avg_pool2x, \
        upsample2x_bicubic
    x = rng.randn(2, 9, 7, 5).astype(np.float32)             # NHWC
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    np.testing.assert_allclose(
        upsample2x_bicubic(xt).permute(0, 2, 3, 1).numpy(),
        np.asarray(up_jax(jnp.asarray(x))), atol=1e-5)
    x = rng.randn(2, 8, 6, 5).astype(np.float32)
    np.testing.assert_allclose(
        avg_pool2x(torch.from_numpy(x).permute(0, 3, 1, 2))
        .permute(0, 2, 3, 1).numpy(), np.asarray(ap_jax(jnp.asarray(x))),
        atol=1e-6)
    uv = (rng.rand(2, 200, 2) * 2.4 - 1.2).astype(np.float32)  # some outside
    np.testing.assert_allclose(
        grid_sample_points(torch.from_numpy(x), torch.from_numpy(uv))
        .numpy(), np.asarray(gs_jax(jnp.asarray(x), jnp.asarray(uv))),
        atol=1e-5)
    # gradient in uv (the projection loop differentiates it)
    g_ref = jax.grad(lambda u: gs_jax(jnp.asarray(x), u).sum())(
        jnp.asarray(uv))
    u = torch.from_numpy(uv).requires_grad_(True)
    grid_sample_points(torch.from_numpy(x), u).sum().backward()
    np.testing.assert_allclose(u.grad.numpy(), np.asarray(g_ref), atol=1e-4)


@pytest.mark.parametrize("hw, crop, net", [((96, 128), 96, 32),
                                           ((300, 400), 200, 64)])
def test_input_crop_matches_pil_path(rng, hw, crop, net):
    """The antialiased torch resize against the JAX package's PIL
    BILINEAR path; values in [0, 1], measured agreement ~2e-7."""
    from vistracker_tpu.data.images import prepare_input_crop as jprep
    from vistracker_tpu_torch.data.images import prepare_input_crop
    H, W = hw
    rgb = (rng.rand(H, W, 3) * 255).astype(np.uint8)
    pm = np.zeros((H, W), bool)
    pm[H // 4:3 * H // 4, W // 4:W // 2] = True
    om = np.zeros((H, W), bool)
    om[H // 3:2 * H // 3, W // 2:3 * W // 4] = True
    a, ca = jprep(rgb, pm, om, crop, net)
    b, cb = prepare_input_crop(rgb, pm, om, crop, net)
    np.testing.assert_array_equal(cb, ca)
    np.testing.assert_allclose(b, a, atol=1e-5)


# ---------------------------------------------------------------------------
# the HGFilterGConv variant (models/hourglass.py, HGConfig.gconv)
# ---------------------------------------------------------------------------

GCONV = dict(input_channels=3, num_hourglass=1, hourglass_dim=256,
             tmpx_dim=32)


def _gconv_pair(num_stack):
    from vistracker_tpu.models.hourglass import HGConfig as JC
    from vistracker_tpu.models.hourglass import HGFilter as JH
    from vistracker_tpu_torch.models.hourglass import HGConfig as TC
    from vistracker_tpu_torch.models.hourglass import HGFilter as TH
    jnet = JH(JC(gconv=True, num_stack=num_stack, **GCONV))
    tnet = TH(TC(gconv=True, num_stack=num_stack, **GCONV))
    return jnet, tnet.eval().requires_grad_(False)


def _hg_close(jout, tout):
    """Per-stack outputs, tmpx and normx (NHWC vs NCHW), 1e-4 of each
    map's largest entry."""
    (jo, jt, jn), (to, tt, tn) = jout, tout
    for a, b in zip([*jo, jt, jn], [*to, tt, tn]):
        a = np.asarray(a)
        np.testing.assert_allclose(b.permute(0, 2, 3, 1).numpy(), a,
                                   atol=1e-4 * np.abs(a).max())


@pytest.mark.parametrize("num_stack", [1, 2])
def test_gconv_hgfilter_matches_jax(rng, num_stack):
    """flax's grouped 1x1 kernels (1, 1, in/256, out) carried into torch's
    (out, in/256, 1, 1) by hgfilter_state_dict_from_flax; the forward
    agrees to 1e-4 (the encoder tolerance above)."""
    from vistracker_tpu_torch.models.hourglass import HGConfig as TC
    from vistracker_tpu_torch.models.weights import \
        hgfilter_state_dict_from_flax
    jnet, tnet = _gconv_pair(num_stack)
    x = rng.randn(2, 16, 16, 3).astype(np.float32)
    params = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(1),
                                                jnp.asarray(x)))
    assert params["params"]["l0"]["kernel"].shape == (1, 1, 1, 256)
    tnet.load_state_dict(hgfilter_state_dict_from_flax(
        params, TC(gconv=True, num_stack=num_stack, **GCONV)))
    assert tnet.l0.groups == 256 and tnet.l0.weight.shape == (256, 1, 1, 1)
    with torch.no_grad():
        tout = tnet(torch.from_numpy(x).permute(0, 3, 1, 2))
    _hg_close(jnet.apply(params, jnp.asarray(x)), tout)


def test_gconv_reference_state_dict_loads(rng, tmp_path):
    """A reference-layout HGFilterGConv checkpoint (torch names, grouped
    weights, "module." prefixes) loads through load_checkpoint_state_dict;
    the JAX package's importer reads the same dict, and both nets agree.
    A hourglass_dim that the groups do not divide is refused."""
    from vistracker_tpu_torch.models.hourglass import HGConfig as TC
    from vistracker_tpu_torch.models.hourglass import HGFilter as TH
    jnet, tnet = _gconv_pair(2)
    init_random_(tnet, torch.Generator().manual_seed(5))
    for m in tnet.modules():     # norms away from the identity too
        if isinstance(m, torch.nn.GroupNorm):
            with torch.no_grad():
                m.weight.uniform_(0.5, 1.5, generator=torch.Generator()
                                  .manual_seed(6))
    path = tmp_path / "hg_gconv.tar"
    torch.save({"state_dict": {"module." + k: v for k, v in
                               tnet.state_dict().items()}}, path)
    sd = load_checkpoint_state_dict(str(path))
    fresh = TH(TC(gconv=True, num_stack=2, **GCONV))
    fresh.load_state_dict(sd)
    params = {"params": TI.hgfilter_params(
        {k: v.numpy() for k, v in sd.items()}, "", 2, 1)}
    x = rng.randn(1, 16, 16, 3).astype(np.float32)
    with torch.no_grad():
        tout = fresh.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    _hg_close(jnet.apply(params, jnp.asarray(x)), tout)
    with pytest.raises(ValueError, match="multiple of 256"):
        TH(TC(gconv=True, num_stack=2, **{**GCONV, "hourglass_dim": 64}))
