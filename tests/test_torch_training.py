"""The port's training (fit/train.py, fit/trainer_loop.py,
data/datasets.py, models/sifnet.py's train side, config.py and the
train-* command lines) against the JAX package on the same numpy inputs,
with weights carried by models/weights.py.

Tolerances: the train-mode forward 1e-4 (the encoder's conv + GroupNorm
stack sums in another order, as in tests/test_torch_sifnet.py); the loss
and each term 1e-5 relative; each gradient tensor 1e-4 of its largest
entry (two stem leaves at rounding level excepted, see
test_losses_and_gradients_match);
losses over three Adam steps 1e-5 relative, parameters 1e-5 absolute
with at most 0.1% of elements outside (see
test_adam_steps_match_across_a_milestone)."""
import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vistracker_tpu.core.camera import PerspectiveCamera as JCam
from vistracker_tpu.models.sifnet import SIFNet as JNet
from vistracker_tpu.models.sifnet import sifnet_losses as jlosses
from vistracker_tpu.models.sifnet import sifnet_preset as jpreset
from vistracker_tpu_torch.core.camera import PerspectiveCamera as TCam
from vistracker_tpu_torch.models.sifnet import SIFNet as TNet
from vistracker_tpu_torch.models.sifnet import sifnet_losses as tlosses
from vistracker_tpu_torch.models.sifnet import sifnet_preset as tpreset
from vistracker_tpu_torch.models.weights import (init_random_,
                                                sifnet_state_dict_from_flax)

torch.set_num_threads(1)
S, N, B = 32, 96, 2
CROP = 96
# tiny widths; (variant, shared triplane encoder, stacks): two stacks
# exercise the train-mode forward's every-stack cache
NETS = [("chore", True, 1), ("chore-triplane", False, 1),
        ("chore-triplane-vis", True, 2)]


def _cfgs(variant, shared, stacks, remat=False):
    kw = dict(variant=variant, triplane_shared=shared, num_stack=stacks,
              remat=remat)
    return (dataclasses.replace(jpreset("tiny", crop_size=CROP), **kw),
            dataclasses.replace(tpreset("tiny", crop_size=CROP), **kw))


def _flax_from_port(sd: dict) -> dict:
    """The port's state_dict -> flax params, the inverse of
    models/weights.py:sifnet_state_dict_from_flax (so no JAX init has to
    be compiled)."""
    from vistracker_tpu_torch.models.weights import _flax_path
    tree = {}
    for key, v in sd.items():
        mod_path, leaf = key.rsplit(".", 1)
        node = tree
        for name in _flax_path(mod_path):
            node = node.setdefault(name, {})
        v = v.numpy().copy()   # no buffer shared with the port's model
        if leaf == "bias":
            node["bias"] = v
        elif v.ndim == 1:                       # GroupNorm weight
            node["scale"] = v
        elif v.ndim == 4:                       # Conv2d
            node["kernel"] = np.transpose(v, (2, 3, 1, 0))
        else:                                   # Conv1d head layer
            node["kernel"] = v[..., 0].T
    return {"params": tree}


_NET_CACHE = {}


def _nets(variant, shared, stacks):
    """JAX net + numpy params and the port net with the same seeded
    weights; the round trip through sifnet_state_dict_from_flax is
    exact."""
    key = (variant, shared, stacks)
    jc, tc = _cfgs(*key)
    if key not in _NET_CACHE:
        net = TNet(tc, TCam(crop_size=CROP))
        init_random_(net, torch.Generator().manual_seed(stacks))
        sd = net.state_dict()
        params = _flax_from_port(sd)
        back = sifnet_state_dict_from_flax(params, tc)
        assert back.keys() == sd.keys()
        assert all(torch.equal(back[k], sd[k]) for k in sd)
        _NET_CACHE[key] = (params, sd)
    params, sd = _NET_CACHE[key]
    tnet = TNet(tc, TCam(crop_size=CROP))
    tnet.load_state_dict(sd)
    return JNet(jc, JCam(crop_size=CROP)), params, tnet


def _batch(seed=0):
    """A seeded batch with points around the body center, most inside
    the 96-px crop, and GT labels at the reference's shapes."""
    rng = np.random.RandomState(seed)
    bc = np.array([[0.0, 0.0, 2.2], [0.05, -0.02, 2.3]], np.float32)
    cc = np.asarray(JCam(crop_size=CROP).project_screen(
        jnp.asarray(bc)[:, None]))[:, 0].astype(np.float32)
    pts = (bc[:, None] + rng.randn(B, N, 3) * 0.04).astype(np.float32)
    return dict(
        images=rng.rand(B, S, S, 8).astype(np.float32), points=pts,
        crop_center=cc, body_center=bc,
        df_h=(rng.rand(B, N) * 0.15).astype(np.float32),
        df_o=(rng.rand(B, N) * 0.15).astype(np.float32),
        parts=rng.randint(0, 14, (B, N)).astype(np.int32),
        pca=rng.randn(B, N, 3, 3).astype(np.float32),
        obj_center=rng.randn(B, 3).astype(np.float32),
        visibility=rng.rand(B, N).astype(np.float32))


def _args(batch, lib):
    keys = ("images", "points", "crop_center", "body_center")
    if lib == "jax":
        return [jnp.asarray(batch[k]) for k in keys]
    return [torch.from_numpy(batch[k]) for k in keys]


def _gt(batch, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return {k: conv(batch[k]) for k in ("df_h", "df_o", "parts", "pca",
                                        "obj_center", "visibility",
                                        "body_center")}


_JAX_RESULTS = {}


def _jax_train(variant, shared, stacks):
    """The JAX train-mode forward, loss, terms and gradients on _batch(1),
    from one compile per variant (shared by the two tests below)."""
    key = (variant, shared, stacks)
    if key not in _JAX_RESULTS:
        jnet, params, _ = _nets(*key)
        batch = _batch(1)

        def loss_fn(p):
            preds = jnet.apply(p, *_args(batch, "jax"), train=True)
            loss, terms = jlosses(preds, _gt(batch, "jax"))
            return loss, (terms, preds)

        (loss, (terms, preds)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        _JAX_RESULTS[key] = (batch, float(loss),
                             {k: float(v) for k, v in terms.items()},
                             jax.tree.map(np.asarray, preds),
                             jax.tree.map(np.asarray, grads))
    return _JAX_RESULTS[key]


@pytest.mark.parametrize("variant, shared, stacks", NETS)
def test_train_forward_matches(variant, shared, stacks):
    """Every stack of the train-mode forward, each variant's heads."""
    _, _, tnet = _nets(variant, shared, stacks)
    batch, _, _, ref, _ = _jax_train(variant, shared, stacks)
    with torch.no_grad():
        out = tnet(*_args(batch, "torch"), train=True)
    assert len(out) == len(ref) == stacks
    for o, r in zip(out, ref):
        assert set(o) == set(r)
        assert o["centers"].shape[-1] == (3 if variant.endswith("vis")
                                          else 6)
        for k in r:
            np.testing.assert_allclose(o[k].numpy(), r[k], atol=1e-4,
                                       err_msg=k)


# the stem's conv1 bias feeds a GroupNorm with one channel a group,
# which removes it, so its true gradient is 0; bn1's scale gets a
# gradient at the same rounding level (both at most 1.5e-7 of the
# network's largest gradient entry, measured)
_ROUNDING_LEAVES = re.compile(
    r"(image_filter|triplane_encoder(_\d)?)\.(conv1\.bias|bn1\.weight)")


@pytest.mark.parametrize("variant, shared, stacks", NETS)
def test_losses_and_gradients_match(variant, shared, stacks):
    """The loss and its six terms within 1e-5 relative; each gradient
    tensor within 1e-4 of its largest entry. The stems' conv1 bias and
    bn1 scale (_ROUNDING_LEAVES) have reference gradients at float32
    rounding level, asserted below 1e-6 of the network's largest entry;
    both packages return rounding noise there, so those two leaves are
    held to 1e-4 of 1e-3 of that entry instead."""
    _, _, tnet = _nets(variant, shared, stacks)
    batch, jl, jt, _, jg = _jax_train(variant, shared, stacks)
    _, tc = _cfgs(variant, shared, stacks)
    tl, tt = tlosses(tnet(*_args(batch, "torch"), train=True),
                     _gt(batch, "torch"))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), jl, rtol=1e-5)
    assert set(tt) == set(jt)
    for k in jt:
        np.testing.assert_allclose(float(tt[k].detach()), jt[k], rtol=1e-5,
                                   atol=1e-12, err_msg=k)
    grads = sifnet_state_dict_from_flax(jg, tc)
    gmax = max(float(g.abs().max()) for g in grads.values())
    n_rounding = 0
    for name, p in tnet.named_parameters():
        ref = grads[name].numpy()
        scale = float(np.abs(ref).max())
        if _ROUNDING_LEAVES.fullmatch(name):
            assert scale <= 1e-6 * gmax, name
            scale = 1e-3 * gmax
            n_rounding += 1
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
    assert n_rounding == 2 * (1 + tc.has_triplane
                              * (1 if tc.triplane_shared else 3))


def _count_outside(sd_t, sd_j, atol):
    bad = total = 0
    for k, v in sd_t.items():
        d = np.abs(v.numpy() - sd_j[k].numpy())
        bad += int((d > atol).sum())
        total += d.size
    return bad, total


def _jax_adam_steps(jnet, params, jtc, batch, n=3):
    """n JAX updates from `params`: [(loss, terms)] per update and the
    final flax params."""
    from vistracker_tpu.fit.train import TrainState as JTS
    from vistracker_tpu.fit.train import make_optimizer, \
        make_train_step as jstep_fn

    jstep = jstep_fn(jnet, jtc)
    jstate = JTS(params=params, opt_state=make_optimizer(jtc).init(params),
                 step=jnp.zeros((), jnp.int32))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    for _ in range(n):
        jstate, jl, jt = jstep(jstate, jb)
        out.append((float(jl), {k: float(v) for k, v in jt.items()}))
    return out, jax.tree.map(np.asarray, jstate.params)


# (variant, shared, stacks), the terms' relative limit after the first
# update, the share of parameters allowed outside 1e-5
ADAM_CASES = [(("chore", True, 1), 1e-5, 0.001),
              (("chore-triplane-vis", True, 1), 1e-4, 0.01)]


@pytest.mark.parametrize("key, term_rtol, outside", ADAM_CASES,
                         ids=["chore", "chore-triplane-vis"])
def test_adam_steps_match_across_a_milestone(key, term_rtol, outside):
    """Three SIF-Net updates (lr 1e-3) on one batch with steps_per_epoch=2
    and a milestone at epoch 1: update 2 runs at lr * gamma in both. The
    loss at every step is held to 1e-5 relative, its terms to 1e-5 at the
    first step, the parameters after the three updates to 1e-5 absolute.
    Adam's normalised update can turn a rounding-level difference in a
    near-zero gradient into a step of up to lr (conv1's bias, whose true
    gradient is 0, moves by +-lr on rounding noise), so the elements
    outside 1e-5 are counted, printed, and at most a share of them may
    be, and none by more than 5 lr (Adam moves an element by about lr an
    update at most: 2.3 lr over the three, in either package).

    For `chore` the terms stay within 1e-5 at every step and at most 0.1%
    of the elements lie outside. The one-stack `chore-triplane-vis` net
    (the one `train-sifnet` trains) drifts more: measured on this batch,
    its terms reach 3.2e-5 relative by the third update and 0.36% of its
    elements lie outside. JAX drifts as far from itself when the images
    are scaled by 1 +- 1e-7 (printed here: up to 0.49% outside and 1.6e-5
    on this batch), so the drift is Adam's amplification of rounding, and
    the later terms are held to 1e-4 and the share to 1%."""
    from vistracker_tpu.fit.train import TrainConfig as JTC
    from vistracker_tpu_torch.fit.train import TrainConfig as TTC
    from vistracker_tpu_torch.fit.train import (init_train_state,
                                                make_train_step)

    jnet, params, tnet = _nets(*key)
    _, tc = _cfgs(*key)
    kw = dict(learning_rate=1e-3, milestones=(1,), steps_per_epoch=2)
    jtc, ttc = JTC(**kw), TTC(**kw)
    tstate = init_train_state(tnet, ttc)
    tstep = make_train_step(tnet, ttc)
    batch = _batch(2)
    jsteps, jparams = _jax_adam_steps(jnet, params, jtc, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i, (jl, jt) in enumerate(jsteps):
        tstate, tl, tt = tstep(tstate, tb)
        np.testing.assert_allclose(float(tl), jl, rtol=1e-5)
        for k in jt:
            np.testing.assert_allclose(float(tt[k]), jt[k],
                                       rtol=1e-5 if i == 0 else term_rtol,
                                       atol=1e-12, err_msg=(i, k))
    assert tstate.step == 3
    assert tstate.optimizer.param_groups[0]["lr"] == pytest.approx(3e-4)
    sd_j = sifnet_state_dict_from_flax(jparams, tc)
    sd_t = tnet.state_dict()
    bad, total = _count_outside(sd_t, sd_j, 1e-5)
    worst = max(float((v - sd_j[k]).abs().max()) for k, v in sd_t.items())
    print(f"{key[0]}: parameters outside 1e-5 after 3 updates: {bad} of "
          f"{total}, max |d| {worst:.3g}")
    assert bad <= outside * total
    assert worst <= 5e-3
    if key[0] == "chore":
        return
    for eps in (1e-7, -1e-7):
        pb = dict(batch, images=batch["images"] * np.float32(1 + eps))
        psteps, pparams = _jax_adam_steps(jnet, params, jtc, pb)
        pbad, _ = _count_outside(sifnet_state_dict_from_flax(pparams, tc),
                                 sd_j, 1e-5)
        drift = max(abs(pt[k] - jt[k]) / abs(jt[k])
                    for (_, pt), (_, jt) in zip(psteps, jsteps) for k in jt)
        print(f"JAX against JAX with images x (1 {eps:+g}): {pbad} of "
              f"{total} outside 1e-5, terms within {drift:.3g} relative")


def test_remat_gives_the_same_outputs_and_gradients():
    _, tc = _cfgs("chore-triplane-vis", False, 2)
    nets = []
    for remat in (False, True):
        net = TNet(dataclasses.replace(tc, remat=remat), TCam(crop_size=CROP))
        torch.manual_seed(0)
        if nets:
            net.load_state_dict(nets[0].state_dict())
        nets.append(net)
    batch = _batch(3)
    outs = []
    for net in nets:
        loss, _ = tlosses(net(*_args(batch, "torch"), train=True),
                          _gt(batch, "torch"))
        loss.backward()
        outs.append((float(loss.detach()), {n: p.grad.clone()
                                   for n, p in net.named_parameters()}))
    assert outs[0][0] == outs[1][0]
    for n, g in outs[0][1].items():
        torch.testing.assert_close(outs[1][1][n], g, rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# SmoothNet and HVOP-Net steps
# ---------------------------------------------------------------------------

def _temporal_pair(kind, dropout=0.0):
    """A JAX SmoothNet / SmoothNetSMPL / ConditionalMInfiller and the
    port's with the same seeded weights (the port's, carried to flax by
    the JAX package's importer, so no JAX init is compiled), and a
    seeded batch."""
    from vistracker_tpu.models import infiller as JI
    from vistracker_tpu.models import smoothnet as JSN
    from vistracker_tpu.models import torch_import as TI
    from vistracker_tpu_torch.models import infiller as TInf
    from vistracker_tpu_torch.models import smoothnet as TSN
    rng = np.random.RandomState(4)
    if kind == "infiller":
        # one layer an encoder keeps the JAX compile short
        kw = dict(clip_len=20, window=5, dropout_smpl=dropout,
                  dropout_obj=dropout, dropout_joint=dropout,
                  num_layers_smpl=1, num_layers_obj=1, num_layers_joint=1)
        jm = JI.ConditionalMInfiller(JI.InfillerConfig(**kw))
        tm = TInf.ConditionalMInfiller(TInf.InfillerConfig(**kw))
        mask = rng.rand(B, 20) < 0.3
        batch = dict(data_smpl=rng.randn(B, 20, 147).astype(np.float32),
                     mask_smpl=np.zeros((B, 20), bool),
                     data_obj=(rng.randn(B, 20, 6) * ~mask[..., None]
                               ).astype(np.float32),
                     mask_obj=mask,
                     gt_obj=rng.randn(B, 20, 6).astype(np.float32))
    else:
        smpl = kind == "smoothnet_smpl"
        C, W = (157 if smpl else 6), 16
        kw = dict(window_size=W, output_size=W, hidden_size=64,
                  dropout=dropout)
        jm = (JSN.SmoothNetSMPL if smpl else JSN.SmoothNet)(**kw)
        tm = (TSN.SmoothNetSMPL if smpl else TSN.SmoothNet)(**kw)
        batch = dict(noisy=rng.randn(4, C, W).astype(np.float32),
                     gt=rng.randn(4, C, W).astype(np.float32))
    init_random_(tm, torch.Generator().manual_seed(4))
    # copies: JAX on the CPU may alias a numpy buffer, which the port's
    # in-place Adam update would then change under it
    sd = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
    params = (TI.infiller_params(sd, jm.cfg) if kind == "infiller"
              else TI.smoothnet_params(sd, smpl=kind == "smoothnet_smpl"))
    back = _to_sd(kind, params)
    assert back.keys() == sd.keys()
    assert all(np.array_equal(back[k].numpy(), sd[k]) for k in sd)
    return jm, params, tm, batch


def _to_sd(kind, params):
    from vistracker_tpu_torch.models.weights import (
        infiller_state_dict_from_flax, smoothnet_state_dict_from_flax)
    params = jax.tree.map(np.asarray, params)
    if kind == "infiller":
        return infiller_state_dict_from_flax(params)
    return smoothnet_state_dict_from_flax(params,
                                          smpl=kind == "smoothnet_smpl")


@pytest.mark.parametrize("kind", ["smoothnet", "smoothnet_smpl", "infiller"])
def test_temporal_steps_match_with_dropout_off(kind):
    """Three updates across the schedule's step (steps_per_epoch=2:
    SmoothNet's lr decays after update 1, the infiller's is cut at the
    epoch-1 milestone), dropout 0 in both packages: the loss and terms at
    every step within 1e-5 relative (measured under 1e-6), the
    parameters within 1e-5 with at most 0.1% of elements outside."""
    from vistracker_tpu.fit import trainer_loop as JL
    from vistracker_tpu_torch.fit import trainer_loop as TL
    jm, params, tm, batch = _temporal_pair(kind)
    if kind == "infiller":
        kw = dict(learning_rate=1e-3, milestones=(1,), steps_per_epoch=2)
        jinit, jstep, jval = JL.make_infiller_train_step(jm, **kw)
        tinit, tstep, tval = TL.make_infiller_train_step(tm, **kw)
    else:
        kw = dict(learning_rate=1e-3, lr_decay=0.5, steps_per_epoch=2)
        jinit, jstep, jval = JL.make_smoothnet_train_step(jm, **kw)
        tinit, tstep, tval = TL.make_smoothnet_train_step(tm, **kw)
    js, ts = jinit(params), tinit()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    np.testing.assert_allclose(float(tval(ts, tb)), float(jval(js, jb)),
                               rtol=1e-5)
    for _ in range(3):
        js, jl, jt = jstep(js, jb)
        ts, tl, tt = tstep(ts, tb)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for k in jt:
            np.testing.assert_allclose(float(tt[k]), float(jt[k]),
                                       rtol=1e-5, err_msg=k)
    bad, total = _count_outside(tm.state_dict(), _to_sd(kind, js["params"]),
                                1e-5)
    print(f"{kind}: parameters outside 1e-5 after 3 updates: {bad} of "
          f"{total}")
    assert bad <= 0.001 * total


@pytest.mark.parametrize("kind", ["smoothnet", "infiller"])
def test_dropout_is_active_in_the_port_step(kind):
    """Dropout draws cannot match across frameworks, so this holds the
    port alone: the training step's loss (train mode, before the update)
    differs from the evaluation loss on the same weights, and two runs
    from the same weights and seed draw the same masks."""
    from vistracker_tpu_torch.fit import trainer_loop as TL
    make = (TL.make_infiller_train_step if kind == "infiller"
            else TL.make_smoothnet_train_step)
    losses = []
    for _ in range(2):
        _, _, tm, batch = _temporal_pair(kind, dropout=0.3)
        init, step, val = make(tm, learning_rate=1e-3)
        state = init()
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        ev = float(val(state, tb))
        state, tl, _ = step(state, tb)
        losses.append((ev, float(tl)))
    assert losses[0][0] != losses[0][1]
    assert losses[0] == losses[1]


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def _flaky(n_fail):
    def example(i):
        if i < n_fail:
            raise ValueError(f"bad example {i}")
        return {"x": np.full(3, i, np.float32), "i": np.int64(i)}
    return example


def test_prefetch_loader_matches_jax():
    """The same batches in the same order over two epochs, also when
    failing examples are replaced (one worker: the replacement draws are
    then in batch order), and an early stop leaves no producer blocked."""
    import threading
    from vistracker_tpu.data.datasets import PrefetchLoader as JLoader
    from vistracker_tpu_torch.data.datasets import PrefetchLoader as TLoader
    for n_fail, workers in ((0, 3), (3, 1)):
        runs = []
        for cls in (TLoader, JLoader):
            loader = cls(_flaky(n_fail), 13, 3, num_workers=workers, seed=5)
            runs.append([b for _ in range(2) for b in loader])
        assert len(runs[0]) == 8
        for a, b in zip(*runs):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
    loader = TLoader(_flaky(0), 40, 2, num_workers=2)
    before = threading.active_count()
    for bi, _ in enumerate(loader):
        if bi == 1:
            break
    full = list(loader)
    assert len(full) == 20
    for _ in range(100):
        if threading.active_count() <= before:
            break
        import time
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_sifnet_example_matches():
    from test_torch_sampling import _scene
    from vistracker_tpu.data.datasets import sifnet_example as jex
    from vistracker_tpu_torch.data.datasets import sifnet_example as tex
    rng = np.random.RandomState(6)
    sv, sf, ov, of, parts = _scene(rng)
    frame = dict(image=rng.rand(S, S, 8).astype(np.float32),
                 crop_center=np.float32([1000, 800]),
                 body_center=np.float32([0, 0, 2.2]), smpl_verts=sv,
                 smpl_faces=sf, obj_verts=ov, obj_faces=of, visibility=0.7)
    out = tex(frame, parts, num_samples=300, rng=np.random.RandomState(4))
    ref = jex(frame, parts, num_samples=300, rng=np.random.RandomState(4))
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_reexpress_and_drop_masks_match():
    from scipy.spatial.transform import Rotation
    from vistracker_tpu.data import datasets as JD
    from vistracker_tpu_torch.data import datasets as TD
    rng = np.random.RandomState(7)
    poses = rng.randn(5, 72) * 0.3
    trans, roots = rng.randn(5, 3), rng.randn(5, 3)
    R = Rotation.from_rotvec(rng.randn(3)).as_matrix()
    t = rng.randn(3)
    for a, b in zip(TD.reexpress_smpl_in_camera(poses, trans, roots, R, t),
                    JD.reexpress_smpl_in_camera(poses, trans, roots, R, t)):
        np.testing.assert_array_equal(a, b)
    rots = Rotation.from_rotvec(rng.randn(5, 3)).as_matrix()
    for a, b in zip(TD.reexpress_obj_in_camera(rots, trans, R, t),
                    JD.reexpress_obj_in_camera(rots, trans, R, t)):
        np.testing.assert_array_equal(a, b)
    for seed in range(5):
        np.testing.assert_array_equal(
            TD.gen_drop_mask(40, 5, 20, np.random.RandomState(seed)),
            JD.gen_drop_mask(40, 5, 20, np.random.RandomState(seed)))


def test_infiller_clips_match():
    from scipy.spatial.transform import Rotation
    from vistracker_tpu.data.datasets import InfillerClips as JC
    from vistracker_tpu_torch.data.datasets import InfillerClips as TC
    rng = np.random.RandomState(8)
    seqs = [dict(poses=(rng.randn(T, 156) * 0.2).astype(np.float32),
                 trans=rng.randn(T, 3).astype(np.float32),
                 obj_rot_real=Rotation.from_rotvec(
                     rng.randn(T, 3) * 0.3).as_matrix().astype(np.float32))
            for T in (30, 12, 26)]
    tc, jc = TC(seqs, clip_len=20, min_drop=3, max_drop=9), \
        JC(seqs, clip_len=20, min_drop=3, max_drop=9)
    assert len(tc) == len(jc) == 11 + 7
    for i in (0, 5, 17):
        a, b = tc.example(i), jc.example(i)
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_allclose(a[k], b[k], atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the loop, checkpoints and the command lines
# ---------------------------------------------------------------------------

def _loop_parts(tmp_path):
    from vistracker_tpu_torch.data.datasets import PrefetchLoader
    from vistracker_tpu_torch.fit.train import (TrainConfig,
                                                init_train_state,
                                                make_train_step, sifnet_loss)
    _, tc = _cfgs("chore-triplane-vis", True, 1)
    net = TNet(tc, TCam(crop_size=CROP))
    tcfg = TrainConfig()
    batch = _batch(9)
    loader = PrefetchLoader(lambda i: {k: v[i % B] for k, v in batch.items()},
                            4, B, num_workers=1)
    to_dev = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    return (init_train_state(net, tcfg), make_train_step(net, tcfg), loader,
            lambda st, b: sifnet_loss(st.model, b, tcfg)[0], to_dev, tc)


def test_checkpoints_resume_and_find_checkpoint(tmp_path, capsys):
    """Checkpoints in the reference layout, a resumed run that goes on
    from the saved step, find_checkpoint picking the best model, and the
    weights `track`'s loader takes from it."""
    from vistracker_tpu_torch.cli.real_track import _load_net
    from vistracker_tpu_torch.fit.trainer_loop import LoopConfig, train_loop
    from vistracker_tpu_torch.models.weights import find_checkpoint
    out = str(tmp_path / "exp")
    state, step, loader, val, to_dev, tc = _loop_parts(tmp_path)
    state = train_loop(state, step, loader, val_loader=loader,
                       val_loss_fn=val, to_device=to_dev,
                       cfg=LoopConfig(num_epochs=2, out_dir=out,
                                      ck_period_min=1e9))
    assert state.step == 4
    tars = sorted(os.listdir(os.path.join(out, "checkpoints")))
    assert len(tars) == 2 and all(t.startswith("checkpoint_") for t in tars)
    best = json.load(open(os.path.join(out, "best_model.json")))
    vm = [f for f in os.listdir(out) if f.startswith("val_min=")]
    assert len(vm) == 1
    rec = np.load(os.path.join(out, vm[0]), allow_pickle=True)
    assert rec[2] == best["ck_file"]
    assert find_checkpoint(out) == os.path.join(out, "checkpoints",
                                                best["ck_file"])
    ck = torch.load(find_checkpoint(out), weights_only=False)
    assert ck["step"] == best["step"]

    # resume: a fresh state continues from the newest checkpoint
    state2, step2, loader2, val2, to_dev2, _ = _loop_parts(tmp_path)
    capsys.readouterr()
    state2 = train_loop(state2, step2, loader2, val_loader=loader2,
                        val_loss_fn=val2, to_device=to_dev2,
                        cfg=LoopConfig(num_epochs=3, out_dir=out,
                                       ck_period_min=1e9,
                                       keep_checkpoints=2))
    assert "resumed from step 4" in capsys.readouterr().out
    assert state2.step == 4 + 3 * 2
    assert len(os.listdir(os.path.join(out, "checkpoints"))) <= 3

    # track's loader takes the best checkpoint's weights
    net = _load_net(TNet(tpreset("tiny")), out, 0, torch.device("cpu"))
    ck = torch.load(find_checkpoint(out), weights_only=False)
    for k, v in net.state_dict().items():
        assert torch.equal(v, ck["model_state_dict"][k]), k


def test_epoch_ck_period_cadence(tmp_path):
    """epoch_ck_period=N checkpoints and validates every N epochs and
    always after the last (the JAX package's cadence)."""
    from vistracker_tpu_torch.data.datasets import PrefetchLoader
    from vistracker_tpu_torch.fit.train import adam
    from vistracker_tpu_torch.fit.trainer_loop import LoopConfig, train_loop

    def step_fn(state, batch):
        state.step += 1
        return state, torch.tensor(1.0), {}

    loader = PrefetchLoader(lambda i: {"x": np.zeros(2, np.float32)}, 4,
                            batch_size=2, num_workers=1)

    def run(period, epochs, out):
        state = adam(torch.nn.Linear(2, 1), lambda i: 1e-3)
        train_loop(state, step_fn, loader, val_loader=loader,
                   val_loss_fn=lambda st, b: torch.tensor(2.0),
                   cfg=LoopConfig(num_epochs=epochs, ck_period_min=1e9,
                                  epoch_ck_period=period, out_dir=str(out),
                                  max_val_batches=1),
                   to_device=lambda b: b)
        recs = [json.loads(l) for l in open(out / "metrics.jsonl")]
        return [r["step"] for r in recs if "val_loss" in r]

    assert run(1, 3, tmp_path / "p1") == [2, 4, 6]
    assert run(2, 5, tmp_path / "p2") == [4, 8, 10]
    assert run(10, 3, tmp_path / "p10") == [6]


def test_config_mappings_match(tmp_path):
    from vistracker_tpu import config as JCfg
    from vistracker_tpu_torch import config as TCfg
    tri = tmp_path / "tri-vis-l2.json"
    tri.write_text(
        "{\n// the release SIF-Net\n\"num_stack\": 3, \"num_hourglass\": 2,"
        " \"hourglass_dim\": 256, \"tmpx_dim\": 64,\n"
        "\"triplane_encoder_stack\": 3, \"triplane_hg_dim\": 64,\n"
        "\"triplane_tmpx_dim\": 32, \"triplane_shared_encoder\": false,\n"
        "\"hidden_dim\": 128, \"z_0\": 2.2, \"loadSize\": 1200,\n"
        "  // clamp\n\"clamp_thres\": 0.1, \"learning_rate\": 0.001,\n"
        "\"milestones\": [15, 25],\n"
        "\"loss_weights\": [1.0, 1.0, 0.006, 500, 1000, 1000]}\n")
    cmf = tmp_path / "cmf-k4-lrot.json"
    cmf.write_text(json.dumps(dict(
        dim_smpl=147, dim_obj=6, d_model_smpl=128, num_layers_joint=4,
        num_heads_joint=1, hidden_dims=[32], clip_len=180, window=1,
        pre_norm_joint=False, unused_key=3)))
    cam = tmp_path / "cam.json"
    cam.write_text(json.dumps(dict(loadSize=800, camera_params=dict(
        fx=900.0, fy=901.0, cx=950.0, cy=530.0))))
    for path, fn in ((tri, "sifnet_config_from_json"),
                     (tri, "train_config_from_json"),
                     (cmf, "infiller_config_from_json"),
                     (cam, "camera_config_from_json"),
                     (tri, "camera_config_from_json")):
        out = getattr(TCfg, fn)(TCfg.load_reference_json(str(path)))
        ref = getattr(JCfg, fn)(JCfg.load_reference_json(str(path)))
        for f in dataclasses.fields(out):
            assert getattr(out, f.name) == getattr(ref, f.name), (fn, f.name)
    assert TCfg.sifnet_config_from_json(
        TCfg.load_reference_json(str(tri))).feature_size == 611


def test_train_cli_flags_match_the_jax_parser():
    """The four subcommands carry the JAX flags and defaults; --device
    stands in for --cpu (boundary-sample gains it: it runs LBS on the
    device); train-sifnet also has --dist-backend, the torch.distributed
    backend of a data-parallel launch."""
    import argparse
    from vistracker_tpu.cli.main import build_parser as jax_parser
    from vistracker_tpu_torch.cli.main import build_parser

    def defaults(parser, cmd):
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {a.dest: a.default for a in sub.choices[cmd]._actions}

    for cmd in ("train-sifnet", "boundary-sample", "train-smoothnet",
                "train-infiller"):
        port, ref = defaults(build_parser(), cmd), defaults(jax_parser(), cmd)
        assert set(port) - set(ref) == ({"device", "dist_backend"}
                                        if cmd == "train-sifnet"
                                        else {"device"}), cmd
        assert set(ref) - set(port) <= {"cpu"}, cmd
        assert port["device"] == "cuda"
        for k, v in ref.items():
            if k != "cpu":
                assert port[k] == v, (cmd, k)


def test_train_cli_refuses_without_a_gpu(monkeypatch):
    from vistracker_tpu_torch.cli.main import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in ("train-sifnet", "train-smoothnet", "train-infiller"):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main([cmd, "--synthetic", "--out", "unused"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["boundary-sample", "--seq", "s", "--gt-pack", "g",
              "--smpl-model", "m", "--assets", "a", "--objects-root", "o",
              "--out", "unused"])


def test_anomaly_option(tmp_path):
    """debug_nans turns autograd's anomaly detection on for every step of
    the loop, and off again after it."""
    from vistracker_tpu_torch.data.datasets import PrefetchLoader
    from vistracker_tpu_torch.fit.train import adam
    from vistracker_tpu_torch.fit.trainer_loop import LoopConfig, train_loop
    seen = []

    def step_fn(state, batch):
        seen.append(torch.is_anomaly_enabled())
        loss = state.model(torch.as_tensor(batch["x"])).sum()
        state.update(loss)
        return state, loss.detach(), {}

    loader = PrefetchLoader(lambda i: {"x": np.ones(2, np.float32)}, 8,
                            batch_size=2, num_workers=1)
    state = adam(torch.nn.Linear(2, 1), lambda i: 1e-3)
    train_loop(state, step_fn, loader,
               cfg=LoopConfig(num_epochs=1, ck_period_min=1e9,
                              out_dir=str(tmp_path), debug_nans=True))
    assert seen == [True] * 4 and not torch.is_anomaly_enabled()


def test_train_smoothnet_and_infiller_cli(tmp_path, capsys):
    from vistracker_tpu_torch.cli.main import main
    for variant in ("smpl", "objrot"):
        main(["train-smoothnet", "--synthetic", "--device", "cpu",
              "--variant", variant, "--frames", "40", "--window", "16",
              "--batch-size", "8", "--epochs", "1",
              "--out", str(tmp_path / variant)])
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert res["steps"] == 25 // 8
        assert np.isfinite([res["noisy_l1"], res["denoised_l1"]]).all()
    main(["train-infiller", "--synthetic", "--device", "cpu", "--frames",
          "36", "--clip-len", "20", "--batch-size", "4", "--epochs", "2",
          "--out", str(tmp_path / "inf")])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["steps"] == 2 * (17 // 4)
    assert np.isfinite([res["downstream_chamfer_cm"],
                        res["downstream_v2v_cm"]]).all()
    recs = [json.loads(l) for l in open(tmp_path / "inf" / "metrics.jsonl")]
    assert sum("downstream_v2v_cm" in r for r in recs) == 2
    best = json.load(open(tmp_path / "inf" / "best_model.json"))
    assert best["val_loss"] == min(r["downstream_v2v_cm"] for r in recs
                                   if "downstream_v2v_cm" in r)


def test_train_sifnet_synthetic_checkpoint_loads_into_track(tmp_path, rng,
                                                            monkeypatch):
    """`train-sifnet --synthetic` at tiny sizes, then `track --neural-only
    --net-preset tiny --sifnet-ckpt <its out>` on the CPU: the weights
    track loads are those of the checkpoint find_checkpoint picks."""
    import functools
    import vistracker_tpu_torch.cli.real_track as rt
    import vistracker_tpu_torch.fit.generator as tgen
    import vistracker_tpu_torch.fit.smplt as tsmplt
    from test_torch_track import GEN_KW, SMALL_FUNNEL, _fixture
    from vistracker_tpu_torch.cli.main import build_parser, main
    from vistracker_tpu_torch.data.packed import load_packed
    from vistracker_tpu_torch.models.weights import find_checkpoint
    out = str(tmp_path / "sifnet")
    main(["train-sifnet", "--synthetic", "--device", "cpu", "--frames", "4",
          "--image-size", "32", "--samples", "96", "--batch-size", "2",
          "--epochs", "1", "--out", out])
    ck = torch.load(find_checkpoint(out), weights_only=False)
    assert ck["step"] == 2
    seq, assets, smpl_pkl = _fixture(tmp_path, rng, T=2)
    loaded = []
    load_net = rt._load_net

    def spy(model, ckpt, *a, **k):
        net = load_net(model, ckpt, *a, **k)
        if ckpt == out:
            loaded.append({k: v.clone() for k, v in net.state_dict().items()})
        return net

    monkeypatch.setattr(rt, "_load_net", spy)
    monkeypatch.setattr(tgen, "GeneratorConfig", functools.partial(
        tgen.GeneratorConfig, **GEN_KW))
    monkeypatch.setattr(tgen, "FUNNEL_DEFAULT", SMALL_FUNNEL)
    orig = tsmplt.SMPLTFitConfig
    monkeypatch.setattr(tsmplt, "SMPLTFitConfig",
                        lambda *a, **k: orig(global_iters=1, max_iters=2))
    summary = rt.run_real_track(build_parser().parse_args([
        "track", "--seq", seq, "--out", str(tmp_path / "track"),
        "--smpl-model", smpl_pkl, "--assets", assets, "--sifnet-ckpt", out,
        "--net-preset", "tiny", "--neural-only", "--device", "cpu",
        "--net-size", "32", "--crop-size", "96"]))
    assert len(loaded) == 1
    for k, v in loaded[0].items():
        assert torch.equal(v, ck["model_state_dict"][k]), k
    packed = load_packed(summary["packed"])
    for k in ("neural_pca", "neural_trans", "neural_visibility"):
        assert np.isfinite(np.asarray(packed[k], np.float64)).all(), k
