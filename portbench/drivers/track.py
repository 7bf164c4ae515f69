"""Driver of the `track` cells: the port's whole `track` (or `track
--neural-only`) through its entry point, cli/main.py's parser into
cli/real_track.py:run_real_track with an in-memory reader, on a sequence
made from the seed (portbench/traffic/fabricate.py).

Set-up: the sequence and its assets; every network's weights drawn on
the card from the seed (SIF-Net's by the reference's parameter list);
one warm-up call on the same clip at the warm-up budgets of the cell,
which builds the kernels and meets every shape of the timed calls.
Window: whole calls back to back; a new call starts only while the mean
of the calls so far says it ends within the window; at least one call.
The calls of a window do the same work, and the first is the one
sampled: its samples are copied to the host as they are taken.

What is checked, after the window with the program's state freed (every
number named in the cell's limits; one that finds nothing to read is
NaN and fails):
- the Adam steps each fit ran in every call, against the configuration's
  budgets (steps_missing);
- stage 1: the first steps of the first SMPL-T fit, followed by the
  reference from a start it works out from the sequence alone
  (stage1_loss_gap: the losses before each of the first 4 steps, so
  every step's update counts);
- stage 6a: the first steps of the SMPL fit's first phase, followed by
  the reference from the fit's start (the program's: stages 1-2's
  output, smoothed) on SIF-Net features the reference encodes from the
  program's inputs (stage6a_loss_gap);
- stage 6b: the first steps of the object fit's object phase, followed
  by the reference from the fit's start (the program's, stage 5's
  output) on the same kind of features (stage6_loss_gap);
- the host inputs: the crop of sampled frames against the reference
  crop of the raw frame (crop_gap);
- SIF-Net: the encode of a sampled frame, and sampled queries on the
  reference's features of their frame (encode_gap, query_gap);
- kernels K1 hard and soft, K2 and K3 at sampled launches, on the
  launch's own inputs (k1_hard_mismatch, k1_soft_mismatch, k2_gap,
  k3_mismatch);
- that no fit of the sampled call returned its start unchanged
  (unmoved_fits: stage 1's fit and refit, 6a's SMPL fit, 6b's
  translation);
- the last call's pack: shapes, finiteness, visibilities in [0, 1],
  proper rotations (pack_faults).
"""
from __future__ import annotations

import contextlib
import functools
import gc
import inspect
import math
import os
import random
import time
import zlib
from unittest import mock

import numpy as np
import torch

from portbench import counters
from portbench import weights as W
from portbench.reference import crop as RC
from portbench.reference import fits as RF
from portbench.reference import kernels as RK
from portbench.reference import sifnet as RS
from portbench.traffic.fabricate import fabricate

KERNELS = ("k1_hard", "k1_soft", "k2", "k3")
FOLLOWED = 4  # losses of a fit's trace the reference follows


class Reservoir:
    """k items drawn uniformly from a stream of unknown length; make()
    is called only for an item that is kept."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, make):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
        elif self.rng.random() < self.k / self.seen:
            self.items[self.rng.randrange(self.k)] = make()


class Capture:
    """Samples of the first timed call, drawn from the seed while `on`:
    kernel launches and queries (reservoirs over the call's stream), the
    encoded input images of every frame (stage 6 is followed on all of
    them) or of the sampled frames, one frame's encode, and the fits'
    starts and first losses. Everything kept is on the host."""

    def __init__(self, seed: int, sample: dict, frames: int,
                 all_rows: bool):
        self.rng = random.Random(seed)
        self.sample, self.on, self.frames = sample, False, frames
        self.res = {k: Reservoir(v["launches"], self.rng)
                    for k, v in sample.items() if k != "frames"}
        self.rows = sorted(self.rng.sample(range(frames),
                                           min(sample["frames"], frames)))
        self.all_rows = all_rows
        self.images, self.encoded, self.encode = {}, 0, None
        self.fits, self.unmoved = {}, 0

    def pick(self, kind: str, n: int) -> list:
        want = min(self.sample[kind].get("rows", n), n)
        return sorted(self.rng.sample(range(n), want))

    def offer(self, kind: str, make):
        if self.on and kind in self.res:
            self.res[kind].offer(make)


def _host(t, rows=None):
    t = t.detach()
    return (t.cpu() if rows is None
            else torch.stack([t[r].cpu() for r in rows]))


def _views(active, B, rows):
    per = active.shape[0] // B
    return torch.cat([active[r * per:(r + 1) * per].detach().cpu()
                      for r in rows])


def kernel_spies(stack, cap: Capture, launches: dict, sil_size: int,
                 k3_calls: list):
    """Wrap the kernels' Python entries (ops/coverage.py max_logit_fwd
    and max_logit_bwd, ops/label_nn.py label_nn_fwd) to count launches
    and hand samples of their inputs and outputs to `cap`. K1's
    silhouette launches are those at the silhouette's size."""
    from vistracker_tpu_torch.ops import coverage as cov
    from vistracker_tpu_torch.ops import label_nn as lnn

    fwd0, bwd0, nn0 = cov.max_logit_fwd, cov.max_logit_bwd, lnn.label_nn_fwd

    def fwd(cpl, active, size):
        m, cnt = fwd0(cpl, active, size)
        kind = "k1_soft" if size == sil_size else "k1_hard"
        launches[kind] += 1

        def make():
            rows = cap.pick(kind, cpl.shape[0])
            return dict(cpl=_host(cpl, rows), size=size,
                        active=_views(active, cpl.shape[0], rows),
                        m=_host(m, rows), cnt=_host(cnt, rows))
        cap.offer(kind, make)
        return m, cnt

    def bwd(cpl, active, m, gw, size):
        dc = bwd0(cpl, active, m, gw, size)
        launches["k2"] += 1

        def make():
            rows = cap.pick("k2", cpl.shape[0])
            return dict(cpl=_host(cpl, rows), size=size,
                        active=_views(active, cpl.shape[0], rows),
                        m=_host(m, rows), gw=_host(gw, rows),
                        dc=_host(dc, rows))
        cap.offer("k2", make)
        return dc

    def nn(x, labels_x, y, labels_y, y_valid, plan=None):
        d, i = nn0(x, labels_x, y, labels_y, y_valid, plan)
        launches["k3"] += 1
        if cap.on:
            k3_calls.append((labels_x, labels_y, y_valid,
                             x.numel() * x.element_size()
                             + y.numel() * y.element_size()))

        def make():
            rows = cap.pick("k3", x.shape[0])
            return {k: _host(v, rows) for k, v in dict(
                x=x, lx=labels_x, y=y, ly=labels_y, yv=y_valid, d=d,
                i=i).items()}
        cap.offer("k3", make)
        return d, i

    # the entries count their launches on the module's names
    fwd.launches = bwd.launches = nn.launches = 0
    stack.enter_context(mock.patch.object(cov, "max_logit_fwd", fwd))
    stack.enter_context(mock.patch.object(cov, "max_logit_bwd", bwd))
    stack.enter_context(mock.patch.object(lnn, "label_nn_fwd", nn))


def _cache_rows(cache: dict, b: int) -> dict:
    one = slice(b, b + 1)
    return dict(rgb_feats=[_host(f[one]) for f in cache["rgb_feats"]],
                tmpx=_host(cache["tmpx"][one]),
                tp_feats=[[_host(f[one]) for f in v]
                          for v in cache["tp_feats"]],
                tp_tmpx=[_host(t[one]) for t in cache["tp_tmpx"]])


def sifnet_spies(net, cap: Capture, tally: dict, cfg: dict):
    """Wrap one SIFNet's encode and query methods (instance attributes,
    set before the program binds them) to count frames encoded and
    decoder FLOPs at the net's boundary, to keep the encoded images and
    one frame's encode, and to sample queries."""
    enc0, q0 = net.encode, net.query
    qh0, qd0 = net.query_heads, net.query_df
    per_head = {h: counters.head_flops(cfg, h) for h in RS.HEADS}

    def tally_query(points, heads, stacks=1):
        grad = torch.is_grad_enabled() and points.requires_grad
        n = points.shape[0] * points.shape[1]
        # a query differentiated w.r.t. its points costs its forward
        # again for the input gradients (the weights are frozen)
        tally["query_flops"] += ((2 if grad else 1) * n * stacks
                                 * sum(per_head[h] for h in heads))

    def offer_query(points, cc, bc, out: dict):
        B = points.shape[0]
        base = cap.encoded - B  # the rows of the pass being queried

        def make():
            b = cap.rng.choice([r for r in cap.rows if r < B])
            return dict(row=base + b, points=_host(points[b]),
                        cc=_host(cc[b]), bc=_host(bc[b]),
                        out={h: _host(v[b]) for h, v in out.items()})
        cap.offer("query", make)

    def encode(images, train=False):
        cache = enc0(images, train=train)
        B = images.shape[0]
        tally["encoded_frames"] += B
        if cap.on:
            rows = range(cap.encoded, cap.encoded + B)
            keep = [b for b, r in enumerate(rows)
                    if cap.all_rows or r % cap.frames in cap.rows]
            if cap.all_rows:
                host = _host(images)
                cap.images.update({rows[b]: host[b] for b in keep})
            else:
                cap.images.update({rows[b]: _host(images[b]) for b in keep})
            if cap.encode is None and cap.rows[0] in rows:
                b = cap.rows[0] - cap.encoded
                cap.encode = dict(row=cap.rows[0],
                                  cache=_cache_rows(cache, b))
            cap.encoded += B
        return cache

    def query(cache, points, cc, bc):
        out = q0(cache, points, cc, bc)
        tally_query(points, RS.HEADS, len(out))
        offer_query(points, cc, bc, out[-1])
        return out

    def query_heads(cache, points, cc, bc, heads=("df",)):
        out = qh0(cache, points, cc, bc, heads=heads)
        tally_query(points, heads)
        offer_query(points, cc, bc, out)
        return out

    def query_df(cache, points, cc, bc):
        out = qd0(cache, points, cc, bc)
        tally_query(points, ("df",))
        offer_query(points, cc, bc, {"df": out})
        return out

    net.encode, net.query = encode, query
    net.query_heads, net.query_df = query_heads, query_df


def sifnet_weights(cfg: dict, seed: int, device) -> dict:
    """SIF-Net's weights from the seed by the reference's parameter
    list, with the checkpoint's alias names."""
    p = W.make(RS.param_spec(cfg), W.net_seed(seed, 0), device)
    p.update({a: p[n] for a, n in RS.aliases(list(p)).items()})
    return p


def load_net_spy(stack, seed: int, cfg: dict, cap, tally, ctx):
    """cli/real_track.py:_load_net with the benchmark's weights: every
    network drawn on its device from the run's seed (SIF-Net's loaded
    through load_state_dict, strict), eval mode, no gradients."""
    from vistracker_tpu_torch.cli import real_track
    from vistracker_tpu_torch.models.sifnet import SIFNet

    def load_net(model, ckpt, seed_arg, device, smoothnet=False):
        model = model.to(device)
        if isinstance(model, SIFNet):
            model.load_state_dict(sifnet_weights(cfg["sifnet"], seed,
                                                 device))
            sifnet_spies(model, cap, tally, cfg["sifnet"])
            model.encode = ctx.span("stage 4: encode", model.encode)
        else:
            salt = zlib.crc32(type(model).__name__.encode())
            W.fill_(model, W.net_seed(seed, salt))
        return model.eval().requires_grad_(False)
    stack.enter_context(mock.patch.object(real_track, "_load_net",
                                          load_net))


def _unmoved(before: list, after: list) -> int:
    """1 where a fit returned its start unchanged."""
    return int(all(torch.equal(a, b) for a, b in zip(before, after)))


def fit_spies(stack, tally: dict, cap: Capture, ctx):
    """Count the Adam steps of every fit by the loss trace it returns
    (fit/smplt.py fit_smplt: stage 1, and the stage-2 refit that skips
    the global phase; the optimizers fit/joint.py makes: stage 6a's
    SMPL fit and 6b's object fit), and, in the sampled call, keep the
    first losses of stage 1's fit and the start and first losses of 6a's
    SMPL fit and of the object fit."""
    from vistracker_tpu_torch.fit import joint as joint_mod
    from vistracker_tpu_torch.fit import smplt as smplt_mod
    fit0 = smplt_mod.fit_smplt
    make_smpl0 = joint_mod.make_smpl_optimizer
    make_obj0 = joint_mod.make_object_optimizer

    fit_sig = inspect.signature(fit0)

    def fit_smplt(*a, **k):
        arg = fit_sig.bind(*a, **k).arguments
        refit = bool(arg.get("skip_global_phase", False))
        params, trace = fit0(*a, **k)
        tally["refit_steps" if refit else "stage1_steps"] += \
            int(trace.shape[0])
        if cap.on:
            cap.unmoved += _unmoved(arg["init"].leaves(), params.leaves())
        if cap.on and not refit and "stage1" not in cap.fits:
            cap.fits["stage1"] = dict(trace=_host(trace[:FOLLOWED]),
                                      frames=int(arg["kpts"].shape[0]))
        return params, trace

    def make_smpl(*a, **k):
        opt = make_smpl0(*a, **k)
        sig_smpl = inspect.signature(opt)

        @functools.wraps(opt)
        def optimize_smpl(*oa, **ok):
            arg = sig_smpl.bind(*oa, **ok).arguments
            start = None
            if cap.on and "stage6a" not in cap.fits:
                smpl = arg["smpl"]
                B = smpl.trans.shape[0]
                start = {k: _host(getattr(smpl, k)) for k in RF.SMPLT_LEAVES}
                start.update(cc=_host(arg["ctx"]["cc"]),
                             bc=_host(arg["ctx"]["bc"]),
                             rows=list(range(cap.encoded - B, cap.encoded)))
            out = opt(*oa, **ok)
            tally["stage6a_steps"] += int(out[1].shape[0])
            if cap.on:
                cap.unmoved += _unmoved(arg["smpl"].leaves(), out[0].leaves())
            if start is not None:
                cap.fits["stage6a"] = dict(start,
                                           trace=_host(out[1][:FOLLOWED]))
            return out
        return optimize_smpl

    def make_object(*a, **k):
        opt = make_obj0(*a, **k)
        sig = inspect.signature(opt)

        @functools.wraps(opt)
        def optimize_object(*oa, **ok):
            start = None
            if cap.on and "stage6_object" not in cap.fits:
                arg = sig.bind(*oa, **ok).arguments
                B = arg["obj_t"].shape[0]
                start = dict(obj_r=_host(arg["obj_r"]),
                             obj_t=_host(arg["obj_t"]),
                             obj_s=_host(arg["obj_s"]),
                             points=_host(arg["obj_points"]),
                             occ=_host(arg["occ_ratios"]),
                             cc=_host(arg["ctx"]["cc"]),
                             bc=_host(arg["ctx"]["bc"]),
                             rows=list(range(cap.encoded - B, cap.encoded)))
            out = opt(*oa, **ok)
            tally["stage6b_steps"] += int(out[2].shape[0])
            if cap.on:
                arg = sig.bind(*oa, **ok).arguments
                cap.unmoved += _unmoved([arg["obj_t"]], [out[1]])
            if start is not None:
                cap.fits["stage6_object"] = dict(
                    start, trace=_host(out[2][:FOLLOWED]))
            return out
        return optimize_object

    stack.enter_context(mock.patch.object(smplt_mod, "fit_smplt", ctx.span(
        "stage 1 or 2: SMPL-T fit", fit_smplt)))
    stack.enter_context(mock.patch.object(joint_mod, "make_smpl_optimizer",
                                          make_smpl))
    stack.enter_context(mock.patch.object(joint_mod,
                                          "make_object_optimizer",
                                          make_object))


def input_span(stack, ctx):
    """The host inputs' crop as a span (it names the idle gaps), where
    the port still has data/images.py:prepare_input_crop."""
    from vistracker_tpu_torch.data import images
    fn = getattr(images, "prepare_input_crop", None)
    if fn is not None:
        stack.enter_context(mock.patch.object(
            images, "prepare_input_crop", ctx.span("host inputs: crop", fn)))


def assumed_settings(stack, cfg: dict):
    """The settings an untrained SIF-Net needs (the configuration's
    `assumed`; the port's command line has no option for them): a
    surface threshold that keeps surface points, and the infiller's
    occlusion threshold placed inside the run's visibilities so that a
    share of the frames counts as occluded."""
    from vistracker_tpu_torch.fit import generator as gen_mod
    from vistracker_tpu_torch.fit import infill as infill_mod
    stack.enter_context(mock.patch.object(
        gen_mod, "GeneratorConfig", functools.partial(
            gen_mod.GeneratorConfig, **cfg["generator"])))
    make, share = infill_mod.make_infiller, cfg["occluded_share"]

    def make_with_threshold(model, icfg):
        run = make(model, icfg)

        def run_with_threshold(poses, trans, rots, occ):
            n = max(0, min(int(len(occ) * share), len(occ) - icfg.window))
            thr = float(np.sort(np.asarray(occ).reshape(-1))[n])
            return run(poses, trans, rots, occ, occ_thres=thr,
                       init_thres=thr)
        return run_with_threshold
    stack.enter_context(mock.patch.object(infill_mod, "make_infiller",
                                          make_with_threshold))


@contextlib.contextmanager
def budgets(fit: dict, joint: dict):
    """The fits' hyperparameters as the configuration states them (the
    port's `track` has no command-line option for them)."""
    from vistracker_tpu_torch.fit import joint as joint_mod
    from vistracker_tpu_torch.fit import smplt as smplt_mod
    with mock.patch.object(smplt_mod, "SMPLTFitConfig", functools.partial(
            smplt_mod.SMPLTFitConfig, **fit)), \
            mock.patch.object(joint_mod, "JointFitConfig", functools.partial(
                joint_mod.JointFitConfig, **joint)):
        yield


def expected_steps(cfg: dict, wl: dict) -> dict:
    """Adam steps a call runs by the configuration's budgets (stage 6's
    early stop is off): per chunk, stage 1's fit, the refit, 6a's SMPL
    fit, 6b's object fit."""
    chunks = math.ceil(wl["frames"] / wl["chunk"])
    f, j = cfg["fit"], cfg["joint"]
    out = dict.fromkeys(("stage1_steps", "refit_steps", "stage6a_steps",
                         "stage6b_steps"), 0)
    out["stage1_steps"] = chunks * f["max_iters"] * f["steps_per_iter"]
    if not wl["neural_only"]:
        out["refit_steps"] = chunks * cfg["refit_iters"] * f["steps_per_iter"]
        out["stage6a_steps"] = chunks * j["steps_per_iter"] * (
            j["iter_betas"] + j["iter_pose"] + j["iter_kpts"]
            + j["smpl_max_iter"])
        out["stage6b_steps"] = chunks * j["steps_per_iter"] * (
            j["iter_obj"] + j["iter_sil"] + j["joint_max_iter"])
    return out


def k3_bound_s(calls: list) -> float:
    """The least time of the sampled call's K3 launches: each launch's
    compatible pairs x 12 operations at the float32 rate, or both clouds
    read once at the memory rate, the larger (counters.bound)."""
    pairs, total = {}, 0.0
    for lx, ly, yv, nbytes in calls:
        key = (id(lx), id(ly), id(yv))
        if key not in pairs:
            pairs[key] = counters.compatible_pairs(lx, ly, yv)
        total += counters.bound(pairs[key] * counters.K3_OPS_PER_PAIR,
                                nbytes)["bound_ms"] / 1e3
    return total


def pack_faults(packed: dict, T: int, neural_only: bool) -> int:
    """Fields of the pack with a wrong shape, a non-finite value,
    visibilities outside [0, 1] or rotations that are not proper."""
    shapes = dict(poses=(T, 156), betas=(T, 10), trans=(T, 3),
                  neural_pca=(T, 3, 3), neural_trans=(T, 3),
                  neural_visibility=(T,), obj_angles=(T, 3, 3),
                  obj_trans=(T, 3))
    bad = 0
    for k, shape in shapes.items():
        v = np.asarray(packed.get(k, np.zeros(0)), np.float64)
        bad += int(v.shape != shape or not np.isfinite(v).all())
    vis = np.asarray(packed["neural_visibility"])
    bad += int(vis.min() < 0.0 or vis.max() > 1.0)
    if not neural_only:
        r = np.asarray(packed["obj_angles"], np.float64)
        bad += int(np.abs(r @ r.transpose(0, 2, 1) - np.eye(3)).max() > 1e-4
                   or np.abs(np.linalg.det(r) - 1.0).max() > 1e-4)
    return bad


def _gap(got, ref, fill=None) -> float:
    """Largest |got - ref| over the largest |ref|; entries where the
    reference holds `fill` (the df of points outside the crop) do not set
    the scale."""
    got, ref = got.double().to(ref.device), ref.double()
    mag = ref.abs() if fill is None else ref.abs().masked_fill(ref == fill,
                                                               0.0)
    scale = float(mag.max())
    diff = float((got - ref).abs().max())
    return diff / scale if scale > 0 else diff


def _nchw(t):
    return t.permute(0, 3, 1, 2).contiguous()


def _ref_cache(c: dict, device) -> dict:
    return dict(rgb=[_nchw(f).to(device) for f in c["rgb_feats"]],
                tmpx=_nchw(c["tmpx"]).to(device),
                tp=[[_nchw(f).to(device) for f in v] for v in c["tp_feats"]],
                tp_tmpx=[_nchw(t).to(device) for t in c["tp_tmpx"]])


def _join(caches: list) -> dict:
    return dict(rgb=[torch.cat(f) for f in zip(*[c["rgb"] for c in caches])],
                tmpx=torch.cat([c["tmpx"] for c in caches]),
                tp=[[torch.cat(f) for f in zip(*[c["tp"][v] for c in caches])]
                    for v in range(3)],
                tp_tmpx=[torch.cat([c["tp_tmpx"][v] for c in caches])
                         for v in range(3)])


class Reference:
    """The reference's side of the check, with what it works out once:
    SIF-Net's weights and its features of an encoded image row; with
    lower, everything in TF32 (the control)."""

    ENCODE_ROWS = 8

    def __init__(self, ctx, fab: dict, images: dict, lower: bool = False):
        self.ctx, self.cfg, self.fab, self.images = (ctx, ctx.config, fab,
                                                     images)
        self.sc, self.device, self.lower = (ctx.config["sifnet"], ctx.device,
                                            lower)
        self.p = sifnet_weights(self.sc, ctx.seed, ctx.device)
        self.feats = {}

    def scope(self):
        return RS.lowered() if self.lower else contextlib.nullcontext()

    def features(self, rows: list) -> dict:
        """The reference encode of the program's input images at these
        rows (the crop is checked on its own), in blocks of rows."""
        todo = [r for r in rows if r not in self.feats]
        with torch.no_grad(), self.scope():
            for i in range(0, len(todo), self.ENCODE_ROWS):
                blk = todo[i:i + self.ENCODE_ROWS]
                imgs = torch.stack([self.images[r] for r in blk]).to(
                    self.device)
                c = RS.encode(self.p, self.sc, imgs)
                for j, r in enumerate(blk):
                    self.feats[r] = {
                        k: ([[f[j:j + 1] for f in v] for v in c[k]]
                            if k == "tp" else [f[j:j + 1] for f in c[k]]
                            if isinstance(c[k], list) else c[k][j:j + 1])
                        for k in c}
        return _join([self.feats[r] for r in rows])


def _dev(d: dict, device) -> dict:
    return {k: (v.to(device) if torch.is_tensor(v) else v)
            for k, v in d.items()}


def kernel_readings(items: dict, device, control: bool) -> dict:
    """Mismatching outputs of K1 (hard, soft) and K3, K2's largest
    relative gap, the reference run on `device`; with control, the
    reference on TF32 inputs in the program's place."""
    low = RK.tf32 if control else (lambda t: t)
    items = {k: [_dev(it, device) for it in v] for k, v in items.items()}
    out = {}
    for kind in ("k1_hard", "k1_soft"):
        if items.get(kind):
            bad = 0
            for it in items[kind]:
                m_r, c_r = RK.max_logit_fwd(it["cpl"], it["active"],
                                            it["size"])
                m_p, c_p = ((it["m"], it["cnt"]) if not control else
                            RK.max_logit_fwd(low(it["cpl"]), it["active"],
                                             it["size"]))
                bad += int((m_p != m_r).sum()) + int((c_p != c_r).sum())
            out[f"{kind}_mismatch"] = bad
    if items.get("k2"):
        gap = 0.0
        for it in items["k2"]:
            ref = RK.max_logit_bwd(it["cpl"], it["active"], it["m"],
                                   it["gw"], it["size"])
            got = it["dc"] if not control else RK.max_logit_bwd(
                low(it["cpl"]), it["active"], it["m"], it["gw"], it["size"])
            gap = max(gap, _gap(got, ref))
        out["k2_gap"] = gap
    if items.get("k3"):
        bad = 0
        for it in items["k3"]:
            d_r, i_r = RK.label_nn(it["x"], it["lx"], it["y"], it["ly"],
                                   it["yv"])
            d_p, i_p = ((it["d"], it["i"]) if not control else RK.label_nn(
                low(it["x"]), it["lx"], low(it["y"]), it["ly"], it["yv"]))
            bad += int((d_p != d_r).sum()) + int((i_p != i_r).sum())
        out["k3_mismatch"] = bad
    return out


def fit_readings(ref: Reference, fits: dict, fault: str | None = None,
                 low: Reference | None = None) -> dict:
    """The gaps of the fits' first losses to the reference's. With low,
    the reference in TF32 stands in the program's place (the control);
    with a fault, the reference with that fault does: `unchanged`, the
    state never updated; `half_batch`, the loss over the first half of
    the frames."""
    cfg, out, fab = ref.cfg, {}, ref.fab
    frames = slice(None)
    body = RF.load_body(fab["smpl_pkl"], fab["assets"], ref.device)
    if "stage1" in fits:
        n = fits["stage1"]["frames"]
        start = RF.stage1_start(fab, cfg["fit"], n, ref.device)
        want = fits["stage1"]["trace"].tolist()
        steps = len(want)
        r = RF.follow_stage1(body, start, cfg["fit"], steps)
        got = want
        if low is not None:
            with low.scope():
                got = RF.follow_stage1(body, start, cfg["fit"], steps)
        elif fault is not None:
            got = RF.follow_stage1(
                body, start, cfg["fit"], steps,
                frames if fault != "half_batch" else slice(0, n // 2),
                update=fault != "unchanged")
        out["stage1_loss_gap"] = RF.trace_gap(got, r)
    if "stage6a" in fits:
        f = fits["stage6a"]
        start = _dev(f, ref.device)
        labels = RF.part_labels(fab["assets"], body["v_template"].shape[0],
                                ref.device)
        j = cfg["joint"]
        # the losses of the first phase (shape and translation) alone
        want = f["trace"][:j["iter_betas"] * j["steps_per_iter"]].tolist()
        args = (body, labels)
        r = RF.follow_smpl_phase(ref.p, ref.sc, *args, ref.features(f["rows"]),
                                 start, j, len(want))
        got = want
        if low is not None:
            with low.scope():
                got = RF.follow_smpl_phase(low.p, low.sc, *args,
                                           low.features(f["rows"]), start, j,
                                           len(want))
        elif fault is not None:
            B = start["trans"].shape[0]
            got = RF.follow_smpl_phase(
                ref.p, ref.sc, *args, ref.features(f["rows"]), start, j,
                len(want),
                frames if fault != "half_batch" else slice(0, B // 2),
                update=fault != "unchanged")
        out["stage6a_loss_gap"] = RF.trace_gap(got, r)
    if "stage6_object" in fits:
        f = fits["stage6_object"]
        start = _dev(f, ref.device)
        tie = torch.as_tensor(cfg["stage6_rot_tie_break"], device=ref.device)
        want = f["trace"].tolist()
        args = (cfg["joint"], tie, len(want))
        cache = ref.features(f["rows"])
        r = RF.follow_object(ref.p, ref.sc, cache, start, *args)
        got = want
        if low is not None:
            with low.scope():
                got = RF.follow_object(low.p, low.sc, low.features(f["rows"]),
                                       start, *args)
        elif fault is not None:
            B = start["obj_t"].shape[0]
            got = RF.follow_object(
                ref.p, ref.sc, cache, start, *args,
                frames if fault != "half_batch" else slice(0, B // 2),
                update=fault != "unchanged")
        out["stage6_loss_gap"] = RF.trace_gap(got, r)
    return out


def input_readings(ref: Reference, cap_images: dict, rows: list,
                   control: bool) -> dict:
    """crop_gap over the sampled frames' encoded rows (every pass); with
    control, the reference crop in bfloat16 in the program's place."""
    fab, cfg, gap, seen = ref.fab, ref.cfg, 0.0, 0
    T = len(fab["color"])
    for f in rows:
        got_rows = [r for r in cap_images if r % T == f]
        if not got_rows:
            continue
        want, tie, _ = RC.input_crop(
            fab["color"][f], fab["person_mask"][f], fab["obj_mask"][f],
            cfg["crop_size"], cfg["net_size"], ref.device)
        if control:
            got, _, _ = RC.input_crop(
                fab["color"][f], fab["person_mask"][f], fab["obj_mask"][f],
                cfg["crop_size"], cfg["net_size"], ref.device, control=True)
            gap = max(gap, RC.crop_gap(got, want, tie))
        else:
            for r in got_rows:
                gap = max(gap, RC.crop_gap(cap_images[r], want, tie))
        seen += 1
    return {"crop_gap": gap} if seen else {}


def sifnet_readings(ref: Reference, low: Reference | None, encode: dict,
                    queries: list) -> dict:
    """SIF-Net's largest relative gaps: a frame's encode against the
    reference encode of the same image, queries against the reference
    query on the reference's features of their frame; with low, the
    reference in TF32 in the program's place."""
    out, sc = {}, ref.sc
    with torch.no_grad():
        if encode is not None:
            want = ref.features([encode["row"]])
            got = (_ref_cache(encode["cache"], ref.device) if low is None
                   else low.features([encode["row"]]))
            pairs = [(got["rgb"][-1], want["rgb"][-1]),
                     (got["tmpx"], want["tmpx"])]
            for v in range(3):
                pairs += [(got["tp"][v][-1], want["tp"][v][-1]),
                          (got["tp_tmpx"][v], want["tp_tmpx"][v])]
            out["encode_gap"] = max(_gap(a, b) for a, b in pairs)
        gap, seen = 0.0, 0
        for it in queries:
            if it["row"] not in ref.images:
                continue
            heads = tuple(it["out"])
            q = [t[None].to(ref.device) for t in (it["points"], it["cc"],
                                                   it["bc"])]
            want = RS.query(ref.p, sc, ref.features([it["row"]]), *q,
                            heads)[-1]
            got = {h: v[None] for h, v in it["out"].items()}
            if low is not None:
                with low.scope():
                    got = RS.query(low.p, sc, low.features([it["row"]]),
                                   *q, heads)[-1]
            gap = max([gap] + [_gap(got[h], want[h], sc["out_dist"])
                               for h in heads])
            seen += 1
        if seen:
            out["query_gap"] = gap
    return out


def _argv(fab, cfg, wl, out, device):
    mode = ["--neural-only"] if wl["neural_only"] else [
        "--objects-root", fab["objects"], "--infiller-ckpt", "random",
        "--smoothnet-smpl-ckpt", "random", "--smoothnet-objrot-ckpt",
        "random"]
    return ["track", "--seq", fab["seq_name"], "--out", out,
            "--smpl-model", fab["smpl_pkl"], "--assets", fab["assets"],
            "--sifnet-ckpt", "random", "--redo", "--device", device,
            "--net-preset", cfg["net_preset"],
            "--net-size", str(cfg["net_size"]),
            "--crop-size", str(cfg["crop_size"]),
            "--chunk-size", str(wl["chunk"]), *mode]


def check(ctx, fab: dict, cap: Capture) -> dict:
    """The compared numbers, with the program's state freed; with
    ctx.control also the control's and the faults' readings in
    ctx.record."""
    wl, rec = ctx.workload, ctx.record
    items = {k: r.items for k, r in cap.res.items()}
    ref = Reference(ctx, fab, cap.images)
    found = kernel_readings(items, ref.device, control=False)
    found.update(fit_readings(ref, cap.fits))
    found.update(input_readings(ref, cap.images, cap.rows, control=False))
    found.update(sifnet_readings(ref, None, cap.encode,
                                 items.get("query", [])))
    want = expected_steps(ctx.config, wl)
    found["steps_missing"] = sum(abs(rec[k] - rec["units"] * n)
                                 for k, n in want.items())
    if ctx.control:
        low = Reference(ctx, fab, cap.images, lower=True)
        control = kernel_readings(items, ref.device, control=True)
        control.update(fit_readings(ref, cap.fits, low=low))
        control.update(input_readings(ref, cap.images, cap.rows,
                                      control=True))
        control.update(sifnet_readings(ref, low, cap.encode,
                                       items.get("query", [])))
        rec["control"] = control
        rec["faults"] = {f: fit_readings(ref, cap.fits, fault=f)
                         for f in ("unchanged", "half_batch")}
    return found


def run(ctx):
    """One run of a track cell; fills ctx.record."""
    from vistracker_tpu_torch.cli.main import build_parser
    from vistracker_tpu_torch.cli.real_track import run_real_track
    from vistracker_tpu_torch.data.behave import MemoryFrameReader
    from vistracker_tpu_torch.data.packed import load_packed

    cfg, wl, device = ctx.config, ctx.workload, ctx.device
    t_setup = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = cfg["precision"]["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["precision"]["tf32"]
    fab = fabricate(os.path.join(ctx.work, "seq"), wl["frames"], ctx.seed,
                    device, tuple(cfg["body_mesh"]),
                    tuple(cfg["object_mesh"]))
    reader = MemoryFrameReader(
        fab["seq_name"], fab["info"], fab["color"], fab["person_mask"],
        fab["obj_mask"], fab["kpts"], fab["mocap_pose"], fab["mocap_betas"])
    args = build_parser().parse_args(_argv(fab, cfg, wl,
                                           os.path.join(ctx.work, "out"),
                                           device))
    call = ctx.span("track: other host work", run_real_track)
    cap = Capture(ctx.seed, wl["sample"], wl["frames"],
                  all_rows=not wl["neural_only"])
    tally = dict.fromkeys(("encoded_frames", "query_flops", "stage1_steps",
                           "refit_steps", "stage6a_steps", "stage6b_steps"),
                          0)
    launches = dict.fromkeys(KERNELS, 0)
    k3_calls = []
    sync = torch.cuda.synchronize if device.startswith("cuda") else (
        lambda: None)
    rec = ctx.record
    with contextlib.ExitStack() as stack:
        load_net_spy(stack, ctx.seed, cfg, cap, tally, ctx)
        fit_spies(stack, tally, cap, ctx)
        assumed_settings(stack, cfg)
        kernel_spies(stack, cap, launches, cfg["joint"]["sil_size"],
                     k3_calls)
        input_span(stack, ctx)
        t_warm = time.perf_counter()
        with budgets({**cfg["fit"], **wl["warmup"]["fit"]},
                     {**cfg["joint"], **wl["warmup"]["joint"]}):
            run_real_track(args, reader=reader)
        print(f"portbench: set-up: sequence and parser "
              f"{t_warm - t_setup:.3f} s, warm-up call "
              f"{time.perf_counter() - t_warm:.3f} s", flush=True)
        for d in (tally, launches):
            d.update(dict.fromkeys(d, 0))
        secs, summaries = [], []
        with budgets(cfg["fit"], cfg["joint"]), ctx.window():
            t_win = time.perf_counter()
            while True:
                cap.on = not secs
                t0 = time.perf_counter()
                summaries.append(call(args, reader=reader))
                sync()
                secs.append(time.perf_counter() - t0)
                cap.on = False
                spent = time.perf_counter() - t_win
                if spent + sum(secs) / len(secs) > ctx.seconds:
                    break
    packed = load_packed(summaries[-1]["packed"])
    stages = {}
    for s in summaries:
        for k, v in s["stage_seconds"].items():
            stages[k] = stages.get(k, 0.0) + v
    T = wl["frames"]
    encode = counters.encode_flops(cfg["sifnet"], cfg["net_size"])
    rec.update(units=len(secs), frames=T * len(secs),
               call_seconds=sum(secs), stage_seconds=stages,
               flops=tally["encoded_frames"] * encode + tally["query_flops"],
               stage6_steps=tally["stage6a_steps"] + tally["stage6b_steps"],
               **{k: tally[k] for k in ("stage1_steps", "refit_steps",
                                        "stage6a_steps", "stage6b_steps")})
    rec["k3_bound_s"] = k3_bound_s(k3_calls) * len(secs)
    sampled = {k: r.seen for k, r in cap.res.items()}
    del summaries, k3_calls
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    found = check(ctx, fab, cap)
    found["pack_faults"] = pack_faults(packed, T, wl["neural_only"])
    found["unmoved_fits"] = cap.unmoved
    rec["found"] = found
    print(f"portbench: {len(secs)} calls of {T} frames in "
          f"{sum(secs):.3f} s; launches {launches}; sampled in the first "
          f"call {sampled}, frames {cap.rows}, images {len(cap.images)}; "
          f"stage seconds {stages}; steps {tally}", flush=True)
