"""Driver of the `train` cells: the port's SIF-Net training step,
fit/train.py:make_train_step over init_train_state (the step that
`train-sifnet` and fit/trainer_loop.py run), on seeded batches made on
the card (portbench/traffic/sifnet_batch.py).

Set-up builds one model and its Adam state from the seed (weights drawn
on the card by the reference's parameter list), makes the cell's batches
and drives the first three steps on three different batches: they are
the warm-up, and what the check reads. The window then goes on with the
same step and state, cycling through the batches, each step synchronised;
a new step starts only while the mean so far says it ends within the
window.

What is checked, after the window with the program freed: the
reference (portbench/reference/sifnet.py, float32, its own Adam) follows
the same three steps from the same weights and batches; compared are
each step's loss, each leaf's gradient norm at step 1 (the program's
from its Adam state: exp_avg / (1 - beta1)), and each leaf's change
after step 3, both by the worst leaf against the larger of the leaf's
reference norm and the median leaf's. Leaves whose reference gradient
is under a thousandth of the median leaf's move by round-off alone under
Adam and are left out of the change.
"""
from __future__ import annotations

import gc
import statistics
import time

import torch

from portbench import counters
from portbench import weights as W
from portbench.reference import sifnet as RS
from portbench.traffic.sifnet_batch import sifnet_batch

CHECKED_STEPS = 3
BETA1 = 0.9
FREEZE_RULE = 1e-3  # a leaf's reference gradient under this x the median


def batches(ctx, count: int) -> list:
    wl, cfg = ctx.workload, ctx.config
    gen = torch.Generator(device=ctx.device).manual_seed(
        W.net_seed(ctx.seed, 1))
    return [sifnet_batch(gen, wl["batch"], wl["points"], wl["size"],
                         cfg["sifnet"]["num_parts"], ctx.device)
            for _ in range(count)]


def weights(ctx) -> dict:
    return W.make(RS.param_spec(ctx.config["sifnet"]),
                  W.net_seed(ctx.seed, 0), ctx.device)


def program(ctx):
    """(model, state, step) of the port, weights from the seed."""
    from vistracker_tpu_torch.core.camera import PerspectiveCamera
    from vistracker_tpu_torch.fit.train import (TrainConfig,
                                                init_train_state,
                                                make_train_step)
    from vistracker_tpu_torch.models.sifnet import SIFNet, sifnet_preset

    sc = ctx.config["sifnet"]
    with torch.device(ctx.device):
        model = SIFNet(sifnet_preset(ctx.config["net_preset"],
                                     crop_size=sc["crop_size"],
                                     remat=ctx.config["remat"]),
                       PerspectiveCamera(crop_size=sc["crop_size"]))
    p = weights(ctx)
    p.update({a: p[n] for a, n in RS.aliases(list(p)).items()})
    model.load_state_dict(p)
    del p
    tcfg = TrainConfig()
    return model, init_train_state(model, tcfg), make_train_step(model,
                                                                 tcfg)


def norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def changes(params: dict, ctx) -> dict:
    """Each leaf's change from the seed's weights (drawn again)."""
    p0 = weights(ctx)
    return {k: float((v.detach() - p0[k]).double().norm())
            for k, v in params.items()}


def program_readings(state, step, data, ctx) -> dict:
    losses, grads = [], {}
    for i in range(CHECKED_STEPS):
        state, loss, _ = step(state, data[i])
        losses.append(float(loss))
        if i == 0:
            opt = state.optimizer.state
            grads = {n: (float(opt[p]["exp_avg"].double().norm()) / (1 - BETA1)
                         if p in opt else 0.0)
                     for n, p in state.model.named_parameters()}
    return dict(loss=losses, grad=grads,
                change=changes(dict(state.model.named_parameters()), ctx))


def reference_readings(ctx, lower: bool = False) -> dict:
    """The reference through the same steps; with lower in TF32 (the
    control)."""
    import contextlib
    sc, lr = ctx.config["sifnet"], ctx.config["learning_rate"]
    p = {k: v.requires_grad_(True) for k, v in weights(ctx).items()}
    adam = RS.Adam(p, lr)
    losses, grads = [], {}
    with RS.lowered() if lower else contextlib.nullcontext():
        for i, batch in enumerate(batches(ctx, CHECKED_STEPS)):
            loss, _ = RS.training_loss(p, sc, batch)
            g = torch.autograd.grad(loss, list(p.values()))
            losses.append(float(loss.detach()))
            if i == 0:
                grads = norms(dict(zip(p, g)))
            adam.step(dict(zip(p, g)))
            del loss, g
    return dict(loss=losses, grad=grads, change=changes(p, ctx))


def gaps(got: dict, ref: dict) -> dict:
    """Per step, |loss - ref| / |ref|; per leaf, the gap of gradient
    norms and of change norms, each over the larger of the leaf's
    reference norm and the median leaf's (the change over the leaves the
    freeze rule keeps)."""
    med_g = statistics.median(ref["grad"].values())
    moved = [k for k, g in ref["grad"].items() if g >= FREEZE_RULE * med_g]
    med_c = statistics.median(ref["change"][k] for k in moved)
    return dict(
        loss=[abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"])],
        grad={k: abs(got["grad"][k] - g) / max(g, med_g)
              for k, g in ref["grad"].items()},
        change={k: abs(got["change"][k] - ref["change"][k])
                / max(ref["change"][k], med_c) for k in moved})


def compare(got: dict, ref: dict) -> dict:
    """loss_gap: the worst step's loss gap; grad_gap and update_gap: the
    worst leaf's."""
    g = gaps(got, ref)
    return dict(loss_gap=max(g["loss"]), grad_gap=max(g["grad"].values()),
                update_gap=max(g["change"].values()))


def detail(got: dict, ref: dict) -> dict:
    """What the control script prints to set the limits from: each
    step's loss gap, and the quartiles and worst of the leaves' gaps."""
    g = gaps(got, ref)
    out = {"loss_steps": g["loss"]}
    for k in ("grad", "change"):
        v = sorted(g[k].values())
        worst = max(g[k], key=g[k].get)
        out[k] = {"q": statistics.quantiles(v, n=4), "max": v[-1],
                  "worst": worst, "ref_norm": ref[k][worst]}
    return out


def run(ctx):
    """One run of a train cell; fills ctx.record."""
    wl, device = ctx.workload, ctx.device
    tf32 = ctx.config["precision"]["tf32"]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    cuda = device.startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    model, state, step = program(ctx)
    step = ctx.span("training step", step)
    data = batches(ctx, wl["batches"])
    got = program_readings(state, step, data, ctx)
    n = CHECKED_STEPS
    with ctx.window():
        t0, steps = time.perf_counter(), 0
        while True:
            state, _, _ = step(state, data[n % len(data)])
            n, steps = n + 1, steps + 1
            sync()
            spent = time.perf_counter() - t0
            if spent + spent / steps > ctx.seconds:
                break
    rec = ctx.record
    rec.update(units=steps, examples=steps * wl["batch"],
               flops=steps * counters.train_step_flops(
                   ctx.config["sifnet"], wl["batch"], wl["points"],
                   wl["size"]))
    del model, state, step, data
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_readings(ctx)
    found = compare(got, ref)
    if ctx.control:
        low = reference_readings(ctx, lower=True)
        rec["control"] = compare(low, ref)
        rec["detail"] = {"program": detail(got, ref),
                         "control": detail(low, ref)}
    rec["found"] = found
    kept = len(gaps(got, ref)["change"])
    print(f"portbench: {steps} steps of {wl['batch']} in "
          f"{rec['window_s']:.3f} s; losses {got['loss']}; the freeze rule "
          f"kept {kept} of {len(ref['grad'])} leaves", flush=True)
