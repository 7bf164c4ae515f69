"""The epoch loop with checkpoints, resume and best-model tracking, and
the SmoothNet and HVOP-Net training steps.

Port of vistracker_tpu/fit/trainer_loop.py. The loop checkpoints and
runs the validation pass at the end of every `epoch_ck_period`-th epoch
(and always after the last) and every `ck_period_min` minutes; the
validation pass reads at most `max_val_batches` batches; a
`downstream_fn` runs a whole downstream task at each validation point
and can select the best model (`select_on`). Scalars go to
<out_dir>/metrics.jsonl with the JAX package's keys.

Checkpoints are the reference's torch layout, which
models/weights.py:find_checkpoint reads, so `track --sifnet-ckpt <out>`
loads the best model:
  <out>/checkpoints/checkpoint_<h>h:<m>m:<s>s_<training seconds>.tar
      {model_state_dict, optimizer_state_dict, step, epoch,
       training_time};
  <out>/val_min=<epoch>.npy     [epoch, best score, checkpoint file];
  <out>/best_model.json         {step, val_loss, ck_file}.
A run resumes from the newest checkpoint in its folder.
"""
from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import os
import time
from typing import Callable, Iterable

import numpy as np
import torch

from .train import TrainState, adam, piecewise_lr


@dataclasses.dataclass
class LoopConfig:
    num_epochs: int = 80
    ck_period_min: float = 30.0     # checkpoint + validation period, minutes
    epoch_ck_period: int = 1        # checkpoint + validation every N epochs
    max_val_batches: int = 64
    out_dir: str = "experiments/default"
    keep_checkpoints: int = 3
    debug_nans: bool = False        # torch.autograd.set_detect_anomaly
    profile_steps: int = 0          # trace this many steps (torch.profiler)


class MetricLogger:
    """Append-only jsonl log: {"step", "time", scalars...} a line."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")

    def log(self, step: int, **scalars):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def _train_seconds(path: str) -> float:
    try:
        return float(os.path.splitext(os.path.basename(path))[0]
                     .split("_")[-1])
    except ValueError:
        return -1.0


class CheckpointIO:
    """Torch tars named by the cumulative training time, the newest
    `keep` kept (and the best one), plus the best-model records."""

    def __init__(self, out_dir: str, keep: int = 3):
        self.out_dir = out_dir
        self.dir = os.path.join(out_dir, "checkpoints")
        os.makedirs(self.dir, exist_ok=True)
        self.keep = keep
        self.best_file = os.path.join(out_dir, "best_model.json")

    def tars(self) -> list:
        """Checkpoint files, oldest first."""
        return sorted(glob.glob(os.path.join(self.dir, "*.tar")),
                      key=_train_seconds)

    def save(self, state: TrainState, epoch: int,
             training_time: float) -> str:
        """Write a checkpoint; returns its file name."""
        secs = int(training_time)
        name = (f"checkpoint_{secs // 3600}h:{secs % 3600 // 60}m:"
                f"{secs % 60}s_{training_time!r}.tar")
        torch.save({**state.state_dict(), "epoch": int(epoch),
                    "training_time": float(training_time)},
                   os.path.join(self.dir, name))
        best = self.best()
        for old in self.tars()[:-self.keep]:
            if best is None or os.path.basename(old) != best["ck_file"]:
                os.remove(old)
        return name

    def restore_latest(self, state: TrainState):
        """Load the newest checkpoint into `state`; returns (the
        checkpoint dict, its step), (None, None) without one."""
        tars = self.tars()
        if not tars:
            return None, None
        ck = torch.load(tars[-1], map_location="cpu", weights_only=False)
        state.load_state_dict(ck)
        return ck, int(ck["step"])

    def best(self):
        if os.path.isfile(self.best_file):
            with open(self.best_file) as f:
                return json.load(f)
        return None

    def record_best(self, step: int, val_loss: float, ck_file: str,
                    epoch: int) -> bool:
        """Record `ck_file` as the best model if val_loss is the lowest
        so far: best_model.json and a val_min=<epoch>.npy that replaces
        the previous one."""
        best = self.best()
        if best is not None and not val_loss < best["val_loss"]:
            return False
        with open(self.best_file, "w") as f:
            json.dump({"step": int(step), "val_loss": float(val_loss),
                       "ck_file": ck_file}, f)
        for old in glob.glob(os.path.join(self.out_dir, "val_min=*")):
            os.remove(old)
        np.save(os.path.join(self.out_dir, f"val_min={epoch}.npy"),
                np.array([epoch, float(val_loss), ck_file], dtype=object),
                allow_pickle=True)
        return True


def train_loop(state: TrainState, step_fn: Callable, train_loader: Iterable,
               val_loader: Iterable | None = None,
               val_loss_fn: Callable | None = None,
               cfg: LoopConfig = LoopConfig(),
               to_device: Callable | None = None,
               downstream_fn: Callable | None = None,
               select_on: str = "val_loss") -> TrainState:
    """Run the epoch loop: step_fn(state, batch) -> (state, loss, terms),
    val_loss_fn(state, batch) -> scalar, downstream_fn(state, step) ->
    {metric: float} at every validation point (select_on one of its keys
    picks the best model by it instead of the validation loss). Resumes
    from the newest checkpoint in cfg.out_dir. Returns the state."""
    logger = MetricLogger(cfg.out_dir)
    ckio = CheckpointIO(cfg.out_dir, cfg.keep_checkpoints)
    ck, at_step = ckio.restore_latest(state)
    train_time0 = 0.0
    if ck is not None:
        train_time0 = float(ck.get("training_time", 0.0))
        print(f"[train] resumed from step {at_step}")

    def run_val(step):
        """The best-model score (lower is better), or None."""
        val = None
        if val_loader is not None and val_loss_fn is not None:
            losses = []
            with torch.no_grad():
                for bi, batch in enumerate(val_loader):
                    if bi >= cfg.max_val_batches:
                        break
                    if to_device is not None:
                        batch = to_device(batch)
                    losses.append(float(val_loss_fn(state, batch)))
            val = float(np.mean(losses)) if losses else float("nan")
            logger.log(step, val_loss=val)
        if downstream_fn is not None:
            metrics = downstream_fn(state, step) or {}
            if metrics:
                logger.log(step, **metrics)
            if select_on != "val_loss":
                return metrics.get(select_on, val)
        return val

    t_start = time.time()
    last_ck = time.time()

    def checkpoint(epoch):
        ck_file = ckio.save(state, epoch,
                            train_time0 + time.time() - t_start)
        val = run_val(state.step)
        if val is not None:
            ckio.record_best(state.step, val, ck_file, epoch)

    last_saved = -1
    prof = None
    with (torch.autograd.set_detect_anomaly(True) if cfg.debug_nans
          else contextlib.nullcontext()):
        for epoch in range(cfg.num_epochs):
            for batch in train_loader:
                if cfg.profile_steps and state.step == 1 and prof is None:
                    prof = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        *([torch.profiler.ProfilerActivity.CUDA]
                          if torch.cuda.is_available() else [])])
                    prof.start()
                if to_device is not None:
                    batch = to_device(batch)
                state, loss, terms = step_fn(state, batch)
                if prof is not None and state.step >= 1 + cfg.profile_steps:
                    prof.stop()  # profile_steps updates after the first
                    prof.export_chrome_trace(
                        os.path.join(cfg.out_dir, "trace.json"))
                    prof = None
                if state.step % 10 == 0:
                    logger.log(state.step, loss=float(loss), epoch=epoch,
                               **{f"loss_{k}": float(v)
                                  for k, v in terms.items()})
                if (time.time() - last_ck) / 60.0 >= cfg.ck_period_min \
                        and state.step != last_saved:
                    checkpoint(epoch)
                    last_saved = state.step
                    last_ck = time.time()
            # end of an epoch: checkpoint + validation every
            # epoch_ck_period epochs, and always after the last
            if (epoch + 1) % max(1, cfg.epoch_ck_period) \
                    and epoch != cfg.num_epochs - 1:
                continue
            if state.step != last_saved:
                checkpoint(epoch)
                last_saved = state.step
    return state


# ---------------------------------------------------------------------------
# SmoothNet and HVOP-Net steps: L1 pose + 0.1 x L1 acceleration
# ---------------------------------------------------------------------------

def _l1_pose_accel(pred, gt, axis: int):
    """(mean |pred - gt|, mean |second difference of pred - that of gt|)
    along the time axis."""
    def acc(x):
        n = x.shape[axis]
        return (x.narrow(axis, 2, n - 2) - 2 * x.narrow(axis, 1, n - 2)
                + x.narrow(axis, 0, n - 2))
    return (pred - gt).abs().mean(), (acc(pred) - acc(gt)).abs().mean()


@contextlib.contextmanager
def _seeded(seed: int, step: int, device: torch.device):
    """The dropout draws of an update come from (seed, update index), so
    a run is repeatable and a resumed run draws what it would have."""
    with torch.random.fork_rng(
            devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed * 1_000_003 + step)
        yield


def _make_steps(model, lr_fn, loss_fn, seed: int):
    def init_state() -> TrainState:
        return adam(model, lr_fn)

    def step(state: TrainState, batch: dict):
        model.train()  # dropout active, as the reference trains
        device = next(model.parameters()).device
        with _seeded(seed, state.step, device):
            total, terms = loss_fn(batch)
        state.update(total)
        return state, total.detach(), {k: v.detach()
                                       for k, v in terms.items()}

    def val_loss(state: TrainState, batch: dict):
        model.eval()
        with torch.no_grad():
            return loss_fn(batch)[0]

    return init_state, step, val_loss


def make_smoothnet_train_step(model, learning_rate: float = 1e-4,
                              lr_decay: float = 0.95,
                              steps_per_epoch: int = 1000,
                              lw_pos: float = 1.0, lw_accel: float = 0.1,
                              seed: int = 0):
    """SmoothNet / SmoothNetSMPL training: Adam, lr * 0.95^(update //
    steps_per_epoch), L_pos + 0.1 L_accel over windows. batch: noisy and
    gt (N, C, W). Returns (init_state(), step(state, batch) -> (state,
    loss, terms {pos, accel}), val_loss(state, batch))."""
    def loss_fn(batch):
        pred = model(batch["noisy"])
        l_pos, l_accel = _l1_pose_accel(pred, batch["gt"], -1)
        return lw_pos * l_pos + lw_accel * l_accel, dict(pos=l_pos,
                                                         accel=l_accel)

    return _make_steps(
        model, lambda i: learning_rate * lr_decay ** (i // steps_per_epoch),
        loss_fn, seed)


def make_infiller_train_step(model, learning_rate: float = 1e-4,
                             milestones=(30, 40), gamma: float = 0.3,
                             steps_per_epoch: int = 1000,
                             lw_pose: float = 1.0, lw_accel: float = 0.1,
                             seed: int = 0):
    """HVOP-Net training: Adam with the lr cut by gamma at the milestone
    epochs (step-based), L1 pose + 0.1 L1 acceleration over the clip.
    batch: data_smpl, mask_smpl, data_obj, mask_obj, gt_obj (B, T, 6).
    Returns (init_state(), step, val_loss) as make_smoothnet_train_step
    does; the terms are {pose, accel}."""
    def loss_fn(batch):
        pred = model(batch["data_smpl"], batch["mask_smpl"],
                     batch["data_obj"], batch["mask_obj"])
        l_pose, l_accel = _l1_pose_accel(pred, batch["gt_obj"], 1)
        return lw_pose * l_pose + lw_accel * l_accel, dict(pose=l_pose,
                                                           accel=l_accel)

    return _make_steps(
        model, piecewise_lr(learning_rate, milestones, gamma,
                            steps_per_epoch), loss_fn, seed)
