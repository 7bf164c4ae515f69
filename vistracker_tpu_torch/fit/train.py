"""SIF-Net training step.

Port of vistracker_tpu/fit/train.py: Adam (lr 1e-3) with the learning
rate cut by gamma 0.3 at epochs 15 and 25, the loss of
models/sifnet.py:sifnet_losses. The schedule is step-based, like optax's
piecewise_constant_schedule: update i (counting from 0) uses
lr * gamma^k, k the number of milestones m with i >= m * steps_per_epoch.
The optimizer is torch.optim.Adam with optax's defaults (betas 0.9 /
0.999, eps 1e-8, no eps inside the root).

A `TrainState` holds the model, its optimizer, the schedule and the
update count; a step function takes (state, batch) and returns (state,
loss, terms) after one update, as the JAX step does, so the training
loop (fit/trainer_loop.py) serves every trainer.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from ..models.sifnet import LOSS_WEIGHTS, sifnet_losses


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    milestones: tuple = (15, 25)       # epochs
    gamma: float = 0.3
    steps_per_epoch: int = 1000        # converts the milestones to steps
    max_dist: float = 0.1              # the df clamp of the loss
    loss_weights: tuple = LOSS_WEIGHTS


def piecewise_lr(learning_rate: float, milestones, gamma: float,
                 steps_per_epoch: int) -> Callable[[int], float]:
    """Update i -> learning_rate * gamma^k, k = #{m : i >= m * steps}."""
    bounds = [m * steps_per_epoch for m in milestones]
    return lambda i: learning_rate * gamma ** sum(i >= b for b in bounds)


@dataclasses.dataclass
class TrainState:
    """A model, its Adam optimizer, the learning rate of each update
    (lr_fn(update index)) and the number of updates made. state_dict() is
    the checkpoint's content: model_state_dict, optimizer_state_dict and
    step."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    lr_fn: Callable[[int], float]
    step: int = 0

    def update(self, loss: torch.Tensor):
        """One Adam update from `loss` at this update's learning rate."""
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_fn(self.step)
        self.optimizer.step()
        self.step += 1

    def state_dict(self) -> dict:
        return {"model_state_dict": self.model.state_dict(),
                "optimizer_state_dict": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, ck: dict):
        self.model.load_state_dict(ck["model_state_dict"])
        self.optimizer.load_state_dict(ck["optimizer_state_dict"])
        self.step = int(ck["step"])


def adam(model: nn.Module, lr_fn: Callable[[int], float]) -> TrainState:
    """A TrainState with torch Adam at optax's defaults over every
    parameter of `model`."""
    opt = torch.optim.Adam(model.parameters(), lr=lr_fn(0),
                           betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model, opt, lr_fn)


def init_train_state(model: nn.Module, cfg: TrainConfig) -> TrainState:
    return adam(model, piecewise_lr(cfg.learning_rate, cfg.milestones,
                                    cfg.gamma, cfg.steps_per_epoch))


def sifnet_loss(model: nn.Module, batch: dict, cfg: TrainConfig):
    """(loss, terms) of the training forward on a batch of tensors:
    images (B, H, W, C), points (B, N, 3), crop_center (B, 2),
    body_center (B, 3), df_h / df_o (B, N), parts (B, N), pca
    (B, N, 3, 3), obj_center (B, 3), visibility (B, N)."""
    preds = model(batch["images"], batch["points"], batch["crop_center"],
                  batch["body_center"], train=True)
    gt = {k: batch[k] for k in ("df_h", "df_o", "parts", "pca",
                                "obj_center", "visibility", "body_center")}
    return sifnet_losses(preds, gt, cfg.loss_weights, cfg.max_dist)


def make_train_step(model: nn.Module, cfg: TrainConfig):
    """-> step(state, batch) -> (state, loss, terms): one update of
    state.model (which must be `model`), the loss and its six terms
    computed before the update, detached."""
    def step(state: TrainState, batch: dict):
        model.train()
        loss, terms = sifnet_loss(model, batch, cfg)
        state.update(loss)
        return state, loss.detach(), {k: v.detach() for k, v in terms.items()}

    return step
