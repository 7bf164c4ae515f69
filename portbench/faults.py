"""Faults planted under the timed path, to read what `correct`'s numbers
give when the program is wrong: by control.py on the card at a cell's
own size (the readings the limits are held against) and by the tests at
a size the CPU holds (`correct` must come out false).

Each is a context manager that patches the port where the fault would be
made: training steps that return the state unchanged or leave out half
of the batch; a kernel's or the decoder's answer altered where it is
produced; stage 6's Adam phases returning their state unchanged or
running half of their steps; loss terms left out of stage 1 and stage
6; the host input's crop shifted.
"""
from __future__ import annotations

import contextlib
from unittest import mock


@contextlib.contextmanager
def unchanged_step():
    """Training steps that compute the loss and return the state as it
    was (no update)."""
    from vistracker_tpu_torch.fit import train

    def make(model, cfg):
        def step(state, batch):
            loss, terms = train.sifnet_loss(model, batch, cfg)
            return state, loss.detach(), terms
        return step
    with mock.patch.object(train, "make_train_step", make):
        yield


@contextlib.contextmanager
def half_batch():
    """Training steps that leave out half of the batch: the loss is the
    mean over the rest."""
    from vistracker_tpu_torch.fit import train
    inner = train.make_train_step

    def make(model, cfg):
        step = inner(model, cfg)

        def half(state, batch):
            n = batch["images"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})
        return half
    with mock.patch.object(train, "make_train_step", make):
        yield


@contextlib.contextmanager
def k1_answer():
    """Kernel K1's tie count altered at one pixel of every view, where
    the wrapper returns it."""
    from vistracker_tpu_torch.ops import coverage
    fwd = coverage.max_logit_fwd

    def altered(cpl, active, size):
        m, cnt = fwd(cpl, active, size)
        cnt = cnt.clone()
        cnt[:, size // 2, size // 2] += 1
        return m, cnt
    altered.launches = 0
    with mock.patch.object(coverage, "max_logit_fwd", altered):
        yield


@contextlib.contextmanager
def decoder_answer():
    """SIF-Net's decoder heads' answers scaled by 1 + 1e-3 where they are
    produced."""
    from vistracker_tpu_torch.models import sifnet
    head = sifnet.DecoderHead.forward

    def altered(self, x):
        return head(self, x) * (1 + 1e-3)
    with mock.patch.object(sifnet.DecoderHead, "forward", altered):
        yield


@contextlib.contextmanager
def unchanged_fit():
    """Stage 6's Adam phases return their state unchanged."""
    from vistracker_tpu_torch.fit import joint
    phase = joint._adam_phase

    def unchanged(loss_fn, params, lrs, *a, **k):
        _, losses, iters = phase(loss_fn, params, lrs, *a, **k)
        return dict(params), losses, iters
    with mock.patch.object(joint, "_adam_phase", unchanged):
        yield


@contextlib.contextmanager
def half_steps():
    """Stage 6's Adam phases run half of their iterations."""
    from vistracker_tpu_torch.fit import joint
    phase = joint._adam_phase

    def half(loss_fn, params, lrs, max_iters, *a, **k):
        return phase(loss_fn, params, lrs, max(1, max_iters // 2), *a, **k)
    with mock.patch.object(joint, "_adam_phase", half):
        yield


@contextlib.contextmanager
def dropped_terms():
    """The temporal terms left out of stage 1's and stage 6's losses."""
    from vistracker_tpu_torch.fit import joint, smplt

    def nought(x, *a, **k):
        return x.sum() * 0.0
    with mock.patch.object(joint, "diff_sq_mean", nought), \
            mock.patch.object(smplt, "diff_sq_mean", nought):
        yield


@contextlib.contextmanager
def crop_shift():
    """The host input's crop shifted by one pixel where it is made."""
    import numpy as np

    from vistracker_tpu_torch.data import images
    crop = images.prepare_input_crop

    def shifted(*a, **k):
        img, centre = crop(*a, **k)
        return np.roll(img, 1, axis=1), centre
    with mock.patch.object(images, "prepare_input_crop", shifted):
        yield


FAULTS = {"unchanged_step": unchanged_step, "half_batch": half_batch,
          "k1_answer": k1_answer, "decoder_answer": decoder_answer,
          "unchanged_fit": unchanged_fit, "half_steps": half_steps,
          "dropped_terms": dropped_terms, "crop_shift": crop_shift}
