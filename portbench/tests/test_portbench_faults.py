"""`correct` comes out false for the control and for the faults a cell
can have, with the real cells' limits, at a size the CPU holds (the
tiny cells of tests/cells/): the harness's look for a card skipped, the
rest of a run driven with the timed path broken underneath."""
from __future__ import annotations

import os

import pytest
import torch

from portbench import faults, harness
from portbench.tests import cells

SEED = 3_000_000_019


@pytest.mark.parametrize("cell", ["train.b8", "track.f32",
                                  "track.neural.f96"])
def test_control_fails(cell):
    """The reference one precision lower (TF32) in the program's place."""
    line = cells.run(cell, seed=SEED, control=True)
    limits = {k: lim for k, (_, lim) in line["checks"].items()}
    fails = {k: v for k, v in line["control"].items() if not v <= limits[k]}
    assert fails, line["control"]
    for k, v in line["control"].items():
        assert v >= line["checks"][k][0]


def test_sound_tiny_runs_pass_their_own_limits():
    for cell, name in (("train.b8", "tiny-train"),
                       ("track.f32", "tiny-track")):
        wl, cfg = cells.tiny(cell)
        own = harness.load_json(harness.BENCH, "tests", "cells",
                                f"{name}.w.json")["limits"]
        line = harness.run_cell(cell, SEED, 0.5, False, device="cpu",
                                workload=dict(wl, limits=own), config=cfg)
        assert line["correct"], line["checks"]


@pytest.mark.parametrize("cell,fault,number", [
    ("train.b8", "unchanged_step", "update_gap"),
    ("train.b8", "half_batch", "grad_gap"),
    ("track.f32", "k1_answer", "k1_hard_mismatch"),
    ("track.f32", "decoder_answer", "query_gap"),
    ("track.neural.f96", "decoder_answer", "query_gap"),
    ("track.f32", "unchanged_fit", "unmoved_fits"),
    ("track.f32", "half_steps", "steps_missing"),
    ("track.f32", "dropped_terms", "stage1_loss_gap"),
    ("track.f32", "dropped_terms", "stage6a_loss_gap"),
    ("track.f32", "dropped_terms", "stage6_loss_gap"),
    ("track.neural.f96", "crop_shift", "crop_gap")])
def test_fault_fails(cell, fault, number):
    """A fault planted under the timed path: `correct` is false, and the
    number named fails its limit."""
    with faults.FAULTS[fault]():
        line = cells.run(cell, seed=SEED)
    assert not line["correct"], line["checks"]
    value, limit = line["checks"][number]
    assert not value <= limit


@pytest.mark.parametrize("spies,numbers", [
    ("kernel_spies", ("k1_hard_mismatch", "k1_soft_mismatch", "k2_gap",
                      "k3_mismatch")),
    ("fit_spies", ("steps_missing", "stage1_loss_gap", "stage6a_loss_gap",
                   "stage6_loss_gap"))])
def test_a_path_the_benchmark_no_longer_sees_fails(monkeypatch, spies,
                                                  numbers):
    """Where the timed path stops passing the benchmark's wrappers (a
    kernel called past its Python entry, a fit reached by another name),
    the numbers they fed read NaN or miss their limit, and `correct` is
    false."""
    driver = harness.load_module(
        os.path.join(harness.BENCH, "drivers", "track.py"),
        "portbench_driver_track")
    monkeypatch.setattr(driver, spies, lambda *a, **k: None)
    line = cells.run("track.f32", seed=SEED)
    assert not line["correct"], line["checks"]
    for number in numbers:
        value, limit = line["checks"][number]
        assert not value <= limit, (number, value)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["train.b8", "track.f32"])
def test_tiny_cells_on_the_card(card, cell):
    """The tiny cells on the card: sound, and the control fails."""
    line = cells.run(cell, seed=SEED, control=True, device=card)
    limits = {k: lim for k, (_, lim) in line["checks"].items()}
    assert any(not v <= limits[k] for k, v in line["control"].items())
    assert line["device"]["memory_peak_bytes"] > 0
    assert torch.cuda.is_available()
