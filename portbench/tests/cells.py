"""Small cells for the CPU: the tiny SIF-Net, 64^2 crops, a 122-vertex
body, 4 frames (tests/cells/*.json), driven through harness.run_cell
with the real cells' names, metrics and limits."""
from __future__ import annotations

from portbench import harness

CELLS = {"track.f32": "tiny-track", "track.neural.f96": "tiny-track",
         "train.b8": "tiny-train"}


def tiny(cell: str) -> tuple:
    """(workload, config) of the tiny stand-in of `cell`, with the real
    cell's limits."""
    real, _ = harness.cell_files(cell)
    wl = harness.load_json(harness.BENCH, "tests", "cells",
                           f"{CELLS[cell]}.w.json")
    cfg = harness.load_json(harness.BENCH, "tests", "cells",
                            f"{wl['config']}.json")
    wl = dict(wl, limits=real["limits"])
    if real.get("neural_only"):
        wl.update(neural_only=True, sample={
            k: v for k, v in wl["sample"].items()
            if k in ("frames", "k1_hard", "query")})
    return wl, cfg


def run(cell: str, seed: int = 2 ** 31 + 11, trace: bool = False,
        seconds: float = 0.5, control: bool = False,
        device: str = "cpu") -> dict:
    wl, cfg = tiny(cell)
    return harness.run_cell(cell, seed, seconds, trace, device=device,
                            workload=wl, config=cfg, control=control)
