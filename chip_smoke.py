"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--frames 32 [96 ...]] [--chunk 16] [--kernels-only]
        [--sensitivity] [--cards N]

Phases (any failure exits non-zero):
  1. build the hand-written kernels from vistracker_tpu_torch/csrc with
     nvcc (one process per source, started together); print the card
     and the host (CPU model and cores, load, the card's SM clock);
  2. kernel K1 (csrc/max_logit_fwd.cu) against its plain PyTorch version
     at the stage-3 shape -- a chunk's 16 frames x 3 triplane views of a
     13,776-face SMPL-sized closed mesh at 512^2 -- and at 32..256 px,
     requiring m and cnt bit-equal, also with every cell dead, on one
     view and with every face repeated in a second face block (cnt
     doubles); its live face blocks per (view, strip, x tile), its skip
     counts; kernel (events and device time), plain times, the bound
     over the work these inputs need (the skip test, the pairs it walks)
     and over all faces of live cells;
  3. K1 in its soft-silhouette use and kernel K2 (csrc/max_logit_bwd.cu)
     at the stage-6 shape -- 16 views of a 2,500-face decimated closed
     mesh at 256^2, sigma 1/128: K1 as in phase 2, the time of the soft
     liveness bound (_strip_active); the plane cotangent within a stated
     tolerance of max_logit_bwd_plain, exactly 0 on dead rows and the
     same bits on two runs; also on one view and with every cell dead
     (dc 0); K2's bound over the work these inputs need (its skip test,
     the pairs it walks) and over all faces of live cells, its time on
     events and its device time from a CUDA graph;
  4. kernel K3 (csrc/label_nn.cu) at (16, 6890, 3) vs (16, 3000, 3), 14
     labels, both directions: with 30% validity, with all points valid
     (the main path's density) and in the dense worst case (all valid,
     one label), requiring min and argmin bit-equal to label_nn_plain,
     rows without a compatible point included; adversarial rows (exact
     ties across tiles and warp slices, an element without valid y,
     ragged sizes, a label span the plan leaves in index order), the plan
     kernel equal to the plain plan; the scatter of its gradient twice,
     for run-to-run equality; times with the plan made inside and given
     (three event readings each, and device time from a CUDA graph), the
     bound over the compatible pairs and over all pairs;
  5. kernel K4 (csrc/label_nn.cu, entry vt_nn_min) at the evaluate shape
     -- 10,000 x 10,000 surface samples at metre scale, one cloud a call
     -- unmasked and with a partial y-mask, with exact distance ties
     between y points far apart in index (across warps and blocks), on a
     small batch with an all-masked row, on clouds of 1 and 129 points
     and with fewer y points than one split, requiring min and argmin
     bit-equal to nn_min_sqdist_plain and two runs equal; kernel (events
     and device time, the latter also at one split of y fewer and one
     more), plain, bound and library (torch.cdist) times;
  6. the whole `track` at a small size on the CPU and on the card, same
     inputs and seeds, with a surface threshold wide enough that the
     untrained net keeps surface points: the packed outputs must agree;
  7. the infiller's clip schedule (seed clip, full clips, truncated tail)
     on a synthetic 215-frame stream, card against CPU;
  8. `evaluate` at a small size (40 frames, window 16, 2,000 chamfer
     samples, recon_exist holes) on the CPU and on the card, same packs:
     the error matrices must agree;
  9. the main path: the whole `track` through the port's entry point on a
     32-frame BEHAVE-layout sequence held in memory (2048x1536 frames, a
     6890-vertex SMPL-H model, a 2,520-face object template read from a
     .ply), two chunks of 16, release SIF-Net, SmoothNets and HVOP-Net
     with random weights from a seed, a quarter of the release's Adam
     steps in stages 1 and 6 (MAIN_FIT, MAIN_JOINT), on the card, with
     every kernel's launch count set to 0 before and read after, and
     K3's compatible-pair share counted from each chunk's
     frozen contact masks; visibility, the silhouette phase's first
     gradient and the object translation's movement must be non-zero, the
     object rotations proper. Each further --frames value runs it again with that many
     frames in one chunk, to read per-stage peak device memory;
 10. `evaluate` through the port's entry point at release settings (10,000
     chamfer samples, window 300) on the card: the pack the main path's
     `track` wrote against a GT pack of the sequence's own parameters
     (single-sequence mode, --angles), then a fabricated 600-frame recon
     with 5% recon_exist holes (two windows of 300: the refit at the
     window's end runs) and a 30-frame identity pair (split mode);
     K4's count, set to 0 before each run, must read 4 per evaluated
     frame after it; every error must be finite, the identity pair's v2v
     0;
 11. the fixture from disk: the port's generate_fixture_sequence on the
     card (8 frames of 2048x1536 at raster 512, the 6890-vertex capsule
     humanoid, seed 0) written as a BEHAVE-layout folder through the
     port's PNG and JPEG writers; every frame read back through
     FrameDataReader with PIL blocked (masks bit-equal to the generator's,
     colour at least 30 dB PSNR); JPEG decode ms a frame; then `track
     --seq` on that folder at release width (one chunk, a tenth of the
     release's Adam steps: FIXTURE_FIT, FIXTURE_JOINT; random weights, no
     reader given: the frames come from disk) and `evaluate` of its pack
     against the fixture's GT pack (K4 4 launches an evaluated frame,
     finite errors);
 12. `track --synthetic --render` at the JAX command line's defaults on
     the card: K1 (hard and soft), K2, K3 and K4 must each launch,
     counted as on the main path; the summary's v2v values must be
     finite; the GT | recon GIF must hold T frames of 128 x 256
     (gif_frames, a block walker);
 13. training, T1: the release SIF-Net's training step at its training
     shapes (chore-triplane-vis, B = 8, 20,000 query points, 512^2, a
     seeded batch), 2 warm-up and 5 timed steps with remat on, then off
     (at B = 8 if it fits, else at the largest B that the peaks of one
     step at B = 1 and 2 say fits; no out-of-memory error is caught):
     median seconds a step, examples/s, query points/s, peak GiB; the
     loss finite and falling over the first 5 steps, every parameter's
     gradient of the first step finite and not all zero;
 14. training, T2: the tiny SIF-Net trained 3 steps across a
     learning-rate milestone on the card and on the CPU from the same
     weights and batch: loss and terms within 1e-4 relative at every
     step, parameters within 1e-5 with at most 0.1% of elements
     outside after the first update and 15% after the third, none
     farther than 5 lr;
 15. training, T3, the command lines on the fixture of phase 11:
     `boundary-sample --samples 20000 --flip` (seconds a frame),
     `train-sifnet --offline-data` (chore, 512^2, 20,000 points, B = 4,
     1 epoch), `train-sifnet --synthetic` (K1 hard counted from 0, must
     launch; that launch's m and cnt bit-equal to the plain version on
     its own planes and liveness), `track --neural-only --net-preset
     tiny` with that
     checkpoint (the weights it loads equal the checkpoint's, outputs
     finite), `train-smoothnet` and `train-infiller --synthetic` at
     their defaults (steps/s, a validation loss that falls; K4 counted
     from 0: 6 launches; both directions of the first downstream
     chamfer's K4 bit-equal to the plain version on its inputs);
 16. `render` through the port's entry point on the card over phase 11's
     fixture: its `track` pack beside the fixture's GT pack with the object
     moved into contact (the fixture's object stays 13-31 cm from the
     body, and contact spheres need 4 cm), --top --contact-spheres --size
     256, all 8 frames: both GIFs must hold 8 frames of 256 x 512 and a
     contact sphere must be drawn; seconds a rendered frame, peak GiB,
     the GIF writer's ms a frame; one frame of render_meshes_perspective
     and one of render_top_view card against CPU on the same meshes (at
     most 0.1% of the pixels apart by more than 1e-5: z-buffer ties);
 17. fit/joint.py's term_probe at the main path's stage-6 widths (4
     frames, the 2,500-face object in 4 silhouette views at 256^2, 3,000
     object points against a 6890-vertex body, frozen contact masks, an
     analytic distance field in place of SIF-Net) on the card and on the
     CPU from the same inputs: K1 soft, K2 and K3, counted from 0, must
     launch; each term's value within 1e-4 relative and its obj_t
     gradient within 1e-3 of its largest entry; seconds;
 18. `track --shard-frames` on the main path's sequence, chunks and seeds
     (MAIN_FIT, MAIN_JOINT) over 2 ranks sharing the card (`chip_smoke.py
     --rank-phase shard` processes with torchrun's variables, gloo,
     --device cuda:0): every rank's launch counts set to 0 before and
     read after, K1 hard and soft, K2 and K3 launched by each; rank 0's
     pack against the main path's under SHARD_LIMITS; per-rank stage
     seconds and peaks; then stage 6b alone on one chunk of identical
     inputs (run_stage6b: 60 Adam steps, contact included) on the ranks
     against one process, its loss trace, obj_t and obj_r within 10x what
     obj_t's start x (1 + 1e-7) moves them in one process
     (STAGE6B_FLOORS);
 19. one DistributedDataParallel step of the release SIF-Net on 2 ranks
     x B = 4 sharing the card (gloo) against the one-process step at B =
     8 from the same weights and batch (check_ddp_step);
 20. every helper of parallel/mesh.py in a world-1 NCCL group on the card;
 21. the fixture accuracy harness, scripts/run_fixture_eval_torch.py, in
     this process through its run_phase over its own folder (HARNESS: 8
     frames at raster 512, net size 256, one chunk, 10 epochs of the tiny
     SIF-Net; the SmoothNet and HVOP-Net epochs and `track`'s budgets at
     their defaults, the release's): every phase's seconds, peak GiB and
     launch counts, set to 0 before it; K1 hard must launch in train-sif
     and track, K1 soft, K2 and K3 in track, K4 in eval; the SIF-Net's
     validation loss must fall from the untrained net's, the W1 and W300
     errors be finite (W1 smpl_v2v and obj_v2v printed); then `render
     --out x.mp4` over phase 11's fixture with cv2 blocked, its boxes
     walked (mp4_walk: ftyp, moov, mdat; one I-VOP sample a frame) and the
     encoder's ms a frame (run_harness_path);
 22. a {"kernels": [...]} line, the nvidia-smi name/power-limit line and,
     last, {"ok": true, "device": {...}}.
After each numbered phase a `clock:` line gives its number, name and
seconds and the seconds since the start. The main path (phase 9) and
phases 18-20 run first, right after the builds, while the process holds
little on the card. --sensitivity reruns the main path with every
keypoint x (1 + 1e-7), prints how far the pack moves (the scale of
SHARD_LIMITS), then runs phase 18 alone; --cards N, on a machine with N
cards, runs the main path and phases 18-19 with a rank on each card over
NCCL. These two print no result line.
Scratch files go to build/chip_smoke/ next to this script. Imports no JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import pickle
import shutil
import subprocess
import sys
import time
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
H100_FP32_OPS = 67e12      # CUDA-core fp32, H100 SXM data sheet
H100_BYTES = 3.35e12       # HBM3, H100 SXM data sheet
K1_OPS_PER_PIXEL_FACE = 15  # 5 planes x 1 FMA (2 flops) + 4 min + 1 cmp
K1_OPS_PER_ROW_FACE = 10    # the row terms b*py + c: 5 FMAs
# K2 recomputes K1's planes and compares with the saved max (winners are
# one or two faces a pixel: their few extra operations are not counted)
K2_OPS_PER_PIXEL_FACE = 15
# K2's skip test a (face, row, 16-column chunk): 5 planes at the chunk's
# two end pixels (10 FMAs) + 5 max + 4 min + 1 compare with the chunk's m
K2_OPS_PER_CHUNK_TEST = 30
# x.y 5, distance 3, mask 2, running min 2; the clamp at 0 is not counted
# (apart from the order of ties at 0 it could follow the min)
K3_OPS_PER_PAIR = 12
K4_OPS_PER_PAIR = 11  # K3's less the label compare
# K1's skip test a (face, 8 x 16 tile): 5 planes x (2 row FMAs + max + 2
# FMAs + max) + 4 min + 1 compare; the kernel's first pass, which repeats
# it for a lower bound of the tile's max, is its design's cost, not work
# the function needs
K1_OPS_PER_TILE_TEST = 55
K1_TILE_ROWS, K1_TILE_COLS = 8, 16
# a walked (face, tile): the row terms of its 8 rows, 15 a pixel
K1_OPS_PER_TILE_WALK = (K1_TILE_ROWS * K1_OPS_PER_ROW_FACE
                        + K1_TILE_ROWS * K1_TILE_COLS * K1_OPS_PER_PIXEL_FACE)
KERNEL_SOURCES = ("max_logit_fwd", "max_logit_bwd", "label_nn")
START = time.perf_counter()


def clock(number: int, name: str, t0: float) -> None:
    """One line after a numbered phase that started at t0: its number,
    name, seconds and the seconds since the script started; flushed, so
    that a run killed later shows how far it got."""
    t = time.perf_counter()
    print(f"clock: phase {number} ({name}) {t - t0:.1f} s, "
          f"{t - START:.1f} s since the start", flush=True)


def phase(number: int, name: str):
    """Decorates the function of a numbered phase: clock() after it."""
    def wrap(fn):
        @functools.wraps(fn)
        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            clock(number, name, t0)
            return out
        return timed
    return wrap


def host_line() -> str:
    """The host CPU's model and logical cores (/proc/cpuinfo; this
    process may use fewer), its 1-minute load average and the card's SM
    clock against its maximum: tells a slow host from a slow change."""
    import platform
    with open("/proc/cpuinfo") as f:
        info = [[s.strip() for s in ln.split(":", 1)] for ln in f
                if ":" in ln]
    cpu = dict(info).get("model name", "(no model in /proc/cpuinfo)")
    cores = sum(k == "processor" for k, _ in info)
    with open("/proc/loadavg") as f:
        load = f.read().split()[0]
    sm = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return (f"host: {platform.machine()} {cpu}, {cores} logical cores "
            f"({len(os.sched_getaffinity(0))} for this process), load "
            f"{load} (1 min); card clocks.sm, clocks.max.sm: {sm}")


def sphere_mesh(rings: int, segments: int, radius: float = 0.4):
    """Closed UV sphere: rings x segments vertices plus two poles,
    2 * rings * segments compact faces (84 x 82 -> 6890 / 13,776, the
    SMPL counts)."""
    th = np.linspace(0.0, np.pi, rings + 2)[1:-1]
    ph = np.linspace(0.0, 2 * np.pi, segments, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    ring = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                     np.sin(tt) * np.sin(pp)], -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 1, 0]], ring, [[0, -1, 0]]]) * radius
    idx = np.arange(rings * segments).reshape(rings, segments) + 1
    nxt = np.roll(idx, -1, axis=1)
    faces = [np.stack([np.zeros(segments, int), nxt[0], idx[0]], -1)]
    a, b = idx[:-1], nxt[:-1]
    c, d = idx[1:], nxt[1:]
    faces += [np.stack([a.ravel(), b.ravel(), d.ravel()], -1),
              np.stack([a.ravel(), d.ravel(), c.ravel()], -1)]
    last = len(verts) - 1
    faces.append(np.stack([np.full(segments, last), idx[-1], nxt[-1]], -1))
    return verts.astype(np.float32), np.concatenate(faces).astype(np.int32)


def sass_loops(name: str) -> list:
    """Innermost loops of each kernel in build/kernels/lib<name>_*.so, from
    `cuobjdump -sass` where the toolkit has it: per loop (kernel, SASS
    instructions on the path that takes every forward branch inside the
    loop -- the path without a winner or a new minimum -- and FMNMX among
    them). A K3/K4 pair clamps once (one FMNMX); a K2 (pixel, face) takes
    4 mins of 5 planes: instructions per unit of work are path / FMNMX
    (x 4 for K2)."""
    import re
    import shutil
    from vistracker_tpu_torch.utils.cuda_build import _lib_path

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not (os.path.exists(tool) and _lib_path(name).is_file()):
        return []
    text = subprocess.run([tool, "-sass", str(_lib_path(name))],
                          capture_output=True, text=True, timeout=120).stdout
    loops = []
    for part in text.split("Function : ")[1:]:
        kernel = part.split()[0]
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)
        where = {int(a, 16): k for k, (a, _) in enumerate(ins)}
        ops = [t.split()[1] if t.startswith("@") else t.split()[0]
               for _, t in ins]
        jumps = {}  # branch index -> target index
        for k, (_, t) in enumerate(ins):
            hit = re.search(r"\bBRA\s+0x([0-9a-f]+)", t)
            if hit and int(hit.group(1), 16) in where:
                jumps[k] = where[int(hit.group(1), 16)]
        back = [(t, k) for k, t in jumps.items() if t < k]
        for lo, hi in back:
            if any(lo <= a and b <= hi and (a, b) != (lo, hi)
                   for a, b in back):
                continue  # not innermost
            skip = {i for k, t in jumps.items() if lo <= k < t <= hi
                    for i in range(k + 1, t)}
            path = [ops[i] for i in range(lo, hi + 1) if i not in skip]
            if "FMNMX" in path:
                loops.append((kernel, len(path), path.count("FMNMX")))
    return loops


def host_ms(fn) -> float:
    """One call on the host clock, synchronized (for the plain versions)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bound(ops: float, nbytes: float) -> dict:
    """The least time the card could take: operations over the fp32 peak
    or bytes over the memory rate, whichever is larger."""
    t_ops, t_bytes = ops / H100_FP32_OPS * 1e3, nbytes / H100_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time of one call: `reps` calls captured in one CUDA graph and
    replayed, so the host's launch overhead is out of the timing (for
    kernels whose launches take less time than the Python around them)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_inputs(device, frames, size, rings=84, segments=82, seed=0):
    """Planes and liveness of `frames` jittered closed spheres seen from
    the 3 triplane views: (cpl, active, n_views, n_faces)."""
    import torch
    from vistracker_tpu_torch.core.camera import triplane_project
    from vistracker_tpu_torch.ops.coverage import _planes, _strip_active_bbox

    rng = np.random.RandomState(seed)
    sv, faces = sphere_mesh(rings, segments)
    verts = (sv[None] * (1.0 + 0.05 * rng.randn(frames, 1, 3))
             + np.array([0.0, 0.3, 2.4]) + 0.02 * rng.randn(frames, 1, 3))
    verts = torch.as_tensor(verts, dtype=torch.float32, device=device)
    ndc = triplane_project(verts, verts.mean(1))
    B, V = 3 * frames, verts.shape[1]
    cpl, *bounds = _planes(ndc.reshape(B, V, 2),
                           torch.as_tensor(faces, device=device), True)
    active = _strip_active_bbox(*bounds, size).contiguous()
    return cpl.contiguous(), active, B, faces.shape[0]


def k1_equal(cpl, active, size) -> float:
    """Kernel vs plain version on the same inputs; exits unless m and cnt
    are bit-equal; returns the max |difference| (0)."""
    import torch
    from vistracker_tpu_torch.ops.coverage import (max_logit_fwd,
                                                   max_logit_fwd_plain)
    m_k, c_k = max_logit_fwd(cpl, active, size)
    m_p, c_p = max_logit_fwd_plain(cpl, active, size)
    torch.cuda.synchronize()
    if not (torch.equal(m_k, m_p) and torch.equal(c_k, c_p)):
        bad = int((m_k != m_p).sum()) + int((c_k != c_p).sum())
        raise SystemExit(f"K1 kernel != plain version at {bad} values "
                         f"({size}^2)")
    return float(torch.maximum((m_k - m_p).abs().max(),
                               (c_k - c_p).abs().max()))


def live_distribution(active, size, n_faces_padded) -> dict:
    """Live face blocks per (view, strip, x tile), the unit the TPU kernel
    and the first CUDA design looped over: max, mean and the share with
    none."""
    from vistracker_tpu_torch.ops.coverage import _FBLK, _xblk

    per = active.reshape(-1, size // _xblk(size),
                         n_faces_padded // _FBLK).sum(-1).flatten().float()
    return {"max": int(per.max()), "mean": float(per.mean()),
            "none": float((per == 0).float().mean())}


def k1_edge_cases(label, cpl, active, size, tie_views) -> dict:
    """K1 on the cases a split of its work could break, each bit-equal to
    the plain version: every cell dead (m = -1e9, cnt = 0 everywhere); one
    view; every face of the first `tie_views` views repeated in a second
    set of face blocks, so each pixel's ties sit in two blocks (m must stay
    and cnt double). Then the kernel's skip counts on the whole input
    (max_logit_fwd_walks, m and cnt checked again) and the live-block
    distribution; returns those numbers."""
    import torch
    from vistracker_tpu_torch.ops.coverage import (_FBLK, _RBLK, _xblk,
                                                   max_logit_fwd,
                                                   max_logit_fwd_plain,
                                                   max_logit_fwd_walks)

    dead = torch.zeros_like(active)
    m_d, c_d = max_logit_fwd(cpl, dead, size)
    if not (bool((m_d == -1e9).all()) and bool((c_d == 0).all())):
        raise SystemExit(f"K1 ({label}): every cell dead, yet m != -1e9 or "
                         "cnt != 0")
    k1_equal(cpl, dead, size)
    n_strips = size // _RBLK
    k1_equal(cpl[:1], active[:n_strips].contiguous(), size)
    n_x = size // _xblk(size)
    v = min(tie_views, cpl.shape[0])
    act = active[:v * n_strips].reshape(v * n_strips, n_x, -1)
    twice = torch.cat([cpl[:v], cpl[:v]], 1).contiguous()
    act2 = torch.cat([act, act], 2).reshape(v * n_strips, -1).contiguous()
    k1_equal(twice, act2, size)
    m1, c1 = max_logit_fwd(cpl[:v].contiguous(),
                           active[:v * n_strips].contiguous(), size)
    m2, c2 = max_logit_fwd(twice, act2, size)
    if not (torch.equal(m1, m2) and torch.equal(2 * c1, c2)):
        raise SystemExit(f"K1 ({label}): faces repeated in other blocks "
                         "did not double cnt at the same m")
    m_w, c_w, tested, walked = max_logit_fwd_walks(cpl, active, size)
    m_p, c_p = max_logit_fwd(cpl, active, size)
    if not (torch.equal(m_w, m_p) and torch.equal(c_w, c_p)):
        raise SystemExit(f"K1 ({label}): the counting launch differs")
    tied = int((c2 > 2).sum())
    return {"dist": live_distribution(active, size, cpl.shape[1]),
            "tested": tested, "walked": walked, "tied": tied}


def k1_need(extra, nbt) -> dict:
    """K1's bound over the work these inputs need: one skip test of every
    (face, 8 x 16 tile) of a live cell, the walk of the pairs it keeps."""
    return bound(extra["tested"] * K1_OPS_PER_TILE_TEST
                 + extra["walked"] * K1_OPS_PER_TILE_WALK, nbt)


def k1_report(label, rec, extra, live, cells) -> str:
    d = extra["dist"]
    return (f"{label}: kernel {rec['ms']:.4f} ms on events, "
            f"{rec['device_ms']:.4f} ms of device time (CUDA graph), plain "
            f"{rec['plain_ms']:.1f} ms, live cells {live} of {cells}, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}) over the work "
            f"these inputs need (one skip test of every (face, 8 x 16 tile) "
            f"of a live cell, the walk of those kept), all-faces bound "
            f"{rec['all_faces']['bound_ms']:.4f} ms over all faces of live "
            f"cells; skip test walked "
            f"{extra['walked']} of {extra['tested']} (face, tile) pairs "
            f"({extra['walked'] / max(extra['tested'], 1):.2%}, skipped "
            f"{1 - extra['walked'] / max(extra['tested'], 1):.2%}); live "
            f"face blocks per (view, strip, x tile): max {d['max']}, mean "
            f"{d['mean']:.3f}, none {d['none']:.2%}; m and cnt bit-equal, "
            f"also with every cell dead, on one view and with every face "
            f"repeated in a second block ({extra['tied']} pixels with more "
            f"than two tied faces), cnt doubled")


@phase(2, "K1 hard")
def check_k1(device, frames=16, size=512, small=(32, 64, 128, 256),
             mesh=(84, 82)):
    """K1 against its plain version at the stage-3 shape, and at the sizes
    that use its ragged tiles and x-tile widths, with k1_edge_cases;
    returns the kernel's record for the {"kernels": ...} line (without
    launches)."""
    import torch
    from vistracker_tpu_torch.ops.coverage import (
        _FBLK, _RBLK, _xblk, max_logit_fwd, max_logit_fwd_plain)

    for px in small:
        k1_equal(*k1_inputs(device, 1, px, *mesh)[:2], px)
    print(f"K1 bit-equal to the plain version at {', '.join(map(str, small))}"
          " px (3 views)")
    cpl, active, B, n_faces = k1_inputs(device, frames, size, *mesh)
    err = k1_equal(cpl, active, size)
    extra = k1_edge_cases("hard", cpl, active, size, tie_views=6)
    ms = cuda_ms(lambda: max_logit_fwd(cpl, active, size), 20)
    device_ms = graph_ms(lambda: max_logit_fwd(cpl, active, size), 20)
    plain_ms = host_ms(lambda: max_logit_fwd_plain(cpl, active, size))
    live = int(active.sum())
    ops = live * _FBLK * _RBLK * (_xblk(size) * K1_OPS_PER_PIXEL_FACE
                                  + K1_OPS_PER_ROW_FACE)
    nbt = nbytes(cpl, active) + 2 * B * size * size * 4
    rec = {"name": "max_logit_fwd", "route": "cuda",
           "source": "vistracker_tpu_torch/csrc/max_logit_fwd.cu",
           "replaces": "vistracker_tpu/ops/pallas_raster.py:140",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **k1_need(extra, nbt), "library_ms": None}
    print(k1_report(f"K1 at {B} views x {n_faces} faces x {size}^2",
                    dict(rec, device_ms=device_ms,
                         all_faces=bound(ops, nbt)), extra, live,
                    active.numel()))
    return rec


def object_mesh(rings=35, segments=36):
    """The object template: a closed ellipsoid with half-axes 15, 10 and
    6 cm, so that its rotation shows in the silhouette and the df terms;
    2,520 faces on the main path (decimate_faces cuts them to 2,500 for
    the silhouette)."""
    verts, faces = sphere_mesh(rings, segments, 1.0)
    return verts * np.array([0.15, 0.10, 0.06], np.float32), faces


def k2_equal(label, cpl, active, m, gw, size, n_faces):
    """K2 against max_logit_bwd_plain on one input: within 1e-5 of the
    largest entry (the two sum a face's pixels in another order: kernel
    columns, rows, column groups, cells; plain torch's tree reductions),
    dead and padding rows exactly 0, and the same bits on a second run.
    With no live cell dc must be 0 everywhere. Returns (max |diff|, max
    |dc|)."""
    import torch
    from vistracker_tpu_torch.ops.coverage import (max_logit_bwd,
                                                   max_logit_bwd_plain)

    dc_k = max_logit_bwd(cpl, active, m, gw, size)
    again = max_logit_bwd(cpl, active, m, gw, size)
    dc_p = max_logit_bwd_plain(cpl, active, m, gw, size)
    torch.cuda.synchronize()
    scale = float(dc_p.abs().max())
    err = float((dc_k - dc_p).abs().max())
    dead = float(dc_k[:, n_faces:].abs().max()) if cpl.shape[1] > n_faces \
        else 0.0
    live = bool(active.any())
    if not (torch.equal(dc_k, again) and np.isfinite(err)
            and err <= 1e-5 * scale and dead == 0.0
            and (scale > 0) == live):
        raise SystemExit(f"K2 kernel vs plain ({label}): max |diff| "
                         f"{err:.3e} against max |dc| {scale:.3e} (limit "
                         f"1e-5 of it), dead rows max {dead}, run to run "
                         f"equal {torch.equal(dc_k, again)}, live {live}")
    return err, scale


def k2_walk_share(cpl, active, m, size, chunk=16):
    """K2's work on these inputs: its (face, row, 16-column chunk) triples
    of live cells (each takes the bound test), the (pixel, face) pairs of
    those whose test does not skip them (csrc/max_logit_bwd.cu walks them
    pixel by pixel), and the share of (32-face warp, row, chunk) triples
    where any face's does (the warp walks then): the kernel's test, in the
    plain version's fma32 arithmetic. Returns a dict of the counts."""
    import torch
    from vistracker_tpu_torch.ops.coverage import _FBLK, _RBLK, _xblk, fma32

    B, Fp, _ = cpl.shape
    xblk = _xblk(size)
    n_x, n_fblk = size // xblk, Fp // _FBLK
    live = active.reshape(B, size // _RBLK, n_x, n_fblk) != 0
    col = torch.arange(size, dtype=torch.float32, device=cpl.device)
    coord = fma32(col, torch.full_like(col, 2.0 / (size - 1)),
                  torch.full_like(col, -1.0))
    starts = list(range(0, xblk, chunk))
    ends = [min(s + chunk, xblk) for s in starts]
    first = torch.tensor(starts, device=cpl.device)
    last = torch.tensor(ends, device=cpl.device) - 1
    width = last - first + 1
    faces = warps = walked = walked_px = walked_warps = 0
    for b in range(B):
        a, bb, c = (cpl[b, :, k::3][:, None, None, :] for k in range(3))
        for r in range(size // _RBLK):
            if not bool(live[b, r].any()):
                continue
            py = coord[r * _RBLK:(r + 1) * _RBLK][None, :, None, None]
            inner = fma32(bb, py, c)                       # (F', 8, 1, 5)
            for x in range(n_x):
                cells = live[b, r, x].repeat_interleave(_FBLK)
                if not bool(cells.any()):
                    continue
                px0, px1 = (coord[x * xblk + i][None, None, :, None]
                            for i in (first, last))
                bound = torch.maximum(fma32(a, px0, inner),
                                      fma32(a, px1, inner)).amin(-1)
                mrow = m[b, r * _RBLK:(r + 1) * _RBLK,
                         x * xblk:(x + 1) * xblk]
                mmin = torch.stack([mrow[:, s:e].amin(1)
                                    for s, e in zip(starts, ends)], 1)
                walk = (bound >= mmin) & cells[:, None, None]
                faces += int(cells.sum()) * _RBLK * len(starts)
                walked += int(walk.sum())
                walked_px += int((walk * width).sum())
                warps += int(cells.sum()) // 32 * _RBLK * len(starts)
                walked_warps += int(walk.reshape(Fp // 32, 32, _RBLK, -1)
                                    .any(1).sum())
    return {"triples": faces, "walked": walked,
            "walked_pixel_faces": walked_px,
            "share": walked / max(faces, 1),
            "warp_share": walked_warps / max(warps, 1)}


@phase(3, "K1 soft and K2")
def check_sil(device, views=16, size=256, sigma=1.0 / 128.0, seed=1):
    """K1 (soft-silhouette use) and K2 against their plain versions at the
    stage-6 shape. Returns the two kernel records."""
    import torch
    from vistracker_tpu_torch.ops.coverage import (
        _FBLK, _RBLK, _planes, _strip_active, _xblk, max_logit_bwd,
        max_logit_bwd_plain, max_logit_fwd, max_logit_fwd_plain)
    from vistracker_tpu_torch.utils.mesh import decimate_faces

    rng = np.random.RandomState(seed)
    ov, of = object_mesh()
    faces = decimate_faces(of, 2500)
    # the object seen in its ROI square: ~3/4 of the side, jittered
    v2d = (ov[None, :, :2] / 0.15 * (0.7 + 0.1 * rng.rand(views, 1, 1))
           + 0.1 * rng.randn(views, 1, 2))
    v2d = torch.as_tensor(v2d, dtype=torch.float32, device=device)
    cpl = _planes(v2d, torch.as_tensor(faces, device=device)).contiguous()
    active = _strip_active(cpl, size, sigma)
    n_faces, Fp = faces.shape[0], cpl.shape[1]
    m_k, c_k = max_logit_fwd(cpl, active, size)
    m_p, c_p = max_logit_fwd_plain(cpl, active, size)
    torch.cuda.synchronize()
    if not (torch.equal(m_k, m_p) and torch.equal(c_k, c_p)):
        raise SystemExit("K1 (soft) kernel != plain version at "
                         f"{int((m_k != m_p).sum() + (c_k != c_p).sum())} "
                         "values")
    # a cotangent as the silhouette loss gives it: a residual times the
    # sigmoid's p (1 - p) / sigma, split among the faces tied at the max
    prob = torch.sigmoid(m_k / sigma)
    g = torch.as_tensor(rng.randn(views, size, size), dtype=torch.float32,
                        device=device) * prob * (1 - prob) / sigma
    gw = (g / torch.clamp(c_k, min=1.0)).contiguous()
    err, scale = k2_equal("16 views", cpl, active, m_k, gw, size, n_faces)
    n_strips = size // _RBLK
    k2_equal("one view", cpl[:1], active[:n_strips], m_k[:1], gw[:1], size,
             n_faces)
    k2_equal("every cell dead", cpl, torch.zeros_like(active), m_k, gw, size,
             n_faces)
    live = int(active.sum())
    walk = k2_walk_share(cpl, active, m_k, size)
    ops_cell = _FBLK * _RBLK * (_xblk(size) * K1_OPS_PER_PIXEL_FACE
                                + K1_OPS_PER_ROW_FACE)
    img = views * size * size * 4
    fwd_bytes = nbytes(cpl, active) + 2 * img
    extra = k1_edge_cases("soft", cpl, active, size, tie_views=views)
    fwd = {"ms": cuda_ms(lambda: max_logit_fwd(cpl, active, size), 20),
           "plain_ms": host_ms(lambda: max_logit_fwd_plain(cpl, active,
                                                           size)),
           **k1_need(extra, fwd_bytes)}
    print(k1_report(f"K1 soft at {views} views x {n_faces} faces (padded "
                    f"{Fp}) x {size}^2",
                    dict(fwd, device_ms=graph_ms(
                        lambda: max_logit_fwd(cpl, active, size), 20),
                        all_faces=bound(live * ops_cell, fwd_bytes)),
                    extra, live, active.numel()))
    bound_fn = functools.partial(_strip_active, cpl, size, sigma)
    print(f"_strip_active (the soft liveness bound, every silhouette step) "
          f"at {views} views x {Fp} faces x {size}^2: "
          f"{cuda_ms(bound_fn, 20):.4f} ms on events, "
          f"{graph_ms(bound_fn, 20):.4f} ms of device time")
    # the bound counts what these inputs need: the row terms and the skip
    # test of every face of a live cell, the walk of the (pixel, face)
    # pairs whose test does not skip them; all faces at every pixel of a
    # live cell beside it
    bwd_bytes = 2 * nbytes(cpl) + nbytes(active) + 2 * img
    bwd_fn = functools.partial(max_logit_bwd, cpl, active, m_k, gw, size)
    bwd_device_ms = graph_ms(bwd_fn, 20)
    share = "n/a"
    bwd = {"ms": cuda_ms(bwd_fn, 20),
           "plain_ms": host_ms(lambda: max_logit_bwd_plain(cpl, active, m_k,
                                                           gw, size)),
           **bound(live * _FBLK * _RBLK * K1_OPS_PER_ROW_FACE
                   + walk["triples"] * K2_OPS_PER_CHUNK_TEST
                   + walk["walked_pixel_faces"] * K2_OPS_PER_PIXEL_FACE,
                   bwd_bytes)}
    if bwd_device_ms > 0:
        share = f"{bwd['bound_ms'] / bwd_device_ms:.2%}"
    all_faces = bound(live * _FBLK * _RBLK
                      * (_xblk(size) * K2_OPS_PER_PIXEL_FACE
                         + K1_OPS_PER_ROW_FACE), bwd_bytes)
    print(f"K1 soft + K2 at {views} views x {n_faces} faces (padded {Fp}) x "
          f"{size}^2, sigma {sigma:.5f}: live cells {live} of "
          f"{active.numel()}; forward {fwd['ms']:.4f} ms (above); backward "
          f"{bwd['ms']:.4f} ms on events, {bwd_device_ms:.4f} ms of device "
          f"time (its bound is {share} of it; "
          f"plain {bwd['plain_ms']:.1f} ms, bound "
          f"{bwd['bound_ms']:.4f} ms by {bwd['bound_by']} over the work "
          f"these inputs need, all-faces bound {all_faces['bound_ms']:.4f} "
          f"ms), max |diff| {err:.3e} of max |dc| {scale:.3e}, dead rows 0, "
          "two runs equal; one view and every cell dead (dc 0) checked too;"
          f" K2 walks {walk['walked']} of its {walk['triples']} (face, row,"
          f" 16-column chunk) triples ({walk['share']:.2%}; "
          f"{walk['walked_pixel_faces']} (pixel, face) pairs), its warps "
          f"{walk['warp_share']:.2%} of theirs (the bound skips the rest)")
    common = {"route": "cuda", "library_ms": None}
    return [{"name": "max_logit_fwd_soft",
             "source": "vistracker_tpu_torch/csrc/max_logit_fwd.cu",
             "replaces": "vistracker_tpu/ops/pallas_raster.py:140 via "
                         "soft_silhouette_batch :309",
             "max_abs_err": 0.0, **fwd, **common},
            {"name": "max_logit_bwd",
             "source": "vistracker_tpu_torch/csrc/max_logit_bwd.cu",
             "replaces": "vistracker_tpu/ops/pallas_raster.py:167",
             "max_abs_err": err, **bwd, **common}]


def k3_equal(label, x, lx, y, ly, valid):
    """K3's plan and wrapper against their plain versions on one input;
    exits unless the plans are equal and min and argmin bit-equal;
    returns the max |difference| (0) and the kernel's distances."""
    import torch
    from vistracker_tpu_torch.ops.label_nn import (label_nn_fwd,
                                                   label_nn_plain,
                                                   label_nn_plan,
                                                   label_nn_plan_plain)

    plan, want = label_nn_plan(lx, ly, valid), label_nn_plan_plain(lx, ly,
                                                                   valid)
    torch.cuda.synchronize()
    bad = [f for f, a, b in zip(plan._fields, plan, want)
           if not torch.equal(a, b)]
    if bad:
        raise SystemExit(f"K3 plan kernel != plain plan ({label}): {bad}")
    d_k, i_k = label_nn_fwd(x, lx, y, ly, valid)
    d_p, i_p = label_nn_plain(x, lx, y, ly, valid)
    torch.cuda.synchronize()
    if not (torch.equal(d_k, d_p) and torch.equal(i_k, i_p)):
        raise SystemExit(
            f"K3 kernel != plain version ({label}): "
            f"{int((d_k != d_p).sum())} distances, "
            f"{int((i_k != i_p).sum())} indices of {d_k.numel()}")
    return float((d_k - d_p).abs().max()), d_k


def compatible_pairs(labels_x, labels_y, y_valid) -> int:
    """The (x, y) pairs where y is valid and shares x's label: what K3
    searches (counted by sort and binary search, not from the plan, whose
    ranges cover all of y where the labels span 32 values or more)."""
    import torch

    key_y = torch.where(y_valid, labels_y.long(),
                        torch.iinfo(torch.int64).max)
    key_y = torch.sort(key_y, dim=1).values
    lx = labels_x.long().contiguous()
    return int((torch.searchsorted(key_y, lx, right=True)
                - torch.searchsorted(key_y, lx)).sum())


def median_ms(fn, repeats=3, reps=20) -> list:
    """`repeats` readings of cuda_ms(fn, reps), in order, and their median
    last: one 20-launch window can read twice the others when the card's
    clock or the host stalls."""
    readings = [cuda_ms(fn, reps) for _ in range(repeats)]
    return readings + [sorted(readings)[len(readings) // 2]]


def k3_adversarial(device, rng, labels: int):
    """Rows built to break a split search: y is three copies of 500
    points (exact distance ties at j, j + 500, j + 1000, which land in
    different 512-point tiles and different warp slices of one label's
    range), N = 777 and M = 1500 are multiples of no tile, and batch
    element 1 has no valid y point. Returns the max |difference| (0)."""
    import torch

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    y0 = rng.randn(3, 500, 3) * 0.15 + [0.2, 0, 2.2]
    l0 = rng.randint(0, labels, (3, 500))
    valid = rng.rand(3, 1500) < 0.9
    valid[1] = False
    x = t(rng.randn(3, 777, 3) * 0.3 + [0, 0, 2.2])
    lx = t(rng.randint(0, labels, (3, 777)), torch.int64)
    y, ly = t(np.tile(y0, (1, 3, 1))), t(np.tile(l0, (1, 3)), torch.int64)
    err, d = k3_equal(f"ties, {labels} label(s)", x, lx, y, ly,
                      t(valid, torch.bool))
    if not bool((d[1] == 1e10).all()):
        raise SystemExit("K3: the batch element without valid y is not 1e10")
    return err


@phase(4, "K3")
def check_k3(device, B=16, N=6890, M=3000, seed=2):
    """K3 (plan kernel and search kernel) against label_nn_plan_plain and
    label_nn_plain in both directions of the contact loss (SMPL vertices
    vs object points and back): with 30% validity and rows without a
    compatible point ("stage 6", the record's case, ~2% of pairs
    compatible); with every point valid ("main-path density": 1 pair in
    14 compatible, as the joint phase of the main path feeds it); in the
    dense worst case (every y valid, one label: every pair compatible); on
    adversarial rows (k3_adversarial); the gradient's scatter twice.
    Times (three readings of 20 launches each, the median kept): the
    wrapper with its plan made inside (the record's) and with the plan
    given, as the joint phase calls it; device times from a CUDA graph.
    Bounds: over the compatible pairs (the record's) and over all N x M
    pairs. No library time: no single PyTorch call computes it
    (torch.cdist has no label mask and no argmin under a mask)."""
    import torch
    from vistracker_tpu_torch.ops.label_nn import (label_nn, label_nn_fwd,
                                                   label_nn_plain,
                                                   label_nn_plan)

    rng = np.random.RandomState(seed)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    xh = t(rng.randn(B, N, 3) * 0.3 + [0, 0, 2.2])
    xo = t(rng.randn(B, M, 3) * 0.15 + [0.2, 0, 2.2])
    lh = t(rng.randint(0, 14, (B, N)), torch.int64)
    lo = t(rng.randint(0, 10, (B, M)), torch.int64)  # parts 10..13 absent
    mh = t(rng.rand(B, N) < 0.3, torch.bool)
    mo = t(rng.rand(B, M) < 0.3, torch.bool)
    mo[0] = False                                    # a frame with no contact
    one_h = torch.zeros_like(lh)
    one_o = torch.zeros_like(lo)
    all_h = torch.ones_like(mh)
    all_o = torch.ones_like(mo)
    cases = {"stage 6": ((xh, lh, xo, lo, mo), (xo, lo, xh, lh, mh)),
             "main-path density": ((xh, lh, xo, lo, all_o),
                                   (xo, lo, xh, lh, all_h)),
             "dense": ((xh, one_h, xo, one_o, all_o),
                       (xo, one_o, xh, one_h, all_h))}
    err, none_rows, res = 0.0, 0, {}
    for name, dirs in cases.items():
        r = dict.fromkeys(("device_ms", "search_device_ms", "plain_ms",
                           "pairs"), 0.0)
        calls, searches = [], []
        for args in dirs:
            e, d = k3_equal(name, *args)
            err = max(err, e)
            if name == "stage 6":
                none_rows += int((d >= 1e10).sum())
            plan = label_nn_plan(args[1], args[3], args[4])
            r["pairs"] += compatible_pairs(args[1], args[3], args[4])
            calls.append(functools.partial(label_nn_fwd, *args))
            searches.append(functools.partial(label_nn_fwd, *args, plan))
            r["device_ms"] += graph_ms(calls[-1], 20)
            r["search_device_ms"] += graph_ms(searches[-1], 20)
            r["plain_ms"] += host_ms(lambda: label_nn_plain(*args))
        # both directions a reading
        r["ms_readings"] = median_ms(lambda: [f() for f in calls])
        r["search_readings"] = median_ms(lambda: [f() for f in searches])
        r["ms"], r["search_ms"] = r["ms_readings"][-1], \
            r["search_readings"][-1]
        res[name] = r
    if none_rows == 0:
        raise SystemExit("K3 check: no row without a compatible point")
    for labels in (1, 3, 1000):  # 1,000: the plan's index order
        err = max(err, k3_adversarial(device, rng, labels))
    # the object side's gradient, as the joint phase takes it: the scatter
    # onto y must give the same bits on every run
    grads = []
    for _ in range(2):
        yo = xo.clone().requires_grad_(True)
        d = label_nn(xh, lh, yo, lo, mo)
        (d * (d < 1e9)).sum().backward()
        grads.append(yo.grad)
    rerun = float((grads[0] - grads[1]).abs().max())
    if rerun != 0.0 or not float(grads[0].abs().max()) > 0:
        raise SystemExit(f"K3 gradient scatter: run-to-run max |diff| "
                         f"{rerun}, max |grad| {float(grads[0].abs().max())}")
    clouds = 2 * nbytes(xh, xo)            # both clouds, both directions
    all_pairs = bound(2 * B * N * M * K3_OPS_PER_PAIR, clouds)
    for name, r in res.items():
        r.update(bound(r["pairs"] * K3_OPS_PER_PAIR, clouds))
        readings = ["/".join(f"{v:.4f}" for v in r[k][:-1])
                    for k in ("ms_readings", "search_readings")]
        print(f"K3 {name} at ({B}, {N}, 3) vs ({B}, {M}, 3), both "
              f"directions: wrapper {r['ms']:.4f} ms (plan made inside; "
              f"readings {readings[0]}), search {r['search_ms']:.4f} ms "
              f"(plan given; readings {readings[1]}); device time "
              f"(CUDA graph) {r['device_ms']:.4f} ms and "
              f"{r['search_device_ms']:.4f} ms; plain "
              f"{r['plain_ms']:.1f} ms; compatible pairs {int(r['pairs'])} "
              f"of {2 * B * N * M} ({r['pairs'] / (2 * B * N * M):.4%}), "
              f"bound {r['bound_ms']:.6f} ms by {r['bound_by']}; all-pairs "
              f"bound {all_pairs['bound_ms']:.4f} ms; min and argmin "
              "bit-equal")
    print(f"K3: {none_rows} stage-6 rows without a compatible point; "
          "adversarial rows (ties across tiles and warp slices, an element "
          "without valid y, N = 777, M = 1500; 1, 3 and 1,000 labels, the "
          "last a label span the plan leaves in index order) bit-equal, "
          "plans equal; "
          f"gradient scatter run-to-run max |diff| {rerun}")
    stage6 = res["stage 6"]
    return {"name": "label_nn", "route": "cuda",
            "source": "vistracker_tpu_torch/csrc/label_nn.cu",
            "replaces": "vistracker_tpu/ops/pallas_nn.py:90",
            "max_abs_err": err, "ms": stage6["ms"],
            "plain_ms": stage6["plain_ms"], "bound_ms": stage6["bound_ms"],
            "bound_by": stage6["bound_by"], "library_ms": None}


@phase(5, "K4")
def check_k4(device, N=10000, M=10000, seed=4):
    """K4 against nn_min_sqdist_plain at the evaluate shape (one cloud of
    10,000 surface samples against another, metre scale, 2.2 m from the
    camera), unmasked as the chamfer calls it and with a partial y-mask;
    with y made of copies of M/5 and of M/80 points (exact distance ties
    between y points that far apart in index, in other blocks' splits and
    other warps' slices: the least index must win); on a batch of three
    129-point clouds whose middle row has no valid y point (1e10, index 0),
    on a single point, and with 5 y points (fewer than a split, most warps
    with none); N = 10,000 = 78 x 128 + 16 already leaves a partial block.
    Min and argmin bit-equal, and two runs equal. Times at the evaluate
    shape (events and device time; device time also at one split fewer
    and one more than the wrapper's rule takes); the library time is torch.cdist(x,
    y[valid]).square().amin(1), three calls and a gather, with TF32 off."""
    import torch
    from vistracker_tpu_torch.ops import chamfer
    from vistracker_tpu_torch.ops.chamfer import (nn_min_sqdist_fwd,
                                                  nn_min_sqdist_plain)

    rng = np.random.RandomState(seed)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    x = t(rng.randn(1, N, 3) * 0.3 + [0, 0, 2.2])
    y = t(rng.randn(1, M, 3) * 0.3 + [0.01, 0, 2.2])
    full = torch.ones((1, M), dtype=torch.bool, device=device)
    part = t(rng.rand(1, M) < 0.6, torch.bool)
    xb = t(rng.randn(3, 129, 3) * 0.3 + [0, 0, 2.2])
    yb = t(rng.randn(3, 700, 3) * 0.3 + [0, 0, 2.2])
    vb = t(rng.rand(3, 700) < 0.5, torch.bool)
    vb[1] = False
    cases = [("unmasked", (x, y, full)), ("masked", (x, y, part))]
    for copies in (5, 80):
        yc = y[:, :M // copies].repeat(1, copies, 1)
        cases.append((f"{copies} copies", (x, yc, full[:, :yc.shape[1]])))
    cases += [("batch", (xb, yb, vb)), ("one point", (x[:, :1], y, part)),
              ("5 y points", (x, y[:, :5], full[:, :5]))]
    err = 0.0
    for label, args in cases:
        d_k, i_k = nn_min_sqdist_fwd(*args)
        d_p, i_p = nn_min_sqdist_plain(*args)
        d_2, i_2 = nn_min_sqdist_fwd(*args)
        torch.cuda.synchronize()
        if not (torch.equal(d_k, d_p) and torch.equal(i_k, i_p)):
            raise SystemExit(
                f"K4 kernel != plain version ({label}): "
                f"{int((d_k != d_p).sum())} distances, "
                f"{int((i_k != i_p).sum())} indices of {d_k.numel()}")
        if not (torch.equal(d_k, d_2) and torch.equal(i_k, i_2)):
            raise SystemExit(f"K4 ({label}): two runs differ")
        err = max(err, float((d_k - d_p).abs().max()))
        if label.endswith("copies") and not bool(
                (i_k < args[1].shape[1] // int(label.split()[0])).all()):
            raise SystemExit(f"K4 ({label}): a tie went to a later copy")
        if label == "batch" and not (bool((d_k[1] == 1e10).all())
                                     and bool((i_k[1] == 0).all())):
            raise SystemExit("K4: the all-masked row is not 1e10 / index 0")

    def library():
        return torch.cdist(x[0], y[0][full[0]]).square().amin(1)

    # the wrapper's split rule against its neighbours at this shape, each
    # bit-equal too
    sms = chamfer._sm_count(device.index or 0) if device.type == "cuda" \
        else 1
    rule = chamfer._splits(-(-N // chamfer._X_BLOCK), M, sms)
    d_p, i_p = nn_min_sqdist_plain(x, y, full)
    split_ms = {}
    for splits in sorted({max(rule - 1, 1), rule, rule + 1}):
        with mock.patch.object(chamfer, "_splits", lambda *a: splits):
            d_k, i_k = nn_min_sqdist_fwd(x, y, full)
            if not (torch.equal(d_k, d_p) and torch.equal(i_k, i_p)):
                raise SystemExit(f"K4 at {splits} splits != plain version")
            split_ms[splits] = graph_ms(
                lambda: nn_min_sqdist_fwd(x, y, full), 20)
    ms = cuda_ms(lambda: nn_min_sqdist_fwd(x, y, full), 20)
    device_ms = graph_ms(lambda: nn_min_sqdist_fwd(x, y, full), 20)
    plain_ms = host_ms(lambda: nn_min_sqdist_plain(x, y, full))
    library_ms = cuda_ms(library, 20)
    lib_err = float((library() - nn_min_sqdist_fwd(x, y, full)[0][0])
                    .abs().max())
    bnd = bound(N * M * K4_OPS_PER_PAIR, nbytes(x, y, full) + 8 * N)
    print(f"K4 at {N} vs {M} points (one cloud a call): kernel {ms:.4f} ms "
          f"on events, {device_ms:.4f} ms of device time (CUDA graph), "
          f"plain {plain_ms:.1f} ms, library (cdist + square + amin, a "
          f"gather before) {library_ms:.4f} ms (max |diff| to the kernel "
          f"{lib_err:.3e}), bound {bnd['bound_ms']:.4f} ms by "
          f"{bnd['bound_by']}; min and argmin bit-equal and two runs equal "
          f"unmasked, masked, on y of 5 and 80 copies (ties to the least "
          f"index), on a batch with an all-masked row, on one point and on "
          f"5 y points")
    print("K4 splits of y at this shape (device time, bit-equal each): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in split_ms.items())
          + f"; the wrapper's rule takes {rule}")
    return {"name": "nn_min_sqdist", "route": "cuda",
            "source": "vistracker_tpu_torch/csrc/label_nn.cu",
            "replaces": "vistracker_tpu/ops/pallas_nn.py:28",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
            "library_ms": library_ms}


def write_smpl_pkl(root: str, rng, rings: int, segments: int) -> str:
    """A synthetic SMPL-H pkl on a closed sphere mesh (84 x 82 rings and
    segments: 6890 vertices, 13,776 faces); returns its path."""
    from vistracker_tpu_torch.core.smpl import SMPLH_PARENTS

    sv, faces = sphere_mesh(rings, segments)
    V, J = len(sv), 52
    kintree = np.zeros((2, J), np.int64)
    kintree[0] = SMPLH_PARENTS
    kintree[0, 0] = 2 ** 32 - 1
    kintree[1] = np.arange(J)
    w = rng.rand(V, J).astype(np.float32) ** 4
    jr = rng.rand(J, V).astype(np.float32)
    smpl = dict(v_template=sv * np.array([0.6, 2.0, 0.5], np.float32),
                shapedirs=rng.randn(V, 3, 16).astype(np.float32) * 0.01,
                posedirs=rng.randn(V, 3, 9 * (J - 1)).astype(np.float32)
                * 0.001,
                J_regressor=jr / jr.sum(1, keepdims=True),
                weights=w / w.sum(1, keepdims=True), f=faces,
                kintree_table=kintree, gender="male")
    smpl_pkl = os.path.join(root, "SMPLH_male.pkl")
    with open(smpl_pkl, "wb") as f:
        pickle.dump(smpl, f)
    return smpl_pkl


def fabricate(tag: str, frames: int, rings: int, segments: int, seed=0,
              obj=(35, 36)):
    """An in-memory BEHAVE-layout sequence (MemoryFrameReader) plus a
    synthetic SMPL-H pkl, assets and an object template folder on disk
    under build/chip_smoke/<tag>; returns (reader, smpl_pkl, assets,
    objects_root)."""
    from vistracker_tpu_torch.data.behave import MemoryFrameReader
    from vistracker_tpu_torch.utils.mesh import save_ply

    rng = np.random.RandomState(seed)
    root = os.path.join(WORK, tag)
    os.makedirs(os.path.join(root, "assets", "priors"), exist_ok=True)
    smpl_pkl = write_smpl_pkl(root, rng, rings, segments)
    V = rings * segments + 2
    assets = os.path.join(root, "assets")
    for name, k in (("body25_regressor", 25), ("face_regressor", 70),
                    ("hand_regressor", 42)):
        reg = rng.rand(V, k).astype(np.float32)
        with open(os.path.join(assets, f"{name}.pkl"), "wb") as f:
            pickle.dump(reg / reg.sum(0, keepdims=True), f)
    with open(os.path.join(assets, "smpl_parts_dense.pkl"), "wb") as f:
        pickle.dump({f"part{i}": np.arange(V)[np.arange(V) % 14 == i]
                     for i in range(14)}, f)
    for name, d in (("body_prior.pkl", 63), ("lh_prior.pkl", 45),
                    ("rh_prior.pkl", 45)):
        with open(os.path.join(assets, "priors", name), "wb") as f:
            pickle.dump(dict(mean=np.zeros(d), precision=np.eye(d) * 0.1), f)

    objects = os.path.join(root, "objects")
    os.makedirs(os.path.join(objects, "boxsmall"), exist_ok=True)
    save_ply(os.path.join(objects, "boxsmall", "boxsmall.ply"),
             *object_mesh(*obj))

    H, W = 1536, 2048
    color = rng.randint(0, 256, (frames, H, W, 3), dtype=np.uint8)
    pm = np.zeros((frames, H, W), bool)
    om = np.zeros((frames, H, W), bool)
    for t in range(frames):  # the object held in front of the person
        x0 = 700 + 4 * t
        pm[t, 300:1300, x0:x0 + 350] = True
        om[t, 650:950, x0 + 150:x0 + 450] = True
    kpts = np.concatenate([rng.rand(frames, 25, 1) * 350 + 700,
                           rng.rand(frames, 25, 1) * 1000 + 300,
                           np.ones((frames, 25, 1))], -1)
    reader = MemoryFrameReader(
        f"Date09_Sub01_{tag}", dict(cat="boxsmall", gender="male"),
        color, pm, om, kpts.astype(np.float32),
        (rng.randn(frames, 72) * 0.1).astype(np.float32),
        np.zeros((frames, 10), np.float32))
    return reader, smpl_pkl, assets, objects


def run_track(fab, device, out, extra=(), neural_only=False, load=True):
    """The port's `track` through its entry point on a fabricated
    sequence; random weights for every network. Returns the summary and
    the pack (None with load=False: only rank 0 of a sharded run writes
    it)."""
    from vistracker_tpu_torch.cli.main import build_parser
    from vistracker_tpu_torch.cli.real_track import run_real_track
    from vistracker_tpu_torch.data.packed import load_packed

    reader, smpl_pkl, assets, objects = fab
    mode = ["--neural-only"] if neural_only else [
        "--objects-root", objects, "--infiller-ckpt", "random",
        "--smoothnet-smpl-ckpt", "random", "--smoothnet-objrot-ckpt",
        "random"]
    args = build_parser().parse_args([
        "track", "--seq", reader.seq_name, "--out", out,
        "--smpl-model", smpl_pkl, "--assets", assets,
        "--sifnet-ckpt", "random", "--redo", "--device", device, *mode,
        *extra])
    summary = run_real_track(args, reader=reader)
    return summary, load_packed(summary["packed"]) if load else None


def check_outputs(packed: dict, T: int):
    shapes = dict(poses=(T, 156), betas=(T, 10), trans=(T, 3),
                  neural_pca=(T, 3, 3), neural_trans=(T, 3),
                  neural_visibility=(T,), obj_angles=(T, 3, 3),
                  obj_trans=(T, 3), obj_scales=(T,))
    for k, shape in shapes.items():
        v = np.asarray(packed[k])
        if v.shape != shape or not np.isfinite(v).all():
            raise SystemExit(f"packed {k}: shape {v.shape} (want {shape}), "
                             f"finite {np.isfinite(v).all()}")
    vis = np.asarray(packed["neural_visibility"])
    if vis.min() < 0.0 or vis.max() > 1.0:
        raise SystemExit(f"visibility outside [0, 1]: {vis}")
    r = np.asarray(packed["obj_angles"], np.float64)
    ortho = np.abs(r @ r.transpose(0, 2, 1) - np.eye(3)).max()
    det = np.abs(np.linalg.det(r) - 1.0).max()
    if not (ortho <= 1e-4 and det <= 1e-4):
        raise SystemExit(f"obj_angles are not proper rotations: "
                         f"|R R^T - I| {ortho:.2e}, |det - 1| {det:.2e}")


def wide_threshold():
    """The untrained SIF-Net's df never drops below the release surface
    threshold (0.004): no surface point would be kept, visibility would be
    0 and every object and silhouette term, weighted by it, would vanish.
    A threshold of 10 keeps surface points."""
    from vistracker_tpu_torch.fit import generator as gen_mod
    return mock.patch.object(gen_mod, "GeneratorConfig", functools.partial(
        gen_mod.GeneratorConfig, filter_val=10.0))


def frame_angles_deg(r1, r2) -> np.ndarray:
    """The angle in degrees between each frame's two rotations."""
    rel = np.asarray(r1, np.float64) @ np.asarray(r2, np.float64) \
        .transpose(0, 2, 1)
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1.0) * 0.5, -1.0, 1.0)
    return np.degrees(np.arccos(cos))


def angle_deg(r1, r2) -> float:
    return float(frame_angles_deg(r1, r2).max())


@phase(6, "small track, card vs CPU")
def check_small_cpu_vs_card():
    """The whole `track` at a small size (tiny SIF-Net, 64^2 inputs, 8
    frames in 2 chunks, a 122-vertex SMPL mesh, a 192-face object, 32^2
    silhouettes, short budgets in stages 1 and 6) on the CPU and on the
    card, same seeds, surface threshold widened. The neural means agree
    to 1e-3 (the top-k of near-tied points). An Adam step moves a
    parameter by about lr * sign(gradient) however small the gradient,
    so where a gradient is small against the card-vs-CPU rounding (the
    SVD behind the object rotation, the net's query) the two runs part
    by up to lr a step; wrong gradients would part them by steps * lr
    (0.18 rad, 0.18 m in stage 6). The check holds the SMPL parameters
    to 1e-3, the object translation to 5e-3 m and the object rotation to
    1 degree."""
    from vistracker_tpu_torch.fit import joint as joint_mod
    from vistracker_tpu_torch.fit import smplt as smplt_mod

    fab = fabricate("small", 8, 12, 10, obj=(8, 12))
    extra = ("--tiny-nets", "--net-size", "64", "--chunk-size", "4")
    short = functools.partial(joint_mod.JointFitConfig, smpl_max_iter=1,
                              iter_obj=1, iter_sil=2, joint_max_iter=2,
                              sil_size=32)
    short_fit = functools.partial(smplt_mod.SMPLTFitConfig, global_iters=2,
                                  max_iters=6)
    with wide_threshold(), \
            mock.patch.object(joint_mod, "JointFitConfig", short), \
            mock.patch.object(smplt_mod, "SMPLTFitConfig", short_fit):
        _, ref = run_track(fab, "cpu", os.path.join(WORK, "small", "out_cpu"),
                           extra)
        _, got = run_track(fab, "cuda",
                           os.path.join(WORK, "small", "out_cuda"), extra)
    neural = ("neural_pca", "neural_trans", "neural_visibility")
    for k in neural:
        for side, out in (("cpu", ref), ("card", got)):
            v = np.abs(np.asarray(out[k])).reshape(len(fab[0]), -1)
            if not (v.max(1) > 0).all():
                raise SystemExit(f"small track on the {side}: {k} is zero "
                                 "for some frame (no surface point kept)")
    diffs = {k: float(np.abs(np.asarray(got[k], np.float64)
                             - np.asarray(ref[k], np.float64)).max())
             for k in ("poses", "betas", "trans", "obj_trans") + neural}
    diffs["obj_angles_deg"] = angle_deg(got["obj_angles"], ref["obj_angles"])
    print(f"small whole track, card vs CPU max |diff|: {json.dumps(diffs)}")
    limits = dict.fromkeys(neural, 1e-3)
    limits.update(poses=1e-3, betas=1e-3, trans=1e-3, obj_trans=5e-3,
                  obj_angles_deg=1.0)
    bad = {k: v for k, v in diffs.items() if not v <= limits[k]}
    if bad:
        raise SystemExit(f"card and CPU disagree on the small track: {bad}")


@phase(7, "infiller schedule")
def check_infiller(T=215):
    """HVOP-Net's whole clip schedule (seed clip, two full clips, the
    truncated tail) on a synthetic stream, card against CPU: rotations
    within 1e-3 (four chained transformer passes in float32)."""
    import torch
    from vistracker_tpu_torch.fit.infill import make_infiller
    from vistracker_tpu_torch.models.infiller import (ConditionalMInfiller,
                                                      InfillerConfig)
    from vistracker_tpu_torch.models.weights import init_random_
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(3)
    poses = (rng.randn(T, 72) * 0.2).astype(np.float32)
    trans = (rng.randn(T, 3) * 0.1 + [0, 0, 2.2]).astype(np.float32)
    rots = Rotation.from_rotvec(rng.randn(T, 3)).as_matrix() \
        .astype(np.float32)
    occ = (rng.rand(T) > 0.3).astype(np.float32)
    cfg = InfillerConfig()
    model = init_random_(ConditionalMInfiller(cfg),
                         torch.Generator().manual_seed(1)).eval()
    ref = make_infiller(model, cfg)(poses, trans, rots, occ)
    t0 = time.perf_counter()
    got = make_infiller(model.to("cuda"), cfg)(poses, trans, rots, occ)
    sec = time.perf_counter() - t0
    err = float(np.abs(got - ref).max())
    print(f"infiller, {T} frames (seed + 2 full clips + tail) card vs CPU: "
          f"max |diff| {err:.3e}, {sec:.3f} s on the card")
    if not (got.shape == (T, 3, 3) and err <= 1e-3):
        raise SystemExit(f"infiller card vs CPU: max |diff| {err}")


def write_eval_packs(root: str, seq: str, T: int, holes=(), seed=5,
                     identity=False):
    """A GT pack (axis-angle object rotations) and a recon pack of T frames
    under root/gt and root/recon_out/recon_track, in the layout `evaluate
    --split` reads: smooth random SMPL-H and object motion 2.2 m from the
    camera; the recon adds noise (none for an identity pair, which stores
    the GT exactly, rotations transposed) and is missing at `holes`.
    Returns (recon path, GT path)."""
    from scipy.spatial.transform import Rotation
    from vistracker_tpu_torch.data.packed import save_packed

    rng = np.random.RandomState(seed)
    t = np.arange(T)[:, None] / 30.0

    def wave(n, amp):  # n sinusoids of random frequency and phase
        phase = t * rng.rand(1, n) * 0.5 + rng.rand(1, n)
        return (amp * np.sin(2 * np.pi * phase)).astype(np.float32)

    poses = wave(156, 0.2)
    betas = np.tile(rng.randn(1, 10).astype(np.float32) * 0.3, (T, 1))
    trans = wave(3, 0.1) + np.float32([0.0, 0.0, 2.2])
    rotvec = wave(3, 0.6)
    obj_trans = wave(3, 0.1) + np.float32([0.2, 0.0, 2.2])
    gt = os.path.join(root, "gt", f"{seq}_GT-packed.pkl")
    save_packed(gt, dict(poses=poses, betas=betas, trans=trans,
                         obj_angles=rotvec, obj_trans=obj_trans,
                         obj_scales=np.ones(T, np.float32), gender="male",
                         frames=[f"t{i:04d}.000" for i in range(T)]))
    noise = 0.0 if identity else 1.0
    rots = Rotation.from_rotvec(
        rotvec + noise * 0.05 * rng.randn(T, 3)).as_matrix()
    exist = np.ones(T, bool)
    exist[list(holes)] = False
    recon = os.path.join(root, "recon_out", "recon_track", f"{seq}_k1.pkl")
    save_packed(recon, dict(
        poses=poses + noise * 0.02 * rng.randn(T, 156).astype(np.float32),
        betas=betas, trans=trans + noise * 0.01 * rng.randn(T, 3)
        .astype(np.float32),
        obj_angles=rots.transpose(0, 2, 1).astype(np.float32),
        obj_trans=obj_trans + noise * 0.01 * rng.randn(T, 3)
        .astype(np.float32),
        obj_scales=np.ones(T, np.float32), recon_exist=exist, gender="male",
        frames=[f"t{i:04d}.000" for i in range(T)]))
    return recon, gt


@phase(8, "evaluate, card vs CPU")
def check_eval_card_vs_cpu(T=40, window=16, samples=2000):
    """`evaluate`'s per-sequence work (LBS of the 6890-vertex model, window
    refits, 2 x 2 K4 chamfers and v2v a frame) on the CPU and on the card,
    same packs: v2v and acceleration within 1e-4, the chamfers within
    1e-3, relative (the CPU tests' limits: the chamfers' squared distances
    cancel values near 10 m^2 in float32, and the two devices' LBS verts,
    and so the samples, differ in the last bits)."""
    import torch
    from vistracker_tpu_torch.cli.main import eval_one
    from vistracker_tpu_torch.core.smpl import load_smpl_pkl
    from vistracker_tpu_torch.data.behave import load_template
    from vistracker_tpu_torch.eval.evaluator import ERROR_KEYS
    from vistracker_tpu_torch.utils.mesh import save_ply

    root = os.path.join(WORK, "eval_small")
    os.makedirs(root, exist_ok=True)
    smpl_pkl = write_smpl_pkl(root, np.random.RandomState(6), 84, 82)
    save_ply(os.path.join(root, "boxsmall.ply"), *object_mesh())
    temp_v, temp_f = load_template(root, "boxsmall")
    holes = [h for h in (3, 17, 18, 33) if h < T]
    recon, gt = write_eval_packs(root, "Date09_Sub02_boxsmall", T, holes)
    errs = {}
    for dev in ("cpu", "cuda"):
        errs[dev] = eval_one(load_smpl_pkl(smpl_pkl, dev), recon, gt, temp_v,
                             temp_f, window, False, torch.device(dev),
                             chamfer_samples=samples)
    ref, got = errs["cpu"], errs["cuda"]
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-12)
    worst = dict(zip(ERROR_KEYS, rel.max(0).tolist()))
    print(f"evaluate, {T} frames ({len(ref)} with recon), window {window}, "
          f"{samples} chamfer samples, card vs CPU max relative |diff|: "
          f"{json.dumps(worst)}")
    limits = np.array([1e-3, 1e-3, 1e-4, 1e-4, 1e-4, 1e-4])
    if got.shape != (T - len(holes), 6) or not np.isfinite(got).all() \
            or not (rel.max(0) <= limits).all():
        raise SystemExit(f"evaluate card vs CPU: shape {got.shape}, worst "
                         f"{worst}, limits {limits.tolist()}")


def json_floats(tree):
    """Every float in a loaded JSON tree."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from json_floats(v)
    elif isinstance(tree, float):
        yield tree


@phase(10, "evaluate")
def run_evaluate_path(fab, track_pack: str) -> int:
    """`evaluate` through the port's entry point on the card at release
    settings: (a) the main path's `track` pack against a GT pack of the
    fabricated sequence's own parameters (its mocap poses and betas, a
    person 2.2 m from the camera holding the object at rest), single-
    sequence mode with --angles; (b) split mode over a 600-frame recon
    with 5% recon_exist holes (two windows of 300, so the window's refit
    runs) and a 30-frame identity pair. Before each run K4's count is set to 0; after it, it
    must read 4 per evaluated frame. Returns K4's launches over both."""
    import torch
    from vistracker_tpu_torch.cli.main import build_parser, run_evaluate
    from vistracker_tpu_torch.data.packed import load_packed, save_packed
    from vistracker_tpu_torch.eval.evaluator import ERROR_KEYS
    from vistracker_tpu_torch.ops import chamfer

    reader, smpl_pkl, _, objects = fab
    root = os.path.join(WORK, "evaluate")
    T = len(load_packed(track_pack)["poses"])
    poses, betas = (np.stack(a) for a in zip(
        *(reader.get_mocap_params(i, 1) for i in range(T))))
    gt = os.path.join(root, "gt", f"{reader.seq_name}_GT-packed.pkl")
    save_packed(gt, dict(
        poses=np.concatenate([poses, np.zeros((T, 84), np.float32)], 1),
        betas=betas, trans=np.tile(np.float32([0, 0, 2.2]), (T, 1)),
        obj_angles=np.zeros((T, 3), np.float32),
        obj_trans=np.tile(np.float32([0.2, 0, 2.2]), (T, 1)),
        obj_scales=np.ones(T, np.float32), gender="male",
        frames=list(reader.frames)))
    hole_rng = np.random.RandomState(7)
    holes = np.flatnonzero(hole_rng.rand(600) < 0.05)
    write_eval_packs(root, "Date09_Sub03_boxsmall", 600, holes, seed=8)
    write_eval_packs(root, "Date09_Sub04_boxsmall", 30, seed=9,
                     identity=True)
    split = os.path.join(root, "split.json")
    with open(split, "w") as f:
        json.dump({"seqs": ["Date09_Sub03_boxsmall",
                            "Date09_Sub04_boxsmall"]}, f)
    runs = (("track pack, single-sequence, --angles",
             ["--recon", track_pack, "--gt", gt, "--template",
              os.path.join(objects, "boxsmall", "boxsmall.ply"), "--angles"]),
            ("600 + 30 frames, split",
             ["--split", split, "--gt-root", os.path.join(root, "gt"),
              "--recon-root", os.path.join(root, "recon_out"),
              "--objects-root", objects]))
    total = 0
    for label, args in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        chamfer.nn_min_sqdist_fwd.launches = 0
        t0 = time.perf_counter()
        outfile = run_evaluate(build_parser().parse_args(
            ["evaluate", *args, "--smpl-model", smpl_pkl, "--out",
             os.path.join(root, "results")]))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = chamfer.nn_min_sqdist_fwd.launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(outfile) as f:
            res = json.load(f)
        n = res["total"]
        means = {k: res[k]["mean"] for k in (*ERROR_KEYS, "rot_error")
                 if k in res}
        print(f"evaluate ({label}): {n} frames evaluated in {sec:.3f} s "
              f"({sec / n:.4f} s a frame), peak {peak:.2f} GiB; K4 launches "
              f"{launches}; mean errors {json.dumps(means)}")
        if launches == 0 or launches != 4 * n:
            raise SystemExit(f"evaluate ({label}): K4 launched {launches} "
                             f"times for {n} frames (want 4 a frame)")
        if not np.isfinite(list(json_floats(res))).all():
            raise SystemExit(f"evaluate ({label}): non-finite errors")
        total += launches
    ident = res["separate"]["Date09_Sub04_boxsmall"]
    if not (ident["smpl_v2v"]["mean"] < 1e-3 and ident["obj_v2v"]["mean"]
            < 1e-3):
        raise SystemExit(f"evaluate: the identity pair's v2v is not 0: "
                         f"{ident}")
    return total


class PhaseProbe:
    """Wraps fit/joint.py:_adam_phase for the main path's non-vacuity
    checks: the object translation each chunk's first object phase starts
    from, and the silhouette phase's loss gradient at its first step. The
    object optimizer runs its phases in the order object, silhouette,
    joint, each on the leaves {obj_r, obj_t}; the probe tells them apart
    by that order. The probe's own forward and backward are kept out of
    the launch counts: the counts are put back to what they were."""

    PHASES = ("object", "silhouette", "joint")

    def __init__(self, joint_mod, counters):
        self.inner = joint_mod._adam_phase
        self.counters = counters
        self.object_calls = 0
        self.t_init, self.sil_grads = [], []

    def __call__(self, loss_fn, params, lrs, max_iters, spi, decay_fn,
                 *rest, **kw):
        import torch
        if set(params) == {"obj_r", "obj_t"}:
            phase = self.PHASES[self.object_calls % len(self.PHASES)]
            self.object_calls += 1
            if phase == "silhouette":
                counts = self.counters.read()
                leaves = {k: v.detach().clone().requires_grad_(True)
                          for k, v in params.items()}
                grads = torch.autograd.grad(
                    loss_fn(leaves, decay_fn(0)), list(leaves.values()))
                self.sil_grads.append(dict(zip(leaves, grads)))
                probed = self.counters.read()
                if not (probed["max_logit_fwd_soft"]
                        > counts["max_logit_fwd_soft"]
                        and probed["max_logit_bwd"]
                        > counts["max_logit_bwd"]):
                    raise SystemExit("main path: the phase taken for the "
                                     "silhouette phase launched no "
                                     "silhouette kernel")
                self.counters.write(counts)
            elif phase == "object":
                self.t_init.append(params["obj_t"].detach().cpu().numpy())
        return self.inner(loss_fn, params, lrs, max_iters, spi, decay_fn,
                          *rest, **kw)


class LaunchCounts:
    """The kernels' launch counts, by the names of the {"kernels": ...}
    line. The forward max-logit kernel has one count in its wrapper; the
    launches made for the soft silhouette are counted where its
    autograd.Function calls the wrapper, and the rest are the hard
    mask's."""

    def __init__(self):
        from vistracker_tpu_torch.ops import chamfer, coverage, label_nn
        self.cov, self.nn, self.chamfer = coverage, label_nn, chamfer

    def read(self) -> dict:
        soft = self.cov._MaxLogit.fwd_launches
        return {"max_logit_fwd": self.cov.max_logit_fwd.launches - soft,
                "max_logit_fwd_soft": soft,
                "max_logit_bwd": self.cov.max_logit_bwd.launches,
                "label_nn": self.nn.label_nn_fwd.launches,
                "nn_min_sqdist": self.chamfer.nn_min_sqdist_fwd.launches}

    def write(self, counts: dict):
        self.cov._MaxLogit.fwd_launches = counts["max_logit_fwd_soft"]
        self.cov.max_logit_fwd.launches = (counts["max_logit_fwd"]
                                           + counts["max_logit_fwd_soft"])
        self.cov.max_logit_bwd.launches = counts["max_logit_bwd"]
        self.nn.label_nn_fwd.launches = counts["label_nn"]
        self.chamfer.nn_min_sqdist_fwd.launches = counts["nn_min_sqdist"]


def occlude_few_infiller():
    """The untrained net's visibility hovers around 0.5, the infiller's
    occlusion threshold, on either side of it. With the threshold placed
    inside this run's visibilities so that a tenth of the frames (at most
    all but 30) count as occluded, the seed gate (30 visible frames)
    passes from 30 frames on and HVOP-Net really infills, for any
    weights."""
    from vistracker_tpu_torch.fit import infill as infill_mod
    make = infill_mod.make_infiller

    def make_with_threshold(model, cfg):
        run = make(model, cfg)

        def run_with_threshold(poses, trans, rots, occ):
            n_occluded = max(0, min(len(occ) // 10, len(occ) - cfg.window))
            thr = float(np.sort(np.asarray(occ).reshape(-1))[n_occluded])
            return run(poses, trans, rots, occ, occ_thres=thr,
                       init_thres=thr)
        return run_with_threshold

    return mock.patch.object(infill_mod, "make_infiller",
                             make_with_threshold)


@phase(9, "main path")
def run_main_path(frames: int, chunk: int, device="cuda", extra=(),
                  mesh=(84, 82), kpts_scale=1.0):
    """The whole `track` at release width on the card, `frames` frames in
    chunks of `chunk`, at MAIN_FIT / MAIN_JOINT; every kernel's count set
    to 0 just before. Returns (the launch counts, the fabricated
    sequence, the pack's path, the host "inputs" seconds a frame).
    kpts_scale != 1 scales the keypoints (the sensitivity run,
    --sensitivity)."""
    import torch
    from vistracker_tpu_torch.fit import joint as joint_mod

    tag = f"main{frames}" + ("" if kpts_scale == 1.0 else "p")
    fab = fabricate(tag, frames, *mesh)
    fab[0].kpts = (fab[0].kpts * np.float32(kpts_scale)).astype(np.float32)
    counters = LaunchCounts()
    probe = PhaseProbe(joint_mod, counters)
    pairs = []  # (compatible, all) pairs of each K3 plan: 2 a chunk
    make_plan = joint_mod.label_nn_plan

    def counted_plan(labels_x, labels_y, y_valid):
        plan = make_plan(labels_x, labels_y, y_valid)
        pairs.append((compatible_pairs(labels_x, labels_y, y_valid),
                      labels_x.numel() * labels_y.shape[1]))
        return plan

    with wide_threshold(), occlude_few_infiller(), \
            fit_budgets(MAIN_FIT, MAIN_JOINT), \
            mock.patch.object(joint_mod, "_adam_phase", probe), \
            mock.patch.object(joint_mod, "label_nn_plan", counted_plan):
        counters.write(dict.fromkeys(counters.read(), 0))
        summary, packed = run_track(
            fab, device, os.path.join(WORK, tag, "out"),
            ("--chunk-size", str(chunk), *extra))
        launches = counters.read()
    check_outputs(packed, frames)
    vis = np.asarray(packed["neural_visibility"])
    if not (vis > 0).all():
        raise SystemExit(f"main path: visibility is 0 for some frame: {vis}")
    n_chunks = -(-frames // chunk)
    if probe.object_calls != 3 * n_chunks \
            or len(probe.sil_grads) != n_chunks or len(pairs) != 2 * n_chunks:
        raise SystemExit("main path: the stage-6 phases were not seen")
    gmax = {}
    for g in probe.sil_grads:
        for k, v in g.items():
            if not bool(torch.isfinite(v).all()) or float(v.abs().max()) == 0:
                raise SystemExit(f"main path: the silhouette phase's first "
                                 f"gradient w.r.t. {k} is zero or not finite")
            gmax[k] = max(gmax.get(k, 0.0), float(v.abs().max()))
    moved = float(np.abs(np.asarray(packed["obj_trans"])
                         - np.concatenate(probe.t_init)).max())
    if not moved > 0:
        raise SystemExit("main path: obj_trans did not move from its init")
    if frames >= 30 and not summary["stage5_infilled"]:
        raise SystemExit("main path: HVOP-Net did not run (pass-through)")
    peaks = summary.get("stage_peak_gib", dict.fromkeys(
        summary["stage_seconds"], 0.0))
    print(f"main path: {frames} frames in chunks of {chunk} in "
          f"{summary['seconds']:.2f} s ({summary['fps']:.3f} frames/s), "
          f"peak device memory {max(peaks.values()):.2f} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}"
          f"; random draws {summary['draw_seconds']:.4f} s on the host; "
          f"visibility {vis.min():.4f}..{vis.max():.4f}; first silhouette "
          f"gradient max |.| {json.dumps(gmax)}; obj_trans moved by up to "
          f"{moved:.4f} m; iterations smpl "
          f"{summary['iters_smpl_mean']}, joint "
          f"{summary['iters_joint_mean']}; launches {json.dumps(launches)}")
    print("  joint phase, K3's compatible pairs a chunk (human -> object, "
          "object -> human) from the frozen contact masks: "
          + ", ".join(f"{c} of {a} ({c / a:.4%})" for c, a in pairs))
    for stage, sec in summary["stage_seconds"].items():
        print(f"  {stage}: {sec:.3f} s, peak {peaks[stage]:.2f} GiB")
    return (launches, fab, summary["packed"],
            summary["stage_seconds"]["inputs"] / frames)


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def check_launched(label: str, launches: dict, names) -> None:
    missing = [n for n in names if launches[n] < 1]
    if missing:
        raise SystemExit(f"{label}: {missing} not launched ({launches})")


# `track`'s Adam budgets in stages 1 and 6 (stage 2's refit keeps its
# 30 iterations): the main path's and phase 18's are a quarter of the
# release's (fit/smplt.py:SMPLTFitConfig global_iters 8, max_iters 100;
# fit/joint.py:JointFitConfig smpl_max_iter 100, iter_obj 15, iter_sil
# 30, joint_max_iter 110), rounded up; the fixture's a tenth. A change
# of MAIN_* needs a --sensitivity run and SHARD_LIMITS derived from it.
# Phase 21 runs `track` at the release's budgets.
MAIN_FIT = dict(global_iters=2, max_iters=25)
MAIN_JOINT = dict(smpl_max_iter=25, iter_obj=4, iter_sil=8,
                  joint_max_iter=28)
FIXTURE_FIT = dict(global_iters=2, max_iters=10)
FIXTURE_JOINT = dict(smpl_max_iter=10, iter_obj=2, iter_sil=3,
                     joint_max_iter=11)


@contextlib.contextmanager
def fit_budgets(fit: dict, joint: dict):
    """`track` with SMPLTFitConfig and JointFitConfig built at these
    budgets (every other field as it was)."""
    from vistracker_tpu_torch.fit import joint as joint_mod
    from vistracker_tpu_torch.fit import smplt as smplt_mod
    with mock.patch.object(smplt_mod, "SMPLTFitConfig", functools.partial(
            smplt_mod.SMPLTFitConfig, **fit)), \
            mock.patch.object(joint_mod, "JointFitConfig", functools.partial(
                joint_mod.JointFitConfig, **joint)):
        yield


@phase(11, "fixture from disk")
def run_fixture_path(frames=8, raster=512, chunk=16,
                     memory_inputs_s=float("nan")):
    """Phase 11: the fixture written on the card, read back from disk
    without PIL, tracked from disk and evaluated against its GT pack
    (memory_inputs_s: the main path's host "inputs" seconds a frame, from
    frames held in memory, printed beside the disk path's). Returns the
    launch counts of the `track` and `evaluate` runs and the fixture's
    paths (generate_fixture_sequence's dict)."""
    import torch
    from vistracker_tpu_torch.cli.main import build_parser, run_evaluate
    from vistracker_tpu_torch.cli.real_track import run_real_track
    from vistracker_tpu_torch.data import imageio
    from vistracker_tpu_torch.data.behave import FrameDataReader
    from vistracker_tpu_torch.data.fixture import generate_fixture_sequence
    from vistracker_tpu_torch.data.packed import load_packed

    root = os.path.join(WORK, "fixture")
    written = {"color": [], "mask": []}
    enc_jpeg, enc_png = imageio.encode_jpeg, imageio.encode_png

    def keep(kind, enc):
        def call(arr, *a, **k):
            written[kind].append(np.array(arr))
            return enc(arr, *a, **k)
        return call

    timings = {}
    t0 = time.perf_counter()
    with mock.patch.object(imageio, "encode_jpeg", keep("color", enc_jpeg)), \
            mock.patch.object(imageio, "encode_png", keep("mask", enc_png)):
        fx = generate_fixture_sequence(root, T=frames, seed=0, raster=raster,
                                       device="cuda", timings=timings)
    gen_s = time.perf_counter() - t0
    print(f"fixture: {frames} frames of 2048x1536 at raster {raster} "
          f"generated on the card in {gen_s:.3f} s: render "
          f"{timings['render']:.3f} s, encode {timings['encode']:.3f} s, "
          f"write {timings['write']:.3f} s; render peak "
          f"{timings.get('render_peak_gib', 0.0):.2f} GiB")

    saved = sys.modules.get("PIL", "absent")
    sys.modules["PIL"] = None          # the reader must not need PIL
    try:
        reader = FrameDataReader(fx["seq_dir"])
        t0 = time.perf_counter()
        got = [(reader.get_color(i, 1), reader.get_mask(i, 1, "person"),
                reader.get_mask(i, 1, "obj")) for i in range(len(reader))]
        read_s = time.perf_counter() - t0
    finally:
        if saved == "absent":
            del sys.modules["PIL"]
        else:
            sys.modules["PIL"] = saved
    if len(got) != frames:
        raise SystemExit(f"fixture: read {len(got)} frames of {frames}")
    psnrs = []
    for i, (rgb, pm, om) in enumerate(got):
        for mine, ref in ((pm, written["mask"][2 * i]),
                          (om, written["mask"][2 * i + 1])):
            if not np.array_equal(mine, ref > 127):
                raise SystemExit(f"fixture frame {i}: a mask read from disk "
                                 "differs from the generator's")
        psnrs.append(psnr(rgb, written["color"][i]))
    if min(psnrs) < 30.0:
        raise SystemExit(f"fixture: colour PSNR {min(psnrs):.2f} dB < 30")
    with open(os.path.join(fx["seq_dir"], reader.frames[0], "k1.color.jpg"),
              "rb") as f:
        frame_jpeg = f.read()
    noise_jpeg = imageio.encode_jpeg(np.random.RandomState(11).randint(
        0, 256, (1536, 2048, 3), dtype=np.uint8))
    dec = {}
    for label, data in (("fixture frame", frame_jpeg),
                        ("2048x1536 noise", noise_jpeg)):
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            imageio.decode_jpeg(data)
            ts.append((time.perf_counter() - t0) * 1e3)
        dec[label] = float(np.median(ts))
    print(f"fixture read back without PIL: {frames} frames (colour + 2 masks)"
          f" in {read_s:.3f} s; masks bit-equal to the generator's; colour "
          f"PSNR {min(psnrs):.2f}..{max(psnrs):.2f} dB; JPEG decode "
          + ", ".join(f"{k} ({len(d)} bytes) {dec[k]:.2f} ms" for k, d in
                      (("fixture frame", frame_jpeg),
                       ("2048x1536 noise", noise_jpeg))))

    counters = LaunchCounts()
    out = os.path.join(root, "out")
    with wide_threshold(), occlude_few_infiller(), \
            fit_budgets(FIXTURE_FIT, FIXTURE_JOINT):
        counters.write(dict.fromkeys(counters.read(), 0))
        summary = run_real_track(build_parser().parse_args([
            "track", "--seq", fx["seq_dir"], "--out", out,
            "--smpl-model", fx["model_pkl"], "--assets", fx["assets_root"],
            "--objects-root", fx["objects_root"], "--sifnet-ckpt", "random",
            "--infiller-ckpt", "random", "--smoothnet-smpl-ckpt", "random",
            "--smoothnet-objrot-ckpt", "random", "--chunk-size", str(chunk),
            "--redo"]))
        launches = counters.read()
    check_outputs(load_packed(summary["packed"]), frames)
    check_launched("fixture track", launches, ("max_logit_fwd",
                                               "max_logit_fwd_soft",
                                               "max_logit_bwd", "label_nn"))
    peaks = summary.get("stage_peak_gib", {})
    print(f"fixture track from disk: {frames} frames in chunks of {chunk} in "
          f"{summary['seconds']:.2f} s ({summary['fps']:.3f} frames/s); "
          f"inputs {summary['stage_seconds']['inputs'] / frames:.4f} s a "
          f"frame from disk ({memory_inputs_s:.4f} from memory on the main "
          f"path); launches {json.dumps(launches)}")
    for stage, sec in summary["stage_seconds"].items():
        print(f"  {stage}: {sec:.3f} s, peak {peaks.get(stage, 0.0):.2f} GiB")

    from vistracker_tpu_torch.ops import chamfer
    chamfer.nn_min_sqdist_fwd.launches = 0
    t0 = time.perf_counter()
    outfile = run_evaluate(build_parser().parse_args([
        "evaluate", "--recon", summary["packed"], "--gt", fx["gt_pack"],
        "--template", os.path.join(fx["objects_root"], "boxmedium",
                                   "boxmedium.ply"),
        "--smpl-model", fx["model_pkl"], "--angles",
        "--out", os.path.join(root, "results")]))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    with open(outfile) as f:
        res = json.load(f)
    n, k4 = res["total"], chamfer.nn_min_sqdist_fwd.launches
    if k4 != 4 * n or n != frames:
        raise SystemExit(f"fixture evaluate: K4 launched {k4} times for {n} "
                         f"frames (want 4 a frame, {frames} frames)")
    keys = ("smpl_v2v", "obj_v2v", "smpl_chamf", "obj_chamf")
    if not np.isfinite([res[k]["mean"] for k in keys]).all():
        raise SystemExit(f"fixture evaluate: non-finite errors {res}")
    print(f"fixture evaluate against its GT pack: {n} frames in {sec:.3f} s; "
          f"K4 launches {k4}; means "
          + json.dumps({k: res[k]["mean"] for k in (*keys, "rot_error")
                        if k in res}))
    launches["nn_min_sqdist"] = k4
    return launches, dict(fx, track_pack=summary["packed"])


@phase(12, "track --synthetic --render")
def run_synthetic_path() -> dict:
    """Phase 12: `track --synthetic --render` at the JAX command line's
    defaults on the card; returns its launch counts. The GT | recon GIF
    must hold T frames of 128 x 256."""
    from vistracker_tpu_torch.cli.main import build_parser, run_synthetic_track

    counters = LaunchCounts()
    counters.write(dict.fromkeys(counters.read(), 0))
    out = os.path.join(WORK, "synthetic")
    args = build_parser().parse_args(["track", "--synthetic", "--render",
                                      "--out", out])
    t0 = time.perf_counter()
    res = run_synthetic_track(args)
    sec = time.perf_counter() - t0
    launches = counters.read()
    check_launched("track --synthetic", launches, launches)
    if not np.isfinite([res["smpl_v2v_cm"], res["obj_v2v_cm"]]).all():
        raise SystemExit(f"track --synthetic: non-finite v2v {res}")
    screen, images, _ = gif_frames(os.path.join(out, "side_by_side.gif"))
    if screen != (256, 128) or images != [(256, 128)] * args.frames:
        raise SystemExit(f"track --synthetic --render: {len(images)} "
                         f"frames on {screen} (want {args.frames} of 256 x "
                         "128)")
    print(f"track --synthetic --render ({args.frames} frames, the JAX "
          "defaults): "
          f"{sec:.3f} s; smpl v2v {res['smpl_v2v_cm']:.4f} cm, obj v2v "
          f"{res['obj_v2v_cm']:.4f} cm; GIF {len(images)} frames of "
          f"{screen[0]} x {screen[1]}; launches {json.dumps(launches)}; "
          f"stage seconds {json.dumps(res['timings'])}")
    return launches


# ---------------------------------------------------------------------------
# phases 16-17: rendering and the stage-6 term probe
# ---------------------------------------------------------------------------

def gif_frames(path: str):
    """Walk an animated GIF's blocks without decoding: ((logical width,
    height), [(width, height) of each image], the NETSCAPE loop count or
    None)."""
    import struct

    with open(path, "rb") as f:
        data = f.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path} is not a GIF")
    w, h, flags = struct.unpack("<HHB", data[6:11])
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)

    def skip_sub_blocks(pos):
        while data[pos]:
            pos += data[pos] + 1
        return pos + 1

    images, loop = [], None
    while True:
        kind = data[pos]
        if kind == 0x3B:
            return (w, h), images, loop
        if kind == 0x21:
            label = data[pos + 1]
            if label == 0xFF and data[pos + 3:pos + 14] == b"NETSCAPE2.0":
                loop = struct.unpack("<H", data[pos + 16:pos + 18])[0]
            pos = skip_sub_blocks(pos + 2)
        elif kind == 0x2C:
            iw, ih, iflags = struct.unpack("<HHB", data[pos + 5:pos + 10])
            images.append((iw, ih))
            pos += 10 + (3 << ((iflags & 7) + 1) if iflags & 0x80 else 0)
            pos = skip_sub_blocks(pos + 1)  # LZW minimum code size first
        else:
            raise ValueError(f"{path}: unknown GIF block 0x{kind:02x}")


MP4_CONTAINERS = ("moov", "trak", "mdia", "minf", "stbl", "dinf")


def mp4_walk(path: str) -> dict:
    """Walk an .mp4's boxes without decoding: {"top": the top-level box
    types in order, "width"/"height" (tkhd), "fps" (mdhd timescale over
    the stts delta), "dsi": the esds DecoderSpecificInfo, "sizes" (stsz),
    "offsets": each sample's file offset (stco chunks split by stsc),
    "starts": each sample's first 4 bytes}. Raises ValueError on a box
    that overruns its parent."""
    import struct

    with open(path, "rb") as f:
        data = f.read()
    boxes = {}

    def walk(start, end, prefix):
        types, pos = [], start
        while pos < end:
            if pos + 8 > end:
                raise ValueError(f"{path}: truncated box at {pos}")
            size, kind = struct.unpack(">I4s", data[pos:pos + 8])
            kind = kind.decode("latin-1")
            if size < 8 or pos + size > end:
                raise ValueError(f"{path}: box {kind!r} at {pos} overruns")
            types.append(kind)
            boxes.setdefault(prefix + kind, (pos + 8, pos + size))
            if kind in MP4_CONTAINERS:
                walk(pos + 8, pos + size, prefix + kind + "/")
            pos += size
        return types

    top = walk(0, len(data), "")
    stbl = "moov/trak/mdia/minf/stbl/"

    def body(name):
        if stbl + name not in boxes and name not in boxes:
            raise ValueError(f"{path}: no {name} box")
        return boxes.get(stbl + name, boxes.get(name))

    def u32s(name, skip, count_at):
        lo, _ = body(name)
        n = struct.unpack(">I", data[lo + count_at:lo + count_at + 4])[0]
        at = lo + skip
        return list(struct.unpack(f">{n}I", data[at:at + 4 * n]))

    lo, _ = boxes["moov/trak/tkhd"]
    width, height = (v >> 16 for v in struct.unpack(
        ">II", data[lo + 76:lo + 84]))
    lo, _ = boxes["moov/trak/mdia/mdhd"]
    timescale = struct.unpack(">I", data[lo + 12:lo + 16])[0]
    lo, _ = body("stts")
    delta = struct.unpack(">I", data[lo + 12:lo + 16])[0]
    sizes = u32s("stsz", 12, 8)
    chunks = u32s("stco", 8, 4)
    lo, _ = body("stsc")
    n = struct.unpack(">I", data[lo + 4:lo + 8])[0]
    runs = [struct.unpack(">III", data[lo + 8 + 12 * i:lo + 20 + 12 * i])
            for i in range(n)]
    offsets = []
    for c, at in enumerate(chunks, 1):   # samples a chunk from stsc
        per = [spc for first, spc, _ in runs if first <= c][-1]
        for _ in range(per):
            offsets.append(at)
            at += sizes[len(offsets) - 1]
    # the sample entry: 8 + 78 bytes before its esds box
    lo, hi = body("stsd")
    esds = data.index(b"esds", lo) + 4 + 4   # past the type and version
    pos, dsi = esds, None
    while pos < hi and dsi is None:
        tag, pos = data[pos], pos + 1
        length = 0
        while True:
            b, pos = data[pos], pos + 1
            length = (length << 7) | (b & 0x7F)
            if not b & 0x80:
                break
        if tag == 0x03:
            pos += 3                          # ES_ID, flags
        elif tag == 0x04:
            pos += 13                         # object type ... avgBitrate
        elif tag == 0x05:
            dsi = data[pos:pos + length]
        else:
            pos += length
    return {"top": top, "width": width, "height": height,
            "fps": timescale / delta, "dsi": dsi, "sizes": sizes,
            "offsets": offsets,
            "starts": [data[o:o + 4] for o in offsets]}


def pack_in_contact(gt_pack: str, model_pkl: str, template: str, out: str,
                    gap: float = 0.01) -> str:
    """A copy of a GT pack (axis-angle object rotations) with the object
    moved, frame by frame, so that its template vertex nearest to a SMPL
    vertex lies `gap` from it: a scene whose contact spheres must be drawn
    (the fixture's object stays 13-31 cm from the body). Returns out."""
    from scipy.spatial import cKDTree
    from vistracker_tpu_torch.core.smpl import load_smpl_pkl
    from vistracker_tpu_torch.data.packed import (gt_obj_verts, load_packed,
                                                  save_packed)
    from vistracker_tpu_torch.eval.evaluator import smpl_verts_from_packed
    from vistracker_tpu_torch.utils.mesh import load_ply

    d = load_packed(gt_pack)
    poses = np.asarray(d["poses"]).reshape(len(d["poses"]), -1)
    sv = smpl_verts_from_packed(load_smpl_pkl(model_pkl), poses,
                                np.asarray(d["betas"]),
                                np.asarray(d["trans"]))
    temp_v = load_ply(template)[0]
    ov = gt_obj_verts(temp_v - temp_v.mean(0), np.asarray(d["obj_angles"]),
                      np.asarray(d["obj_trans"]))
    trans = np.array(d["obj_trans"], np.float32)
    for i in range(len(sv)):
        dist, idx = cKDTree(sv[i]).query(ov[i])
        j = int(np.argmin(dist))
        step = sv[i][idx[j]] - ov[i][j]
        trans[i] += step * (1.0 - gap / max(float(dist[j]), gap))
    save_packed(out, {**d, "obj_trans": trans})
    return out


def images_agree(label: str, card, cpu, tol=1e-5, share=1e-3) -> float:
    """At most `share` of the pixels may differ by more than tol (z-buffer
    ties: two surfaces at one depth within float32 rounding); returns the
    share that does."""
    bad = float((np.abs(np.asarray(card) - np.asarray(cpu)) > tol)
                .any(-1).mean())
    if not (np.asarray(card).shape == np.asarray(cpu).shape
            and bad <= share):
        raise SystemExit(f"{label}: card and CPU renders differ in "
                         f"{bad:.4%} of the pixels (at most {share:.1%} may)")
    return bad


@phase(16, "render")
def run_render_path(fx: dict, track_pack: str, size: int = 256,
                    card: str = "cuda") -> dict:
    """Phase 16: `render` through the port's entry point on the card over
    the fixture of phase 11: its `track` pack beside the fixture's GT pack
    with the object moved into contact (pack_in_contact), --top
    --contact-spheres; both GIFs parsed (T frames of size x 2 size),
    contact spheres drawn in at least one frame; seconds a rendered frame,
    peak GiB and the GIF writer's ms a frame; then one frame of
    render_meshes_perspective and one of render_top_view, card against
    CPU on the same meshes."""
    import torch
    from vistracker_tpu_torch.cli.main import main as cli_main
    from vistracker_tpu_torch.data import gif
    from vistracker_tpu_torch.render import viz

    root = os.path.join(WORK, "render")
    os.makedirs(root, exist_ok=True)
    template = os.path.join(fx["objects_root"], "boxmedium",
                            "boxmedium.ply")
    contact = pack_in_contact(fx["gt_pack"], fx["model_pkl"], template,
                              os.path.join(root, "gt_in_contact.pkl"))
    out = os.path.join(root, "side_by_side.gif")
    drawn, kept, gif_s = [], [], []
    real_cs, real_gif = viz.contact_spheres, gif.save_gif

    def spheres(*a, **k):
        got = real_cs(*a, **k)
        drawn.append(len(got))
        kept.append(a)
        return got

    def timed_gif(frames, *a, **k):
        t0 = time.perf_counter()
        path = real_gif(frames, *a, **k)
        gif_s.append((time.perf_counter() - t0, len(frames)))
        return path

    on_card = card != "cpu"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(viz, "contact_spheres", spheres), \
            mock.patch.object(gif, "save_gif", timed_gif):
        cli_main(["render", "--recon", track_pack, "--recon2", contact,
                  "--template", template, "--smpl-model", fx["model_pkl"],
                  "--top", "--contact-spheres", "--assets",
                  fx["assets_root"], "--size", str(size), "--out", out,
                  "--device", card])
    if on_card:
        torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0
    T = len(fx["occ_ratios"])
    for path in (out, os.path.join(root, "side_by_side_top.gif")):
        if not os.path.isfile(path):
            raise SystemExit(f"render: {path} was not written")
        screen, images, loop = gif_frames(path)
        if screen != (2 * size, size) or images != [(2 * size, size)] * T \
                or loop != 0:
            raise SystemExit(f"render: {path} holds {len(images)} images "
                             f"of {set(images)} on {screen}, loop {loop} "
                             f"(want {T} of {(2 * size, size)}, loop 0)")
    if not any(drawn):
        raise SystemExit("render: no frame drew a contact sphere")
    frames = 2 * T                       # two videos of T frames
    gif_ms = 1e3 * sum(t for t, _ in gif_s) / sum(n for _, n in gif_s)
    print(f"render (--top --contact-spheres, {T} frames of {size} x "
          f"{2 * size}, two videos): {sec:.3f} s, {sec / frames:.4f} s a "
          f"rendered frame (GIF writing included), peak {peak:.2f} GiB; "
          f"GIF writer {gif_ms:.2f} ms a frame; contact spheres in "
          f"{sum(1 for n in drawn if n)} of {len(drawn)} meshes' frames")

    # one frame, card against CPU: the contact side's frame 0 meshes
    from vistracker_tpu_torch.core.camera import PerspectiveCamera
    from vistracker_tpu_torch.core.smpl import load_smpl_pkl
    from vistracker_tpu_torch.utils.mesh import decimate_faces, load_ply
    smpl_v, part_labels, obj_v = kept[-1][:3]
    faces = decimate_faces(load_smpl_pkl(fx["model_pkl"]).faces, 4000)
    temp_f = decimate_faces(load_ply(template)[1], 2500)
    meshes = [(smpl_v, faces, (0.4, 0.8, 0.4)),
              (obj_v, temp_f, (0.9, 0.6, 0.2))]
    meshes += [(v, f, c) for c, v, f in real_cs(smpl_v, part_labels, obj_v)]
    cam = PerspectiveCamera()
    cc = cam.project_screen(torch.as_tensor(
        smpl_v.mean(0, keepdims=True))[None]).numpy()[0, 0]
    shares = [images_agree(
        f"render {label}",
        *[fn(dev) for dev in (card, "cpu")])
        for label, fn in (
            ("front", lambda d: viz.render_meshes_perspective(
                meshes, cam, cc, size, device=d)),
            ("top", lambda d: viz.render_top_view(meshes, cam, size,
                                                  device=d)))]
    print(f"render card vs CPU, one frame ({len(meshes)} meshes): front "
          f"{shares[0]:.4%}, top {shares[1]:.4%} of the pixels apart by "
          "more than 1e-5 (at most 0.1% may)")
    return {"seconds_per_frame": sec / frames, "peak_gib": peak,
            "gif_ms_per_frame": gif_ms}


def stage6_problem(T=8, size=256, seed=8, mesh=(84, 82),
                   obj=(35, 36)) -> dict:
    """The stage-6 problem of phases 17 and 18 at the main path's widths,
    as host arrays: T frames, a body of the main path's sphere mesh
    (6890 vertices at 84 x 82), the 2,520-face ellipsoid template
    decimated to 2,500 faces for T silhouette views at size^2 with 3,000
    surface points, the object pressed against the body so both contact
    masks hold points, and the parameters of an analytic distance field
    in place of SIF-Net (stage6_optimizer). `mesh` and `obj` are the
    body's and the template's sphere meshes (rings, segments)."""
    import torch
    from scipy.spatial.transform import Rotation
    from vistracker_tpu_torch.core.camera import PerspectiveCamera
    from vistracker_tpu_torch.utils.mesh import decimate_faces, sample_surface

    rng = np.random.RandomState(seed)
    hum_c = np.array([0.0, 0.0, 2.4], np.float32)
    sv, _ = sphere_mesh(*mesh)
    body = sv * np.array([0.6, 2.0, 0.5], np.float32) + hum_c
    drift = rng.randn(T, 1, 3).astype(np.float32) * 0.01
    temp_v, temp_f = object_mesh(*obj)
    obj_t = (np.array([0.05, 0.0, 2.14], np.float32) + drift[:, 0]
             + rng.randn(T, 3).astype(np.float32) * 0.005)
    obj_r = Rotation.from_rotvec(rng.randn(T, 3) * 0.2).as_matrix() \
        .astype(np.float32)
    center_px = PerspectiveCamera().project_screen(
        torch.as_tensor(obj_t)[:, None])[:, 0]
    roi = torch.cat([center_px - 150.0, torch.full((T, 1), 300.0)], 1)
    yy, xx = np.mgrid[0:size, 0:size] / (size - 1.0) * 2 - 1
    ref = ((xx - 0.05) ** 2 / 0.5 + (yy + 0.03) ** 2 / 0.3 < 0.4)
    part_w = rng.randn(3, 14).astype(np.float32)
    keep = rng.rand(T, size, size) > 0.1
    return dict(hum_c=hum_c, smpl_verts=body[None] + drift, obj_t=obj_t,
                obj_r=obj_r, roi=roi.numpy(), part_w=part_w,
                image_ref=np.repeat(ref[None], T, 0), keep=keep,
                occ=0.5 + 0.5 * rng.rand(T), labels_h=np.arange(len(sv)) % 14,
                obj_points=sample_surface(temp_v, temp_f, 3000,
                                          np.random.RandomState(0)),
                sil_verts=temp_v, sil_faces=decimate_faces(temp_f, 2500))


def stage6_optimizer(prob: dict, device, size: int, **budget):
    """make_object_optimizer on stage6_problem's analytic field: distances
    to a body sphere and to an object sphere around each frame's
    ctx["oc"], parts a fixed linear map; the release JointFitConfig at
    size^2, its budgets as given."""
    import torch
    from vistracker_tpu_torch.core.camera import PerspectiveCamera
    from vistracker_tpu_torch.fit import joint as joint_mod

    hc = torch.as_tensor(prob["hum_c"], device=device)
    part_w = torch.as_tensor(prob["part_w"], device=device)
    cam = PerspectiveCamera()

    def query(ctx, points):
        d_h = (torch.linalg.norm(points - hc, dim=-1) - 0.3).abs()
        d_o = (torch.linalg.norm(points - ctx["oc"][:, None], dim=-1)
               - 0.1).abs()
        return dict(df=torch.stack([d_h, d_o], -1), parts=(points - hc)
                    @ part_w)

    return joint_mod.make_object_optimizer(
        query, lambda ctx, p: cam.project_screen(p),
        joint_mod.JointFitConfig(sil_size=size, **budget))


def probe_inputs(device, T=8, size=256, seed=8):
    """Phase 17's term probe on stage6_problem: (optimize_object, params,
    env) with frozen contact masks and an ocent target 2 cm off."""
    import torch
    from vistracker_tpu_torch.fit import joint as joint_mod

    prob = stage6_problem(T, size, seed)

    def t(name, dtype=torch.float32):
        return torch.as_tensor(np.asarray(prob[name]), dtype=dtype,
                               device=device)

    oc = t("obj_t")
    opt = stage6_optimizer(prob, device, size)
    sil = joint_mod.SilRefs(t("image_ref"), t("keep"), t("roi"))
    env = dict(obj_points=t("obj_points").expand(T, -1, -1),
               obj_s=torch.ones(T, device=device), occ=t("occ"),
               ctx=dict(oc=oc), ocent_target=oc + 0.02,
               smpl_verts=t("smpl_verts"), labels_h=prob["labels_h"],
               sil=sil, sil_verts=t("sil_verts").expand(T, -1, -1),
               sil_faces=t("sil_faces", torch.int64))
    params = {"obj_r": t("obj_r"), "obj_t": oc}
    labels_o, mask_h, mask_o = opt.contact_masks(params, dict(
        env, labels_h=t("labels_h", torch.int64)))
    env.update(labels_o=labels_o, mask_h=mask_h, mask_o=mask_o)
    return opt, params, env


# Two terms' obj_t gradients follow discrete choices that near-ties
# decide: contact the nearest-neighbour pairings, mask the face of largest
# logit at each pixel. On the CPU alone, moving obj_t by 1e-7 relative
# moves them by 2.1e-3 (contact; 4.2e-3 at 3e-7) and 4.5e-3 (mask) of their
# largest entries; the card differs from the CPU by 2.06e-3 and 6.4e-3
# (H100 80GB HBM3 at 700 W, values within 5e-7 relative). Every other
# term is held to 1e-3.
PROBE_GRAD_LIMIT = {"contact": 5e-3, "mask": 1.5e-2}


@phase(17, "term probe")
def check_term_probe(card="cuda", T=4, size=256):
    """Phase 17: fit/joint.py's term_probe at the main path's stage-6
    widths, T frames (probe_inputs), on the card and on the CPU: K1 soft,
    K2 and K3, counted from 0, must launch on the card; each term's value
    within 1e-4 relative, its obj_t gradient within PROBE_GRAD_LIMIT
    (else 1e-3) of its largest entry. Returns the card's seconds."""
    import torch

    counters = LaunchCounts()
    out, secs = {}, {}
    for dev in (card, "cpu"):
        opt, params, env = probe_inputs(torch.device(dev), T, size)
        if dev == card:
            counters.write(dict.fromkeys(counters.read(), 0))
        t0 = time.perf_counter()
        out[dev] = opt.term_probe(params, env)
        if dev != "cpu":
            torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t0
        if dev == card:
            launches = counters.read()
    if card != "cpu":    # a CPU rehearsal runs the plain versions
        check_launched("term_probe", launches, ("max_logit_fwd_soft",
                                                "max_logit_bwd", "label_nn"))
    names = sorted(out["cpu"])
    if list(out[card]) != names or not {"mask", "contact"} <= set(names):
        raise SystemExit(f"term_probe: terms {list(out[card])} vs {names}")
    worst, failed = {}, []
    for n in names:
        (cv, cg), (pv, pg) = out[card][n], out["cpu"][n]
        cv, pv = float(cv), float(pv)
        cg, pg = cg.cpu().numpy(), pg.cpu().numpy()
        scale = float(np.abs(pg).max())
        if not (np.isfinite([cv, pv]).all() and np.isfinite(cg).all()
                and scale > 0):
            raise SystemExit(f"term_probe {n}: value {cv}, |grad| {scale}")
        worst[n] = (abs(cv - pv) / max(abs(pv), 1e-30),
                    float(np.abs(cg - pg).max()) / scale)
        if worst[n][0] > 1e-4 or worst[n][1] > PROBE_GRAD_LIMIT.get(n, 1e-3):
            failed.append(n)
    print(f"term_probe ({T} frames, 2,500-face object, {T} views at "
          f"{size}^2, frozen contact masks): card {secs[card]:.3f} s, CPU "
          f"{secs['cpu']:.3f} s; launches {json.dumps(launches)}; card vs "
          "CPU (value relative, gradient of its largest entry): "
          + ", ".join(f"{n} {r:.1e} / {g:.1e}" for n, (r, g)
                      in worst.items()))
    if failed:
        raise SystemExit(f"term_probe: {failed} outside the limits (values "
                         "1e-4 relative, gradients "
                         f"{json.dumps(PROBE_GRAD_LIMIT)}, else 1e-3)")
    return secs[card]


# ---------------------------------------------------------------------------
# phases 13-15: training
# ---------------------------------------------------------------------------

def sifnet_batch(device, B: int, N: int, S: int, crop: int = 1200, seed=0):
    """A seeded SIF-Net training batch at the reference's shapes: images
    (B, S, S, 8), N query points around each body center (most inside the
    crop), GT distances, parts, PCA axes, object centers and
    visibilities."""
    import torch
    from vistracker_tpu_torch.core.camera import PerspectiveCamera
    rng = np.random.RandomState(seed)
    bc = (np.float32([0.0, 0.0, 2.2])
          + rng.randn(B, 3).astype(np.float32) * 0.05)
    cc = PerspectiveCamera(crop_size=crop).project_screen(
        torch.as_tensor(bc)[:, None])[:, 0].numpy()
    batch = dict(
        images=rng.rand(B, S, S, 8).astype(np.float32),
        points=(bc[:, None] + rng.randn(B, N, 3) * 0.15).astype(np.float32),
        crop_center=cc.astype(np.float32), body_center=bc,
        df_h=(rng.rand(B, N) * 0.15).astype(np.float32),
        df_o=(rng.rand(B, N) * 0.15).astype(np.float32),
        parts=rng.randint(0, 14, (B, N)).astype(np.int64),
        pca=rng.randn(B, N, 3, 3).astype(np.float32),
        obj_center=rng.randn(B, 3).astype(np.float32),
        visibility=rng.rand(B, N).astype(np.float32))
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def sifnet_steps(cfg, batch, device, warmup: int, timed: int,
                 tcfg=None, seed=0, after_first=None):
    """Seeded SIF-Net (`cfg`) trained on one batch: `warmup` + `timed`
    steps on `device`, each synchronized; after_first(state) is called
    after the first step, whose gradients the parameters still hold.
    Returns (losses, terms per step, timed seconds, peak GiB, the train
    state)."""
    import torch
    from vistracker_tpu_torch.core.camera import PerspectiveCamera
    from vistracker_tpu_torch.fit.train import (TrainConfig,
                                                init_train_state,
                                                make_train_step)
    from vistracker_tpu_torch.models.sifnet import SIFNet
    from vistracker_tpu_torch.models.weights import init_random_

    tcfg = tcfg or TrainConfig()
    model = init_random_(SIFNet(cfg, PerspectiveCamera(crop_size=cfg.crop_size)),
                         torch.Generator().manual_seed(seed)).to(device)
    state = init_train_state(model, tcfg)
    step = make_train_step(model, tcfg)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, terms, secs = [], [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        state, loss, tt = step(state, batch)
        if cuda:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        terms.append({k: float(v) for k, v in tt.items()})
        if i == 0 and after_first is not None:
            after_first(state)
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    return losses, terms, secs[warmup:], peak, state


def check_gradients(state, label: str):
    """Every parameter's gradient finite and not all zero. Read at the
    first step: later, Adam may have pushed every df prediction above the
    loss's clamp (0.1), where the df head gets no gradient at all."""
    bad = [n for n, p in state.model.named_parameters()
           if p.grad is None or not bool(p.grad.isfinite().all())
           or float(p.grad.abs().max()) == 0.0]
    if bad:
        raise SystemExit(f"{label}: zero, missing or non-finite gradients "
                         f"for {bad}")


@phase(13, "training T1")
def check_training_release(B=8, N=20000, S=512, device="cuda",
                           preset="release"):
    """Phase 13 (T1): the release SIF-Net's training step at its training
    shapes (chore-triplane-vis, B x N query points, S^2 images), 2 warm-up
    and 5 timed steps with remat on, then off (the loss must fall over
    the first 5 steps); returns the results."""
    import torch
    from vistracker_tpu_torch.models.sifnet import sifnet_preset

    results = {}
    cuda = device == "cuda"
    total = (torch.cuda.get_device_properties(0).total_memory / 2**30
             if cuda else 0.0)
    if cuda:
        torch.cuda.empty_cache()
    for remat in (True, False):
        cfg = sifnet_preset(preset, remat=remat)
        b = B
        if not remat and cuda:
            # the largest B up to 8 that fits, from the peaks of one step
            # at B = 1 and 2 (no out-of-memory error is caught)
            p = [sifnet_steps(cfg, sifnet_batch(device, n, N, S), device,
                              1, 0)[3] for n in (1, 2)]
            slope = p[1] - p[0]
            b = min(B, int((0.92 * total - (p[0] - slope)) / slope))
            print(f"T1 remat off: peak {p[0]:.2f} GiB at B=1, {p[1]:.2f} at "
                  f"B=2 ({slope:.2f} GiB an example): B={b} "
                  f"{'(8 fits)' if b == B else '(the largest that fits)'}")
            if b < 1:
                raise SystemExit("T1: no batch fits without remat")
        if cuda:
            torch.cuda.empty_cache()
        batch = sifnet_batch(device, b, N, S)
        losses, _, secs, peak, state = sifnet_steps(
            cfg, batch, device, 2, 5, after_first=functools.partial(
                check_gradients, label=f"T1 remat={remat}"))
        if not np.isfinite(losses).all():
            raise SystemExit(f"T1 remat={remat}: non-finite loss {losses}")
        # a seeded random batch: the loss falls to its floor within a few
        # steps and then moves at the step size, so its fall is read over
        # the first 5 steps
        if not losses[4] < losses[0]:
            raise SystemExit(f"T1 remat={remat}: the loss did not fall over "
                             f"5 steps: {losses}")
        med = float(np.median(secs))
        results["remat" if remat else "no_remat"] = dict(
            B=b, seconds_a_step=med, examples_s=b / med,
            points_s=b * N / med, peak_gib=peak, losses=losses)
        print(f"T1 {preset} SIF-Net step, remat {'on' if remat else 'off'}, "
              f"B={b}, N={N}, {S}^2: median {med:.4f} s a step "
              f"(steps {', '.join(f'{x:.4f}' for x in secs)}), "
              f"{b / med:.3f} examples/s, {b * N / med:.0f} query points/s,"
              f" peak {peak:.2f} GiB of {total:.2f}; losses "
              + ", ".join(f"{x:.4f}" for x in losses))
        del state, batch
        if cuda:
            torch.cuda.empty_cache()
    return results


def _outside(sd_a: dict, sd_b: dict, atol: float):
    """(elements of sd_a farther than atol from sd_b, elements, max |d|)."""
    diffs = [(sd_a[k].cpu() - v.cpu()).abs() for k, v in sd_b.items()]
    return (sum(int((d > atol).sum()) for d in diffs),
            sum(d.numel() for d in diffs), max(float(d.max()) for d in diffs))


@phase(14, "training T2")
def check_training_card_vs_cpu(steps=3, B=2, N=2000, S=64, card="cuda"):
    """Phase 14 (T2): the tiny SIF-Net trained 3 steps (across a
    learning-rate milestone) on the card and on the CPU from the same
    weights and batch: loss and terms within 1e-4 relative at every step;
    the parameters after the first update within 1e-5 with at most 0.1%
    of elements outside. Adam's first update moves every parameter by
    +-lr, so the elements outside are those whose gradient the two
    devices round to other signs; they perturb every later gradient, so
    after 3 updates at most 15% of the elements may lie outside 1e-5
    (6.95% and 7.94% measured on an H100) and none farther than 5 lr
    (Adam moves an element by about lr an update at most: 2.3 lr over
    the three, in either run)."""
    import torch
    from vistracker_tpu_torch.fit.train import TrainConfig
    from vistracker_tpu_torch.models.sifnet import sifnet_preset

    cfg = sifnet_preset("tiny")
    tcfg = TrainConfig(milestones=(1,), steps_per_epoch=2)
    runs, first = {}, {}

    def keep(key, state):
        first[key] = {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()}

    for key, dev in (("cuda", card), ("cpu", "cpu")):
        runs[key] = sifnet_steps(cfg, sifnet_batch(dev, B, N, S, seed=1),
                                 dev, 0, steps, tcfg,
                                 after_first=functools.partial(keep, key))
    worst = 0.0
    for i in range(steps):
        pairs = [(runs["cuda"][0][i], runs["cpu"][0][i], "loss")]
        pairs += [(runs["cuda"][1][i][k], v, k)
                  for k, v in runs["cpu"][1][i].items()]
        for a, b, k in pairs:
            rel = abs(a - b) / max(abs(b), 1e-30)
            worst = max(worst, rel)
            if rel > 1e-4:
                raise SystemExit(f"T2 step {i}: {k} card {a} vs cpu {b}")
    out1, total, max1 = _outside(first["cuda"], first["cpu"], 1e-5)
    if out1 > 0.001 * total:
        raise SystemExit(f"T2: {out1} of {total} parameters differ by more "
                         "than 1e-5 after the first update")
    out3, _, max3 = _outside(runs["cuda"][4].model.state_dict(),
                             runs["cpu"][4].model.state_dict(), 1e-5)
    if out3 > 0.15 * total or not max3 <= 5 * tcfg.learning_rate:
        raise SystemExit(f"T2: {out3} of {total} parameters differ by more "
                         f"than 1e-5 after {steps} updates, max |d| {max3}")
    print(f"T2 tiny SIF-Net card vs CPU, {steps} steps: loss and terms "
          f"within {worst:.2e} relative; parameters outside 1e-5: {out1} "
          f"of {total} after the first update (max |d| {max1:.2e}), "
          f"{out3} after {steps} (max |d| {max3:.2e})")


def _metrics(out: str) -> list:
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _val_falls(label: str, out: str):
    vals = [r["val_loss"] for r in _metrics(out) if "val_loss" in r]
    if not (np.isfinite(vals).all() and len(vals) >= 2
            and vals[-1] < vals[0]):
        raise SystemExit(f"{label}: the validation loss did not fall: "
                         f"{vals}")
    return vals


def _detached(x):
    """Tensors in x (nested tuples, lists, dicts) detached and cloned."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_detached(v) for v in x)
    if isinstance(x, dict):
        return {k: _detached(v) for k, v in x.items()}
    return x


def first_call(module, name: str, keep: list):
    """A patch of module.name that passes every call on and keeps the
    first one's (args, kwargs, result), detached, in `keep`."""
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        out = fn(*args, **kwargs)
        if not keep:
            keep.append(_detached((args, kwargs, out)))
        return out

    return mock.patch.object(module, name, spy)


def k1_train_call(call) -> str:
    """K1 hard as train-sifnet --synthetic's triplane render launched it:
    the m and cnt of that launch bit-equal to max_logit_fwd_plain on the
    same planes and liveness."""
    import torch
    from vistracker_tpu_torch.ops.coverage import max_logit_fwd_plain

    (cpl, active, size, *_), _, (m_k, c_k) = call
    m_p, c_p = max_logit_fwd_plain(cpl, active, size)
    if not (torch.equal(m_k, m_p) and torch.equal(c_k, c_p)):
        raise SystemExit(
            f"K1 at train-sifnet --synthetic's shape: kernel != plain "
            f"version at {int((m_k != m_p).sum()) + int((c_k != c_p).sum())}"
            " values")
    return (f"{cpl.shape[0]} views x {cpl.shape[1]} faces (padded) x "
            f"{size}^2, m and cnt bit-equal to the plain version")


def k4_downstream_call(call) -> str:
    """K4 at train-infiller's downstream chamfer: both directions of its
    first chamfer_distance call (min and argmin) bit-equal to
    nn_min_sqdist_plain."""
    import torch
    from vistracker_tpu_torch.ops.chamfer import (_valid, nn_min_sqdist_fwd,
                                                  nn_min_sqdist_plain)

    (s1, s2), kwargs, _ = call
    for x, y, mask in ((s1, s2, kwargs.get("mask2")),
                       (s2, s1, kwargs.get("mask1"))):
        valid = _valid(mask, y)
        d_k, i_k = nn_min_sqdist_fwd(x, y, valid)
        d_p, i_p = nn_min_sqdist_plain(x, y, valid)
        if not (torch.equal(d_k, d_p) and torch.equal(i_k, i_p)):
            raise SystemExit(
                f"K4 at train-infiller's downstream shape: kernel != plain "
                f"version at {int((d_k != d_p).sum())} distances, "
                f"{int((i_k != i_p).sum())} indices")
    return (f"{s1.shape[0]} x {s1.shape[1]} vs {s2.shape[1]} points, both "
            "directions, min and argmin bit-equal to the plain version")


@phase(15, "training T3")
def run_training_cli(fx: dict, samples=20000, size=512, batch=4,
                     track_extra=()):
    """Phase 15 (T3): the training command lines on the fixture's folder
    and GT pack (boundary-sample at `samples` points, train-sifnet
    --offline-data at size^2 and B = `batch`), then a trained checkpoint
    loaded by `track` (with `track_extra` flags), then the SmoothNet and
    HVOP-Net trainers. The first K1 launch of train-sifnet --synthetic
    and the first downstream chamfer of train-infiller are held against
    their plain versions on the inputs those runs gave them."""
    import torch
    from vistracker_tpu_torch.cli import main as cli
    from vistracker_tpu_torch.cli import real_track as rt
    from vistracker_tpu_torch.data.packed import load_packed
    from vistracker_tpu_torch.models.weights import find_checkpoint
    from vistracker_tpu_torch.ops import chamfer, coverage

    root = os.path.join(WORK, "training")
    shutil.rmtree(root, ignore_errors=True)  # a trainer would resume
    parse = cli.build_parser().parse_args
    frames = len(load_packed(fx["gt_pack"])["poses"])

    npz = os.path.join(root, "boundary")
    t0 = time.perf_counter()
    res = cli.run_boundary_sample(parse([
        "boundary-sample", "--seq", fx["seq_dir"], "--gt-pack", fx["gt_pack"],
        "--smpl-model", fx["model_pkl"], "--assets", fx["assets_root"],
        "--objects-root", fx["objects_root"], "--out", npz,
        "--samples", str(samples), "--flip", "--redo"]))
    sec = time.perf_counter() - t0
    if res["written"] != frames or len(os.listdir(npz)) != 2 * frames:
        raise SystemExit(f"boundary-sample: wrote {res}, "
                         f"{len(os.listdir(npz))} files")
    print(f"T3 boundary-sample --samples {samples} --flip: {frames} frames in "
          f"{sec:.3f} s, {sec / frames:.4f} s a frame (two npz each)")

    out = os.path.join(root, "sifnet_offline")
    t0 = time.perf_counter()
    res = cli.run_train_sifnet(parse([
        "train-sifnet", "--offline-data", npz, "--variant", "chore",
        "--image-size", str(size), "--crop-size", "1200", "--samples",
        str(samples), "--batch-size", str(batch), "--epochs", "1",
        "--out", out]))
    sec = time.perf_counter() - t0
    vals = [r["val_loss"] for r in _metrics(out) if "val_loss" in r]
    if res["steps"] != frames // batch or not vals \
            or not np.isfinite(vals).all():
        raise SystemExit(f"train-sifnet --offline-data: {res}, val {vals}")
    print(f"T3 train-sifnet --offline-data (chore, {size}^2, {samples} "
          f"points, B={batch}, 1 epoch): {res['steps']} steps in {sec:.3f} "
          f"s (validation included), val loss {vals[-1]:.4f}")

    counters = LaunchCounts()
    synth = os.path.join(root, "sifnet_synthetic")
    counters.write(dict.fromkeys(counters.read(), 0))
    k1_call = []
    t0 = time.perf_counter()
    with first_call(coverage, "_fwd_launch", k1_call):
        res = cli.run_train_sifnet(parse(["train-sifnet", "--synthetic",
                                          "--out", synth]))
    sec = time.perf_counter() - t0
    launches = counters.read()
    check_launched("train-sifnet --synthetic", launches, ("max_logit_fwd",))
    _val_falls("train-sifnet --synthetic", synth)
    print(f"T3 train-sifnet --synthetic (the JAX defaults): {res['steps']} "
          f"steps in {sec:.3f} s; launches {json.dumps(launches)}; K1 hard "
          f"at its call: {k1_train_call(k1_call[0])}")

    loaded = []
    load_net = rt._load_net

    def spy(model, ckpt, *a, **k):
        net = load_net(model, ckpt, *a, **k)
        if ckpt == synth:
            loaded.append({n: v.cpu() for n, v in net.state_dict().items()})
        return net

    with wide_threshold(), mock.patch.object(rt, "_load_net", spy):
        summary = rt.run_real_track(parse([
            "track", "--seq", fx["seq_dir"], "--out",
            os.path.join(root, "track"), "--smpl-model", fx["model_pkl"],
            "--assets", fx["assets_root"], "--sifnet-ckpt", synth,
            "--net-preset", "tiny", "--neural-only", "--redo",
            *track_extra]))
    ck = torch.load(find_checkpoint(synth), map_location="cpu",
                    weights_only=False)["model_state_dict"]
    if len(loaded) != 1 or any(not torch.equal(v, ck[n])
                               for n, v in loaded[0].items()):
        raise SystemExit("track did not load the trained checkpoint's "
                         "weights")
    packed = load_packed(summary["packed"])
    for k in ("poses", "neural_pca", "neural_trans", "neural_visibility"):
        if not np.isfinite(np.asarray(packed[k], np.float64)).all():
            raise SystemExit(f"track with the trained SIF-Net: {k} not "
                             "finite")
    print(f"T3 track --neural-only --net-preset tiny with the trained "
          f"checkpoint ({os.path.basename(find_checkpoint(synth))}): "
          f"{frames} frames in {summary['seconds']:.2f} s, weights equal "
          "to the checkpoint's, outputs finite")

    for cmd in ("train-smoothnet", "train-infiller"):
        out = os.path.join(root, cmd)
        k4_call = []
        spy = (first_call(chamfer, "chamfer_distance", k4_call)
               if cmd == "train-infiller" else contextlib.nullcontext())
        counters.write(dict.fromkeys(counters.read(), 0))
        t0 = time.perf_counter()
        with spy:
            res = getattr(cli, "run_" + cmd.replace("-", "_"))(parse([
                cmd, "--synthetic", "--out", out]))
        sec = time.perf_counter() - t0
        launches = counters.read()
        vals = _val_falls(cmd, out)
        extra = ""
        if cmd == "train-infiller":
            # 2 chamfer directions at each of the 2 validation points and
            # the final score
            if launches["nn_min_sqdist"] != 6:
                raise SystemExit(f"train-infiller: K4 launched "
                                 f"{launches['nn_min_sqdist']} times (want "
                                 "6)")
            extra = (f", downstream v2v {res['downstream_v2v_cm']} cm; K4 "
                     f"launches {launches['nn_min_sqdist']}; K4 at its "
                     f"downstream chamfer: {k4_downstream_call(k4_call[0])}")
        print(f"T3 {cmd} --synthetic (the JAX defaults): {res['steps']} "
              f"steps in {sec:.3f} s ({res['steps'] / sec:.2f} steps/s "
              f"with validation); val loss {vals[0]:.5f} -> {vals[-1]:.5f}"
              + extra)


# ---------------------------------------------------------------------------
# phases 18-20: several processes (parallel/mesh.py)
# ---------------------------------------------------------------------------

# Phase 18's limits: the sharded pack against the unsharded main path's,
# per packed field, on a statistic of the per-frame differences (max |d|
# over a frame's entries; obj_angles: the angle in degrees): "max" over
# the frames or "p90", their 90th percentile. Each is 10 x what the main
# path moves when its input moves by a rounding error (--sensitivity:
# every keypoint x (1 + 1e-7)), rounded up to one digit, at MAIN_FIT /
# MAIN_JOINT: from `chip_smoke.py --sensitivity` on an NVIDIA H100 80GB
# HBM3 at 700 W, whose maxima were poses 1.99e-5, betas 3.65e-4, trans
# 3.31e-5, neural_pca 1.23e-3, neural_trans 7.05e-4, neural_visibility
# 1.60e-4, obj_trans 9.25e-3 (PERF.md §6). obj_angles has none (None:
# printed only): there the rounding error already moves the
# 90th-percentile frame by 6.2 degrees, since stage 6b on untrained
# weights settles in another minimum.
SHARD_LIMITS = {"poses": ("max", 2e-4), "betas": ("max", 4e-3),
                "trans": ("max", 4e-4), "neural_pca": ("max", 2e-2),
                "neural_trans": ("max", 8e-3),
                "neural_visibility": ("max", 2e-3),
                "obj_trans": ("max", 0.1), "obj_angles": ("p90", None)}
# The pack cannot hold stage 6b to much: on untrained weights it turns
# the sensitivity run's rounding into degrees of obj_angles (20 at the
# release's budgets, 7.1 at MAIN_JOINT), and the first 10 losses of each
# of its phases move by 0.4-4% with it at the release's budgets
# (--sensitivity on an H100 80GB HBM3 at 700 W). So phase 18 also runs
# stage 6b alone on identical inputs (stage6_problem at the main path's
# widths, one chunk, STAGE6B_BUDGET: 60 Adam steps through all three
# phases, contact included) on the ranks and in one process, and holds
# the global loss trace (relative, at the first step and its largest)
# and the chunk's obj_t (m) and obj_r (degrees) to 10 x what obj_t's
# start x (1 + 1e-7) moves them in one process in the same run, or 10 x
# the floor below where that moves less (a sum of two shares rounds
# apart from one mean by a few ulps).
STAGE6B_BUDGET = dict(iter_obj=2, iter_sil=2, joint_max_iter=2)
STAGE6B_FLOORS = {"first": 1e-6, "trace": 1e-6, "obj_t": 1e-6,
                  "obj_r": 1e-3}
RANK_TIMEOUT = 600  # seconds for one launch of ranks


def cap_shared_card(device: str):
    """A rank that shares its card with the other ranks (an explicit
    cuda:N) may cache at most its share of what was free when it
    started: a rank's caching allocator keeps its peak (the encode's 23
    GiB) for good, and libraries that allocate outside it (cuSOLVER's
    handle, at stage 6b's first SVD) then find the card full. Not for
    phase 19's ranks: a cap narrows cuDNN's choice of convolution
    algorithms, whose rounding phase 19 compares."""
    import torch
    dev = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dev.type == "cuda" and dev.index is not None and world > 1:
        free, total = torch.cuda.mem_get_info(dev)
        torch.cuda.set_per_process_memory_fraction(0.9 * free / world
                                                   / total, dev)


def free_card() -> float:
    """Release what this process caches on the card before ranks share
    it (the ranks' encode peaks at 23 GiB each); returns the card's free
    GiB (nan without one)."""
    import gc
    import torch
    gc.collect()
    if not torch.cuda.is_available():
        return float("nan")
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info()[0] / 2**30


def memory_gib() -> float:
    """What this process's caching allocator holds on the card, GiB."""
    import torch
    return torch.cuda.memory_reserved() / 2**30 \
        if torch.cuda.is_available() else 0.0


def pack_differences(got: dict, ref: dict) -> dict:
    """Per packed field of SHARD_LIMITS, the per-frame difference (max
    |d| over the frame's entries; obj_angles: the angle between the two
    rotations in degrees), as its max and 90th percentile over frames."""
    out = {}
    for k in SHARD_LIMITS:
        a = np.asarray(got[k], np.float64)
        b = np.asarray(ref[k], np.float64)
        d = frame_angles_deg(a, b) if k == "obj_angles" \
            else np.abs(a - b).reshape(len(a), -1).max(1)
        out[k] = {"max": float(d.max()), "p90": float(np.percentile(d, 90))}
    return out


def run_stage6b(device, T: int, size: int, mesh=(84, 82), obj=(35, 36),
                shard=None, scale: float = 1.0):
    """Stage 6b alone (make_object_optimizer's three phases at
    STAGE6B_BUDGET) on stage6_problem: the whole chunk of T frames, or
    this rank's block under `shard`; obj_t's start x scale (the
    sensitivity run). Returns the global loss trace and the chunk's
    rotations and translations, host arrays."""
    import torch
    from vistracker_tpu_torch.fit import joint as joint_mod

    prob = stage6_problem(T, size, mesh=mesh, obj=obj)
    pick = (lambda a: a) if shard is None else shard.local
    B = T if shard is None else shard.size

    def t(name, dtype=torch.float32, framed=True):
        a = np.asarray(prob[name])
        return torch.as_tensor(pick(a) if framed else a, dtype=dtype,
                               device=device)

    oc = t("obj_t")
    opt = stage6_optimizer(prob, device, size, **STAGE6B_BUDGET)
    r, tt, trace = opt(
        t("obj_r"), oc * scale, torch.ones(B, device=device),
        t("obj_points", framed=False).expand(B, -1, -1), t("smpl_verts"),
        prob["labels_h"], t("occ"),
        joint_mod.SilRefs(t("image_ref"), t("keep"), t("roi")),
        t("sil_verts", framed=False).expand(B, -1, -1),
        t("sil_faces", torch.int64, framed=False), dict(oc=oc), shard=shard)
    if shard is not None:
        r, tt = shard.gather_frames(r), shard.gather_frames(tt)
    return [x.detach().cpu().numpy() for x in (trace, r, tt)]


def stage6b_differences(got, ref) -> dict:
    """run_stage6b's outputs against another run's: the loss trace's
    relative difference at its first step and its largest, obj_t's
    largest |difference| and obj_r's largest angle."""
    (tg, rg, xg), (tr, rr, xr) = got, ref
    if len(tg) != len(tr):
        raise SystemExit(f"stage 6b: {len(tg)} steps against {len(tr)}")
    rel = np.abs(tg - tr) / np.maximum(np.abs(tr), 1e-30)
    return {"first": float(rel[0]), "trace": float(rel.max()),
            "obj_t": float(np.abs(xg - xr).max()),
            "obj_r": angle_deg(rg, rr)}


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(phase: str, world: int, extra=(), command=None) -> list:
    """`python3 chip_smoke.py --rank-phase <phase> <extra>` (or `command`)
    as `world` ranks with torchrun's variables, all started together,
    each logging to build/chip_smoke/<phase>/rank<r>.log; waits for all
    under one deadline, kills every rank if one fails or the deadline
    passes (printing the logs' tails), and returns each
    rank's JSON result."""
    out = os.path.join(WORK, phase)
    os.makedirs(out, exist_ok=True)
    port = _free_port()
    procs, logs = [], []
    for r in range(world):
        logs.append(open(os.path.join(out, f"rank{r}.log"), "w"))
        procs.append(subprocess.Popen(
            command or [sys.executable, os.path.abspath(__file__),
                        "--rank-phase", phase, "--work", WORK, *extra],
            env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                     WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                     MASTER_PORT=str(port), OMP_NUM_THREADS=os.environ.get(
                         "OMP_NUM_THREADS",
                         str(max(1, (os.cpu_count() or 1) // world)))),
            stdout=logs[-1], stderr=subprocess.STDOUT, cwd=ROOT))
    deadline = time.monotonic() + RANK_TIMEOUT
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}" \
                    if bad else f"timed out after {RANK_TIMEOUT} s"
                break
            time.sleep(0.5)
        if failed is None and any(p.returncode for p in procs):
            failed = "exit codes " + str([p.returncode for p in procs])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if failed:
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.log")) as f:
                print(f"---- {phase} rank {r} log (tail) ----\n"
                      + f.read()[-3000:])
        raise SystemExit(f"{phase}: {failed}")
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def _rank_result(phase: str, result: dict):
    os.makedirs(os.path.join(WORK, phase), exist_ok=True)
    with open(os.path.join(WORK, phase, f"rank{os.environ['RANK']}.json"),
              "w") as f:
        json.dump(result, f)


def shard_rank(frames: int, chunk: int, device="cuda:0", backend="gloo",
               extra=(), mesh=(84, 82), obj=(35, 36), sil_size=256):
    """One rank of phase 18: the main path's `track` (MAIN_FIT /
    MAIN_JOINT) with --shard-frames --dist-backend gloo --device cuda:0
    (or the device and backend given), every kernel's count set to 0
    just before and read just after; then stage 6b alone on one chunk
    (run_stage6b)."""
    from vistracker_tpu_torch.parallel.mesh import (FrameShard,
                                                    init_distributed,
                                                    shutdown_distributed)

    rank = int(os.environ["RANK"])
    cap_shared_card(device)
    fab = fabricate(f"shard{rank}", frames, *mesh, obj=obj)
    counters = LaunchCounts()
    with wide_threshold(), occlude_few_infiller(), \
            fit_budgets(MAIN_FIT, MAIN_JOINT):
        counters.write(dict.fromkeys(counters.read(), 0))
        summary, _ = run_track(
            fab, device, os.path.join(WORK, "shard", "out"),
            ("--chunk-size", str(chunk), "--shard-frames", "--dist-backend",
             backend, *extra), load=False)
        launches = counters.read()
    ranks = init_distributed(device, backend)  # the group `track` joined
    s6 = run_stage6b(ranks.device, chunk, sil_size, mesh, obj,
                     FrameShard(chunk, ranks))
    shutdown_distributed()
    _rank_result("shard", dict(launches=launches, summary=summary,
                               stage6b=[x.tolist() for x in s6]))


@phase(18, "sharded track")
def run_sharded_path(main_pack: str, frames: int, chunk: int,
                     command=None, world=2, device="cuda:0",
                     backend="gloo", ref_device="cuda", mesh=(84, 82),
                     obj=(35, 36), sil_size=256) -> list:
    """Phase 18: `track --shard-frames` over 2 ranks sharing the card
    (gloo; or `world` ranks on `device` over `backend`: --cards), the
    main path's sequence, chunks and seeds; its pack held to the main
    path's unsharded pack (SHARD_LIMITS); K1 hard and soft, K2 and K3
    launched by each rank; the ranks' stage 6b alone on one chunk
    against this process's on `ref_device` (STAGE6B_FLOORS). Returns the
    ranks' launch counts."""
    from vistracker_tpu_torch.data.packed import load_packed

    free = free_card()
    print(f"sharded track: {free:.2f} GiB of the card free before the "
          f"ranks; this process holds {memory_gib():.2f} GiB")
    t0 = time.perf_counter()
    res = launch_ranks("shard", world, (
        "--frames", str(frames), "--chunk", str(chunk), "--rank-device",
        device, "--rank-backend", backend), command)
    wall = time.perf_counter() - t0
    summary = res[0]["summary"]
    got, ref = load_packed(summary["packed"]), load_packed(main_pack)
    check_outputs(got, frames)
    diffs = pack_differences(got, ref)
    for r, x in enumerate(res):
        check_launched(f"sharded track rank {r}", x["launches"],
                       ("max_logit_fwd", "max_logit_fwd_soft",
                        "max_logit_bwd", "label_nn"))
    cards = "one card" if ":" in device else f"{world} cards"
    print(f"sharded track: {world} ranks ({backend}) on {cards}, {frames} "
          f"frames in "
          f"chunks of {chunk}, {summary['seconds']:.2f} s of rank 0 "
          f"({wall:.2f} s with the ranks' start); world_size "
          f"{summary['world_size']}; launches "
          + "; ".join(f"rank {r} {json.dumps(x['launches'])}"
                      for r, x in enumerate(res)))
    peaks = summary.get("rank_peak_gib",
                        [{}] * len(summary["rank_stage_seconds"]))
    for stage in summary["stage_seconds"]:
        print(f"  {stage}: " + ", ".join(
            f"rank {r} {s[stage]:.3f} s, peak {p.get(stage, 0.0):.2f} GiB"
            for r, (s, p) in enumerate(zip(summary["rank_stage_seconds"],
                                           peaks))))
    print("  against the unsharded main path, per-frame differences, max "
          "/ p90 (limit): " + ", ".join(
              f"{k} {d['max']:.3e} / {d['p90']:.3e} ({SHARD_LIMITS[k][0]} "
              f"{SHARD_LIMITS[k][1]})" for k, d in diffs.items()))
    s6 = [[np.asarray(a) for a in x["stage6b"]] for x in res]
    if any(not all(np.array_equal(a, b) for a, b in zip(x, s6[0]))
           for x in s6):
        raise SystemExit("sharded stage 6b: the ranks' results differ")
    ref = run_stage6b(ref_device, chunk, sil_size, mesh, obj)
    sens = stage6b_differences(run_stage6b(
        ref_device, chunk, sil_size, mesh, obj, scale=1.0 + 1e-7), ref)
    got = stage6b_differences(s6[0], ref)
    limits = {k: 10 * max(sens[k], floor)
              for k, floor in STAGE6B_FLOORS.items()}
    print(f"  stage 6b alone ({chunk} frames, {len(ref[0])} Adam steps) on "
          f"{world} ranks against one process (limit, from obj_t's start "
          "x (1 + 1e-7) in one process): " + ", ".join(
              f"{k} {got[k]:.3e} ({limits[k]:.3e}, from {sens[k]:.3e})"
              for k in limits))
    over = [k for k, (stat, limit) in SHARD_LIMITS.items()
            if limit is not None and not diffs[k][stat] <= limit]
    over += [f"stage 6b {k}" for k, v in got.items() if not v <= limits[k]]
    if over:
        raise SystemExit(f"sharded track: {over} beyond the limits")
    return [x["launches"] for x in res]


def ddp_rank(B: int, N: int, S: int, preset: str, device="cuda:0",
             backend="gloo"):
    """One rank of phase 19: one DistributedDataParallel step of the
    SIF-Net preset on its B / world examples of the seeded batch."""
    import torch
    from vistracker_tpu_torch.core.camera import PerspectiveCamera
    from vistracker_tpu_torch.fit.train import (TrainConfig,
                                                init_train_state,
                                                make_train_step)
    from vistracker_tpu_torch.models.sifnet import SIFNet, sifnet_preset
    from vistracker_tpu_torch.models.weights import init_random_
    from vistracker_tpu_torch.parallel import mesh

    ranks = mesh.init_distributed(device, backend)
    device = ranks.device
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = sifnet_preset(preset, remat=True)
    model = init_random_(SIFNet(cfg, PerspectiveCamera(
        crop_size=cfg.crop_size)), torch.Generator().manual_seed(0))
    net = mesh.data_parallel(model.to(device), ranks)
    tcfg = TrainConfig()
    state, step = init_train_state(net, tcfg), make_train_step(net, tcfg)
    b = B // ranks.world_size
    batch = {k: v[ranks.rank * b:(ranks.rank + 1) * b].contiguous()
             for k, v in sifnet_batch(device, B, N, S).items()}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, loss, _ = step(state, batch)
    if cuda:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    loss = float(mesh.all_reduce_sum(loss, ranks)) / ranks.world_size
    if ranks.rank == 0:   # the parameters after the step, and its gradients
        inner = mesh.unwrap(net)
        torch.save({"params": {k: v.cpu() for k, v in
                               inner.state_dict().items()},
                    "grads": {k: p.grad.cpu() for k, p in
                              inner.named_parameters()}},
                   os.path.join(WORK, "ddp", "step.pt"))
    _rank_result("ddp", dict(
        loss=loss, seconds=secs, ddp=type(net).__name__,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda
        else 0.0))
    mesh.shutdown_distributed()


def split_gradients(cfg, batch: dict, world: int, device) -> dict:
    """The gradient that DDP's ranks average, made in one process: the
    seeded SIF-Net's loss gradient on each of `world` equal slices of
    the batch, each divided by `world` and summed."""
    import torch
    from vistracker_tpu_torch.core.camera import PerspectiveCamera
    from vistracker_tpu_torch.fit.train import TrainConfig, sifnet_loss
    from vistracker_tpu_torch.models.sifnet import SIFNet
    from vistracker_tpu_torch.models.weights import init_random_

    model = init_random_(SIFNet(cfg, PerspectiveCamera(
        crop_size=cfg.crop_size)), torch.Generator().manual_seed(0)).to(
            device).train()
    b = len(batch["images"]) // world
    for r in range(world):
        part = {k: v[r * b:(r + 1) * b] for k, v in batch.items()}
        (sifnet_loss(model, part, TrainConfig())[0] / world).backward()
    return {k: p.grad.detach() for k, p in model.named_parameters()}


def _grad_err(grads: dict, ref: dict) -> float:
    """The largest gradient difference, each tensor's over its scale: its
    largest reference entry, or 1e-3 of the network's where that is
    smaller (a bias under GroupNorm has a gradient of 0 and gets rounding
    noise)."""
    gmax = max(float(g.abs().max()) for g in ref.values())
    return max(float((grads[k].cpu() - g.cpu()).abs().max())
               / max(float(g.abs().max()), 1e-3 * gmax)
               for k, g in ref.items())


@phase(19, "DDP step")
def check_ddp_step(B=8, N=20000, S=512, preset="release", device="cuda",
                   world=2, rank_device="cuda:0", backend="gloo"):
    """Phase 19: one DistributedDataParallel step of the release SIF-Net,
    2 ranks x B/2 sharing the card (gloo), from the same weights and
    batch as the one-process step on all B: the loss within 1e-5 of the
    one-process step's (the mean of the half-batch means is the batch
    mean); the gradient DDP applied within 1e-4 of its scale (_grad_err;
    the training tests' tolerance) of the same halves' mean made in one
    process (split_gradients: DDP's arithmetic without the collective;
    sums may run in another order, on the CPU with other thread counts);
    the parameters after the step
    against the one-process step's: none beyond 2 lr (Adam's first step
    moves an element by less than lr either way, so a gradient rounded to
    the other sign is at most 2 lr off) and at most 1% of elements
    outside 1e-5. The one-process step's own gradient differs from the
    halves' by the card's batch-size-dependent rounding: printed."""
    import torch
    from vistracker_tpu_torch.fit.train import TrainConfig
    from vistracker_tpu_torch.models.sifnet import sifnet_preset

    free_card()
    res = launch_ranks("ddp", world, (
        "--ddp-size", str(B), str(N), str(S), preset, "--rank-device",
        rank_device if device == "cuda" else device, "--rank-backend",
        backend))
    if any(r["ddp"] != "DistributedDataParallel" for r in res):
        raise SystemExit(f"DDP step: not wrapped ({res})")
    cfg = sifnet_preset(preset, remat=True)
    batch = sifnet_batch(device, B, N, S)
    losses, _, secs, peak, state = sifnet_steps(cfg, batch, device, 0, 1)
    ddp = torch.load(os.path.join(WORK, "ddp", "step.pt"))
    rel = abs(res[0]["loss"] - losses[0]) / abs(losses[0])
    out, total, worst = _outside(ddp["params"], state.model.state_dict(),
                                 1e-5)
    one = {k: p.grad.detach() for k, p in state.model.named_parameters()}
    del state
    torch.cuda.empty_cache()
    halves = split_gradients(cfg, batch, world, device)
    gerr, batch_err = _grad_err(ddp["grads"], halves), _grad_err(one, halves)
    lr = TrainConfig().learning_rate
    print(f"DDP step, {preset} SIF-Net, {world} ranks x B={B // world} "
          f"({backend}, {'one card' if ':' in rank_device else 'a card each'}"
          f") vs one process at B={B}, N={N}, {S}^2: loss "
          f"{res[0]['loss']:.6f} vs {losses[0]:.6f} ({rel:.2e} relative); "
          f"gradient within {gerr:.2e} of the halves' mean in one process "
          f"(the B={B} step's within {batch_err:.2e}); parameters outside "
          f"1e-5: {out} of {total}, max |d| {worst:.2e}; seconds a step: "
          "ranks " + " / ".join(f"{r['seconds']:.3f}" for r in res)
          + f", one process {secs[0]:.3f}; peak GiB: ranks "
          + " / ".join(f"{r['peak_gib']:.2f}" for r in res)
          + f", one process {peak:.2f}")
    if not (rel <= 1e-5 and gerr <= 1e-4 and out <= 0.01 * total
            and worst <= 2 * lr * (1 + 1e-3)):
        raise SystemExit("DDP step: differs from the one-process step")
    del halves, one
    torch.cuda.empty_cache()


@phase(20, "NCCL helpers")
def check_nccl_helpers():
    """Phase 20: a world-1 NCCL group on the card through every helper of
    parallel/mesh.py (gather_frames, halo, all_reduce_sum,
    broadcast_module, frame_mean, diff_sq_mean, data_parallel, and
    ShardDraws over gather_frames), each against what one process
    computes without a group; NCCL's init and collectives run."""
    import torch
    import torch.distributed as dist
    from vistracker_tpu_torch.fit.generator import ShardDraws, TorchDraws
    from vistracker_tpu_torch.parallel import mesh

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method="tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        d = mesh.Dist(0, 1, 0, dev, "nccl")
        sh = mesh.FrameShard(5, d)
        g = torch.Generator(device="cpu").manual_seed(9)
        x = torch.randn(5, 7, 3, generator=g).to(dev)
        left, right = sh.halo(x, 2)
        mod = torch.nn.Linear(3, 2).to(dev)
        w = mod.weight.detach().clone()
        mesh.broadcast_module(mod, d)
        leaf = x.clone().requires_grad_(True)
        share = mesh.diff_sq_mean(leaf, 2, sh)
        share.backward()
        ref = x.clone().requires_grad_(True)
        plain = mesh.diff_sq_mean(ref, 2)
        plain.backward()
        net = mesh.data_parallel(torch.nn.Linear(3, 2).to(dev), d)
        net(x).square().mean().backward()
        logits = torch.where(torch.rand(5, 40, generator=g) > 0.5, 0.0,
                             -1e9).to(dev)
        a, b = ShardDraws(TorchDraws(3, dev), sh), TorchDraws(3, dev)
        draws = [torch.equal(a.uniform((5, 6, 3)), b.uniform((5, 6, 3))),
                 torch.equal(a.categorical(logits, 6),
                             b.categorical(logits, 6))]
        checks = {
            "gather_frames": torch.equal(sh.gather_frames(x), x),
            "halo": left.shape[0] == 0 and right.shape[0] == 0,
            "all_reduce_sum": torch.equal(mesh.all_reduce_sum(x, d), x),
            "broadcast_module": torch.equal(mod.weight, w),
            "frame_mean": bool(torch.isclose(mesh.frame_mean(x, sh),
                                             x.mean(), rtol=1e-6)),
            "diff_sq_mean": bool(torch.isclose(share.detach(),
                                               plain.detach(), rtol=1e-6))
            and bool(torch.allclose(leaf.grad, ref.grad, rtol=1e-6)),
            "data_parallel": type(net).__name__ == "DistributedDataParallel"
            and all(p.grad is not None for p in net.parameters()),
            "ShardDraws": all(draws)}
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    print(f"NCCL world-1 group ({torch.cuda.nccl.version()}), every "
          f"parallel/mesh.py helper in {time.perf_counter() - t0:.2f} s: "
          + json.dumps(checks))
    if not all(checks.values()):
        raise SystemExit(f"NCCL helpers: {checks}")


# ---------------------------------------------------------------------------
# phase 21: the fixture accuracy harness, then an .mp4 without cv2
# ---------------------------------------------------------------------------

# scripts/run_fixture_eval_torch.py's options for phase 21: the JAX
# defaults but 8 frames in one chunk and 10 SIF-Net epochs
HARNESS = ("--frames", "8", "--raster", "512", "--net-size", "256",
           "--crop-size", "1200", "--chunk-size", "8", "--sif-epochs", "10",
           "--net-preset", "tiny")
# the kernels each harness phase must launch
HARNESS_LAUNCHES = {"train-sif": ("max_logit_fwd",),
                    "track": ("max_logit_fwd", "max_logit_fwd_soft",
                              "max_logit_bwd", "label_nn"),
                    "eval": ("nn_min_sqdist",)}


def harness_module():
    """scripts/run_fixture_eval_torch.py as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "run_fixture_eval_torch",
        os.path.join(ROOT, "scripts", "run_fixture_eval_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@phase(21, "accuracy harness")
def run_harness_path(fx: dict, argv=HARNESS, device="cuda",
                     render_size=256) -> dict:
    """Phase 21: scripts/run_fixture_eval_torch.py's phases in this
    process through its run_phase (generate, train-sif, train-sn,
    train-inf, track, eval) over build/chip_smoke/harness, each with the
    launch counts set to 0 before and read after, its seconds and peak
    device memory: K1 hard must launch in train-sif and in track, K1
    soft, K2 and K3 in track, K4 in eval; the SIF-Net's validation loss
    must fall from the untrained net's (taken over the batches the loop's
    validation reads, before the first step); the W1 and W300 errors must
    be finite. Then `render --out x.mp4` over phase 11's fixture (its
    track pack beside its GT pack) with cv2 blocked: the box walk must
    find ftyp, moov, mdat, one sample a frame, each an I-VOP (00 00 01
    B6); the encoder's ms a frame, its build apart. Returns {phase:
    {seconds, peak_gib, launches}, "report": the eval report, "mp4":
    {...}}."""
    import torch
    from vistracker_tpu_torch.cli.main import main as cli_main
    from vistracker_tpu_torch.data import mp4 as mp4_mod
    from vistracker_tpu_torch.fit import trainer_loop

    rf = harness_module()
    root = os.path.join(WORK, "harness")
    shutil.rmtree(root, ignore_errors=True)   # no resume from a past run
    args = rf.default_results(rf.build_parser().parse_args([
        *argv, "--out", root, "--device", device,
        "--results", os.path.join(root, "fixture_eval.json"),
        "--heldout-results", os.path.join(root, "fixture_eval_ho.json")]))
    on_card = device != "cpu"
    counters = LaunchCounts()
    real_loop = trainer_loop.train_loop
    val_start = []

    def loop_val_first(state, step_fn, train_loader, val_loader=None,
                       val_loss_fn=None, cfg=None, to_device=None, **kw):
        losses = []
        with torch.no_grad():
            for bi, batch in enumerate(val_loader):
                if bi >= cfg.max_val_batches:
                    break
                losses.append(float(val_loss_fn(state, to_device(batch))))
        val_start.append(float(np.mean(losses)))
        return real_loop(state, step_fn, train_loader, val_loader=val_loader,
                         val_loss_fn=val_loss_fn, cfg=cfg,
                         to_device=to_device, **kw)

    rows, report = {}, None
    for phase in rf.PHASES:
        args.phase = phase
        counters.write(dict.fromkeys(counters.read(), 0))
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with (mock.patch.object(trainer_loop, "train_loop", loop_val_first)
              if phase == "train-sif" else contextlib.nullcontext()):
            out = rf.run_phase(args)
        if on_card:
            torch.cuda.synchronize()
        rows[phase] = dict(
            seconds=time.perf_counter() - t0,
            peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                      if on_card else 0.0),
            launches=counters.read())
        print(f"harness {phase}: {rows[phase]['seconds']:.3f} s, peak "
              f"{rows[phase]['peak_gib']:.2f} GiB, launches "
              f"{json.dumps(rows[phase]['launches'])}")
        if phase == "eval":
            report = out
    for phase, names in HARNESS_LAUNCHES.items():
        check_launched(f"harness {phase}", rows[phase]["launches"], names)
    vals = [r["val_loss"] for r in _metrics(os.path.join(root, "sifnet"))
            if "val_loss" in r]
    if not (len(val_start) == 1 and vals and np.isfinite(vals).all()
            and vals[-1] < val_start[0]):
        raise SystemExit("harness: the SIF-Net validation loss did not fall "
                         f"from the untrained net's {val_start[:1]}: {vals}")
    keys = ("smpl_v2v", "obj_v2v", "smpl_chamf", "obj_chamf")
    errs = {w: {k: report[w][k]["mean"] for k in keys}
            for w in ("W1_chore_protocol", "W300_video_protocol")}
    if not np.isfinite([list(e.values()) for e in errs.values()]).all():
        raise SystemExit(f"harness eval: non-finite errors {errs}")
    total = sum(r["seconds"] for r in rows.values())
    print(f"harness ({' '.join(argv)}): {total:.3f} s in all; SIF-Net "
          f"validation loss {val_start[0]:.6g} untrained -> {vals[-1]:.6g}; "
          f"W1 smpl_v2v {errs['W1_chore_protocol']['smpl_v2v']:.4f} cm, "
          f"obj_v2v {errs['W1_chore_protocol']['obj_v2v']:.4f} cm; W300 "
          + json.dumps(errs["W300_video_protocol"]))

    # `render --out x.mp4` with cv2 blocked
    template = os.path.join(fx["objects_root"], "boxmedium", "boxmedium.ply")
    out = os.path.join(root, "render", "side_by_side.mp4")
    enc, real_write = [], mp4_mod.write_mp4

    def timed_write(frames, path, fps):
        t0 = time.perf_counter()
        path = real_write(frames, path, fps)
        enc.append((time.perf_counter() - t0, len(frames)))
        return path

    t0 = time.perf_counter()
    mp4_mod._lib()           # its g++ build at first use, not in the timing
    build_s = time.perf_counter() - t0
    saved = sys.modules.get("cv2", "absent")
    sys.modules["cv2"] = None
    try:
        with mock.patch.object(mp4_mod, "write_mp4", timed_write):
            cli_main(["render", "--recon", fx["track_pack"], "--recon2",
                      fx["gt_pack"], "--template", template, "--smpl-model",
                      fx["model_pkl"], "--size", str(render_size), "--out",
                      out, "--device", device])
    finally:
        if saved == "absent":
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved
    T = len(fx["occ_ratios"])
    walk = mp4_walk(out)
    if walk["top"] != ["ftyp", "moov", "mdat"] or len(walk["sizes"]) != T \
            or walk["starts"] != [b"\x00\x00\x01\xb6"] * T \
            or (walk["width"], walk["height"]) != (2 * render_size,
                                                   render_size):
        raise SystemExit(f"render .mp4: boxes {walk['top']}, "
                         f"{len(walk['sizes'])} samples starting "
                         f"{set(walk['starts'])}, {walk['width']} x "
                         f"{walk['height']} (want ftyp moov mdat, {T} "
                         f"I-VOPs of {2 * render_size} x {render_size})")
    enc_ms = 1e3 * sum(t for t, _ in enc) / sum(n for _, n in enc)
    print(f"render .mp4 without cv2: {T} frames of {2 * render_size} x "
          f"{render_size}, {os.path.getsize(out)} bytes, boxes "
          f"{' '.join(walk['top'])}, every sample an I-VOP; encoder "
          f"{enc_ms:.2f} ms a frame (its g++ build before it "
          f"{build_s:.2f} s)")
    return dict(rows, report=report, val_start=val_start[0],
                val_end=vals[-1], mp4={"ms_per_frame": enc_ms,
                                       "bytes": os.path.getsize(out)})


def check_sensitivity(main_pack: str, frames: int, chunk: int):
    """--sensitivity: the main path again with every keypoint scaled by 1
    + 1e-7, and each packed field's per-frame differences from the first
    run: how far a rounding-level change of the input carries, the scale
    of SHARD_LIMITS."""
    from vistracker_tpu_torch.data.packed import load_packed
    _, _, pack, _ = run_main_path(frames, chunk, kpts_scale=1.0 + 1e-7)
    diffs = pack_differences(load_packed(pack), load_packed(main_pack))
    print("sensitivity: keypoints x (1 + 1e-7), per-frame differences from "
          "the main path (max, p90): " + json.dumps(diffs))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, nargs="+", default=[32],
                    help="main-path frame counts; the first runs in chunks "
                         "of --chunk and is the run whose launches are "
                         "counted, each further one runs in one chunk")
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phases 1-5); "
                         "prints no result line")
    ap.add_argument("--sensitivity", action="store_true",
                    help="the main path twice, the second with the "
                         "keypoints scaled by 1 + 1e-7, the packs' "
                         "differences, then phase 18; "
                         "prints no result line")
    ap.add_argument("--rank-phase", choices=("shard", "ddp"),
                    help=argparse.SUPPRESS)  # one rank of phase 18 or 19
    ap.add_argument("--ddp-size", nargs=4, default=("8", "20000", "512",
                                                    "release"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--cards", type=int, default=1,
                    help="with N > 1 cards: the main path, then phases 18 "
                         "and 19 with a rank on each card over NCCL; "
                         "prints no result line")
    ap.add_argument("--rank-device", default="cuda:0",
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank-backend", default="gloo",
                    help=argparse.SUPPRESS)
    ap.add_argument("--work", help=argparse.SUPPRESS)  # the parent's WORK
    opts = ap.parse_args()
    if opts.work:
        global WORK
        WORK = opts.work
    if opts.rank_phase == "shard":
        return shard_rank(opts.frames[0], opts.chunk, opts.rank_device,
                          opts.rank_backend)
    if opts.rank_phase == "ddp":
        B, N, S, preset = opts.ddp_size
        return ddp_rank(int(B), int(N), int(S), preset, opts.rank_device,
                        opts.rank_backend)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    from vistracker_tpu_torch.utils.cuda_build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    for name, log in build_all(KERNEL_SOURCES).items():
        for line in log.splitlines():
            if any(w in line for w in ("properties", "registers", "spill")):
                print(f"  {name}: {line.strip()}")
    print(f"built {list(KERNEL_SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name in KERNEL_SOURCES:
        for kernel, n_ins, n_min in sass_loops(name):
            print(f"  {name} SASS inner loop of {kernel}: {n_ins} "
                  f"instructions on its common path, {n_min} FMNMX")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(host_line())
    clock(1, "build", t0)

    device = torch.device("cuda")
    if opts.cards > 1:
        if torch.cuda.device_count() < opts.cards:
            raise SystemExit(f"--cards {opts.cards}: "
                             f"{torch.cuda.device_count()} cards here")
        _, _, track_pack, _ = run_main_path(opts.frames[0], opts.chunk)
        run_sharded_path(track_pack, opts.frames[0], opts.chunk,
                         world=opts.cards, device="cuda", backend="nccl")
        check_ddp_step(world=opts.cards, rank_device="cuda",
                       backend="nccl")
        sys.exit(3)
    if opts.sensitivity:
        _, _, track_pack, _ = run_main_path(opts.frames[0], opts.chunk)
        check_sensitivity(track_pack, opts.frames[0], opts.chunk)
        run_sharded_path(track_pack, opts.frames[0], opts.chunk)
        sys.exit(3)
    if not opts.kernels_only:
        # the main path and phases 18-20 first, while this process holds
        # little on the card (2 ranks share it in phases 18 and 19)
        launches, fab, track_pack, inputs_s = run_main_path(
            opts.frames[0], opts.chunk)
        run_sharded_path(track_pack, opts.frames[0], opts.chunk)
        check_ddp_step()
        check_nccl_helpers()
    records = [check_k1(device, frames=opts.chunk), *check_sil(device),
               check_k3(device), check_k4(device)]
    if opts.kernels_only:
        print(json.dumps({"kernels": records}))
        sys.exit(3)
    check_small_cpu_vs_card()
    check_infiller()
    check_eval_card_vs_cpu()
    for frames in opts.frames[1:]:
        run_main_path(frames, frames)
    launches["nn_min_sqdist"] = run_evaluate_path(fab, track_pack)
    _, fx = run_fixture_path(memory_inputs_s=inputs_s)
    run_synthetic_path()
    check_training_release()
    check_training_card_vs_cpu()
    run_training_cli(fx)
    run_render_path(fx, fx["track_pack"])
    check_term_probe()
    run_harness_path(fx)
    t0 = time.perf_counter()
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        if rec["launches"] < 1:
            raise SystemExit(f"{rec['name']} was not launched on the main "
                             "path")
    clock(22, "result", t0)
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
