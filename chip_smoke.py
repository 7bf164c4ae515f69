"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--frames 8 [16 32 ...]]

Phases (any failure exits non-zero):
  1. build the hand-written kernel from vistracker_tpu_torch/csrc with
     nvcc; print the card;
  2. kernel K1 (csrc/max_logit_fwd.cu) against its plain PyTorch version
     at the stage-3 shape -- 8 frames x 3 triplane views of a 13,776-face
     SMPL-sized closed mesh at 512^2 -- and at 32..256 px (each
     pixels-per-thread instance), requiring m and cnt bit-equal; kernel,
     plain and bound times;
  3. the neural-only slice at a small size on the CPU and on the card,
     same inputs and seeds, with a surface threshold wide enough that the
     untrained net keeps surface points: the packed outputs, non-zero,
     must agree;
  4. the main path: `track --neural-only` through the port's entry point
     on an 8-frame BEHAVE-layout sequence held in memory (2048x1536
     frames, a 6890-vertex SMPL-H model), release SIF-Net (random weights
     from a seed), full stage-1 budget and funnel harvest, on the card,
     with every kernel's launch count set to 0 before and read after;
     each further --frames value runs it again with that many frames in
     one chunk, to read per-stage peak device memory against chunk size;
  5. a {"kernels": [...]} line, the nvidia-smi name/power-limit line and,
     last, {"ok": true, "device": {...}}.
Scratch files go to build/chip_smoke/ next to this script. Imports no JAX.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import pickle
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


def check_k1(device, frames=8, size=512):
    """K1 against its plain version at the stage-3 shape, and at the sizes
    that use the kernel's other pixels-per-thread instances; returns the
    kernel's record for the {"kernels": ...} line (without launches)."""
    import torch
    from vistracker_tpu_torch.ops.coverage import (
        _FBLK, _RBLK, _xblk, max_logit_fwd, max_logit_fwd_plain)

    for small in (32, 64, 128, 256):
        k1_equal(*k1_inputs(device, 1, small)[:2], small)
    print("K1 bit-equal to the plain version at 32, 64, 128, 256 px "
          "(3 views)")
    cpl, active, B, n_faces = k1_inputs(device, frames, size)
    err = k1_equal(cpl, active, size)
    ms = cuda_ms(lambda: max_logit_fwd(cpl, active, size), 20)
    t0 = time.perf_counter()
    max_logit_fwd_plain(cpl, active, size)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    live = int(active.sum())
    ops = live * _FBLK * _RBLK * (_xblk(size) * K1_OPS_PER_PIXEL_FACE
                                  + K1_OPS_PER_ROW_FACE)
    nbytes = (cpl.numel() * 4 + active.numel() * 4 + 2 * B * size * size * 4)
    t_ops, t_bytes = ops / H100_FP32_OPS * 1e3, nbytes / H100_BYTES * 1e3
    print(f"K1 at {B} views x {n_faces} faces x {size}^2: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.1f} ms, live cells {live} of "
          f"{active.numel()}, bound {max(t_ops, t_bytes):.4f} ms "
          f"({'operations' if t_ops >= t_bytes else 'bytes'}; ops "
          f"{t_ops:.4f} ms, bytes {t_bytes:.4f} ms), m and cnt bit-equal")
    return {"name": "max_logit_fwd", "route": "cuda",
            "source": "vistracker_tpu_torch/csrc/max_logit_fwd.cu",
            "replaces": "vistracker_tpu/ops/pallas_raster.py:140",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def fabricate(tag: str, frames: int, rings: int, segments: int, seed=0):
    """An in-memory BEHAVE-layout sequence (MemoryFrameReader) plus a
    synthetic SMPL-H pkl and assets on disk under build/chip_smoke/<tag>;
    returns (reader, smpl_pkl, assets)."""
    from vistracker_tpu_torch.core.smpl import SMPLH_PARENTS
    from vistracker_tpu_torch.data.behave import MemoryFrameReader

    rng = np.random.RandomState(seed)
    root = os.path.join(WORK, tag)
    os.makedirs(os.path.join(root, "assets", "priors"), exist_ok=True)
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

    H, W = 1536, 2048
    color = rng.randint(0, 256, (frames, H, W, 3), dtype=np.uint8)
    pm = np.zeros((frames, H, W), bool)
    om = np.zeros((frames, H, W), bool)
    for t in range(frames):  # person left of the image center, object right
        x0 = 700 + 10 * t
        pm[t, 300:1300, x0:x0 + 350] = True
        om[t, 700:1100, x0 + 350:x0 + 650] = True
    kpts = np.concatenate([rng.rand(frames, 25, 1) * 350 + 700,
                           rng.rand(frames, 25, 1) * 1000 + 300,
                           np.ones((frames, 25, 1))], -1)
    reader = MemoryFrameReader(
        f"Date09_Sub01_{tag}", dict(cat="boxsmall", gender="male"),
        color, pm, om, kpts.astype(np.float32),
        (rng.randn(frames, 72) * 0.1).astype(np.float32),
        np.zeros((frames, 10), np.float32))
    return reader, smpl_pkl, assets


def run_slice(reader, smpl_pkl, assets, device, out, extra=()):
    from vistracker_tpu_torch.cli.main import build_parser
    from vistracker_tpu_torch.cli.real_track import run_real_track
    from vistracker_tpu_torch.data.packed import load_packed

    args = build_parser().parse_args([
        "track", "--seq", reader.seq_name, "--out", out,
        "--smpl-model", smpl_pkl, "--assets", assets,
        "--sifnet-ckpt", "random", "--neural-only", "--redo",
        "--device", device, *extra])
    summary = run_real_track(args, reader=reader)
    return summary, load_packed(summary["packed"])


def check_outputs(packed: dict, T: int):
    shapes = dict(poses=(T, 156), betas=(T, 10), trans=(T, 3),
                  neural_pca=(T, 3, 3), neural_trans=(T, 3),
                  neural_visibility=(T,))
    for k, shape in shapes.items():
        v = np.asarray(packed[k])
        if v.shape != shape or not np.isfinite(v).all():
            raise SystemExit(f"packed {k}: shape {v.shape} (want {shape}), "
                             f"finite {np.isfinite(v).all()}")
    vis = np.asarray(packed["neural_visibility"])
    if vis.min() < 0.0 or vis.max() > 1.0:
        raise SystemExit(f"visibility outside [0, 1]: {vis}")


def check_small_cpu_vs_card():
    """The slice at a small size (tiny SIF-Net, 64^2 inputs, 2 frames, a
    122-vertex mesh) on the CPU and on the card, same seeds. The untrained
    net's df never drops below the release surface threshold (0.004), so
    the threshold is widened to 10 here: surface points survive and the
    neural outputs, which must be non-zero, exercise the card's
    grid_sample, heads and masked means. Stage-1 fits agree to 1e-3 (1000
    Adam steps; reductions run in another order on the card) and so do
    the neural means over the 4000 kept points."""
    from vistracker_tpu_torch.fit import generator as gen_mod

    reader, smpl_pkl, assets = fabricate("small", 2, 12, 10)
    extra = ("--tiny-nets", "--net-size", "64", "--chunk-size", "2")
    wide = functools.partial(gen_mod.GeneratorConfig, filter_val=10.0)
    with mock.patch.object(gen_mod, "GeneratorConfig", wide):
        _, ref = run_slice(reader, smpl_pkl, assets, "cpu",
                           os.path.join(WORK, "small", "out_cpu"), extra)
        _, got = run_slice(reader, smpl_pkl, assets, "cuda",
                           os.path.join(WORK, "small", "out_cuda"), extra)
    neural = ("neural_pca", "neural_trans", "neural_visibility")
    for k in neural:
        for side, out in (("cpu", ref), ("card", got)):
            v = np.abs(np.asarray(out[k])).reshape(len(reader), -1)
            if not (v.max(1) > 0).all():
                raise SystemExit(f"small slice on the {side}: {k} is zero "
                                 "for some frame (no surface point kept)")
    diffs = {k: float(np.abs(np.asarray(got[k], np.float64)
                             - np.asarray(ref[k], np.float64)).max())
             for k in ("poses", "betas", "trans") + neural}
    print(f"small slice, card vs CPU max |diff|: {json.dumps(diffs)}; "
          f"neural means on the card: pca |max| "
          f"{float(np.abs(got['neural_pca']).max()):.4g}, trans "
          f"{np.asarray(got['neural_trans']).tolist()}, visibility "
          f"{np.asarray(got['neural_visibility']).tolist()}")
    bad = {k: v for k, v in diffs.items() if not v <= 1e-3}
    if bad:
        raise SystemExit(f"card and CPU disagree on the small slice: {bad}")


def run_main_path(frames: int, wrappers: dict) -> dict:
    """`track --neural-only` at release width, all frames in one chunk, on
    the card; every kernel's count set to 0 just before. Returns the
    launch counts."""
    import torch
    reader, smpl_pkl, assets = fabricate(f"main{frames}", frames, 84, 82)
    for w in wrappers.values():
        w.launches = 0
    summary, packed = run_slice(reader, smpl_pkl, assets, "cuda",
                                os.path.join(WORK, f"main{frames}", "out"),
                                ("--chunk-size", str(frames)))
    launches = {name: w.launches for name, w in wrappers.items()}
    check_outputs(packed, frames)
    peaks = summary["stage_peak_gib"]
    print(f"main path: {frames} frames in one chunk in "
          f"{summary['seconds']:.2f} s ({summary['fps']:.3f} frames/s), "
          f"peak device memory {max(peaks.values()):.2f} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}"
          f"; random draws {summary['draw_seconds']:.4f} s on the host")
    for stage, sec in summary["stage_seconds"].items():
        print(f"  {stage}: {sec:.3f} s, peak {peaks[stage]:.2f} GiB")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, nargs="+", default=[8],
                    help="main-path frame counts (one chunk each); the "
                         "first is the run whose launches are counted")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    from vistracker_tpu_torch.ops.coverage import max_logit_fwd
    from vistracker_tpu_torch.utils.cuda_build import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = {"max_logit_fwd": max_logit_fwd}
    t0 = time.perf_counter()
    for name in wrappers:
        log = build(name)
        for line in log.splitlines():
            if any(w in line for w in ("properties", "registers", "spill")):
                print(f"  {name}: {line.strip()}")
    print(f"built {sorted(wrappers)} in {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")

    records = [check_k1(torch.device("cuda"))]
    check_small_cpu_vs_card()

    launches = run_main_path(opts.frames[0], wrappers)
    for frames in opts.frames[1:]:
        run_main_path(frames, wrappers)
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        if rec["launches"] < 1:
            raise SystemExit(f"{rec['name']} was not launched on the main "
                             "path")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
