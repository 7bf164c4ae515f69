"""A BEHAVE-layout sequence made from a seed: the input of the `track`
cells.

FROZEN COPY of chip_smoke.py's fabricate, write_smpl_pkl, sphere_mesh and
object_mesh at commit ebfc849. A change that claims a speed-up may not
edit this file. Departures from the original, so that a run's set-up
stays short and its inputs follow the seed: the colour frames are drawn
with torch.randint on a generator of the run's device and copied to the
host in one transfer; the small draws use np.random.RandomState(seed mod
2^32); the PLY writer and the SMPL-H parent table are copied here, so
that the yardstick imports nothing of the port.

The sequence: frames of 2048 x 1536 Kinect colour, uniform random
pixels; a person mask (a 1000 x 350 box) and an object mask (300 x 300,
held in front of the person) moving 4 px a frame; 25 body keypoints
inside the person box; mocap poses and betas. The assets: a synthetic
SMPL-H pkl on a closed sphere of rings x segments vertices plus two
poles (84 x 82: 6,890 vertices, 13,776 faces, the SMPL-H counts), the
keypoint and part regressors, the pose priors, and an object template,
a closed ellipsoid of half-axes 15, 10 and 6 cm (35 x 36: 2,520 faces).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

SMPLH_PARENTS = (
    0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
    19, 20, 22, 23, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 21,
    37, 38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50)
HEIGHT, WIDTH = 1536, 2048


def sphere_mesh(rings: int, segments: int, radius: float = 0.4):
    """Closed UV sphere: rings x segments vertices plus two poles,
    2 * rings * segments faces."""
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


def object_mesh(rings=35, segments=36):
    """The object template: a closed ellipsoid, half-axes 15, 10, 6 cm."""
    verts, faces = sphere_mesh(rings, segments, 1.0)
    return verts * np.array([0.15, 0.10, 0.06], np.float32), faces


def save_ply(path: str, verts, faces):
    """Binary little-endian PLY, float vertices and int triangles."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    with open(path, "wb") as f:
        f.write(("ply\nformat binary_little_endian 1.0\n"
                 f"element vertex {len(verts)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 f"element face {len(faces)}\n"
                 "property list uchar int vertex_indices\nend_header\n")
                .encode())
        f.write(verts.astype("<f4").tobytes())
        rec = np.zeros(len(faces), dtype=[("n", "u1"), ("v", "<i4", 3)])
        rec["n"] = 3
        rec["v"] = faces
        f.write(rec.tobytes())


def write_smpl_pkl(root: str, rng, rings: int, segments: int) -> str:
    """A synthetic SMPL-H pkl on a closed sphere mesh; returns its path."""
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


def fabricate(root: str, frames: int, seed: int, device, mesh=(84, 82),
              obj=(35, 36)) -> dict:
    """Write the assets under `root` and draw the frames. Returns a dict:
    seq_name, info, color (T, H, W, 3) uint8, person_mask, obj_mask
    (T, H, W) bool, kpts (T, 25, 3), mocap_pose (T, 72), mocap_betas
    (T, 10), smpl_pkl, assets, objects."""
    rng = np.random.RandomState(seed % 2 ** 32)
    os.makedirs(os.path.join(root, "assets", "priors"), exist_ok=True)
    smpl_pkl = write_smpl_pkl(root, rng, *mesh)
    V = mesh[0] * mesh[1] + 2
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

    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    color = torch.randint(0, 256, (frames, HEIGHT, WIDTH, 3), generator=gen,
                          device=device, dtype=torch.uint8).cpu().numpy()
    pm = np.zeros((frames, HEIGHT, WIDTH), bool)
    om = np.zeros((frames, HEIGHT, WIDTH), bool)
    for t in range(frames):  # the object held in front of the person
        x0 = 700 + 4 * t
        pm[t, 300:1300, x0:x0 + 350] = True
        om[t, 650:950, x0 + 150:x0 + 450] = True
    kpts = np.concatenate([rng.rand(frames, 25, 1) * 350 + 700,
                           rng.rand(frames, 25, 1) * 1000 + 300,
                           np.ones((frames, 25, 1))], -1)
    return dict(seq_name="Date09_Sub01_bench",
                info=dict(cat="boxsmall", gender="male"), color=color,
                person_mask=pm, obj_mask=om, kpts=kpts.astype(np.float32),
                mocap_pose=(rng.randn(frames, 72) * 0.1).astype(np.float32),
                mocap_betas=np.zeros((frames, 10), np.float32),
                smpl_pkl=smpl_pkl, assets=assets, objects=objects)
