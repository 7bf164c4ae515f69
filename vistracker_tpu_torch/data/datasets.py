"""Training datasets and the host input pipeline (numpy batches).

Port of vistracker_tpu/data/datasets.py:
  * `PrefetchLoader`: an index-based example function as a shuffled,
    batched loader. Worker threads build batches ahead of the consumer,
    but batches are yielded in a fixed order for a seed and epoch; a
    failing example is replaced by a random one (up to 10 tries); a
    consumer that stops early leaves no producer blocked.
  * `sifnet_example`: one SIF-Net training example from a prepared frame
    (image, crop and body centers, meshes in the camera frame,
    visibility), with online GT labelling (data/sampling.py).
  * `reexpress_smpl_in_camera` / `reexpress_obj_in_camera`: the
    multi-kinect view augmentation of the infiller's data.
  * `gen_drop_mask` and `InfillerClips`: HVOP-Net training clips over
    packed GT sequences with a random contiguous occlusion drop.
Batches stay numpy; the training loop moves them to the device.
"""
from __future__ import annotations

import queue
import threading
import traceback
from typing import Callable, Iterator, Sequence

import numpy as np

from .sampling import boundary_sample


class PrefetchLoader:
    """Shuffled, batched, prefetched loader over example_fn(index)."""

    def __init__(self, example_fn: Callable[[int], dict], n_examples: int,
                 batch_size: int, shuffle: bool = True, num_workers: int = 4,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 drop_last: bool = True):
        self.example_fn = example_fn
        self.n = n_examples
        self.bs = batch_size
        self.shuffle = shuffle
        self.workers = max(1, num_workers)
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.drop_last = drop_last
        self.epoch = 0

    def _indices(self):
        idx = np.arange(self.n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx[self.host_id::self.num_hosts]  # this host's shard

    def _get(self, i, rng):
        for _ in range(10):
            try:
                return self.example_fn(int(i))
            except Exception:
                traceback.print_exc()
                i = rng.randint(self.n)
        raise RuntimeError("10 consecutive failing examples")

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        self.epoch += 1
        nb = len(idx) // self.bs if self.drop_last else \
            -(-len(idx) // self.bs)
        # one single-slot queue per batch, read in batch order: workers
        # produce in parallel, the yielded stream is deterministic
        slots = [queue.Queue(maxsize=1) for _ in range(nb)]
        rng = np.random.RandomState(self.seed + 1000 + self.epoch)
        # at most workers + 4 batches ahead of the consumer
        ahead = threading.Semaphore(self.workers + 4)
        cancelled = threading.Event()  # set when the consumer stops early

        def produce(batch_indices, slot_q):
            try:
                ex = [self._get(i, rng) for i in batch_indices]
                slot_q.put({k: np.stack([e[k] for e in ex], 0)
                            for k in ex[0]})
            except Exception as e:  # handed to the consumer
                slot_q.put(e)

        def runner():
            threads = []
            for b in range(nb):
                while not ahead.acquire(timeout=1.0):
                    if cancelled.is_set():
                        return
                if cancelled.is_set():
                    return
                bi = idx[b * self.bs:(b + 1) * self.bs]
                # daemon: a producer blocked after an early stop must not
                # keep the process alive
                t = threading.Thread(target=produce, args=(bi, slots[b]),
                                     daemon=True)
                t.start()
                threads.append(t)
                while len([x for x in threads if x.is_alive()]) >= self.workers:
                    for x in threads:
                        if x.is_alive():
                            x.join(timeout=0.05)
                            break
                    threads = [x for x in threads if x.is_alive()]

        threading.Thread(target=runner, daemon=True).start()
        try:
            for b in range(nb):
                batch = slots[b].get()
                ahead.release()
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            cancelled.set()

    def __len__(self):
        return len(self._indices()) // self.bs


def sifnet_example(frame: dict, part_labels: np.ndarray,
                   num_samples: int = 20000,
                   sigmas=(0.08, 0.02, 0.003), ratios=(0.01, 0.49, 0.5),
                   grid_ratio: float = 0.01,
                   rng: np.random.RandomState | None = None) -> dict:
    """One SIF-Net training example from a prepared frame dict {image
    (H, W, 8) float32 (RGBM3 + triplanes), crop_center (2,), body_center
    (3,), smpl_verts / smpl_faces, obj_verts / obj_faces (camera frame),
    visibility (scalar)}: the batch-ready training dict."""
    rng = rng or np.random.RandomState()
    labels = boundary_sample(frame["smpl_verts"], frame["smpl_faces"],
                             frame["obj_verts"], frame["obj_faces"],
                             part_labels, sigmas, ratios, num_samples,
                             grid_ratio=grid_ratio, rng=rng)
    n = len(labels["points"])
    return dict(
        images=frame["image"].astype(np.float32),
        points=labels["points"],
        df_h=labels["df_h"],
        df_o=labels["df_o"],
        parts=labels["parts"],
        pca=np.broadcast_to(labels["pca_axis"], (n, 3, 3)).copy(),
        obj_center=(labels["obj_center"]
                    - frame["body_center"]).astype(np.float32),
        visibility=np.full(n, frame["visibility"], np.float32),
        crop_center=frame["crop_center"].astype(np.float32),
        body_center=frame["body_center"].astype(np.float32),
    )


def reexpress_smpl_in_camera(poses: np.ndarray, trans: np.ndarray,
                             roots: np.ndarray, w2c_R: np.ndarray,
                             w2c_t: np.ndarray):
    """SMPL poses (T, >=3, global orientation first) and translations
    (T, 3) in another camera (w2c_R (3, 3), w2c_t (3,)); roots (T, 3) are
    the root-joint positions. The global orientation is left-multiplied
    by R; the translation is corrected for the root offset."""
    from scipy.spatial.transform import Rotation
    g = Rotation.from_rotvec(poses[:, :3]).as_matrix()
    new_g = np.matmul(w2c_R[None], g)
    roots_cent = roots - trans
    new_trans = (trans @ w2c_R.T + w2c_t
                 + roots_cent @ w2c_R.T - roots_cent)
    out = poses.copy()
    out[:, :3] = Rotation.from_matrix(new_g).as_rotvec()
    return out, new_trans.astype(np.float32)


def reexpress_obj_in_camera(rots: np.ndarray, trans: np.ndarray,
                            w2c_R: np.ndarray, w2c_t: np.ndarray):
    """Object rotations (T, 3, 3) and translations (T, 3) in another
    camera: R_new = w2c_R @ R, t_new = t @ w2c_R.T + w2c_t."""
    new_rot = np.matmul(w2c_R[None], rots)
    new_trans = trans @ w2c_R.T + w2c_t
    return new_rot, new_trans.astype(np.float32)


def gen_drop_mask(length: int, min_drop: int, max_drop: int,
                  rng: np.random.RandomState) -> np.ndarray:
    """A random contiguous occlusion drop of min_drop..max_drop frames
    (at most length - 1)."""
    drop = rng.randint(min_drop, max_drop + 1)
    drop = min(drop, length - 1)
    start = rng.randint(0, max(1, length - drop))
    mask = np.zeros(length, bool)
    mask[start:start + drop] = True
    return mask


class InfillerClips:
    """Clips over concatenated packed GT sequences ({poses, trans,
    obj_rot_real}). Each example: the SMPL stream (clip, 147) = 24-joint
    rot6d + translation, the object stream (clip, 6) rot6d zeroed where
    occluded, the occlusion mask (clip,) and the GT object rot6d (clip,
    6). Sequences shorter than clip_len are skipped."""

    def __init__(self, sequences: Sequence[dict], clip_len: int = 180,
                 min_drop: int = 10, max_drop: int = 120, seed: int = 0):
        from ..fit.infill import prepare_streams
        self.clips = []
        self.clip_len = clip_len
        self.min_drop = min_drop
        self.max_drop = max_drop
        self.seed = seed
        self.streams = []
        for seq in sequences:
            T = len(seq["poses"])
            if T < clip_len:
                continue
            smpl_s, obj_s = prepare_streams(
                np.asarray(seq["poses"]).reshape(T, -1),
                np.asarray(seq["trans"]),
                np.asarray(seq["obj_rot_real"]))
            sid = len(self.streams)
            self.streams.append((smpl_s, obj_s))
            self.clips += [(sid, s) for s in range(T - clip_len + 1)]

    def __len__(self):
        return len(self.clips)

    def example(self, i: int) -> dict:
        rng = np.random.RandomState(self.seed + i)
        sid, start = self.clips[i]
        smpl_s, obj_s = self.streams[sid]
        sl = slice(start, start + self.clip_len)
        mask = gen_drop_mask(self.clip_len, self.min_drop, self.max_drop, rng)
        obj_in = obj_s[sl] * (1.0 - mask[:, None].astype(np.float32))
        return dict(data_smpl=smpl_s[sl].astype(np.float32),
                    mask_smpl=np.zeros(self.clip_len, bool),
                    data_obj=obj_in.astype(np.float32),
                    mask_obj=mask,
                    gt_obj=obj_s[sl].astype(np.float32))
