"""BEHAVE sequence access (port of the readers in vistracker_tpu/data/behave.py).

A sequence folder holds info.json and per-frame folders tXXXX.XXX with
k{kid}.color.jpg, person/object masks, k{kid}.color.json (OpenPose) and
k{kid}.mocap.json (FrankMocap). Images are read through data/imageio.py
(PNG in numpy, JPEG in host C++), which decodes what PIL decodes without
PIL. `MemoryFrameReader` serves the same interface from arrays held in
memory, for callers that have frames but no files. `KinectCalib` and
`KinectTransform` map points between the world and a kinect's camera
frame from the sequence's calibration folder.
"""
from __future__ import annotations

import json
import os.path as osp
from glob import glob

import numpy as np

from .imageio import read_l, read_rgb


class SeqInfo:
    """Sequence metadata (the contents of info.json)."""

    def __init__(self, info: dict):
        self.info = info

    def get_gender(self) -> str:
        return self.info["gender"]

    def get_obj_name(self) -> str:
        return self.info["cat"]

    @property
    def kids(self):
        return self.info.get("kinects", [0, 1, 2, 3])

    def beta_init(self):
        return self.info.get("beta")


def _read_info(seq: str) -> SeqInfo:
    with open(osp.join(seq, "info.json")) as f:
        return SeqInfo(json.load(f))


def _clean_kpts(arr: np.ndarray, tol: float) -> np.ndarray:
    arr = np.asarray(arr, np.float32).reshape(-1, 3)[:25].copy()
    arr[arr[:, 2] < tol] = 0.0
    return arr


class FrameDataReader:
    """Per-frame file access for one sequence folder."""

    def __init__(self, seq: str):
        self.seq_path = seq
        self.seq_name = osp.basename(seq.rstrip("/"))
        self.frames = sorted(
            osp.basename(d.rstrip("/")) for d in glob(osp.join(seq, "*/"))
            if osp.basename(d.rstrip("/")).startswith("t"))
        self.seq_info = (_read_info(seq) if osp.isfile(
            osp.join(seq, "info.json")) else None)

    def __len__(self):
        return len(self.frames)

    def cvt_end(self, end):
        return len(self.frames) if end is None else min(end, len(self.frames))

    def get_frame_folder(self, idx) -> str:
        """The folder of frame `idx`, an index or a frame name."""
        return osp.join(self.seq_path,
                        idx if isinstance(idx, str) else self.frames[idx])

    def get_color_file(self, idx, kid: int) -> str:
        return osp.join(self.get_frame_folder(idx), f"k{kid}.color.jpg")

    def get_mask_file(self, idx: int, kid: int, cat: str = "person") -> str:
        folder = self.get_frame_folder(idx)
        names = {
            "person": [f"k{kid}.person_mask.png", f"k{kid}.person_mask.jpg"],
            "obj": [f"k{kid}.obj_rend_mask.png", f"k{kid}.obj_rend_mask.jpg",
                    f"k{kid}.obj_mask.png", f"k{kid}.obj_mask.jpg"],
        }[cat]
        for n in names:
            p = osp.join(folder, n)
            if osp.isfile(p):
                return p
        raise FileNotFoundError(f"no {cat} mask in {folder}")

    def get_mask(self, idx: int, kid: int, cat: str = "person") -> np.ndarray:
        return read_l(self.get_mask_file(idx, kid, cat)) > 127

    def get_color(self, idx: int, kid: int) -> np.ndarray:
        return read_rgb(self.get_color_file(idx, kid))

    def get_body_kpts(self, idx: int, kid: int, tol: float = 0.5):
        """OpenPose body25 keypoints (25, 3); low-confidence rows zeroed."""
        path = osp.join(self.get_frame_folder(idx), f"k{kid}.color.json")
        with open(path) as f:
            data = json.load(f)
        if "body_joints" in data:
            return _clean_kpts(data["body_joints"], tol)
        people = data.get("people", [])
        if not people:
            return np.zeros((25, 3), np.float32)
        return _clean_kpts(people[0]["pose_keypoints_2d"], tol)

    def get_mocap_params(self, idx: int, kid: int):
        """FrankMocap init pose (72,) + betas (10,)."""
        path = osp.join(self.get_frame_folder(idx), f"k{kid}.mocap.json")
        with open(path) as f:
            data = json.load(f)
        return (np.asarray(data["pose"], np.float32).reshape(-1),
                np.asarray(data["betas"], np.float32).reshape(-1))


class MemoryFrameReader:
    """FrameDataReader interface over in-memory frames of one kinect:
    color (T, H, W, 3) uint8, person/obj masks (T, H, W) bool, kpts
    (T, 25, 3) pixel x, y, confidence, mocap poses (T, 72) and betas
    (T, 10); info is the sequence's info.json content. Frames are named
    t0000.000, t0001.000, ..."""

    def __init__(self, seq_name: str, info: dict, color, person_mask,
                 obj_mask, kpts, mocap_pose, mocap_betas):
        self.seq_name = seq_name
        self.seq_info = SeqInfo(info)
        self.color, self.kpts = color, kpts
        self.masks = {"person": person_mask, "obj": obj_mask}
        self.mocap = (mocap_pose, mocap_betas)
        self.frames = [f"t{i:04d}.000" for i in range(len(color))]

    def __len__(self):
        return len(self.frames)

    def cvt_end(self, end):
        return len(self.frames) if end is None else min(end, len(self.frames))

    def get_mask(self, idx: int, kid: int, cat: str = "person"):
        return np.asarray(self.masks[cat][idx], bool)

    def get_color(self, idx: int, kid: int) -> np.ndarray:
        return np.asarray(self.color[idx])

    def get_body_kpts(self, idx: int, kid: int, tol: float = 0.5):
        return _clean_kpts(self.kpts[idx], tol)

    def get_mocap_params(self, idx: int, kid: int):
        return (np.asarray(self.mocap[0][idx], np.float32).reshape(-1),
                np.asarray(self.mocap[1][idx], np.float32).reshape(-1))


class KinectCalib:
    """One kinect's extrinsics (world <-> camera) from
    <config>/<kid>/config.json: rotation (3, 3) and translation (3,)."""

    def __init__(self, config_folder: str, kid: int):
        with open(osp.join(config_folder, str(kid), "config.json")) as f:
            cfg = json.load(f)
        self.rotation = np.asarray(cfg["rotation"], np.float64).reshape(3, 3)
        self.translation = np.asarray(cfg["translation"],
                                      np.float64).reshape(3)

    def world2local(self, points: np.ndarray) -> np.ndarray:
        """World -> this camera: R^T (p - t), rows as points."""
        return (points - self.translation) @ self.rotation

    def local2world(self, points: np.ndarray) -> np.ndarray:
        return points @ self.rotation.T + self.translation


class KinectTransform:
    """Every kinect's calibration of one sequence: the folder named by
    info.json's "config" where it exists, else <seq>/config; a kinect
    without a config.json is left out."""

    def __init__(self, seq: str):
        self.seq_info = _read_info(seq)
        config = self.seq_info.info.get("config")
        if not (config and osp.isdir(config)):
            config = osp.join(seq, "config")
        self.calibs = {}
        for kid in self.seq_info.kids:
            try:
                self.calibs[kid] = KinectCalib(config, kid)
            except FileNotFoundError:
                pass

    def world2local(self, points: np.ndarray, kid: int) -> np.ndarray:
        return self.calibs[kid].world2local(points)

    def local2world(self, points: np.ndarray, kid: int) -> np.ndarray:
        return self.calibs[kid].local2world(points)


def load_template(objects_root: str, obj_name: str, center: bool = True):
    """Load an object template mesh (verts, faces), centered at its vertex
    mean: <objects_root>/<obj_name>/<obj_name>.ply (BEHAVE layout) or a
    flat <objects_root>/<obj_name>.ply."""
    from ..utils.mesh import load_ply

    for cand in (osp.join(objects_root, obj_name, f"{obj_name}.ply"),
                 osp.join(objects_root, f"{obj_name}.ply")):
        if osp.isfile(cand):
            v, f = load_ply(cand)
            return (v - v.mean(0) if center else v), f
    raise FileNotFoundError(f"no template for {obj_name} under {objects_root}")
