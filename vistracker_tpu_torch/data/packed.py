"""The packed-pkl contract (port of vistracker_tpu/data/packed.py).

The packs are the pipeline's inter-stage interface: `track` writes one
per sequence, `evaluate` reads a recon pack and a `<seq>_GT-packed.pkl`,
`unpack`/`pack` convert to and from per-frame fit files. Conventions:
poses (T, 156) axis-angle SMPL-H, betas (T, 10), trans (T, 3),
obj_angles (T, 3, 3) ROW-VECTOR rotations (verts = (temp @ obj_angles +
obj_trans) * obj_scales) in recon packs and axis-angle (T, 3) applied as
temp @ R(aa).T in GT packs, recon_exist (T,) bool, frames a list of
frame names.

The port writes plain pickles (protocol 4), which joblib.load -- the JAX
package's reader -- also reads. `load_packed` reads those and the files
the JAX package and the reference write with joblib.dump: an
uncompressed joblib file is a pickle in which each numpy array is a
`NumpyArrayWrapper` object followed by the array's raw bytes, which
`pickle.load` cannot read. joblib itself is not needed.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any

import numpy as np

RECON_KEYS = ("poses", "betas", "trans", "root_joints", "obj_angles",
              "obj_trans", "obj_scales", "neural_pca", "neural_trans",
              "neural_visibility", "recon_exist", "recon_name", "frames",
              "gender")

# joblib's compressed containers, by their magic bytes (joblib/compressor.py)
_COMPRESSED = ((b"ZF", "joblib < 0.10 zfile"), (b"\x78", "zlib"),
               (b"\x1f\x8b", "gzip"), (b"BZ", "bz2"),
               (b"\xfd\x37\x7a\x58\x5a", "xz"), (b"\x5d\x00", "lzma"),
               (b"\x04\x22\x4d\x18", "lz4"))


@dataclasses.dataclass
class PackedRecon:
    poses: np.ndarray          # (T, 156)
    betas: np.ndarray          # (T, 10)
    trans: np.ndarray          # (T, 3)
    obj_angles: np.ndarray     # (T, 3, 3) row-vector convention
    obj_trans: np.ndarray      # (T, 3)
    obj_scales: np.ndarray     # (T,)
    frames: list
    gender: str = "male"
    root_joints: np.ndarray | None = None
    neural_pca: Any = None
    neural_trans: Any = None
    neural_visibility: Any = None
    recon_exist: np.ndarray | None = None
    recon_name: str = ""

    def __post_init__(self):
        if self.recon_exist is None:
            self.recon_exist = np.ones(len(self.poses), bool)

    @property
    def num_frames(self) -> int:
        return len(self.poses)


def save_packed(path: str, data: dict | PackedRecon):
    if isinstance(data, PackedRecon):
        data = dataclasses.asdict(data)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=4)


class _ArrayWrapper:
    """Stands in for joblib.numpy_pickle.NumpyArrayWrapper: receives the
    wrapper's state (subclass, shape, order, dtype, allow_mmap and, from
    joblib 1.2 on, numpy_array_alignment_bytes)."""

    def __setstate__(self, state):
        self.__dict__.update(state)


class _JoblibUnpickler(pickle._Unpickler):
    """Unpickler for plain pickles and uncompressed joblib files.

    The pure-Python unpickler, so that the file position after each
    opcode is exact (the array bytes follow the wrapper's BUILD opcode,
    which ends a pickle frame) and BUILD can be intercepted, as joblib's
    own NumpyUnpickler does.
    """

    dispatch = pickle._Unpickler.dispatch.copy()

    def __init__(self, file):
        super().__init__(file)
        self._file = file

    def find_class(self, module, name):
        if module.startswith("joblib.numpy_pickle"):
            if name == "NumpyArrayWrapper":
                return _ArrayWrapper
            raise pickle.UnpicklingError(
                f"joblib {name} (a joblib < 0.10 pack that keeps its arrays "
                "in side files) is not read; write the pack again")
        return super().find_class(module, name)

    def load_build(self):
        super().load_build()
        if isinstance(self.stack[-1], _ArrayWrapper):
            self.stack[-1] = self._read_array(self.stack[-1])

    dispatch[pickle.BUILD[0]] = load_build

    def _read_array(self, w: _ArrayWrapper) -> np.ndarray:
        dtype = np.dtype(w.dtype)
        if dtype.hasobject:  # pickled inline (protocol 5) by joblib
            return pickle.load(self._file)
        if getattr(w, "numpy_array_alignment_bytes", None) is not None:
            pad = self._file.read(1)
            if len(pad) != 1:
                raise pickle.UnpicklingError("truncated joblib array padding")
            self._file.read(pad[0])
        shape = tuple(int(s) for s in w.shape)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        data = self._file.read(nbytes)
        if len(data) != nbytes:
            raise pickle.UnpicklingError(
                f"truncated joblib array: {len(data)} of {nbytes} bytes")
        arr = np.frombuffer(data, dtype=dtype).copy()
        arr = (arr.reshape(shape[::-1]).T if w.order == "F"
               else arr.reshape(shape))
        if not dtype.isnative:
            arr = arr.astype(dtype.newbyteorder("="))
        return arr


def load_packed(path: str) -> dict:
    """Load a packed pkl: a plain pickle (the port's save_packed) or an
    uncompressed joblib file (the JAX package's save_packed, the
    reference's GT packs). A compressed joblib file raises. Only trusted
    files: unpickling runs code."""
    with open(path, "rb") as f:
        head = f.read(8)
        for magic, name in _COMPRESSED:
            if head.startswith(magic):
                raise ValueError(
                    f"{path} is a {name}-compressed joblib file; the port "
                    "reads uncompressed joblib and plain pickles only "
                    "(re-save it with joblib.dump(..., compress=0))")
        f.seek(0)
        return _JoblibUnpickler(f).load()


def load_packed_recon(path: str) -> PackedRecon:
    d = load_packed(path)
    return PackedRecon(
        poses=np.asarray(d["poses"]).reshape(len(d["poses"]), -1),
        betas=np.asarray(d["betas"]),
        trans=np.asarray(d["trans"]),
        obj_angles=np.asarray(d["obj_angles"]),
        obj_trans=np.asarray(d["obj_trans"]),
        obj_scales=np.asarray(d["obj_scales"]),
        frames=list(d.get("frames", [])),
        gender=str(d.get("gender", "male")),
        root_joints=(np.asarray(d["root_joints"])
                     if "root_joints" in d else None),
        neural_pca=d.get("neural_pca"),
        neural_trans=d.get("neural_trans"),
        neural_visibility=d.get("neural_visibility"),
        recon_exist=(np.asarray(d["recon_exist"])
                     if "recon_exist" in d else None),
        recon_name=str(d.get("recon_name", "")),
    )


def _fit_files(seq_dir: str, frame: str, save_name: str, kid: int):
    fd = os.path.join(seq_dir, frame)
    return (os.path.join(fd, f"k{kid}.smplfit_{save_name}.pkl"),
            os.path.join(fd, f"k{kid}.objfit_{save_name}.pkl"))


def unpack_to_frames(packed: dict, seq_dir: str, save_name: str,
                     kid: int = 1) -> list:
    """Write per-frame fit files from a packed dict (the reference's
    tools/pack2separate.py): <seq>/<frame>/k{kid}.smplfit_{save_name}.pkl
    {pose, betas, trans} and k{kid}.objfit_{save_name}.pkl {rot, trans,
    scale}. Frames whose two files exist are skipped (resume); returns the
    frames written."""
    written = []
    for i, frame in enumerate(packed["frames"]):
        sf, of = _fit_files(seq_dir, frame, save_name, kid)
        if os.path.isfile(sf) and os.path.isfile(of):
            continue
        os.makedirs(os.path.dirname(sf), exist_ok=True)
        with open(sf, "wb") as f:
            pickle.dump(dict(pose=np.asarray(packed["poses"][i]),
                             betas=np.asarray(packed["betas"][i]),
                             trans=np.asarray(packed["trans"][i])), f)
        with open(of, "wb") as f:
            pickle.dump(dict(rot=np.asarray(packed["obj_angles"][i]),
                             trans=np.asarray(packed["obj_trans"][i]),
                             scale=float(np.asarray(
                                 packed["obj_scales"][i]))), f)
        written.append(frame)
    return written


def pack_from_frames(seq_dir: str, frames: list, save_name: str,
                     kid: int = 1) -> dict:
    """Inverse of unpack_to_frames: gather per-frame fit files into the
    packed layout; a frame without both files is dummy-filled (identity
    rotation, unit scale, zeros) and marked False in recon_exist."""
    poses, betas, trans = [], [], []
    rots, otrans, oscales, exist = [], [], [], []
    for frame in frames:
        sf, of = _fit_files(seq_dir, frame, save_name, kid)
        ok = os.path.isfile(sf) and os.path.isfile(of)
        exist.append(ok)
        if ok:
            with open(sf, "rb") as f:
                s = pickle.load(f)
            with open(of, "rb") as f:
                o = pickle.load(f)
            poses.append(np.asarray(s["pose"]).reshape(-1))
            betas.append(np.asarray(s["betas"]).reshape(-1))
            trans.append(np.asarray(s["trans"]).reshape(-1))
            rots.append(np.asarray(o["rot"]))
            otrans.append(np.asarray(o["trans"]).reshape(-1))
            oscales.append(float(o["scale"]))
        else:
            poses.append(np.zeros(156, np.float32))
            betas.append(np.zeros(10, np.float32))
            trans.append(np.zeros(3, np.float32))
            rots.append(np.eye(3, dtype=np.float32))
            otrans.append(np.zeros(3, np.float32))
            oscales.append(1.0)
    return dict(poses=np.stack(poses), betas=np.stack(betas),
                trans=np.stack(trans), obj_angles=np.stack(rots),
                obj_trans=np.stack(otrans), obj_scales=np.asarray(oscales),
                recon_exist=np.asarray(exist), recon_name=save_name,
                frames=list(frames))


def recon_obj_verts(temp_verts: np.ndarray, obj_angles: np.ndarray,
                    obj_trans: np.ndarray,
                    obj_scales: np.ndarray) -> np.ndarray:
    """Recon packs: verts = (temp @ obj_angles + trans) * scale."""
    v = np.matmul(temp_verts[None], obj_angles) + obj_trans[:, None]
    return v * obj_scales[:, None, None]


def gt_obj_verts(temp_verts: np.ndarray, obj_axis_angle: np.ndarray,
                 obj_trans: np.ndarray) -> np.ndarray:
    """GT packs: verts = temp @ R(axis_angle).T + trans."""
    from scipy.spatial.transform import Rotation
    R = Rotation.from_rotvec(obj_axis_angle).as_matrix()
    return (np.matmul(temp_verts[None], R.transpose(0, 2, 1))
            + obj_trans[:, None])
