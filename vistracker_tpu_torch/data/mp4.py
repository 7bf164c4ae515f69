""".mp4 files without cv2.

The port's counterpart of the `cv2.VideoWriter(path,
cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))` that the JAX package's
render/viz.py:save_video calls, for machines that have no cv2 (the one
with the card). The encoder and the file layout are host C++
(csrc/mp4_host.cpp, built with g++ at first use into build/kernels/ and
loaded through ctypes; a failed build raises):

- the video track is MPEG-4 Part 2 Visual, Simple Profile, in an `mp4v`
  sample entry: the codec and the fourcc cv2 writes;
- every frame is an I-VOP at the fixed qscale QSCALE, BT.601
  limited-range 4:2:0, padded to whole macroblocks by repeating its
  edges (the stream carries the true size);
- the timescale is fps and each frame lasts one tick.

It refuses by name what it cannot write: zero frames, frames of
different sizes or not RGB, a side outside 1..8191 pixels, an fps outside
1..65535 or not whole, and a file of 4 GiB or more (its chunk offsets and
its mdat size are 32-bit).
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

QSCALE = 2
# stco offsets and the mdat size are 32-bit
MAX_FILE_BYTES = 1 << 32

_REFUSALS = {
    1: "write_mp4 refuses zero frames",
    2: "write_mp4 refuses a frame side outside 1..8191 pixels (the MPEG-4 "
       "video object layer's 13-bit width and height)",
    3: "write_mp4 refuses an fps outside 1..65535 (the 16-bit "
       "vop_time_increment_resolution)",
    4: "write_mp4 refuses a qscale outside 1..31",
    5: "write_mp4 refuses a file of 4 GiB or more (32-bit stco offsets "
       "and mdat size)",
}


@functools.cache
def _lib():
    from ..utils.cuda_build import load_host_library

    lib = load_host_library("mp4_host")
    lib.vt_mp4_write.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int32, ctypes.c_int32,
                                 ctypes.c_int32, ctypes.c_int32,
                                 ctypes.c_int64, ctypes.c_char_p]
    lib.vt_mp4_write.restype = ctypes.c_int
    return lib


def write_mp4(frames, path: str, fps: int) -> str:
    """(T, H, W, 3) uint8 RGB frames (an array or a sequence of frames) ->
    an .mp4 at `path` playing at `fps` frames a second; returns path."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError(_REFUSALS[1])
    shapes = sorted({f.shape for f in frames})
    if len(shapes) != 1:
        raise ValueError(f"write_mp4 refuses frames of different sizes: "
                         f"{shapes}")
    if len(shapes[0]) != 3 or shapes[0][2] != 3:
        raise ValueError("write_mp4 refuses frames that are not (H, W, 3) "
                         f"RGB: {shapes[0]}")
    if float(fps) != int(fps):
        raise ValueError(f"write_mp4 refuses an fps that is not whole: {fps}")
    rgb = np.ascontiguousarray(np.stack(frames), np.uint8)
    T, H, W = rgb.shape[:3]
    rc = _lib().vt_mp4_write(rgb.ctypes.data, T, H, W, int(fps), QSCALE,
                             MAX_FILE_BYTES, os.fsencode(path))
    if rc in _REFUSALS:
        raise ValueError(_REFUSALS[rc])
    if rc != 0:
        raise OSError(f"write_mp4 could not write {path} (code {rc})")
    return path
