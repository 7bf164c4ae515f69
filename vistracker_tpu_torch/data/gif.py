"""Animated GIF files without PIL.

The port's counterpart of `Image.save(path, save_all=True,
append_images=..., duration=d, loop=0)`, which the JAX package's
render/viz.py:save_video calls, for machines that have no PIL.

- The file is GIF89a: a NETSCAPE2.0 application block with the loop
  count, then per frame a graphic control block carrying the delay (in
  hundredths of a second, `int(duration / 10)`, as PIL writes it), an
  image descriptor with a local colour table, and the LZW image data.
  As in PIL, a frame equal to the one before it is not written again:
  its duration is added to that frame's.
- The LZW coding runs in host C++ (csrc/gif_host.cpp, built with g++ at
  first use into build/kernels/ and loaded through ctypes); a failed
  build raises.
- Palette: a frame with at most 256 distinct colours gets exactly those
  colours, so it decodes to its own pixels. A frame with more gets 256
  colours from a median cut of its own colours (weighted by pixel count;
  each box split at the weighted median of its widest channel; a box's
  colour is its weighted mean), and each pixel the nearest of them. PIL
  quantizes with its own median cut, so those frames do not decode to
  PIL's pixels; tests/test_torch_render.py states the error.
"""
from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np

MAX_COLORS = 256


@functools.cache
def _lib():
    from ..utils.cuda_build import load_host_library

    lib = load_host_library("gif_host")
    lib.vt_gif_lzw.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_int64)]
    lib.vt_gif_lzw.restype = ctypes.c_int
    return lib


def lzw_image_data(indices: np.ndarray, min_code_size: int) -> bytes:
    """Palette indices (any shape, uint8) -> the GIF image data: the
    minimum code size byte, the LZW sub-blocks and their terminator."""
    idx = np.ascontiguousarray(indices, np.uint8).reshape(-1)
    cap = 2 * idx.size + 1024          # 12-bit codes and block lengths
    out = np.empty(cap, np.uint8)
    size = ctypes.c_int64()
    rc = _lib().vt_gif_lzw(idx.ctypes.data, idx.size, min_code_size,
                           out.ctypes.data, cap, ctypes.byref(size))
    if rc != 0:
        raise ValueError(f"GIF LZW coding failed (code {rc})")
    return out[:size.value].tobytes()


def _median_cut(colors: np.ndarray, counts: np.ndarray,
                n: int = MAX_COLORS) -> np.ndarray:
    """(K, 3) distinct colours with pixel counts -> (<= n, 3) uint8
    palette."""
    def span(box):
        return np.ptp(colors[box], 0) if len(box) > 1 else np.zeros(3)

    boxes = [np.arange(len(colors))]
    spans = [span(boxes[0])]
    while len(boxes) < n:
        k = int(np.argmax([s.max() for s in spans]))
        if spans[k].max() <= 0:
            break
        box, ch = boxes.pop(k), int(np.argmax(spans.pop(k)))
        order = box[np.argsort(colors[box, ch], kind="stable")]
        cum = np.cumsum(counts[order])
        cut = int(np.searchsorted(cum, cum[-1] / 2.0, side="right"))
        cut = min(max(cut, 1), len(order) - 1)
        for half in (order[:cut], order[cut:]):
            boxes.append(half)
            spans.append(span(half))
    pal = [np.average(colors[b], axis=0, weights=counts[b]) for b in boxes]
    return np.clip(np.rint(pal), 0, 255).astype(np.uint8)


def quantize(frame: np.ndarray):
    """(H, W, 3) uint8 -> (indices (H, W) uint8, palette (P, 3) uint8),
    exact when the frame has at most 256 colours."""
    flat = frame.reshape(-1, 3).astype(np.int64)
    packed = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
    uniq, inverse, counts = np.unique(packed, return_inverse=True,
                                      return_counts=True)
    colors = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], -1)
    if len(uniq) <= MAX_COLORS:
        return (inverse.reshape(frame.shape[:2]).astype(np.uint8),
                colors.astype(np.uint8))
    from scipy.spatial import cKDTree

    palette = _median_cut(colors.astype(np.float64), counts)
    _, nearest = cKDTree(palette.astype(np.float64)).query(colors)
    return (nearest[inverse].reshape(frame.shape[:2]).astype(np.uint8),
            palette)


def _frame_bytes(frame: np.ndarray, duration_ms: int) -> bytes:
    h, w = frame.shape[:2]
    idx, palette = quantize(frame)
    bits = max(1, int(np.ceil(np.log2(max(len(palette), 2)))))
    table = np.zeros((1 << bits, 3), np.uint8)
    table[:len(palette)] = palette
    delay = int(duration_ms / 10)
    # PIL writes the control block only for a non-zero delay
    control = (struct.pack("<BBBBHBB", 0x21, 0xF9, 4, 0, delay, 0, 0)
               if delay else b"")
    descriptor = struct.pack("<BHHHHB", 0x2C, 0, 0, w, h, 0x80 | (bits - 1))
    return (control + descriptor + table.tobytes()
            + lzw_image_data(idx, max(2, bits)))


def save_gif(frames, path: str, duration_ms: int, loop: int = 0) -> str:
    """(T, H, W, 3) uint8 frames -> an animated GIF at `path` that shows
    each frame for duration_ms and loops `loop` times (0: forever)."""
    frames = [np.ascontiguousarray(f, np.uint8) for f in frames]
    if not frames or any(f.ndim != 3 or f.shape[2] != 3
                         or f.shape != frames[0].shape for f in frames):
        raise ValueError("save_gif takes a non-empty sequence of (H, W, 3) "
                         "uint8 frames of one size")
    kept, durations = [], []
    for f in frames:
        if kept and np.array_equal(f, kept[-1]):
            durations[-1] += duration_ms
        else:
            kept.append(f)
            durations.append(duration_ms)
    h, w = frames[0].shape[:2]
    parts = [b"GIF89a", struct.pack("<HHBBB", w, h, 0, 0, 0),
             b"\x21\xFF\x0BNETSCAPE2.0" + struct.pack("<BBHB", 3, 1, loop, 0)]
    parts += [_frame_bytes(f, d) for f, d in zip(kept, durations)]
    parts.append(b"\x3B")
    with open(path, "wb") as fh:
        fh.write(b"".join(parts))
    return path
