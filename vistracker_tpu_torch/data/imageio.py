"""Image files without PIL: PNG and baseline JPEG, read and written.

The port's counterpart of the few PIL calls the JAX package makes
(`Image.open(p).convert("L" | "RGB")`, `Image.fromarray(a).save(p)`), for
machines that have no PIL.

- PNG in Python with zlib and numpy. The decoder reads 8-bit grey,
  grey+alpha, RGB, RGBA and palette images with all five row filters;
  16-bit, 1/2/4-bit and interlaced files are refused by name. The
  encoder writes 8-bit L and RGB files (the "Up" filter on every row).
- Baseline JPEG in host C++ (csrc/jpeg_host.cpp, built with g++ at first
  use into build/kernels/ and loaded through ctypes). It runs libjpeg's
  arithmetic as libjpeg-turbo runs it by default, so it decodes the pixels
  PIL decodes and its default encode writes the bytes PIL's default
  `save(..., "JPEG")` writes (quality 75, 4:2:0).

`read_l` and `read_rgb` convert as PIL's `.convert("L")` and
`.convert("RGB")` do: L from RGB is PIL's integer ITU-R 601 luma,
(19595 R + 38470 G + 7471 B + 0x8000) >> 16; alpha is dropped; palette
entries are looked up.
"""
from __future__ import annotations

import ctypes
import functools
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_QUALITY = 75  # PIL's (and libjpeg's) default
_COLOR_TYPES = {0: ("L", 1), 2: ("RGB", 3), 3: ("P", 1), 4: ("LA", 2),
                6: ("RGBA", 4)}


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _unfilter(raw: bytes, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters: (height, row_bytes) uint8."""
    stride = row_bytes + 1
    if len(raw) < height * stride:
        raise ValueError("truncated PNG image data")
    rows = np.frombuffer(raw, np.uint8, height * stride).reshape(height, stride)
    kinds, data = rows[:, 0], rows[:, 1:]
    out = np.zeros((height, row_bytes), np.uint8)
    prior = np.zeros(row_bytes, np.uint8)
    for y in range(height):
        f, line = int(kinds[y]), data[y]
        if f == 0:
            cur = line.copy()
        elif f == 1:    # Sub: a running sum per byte lane, mod 256
            cur = _lane_cumsum(line, bpp)
        elif f == 2:    # Up
            cur = line + prior
        elif f in (3, 4):
            cur = _sequential(f, line, prior, bpp)
        else:
            raise ValueError(f"corrupt PNG: unknown row filter {f}")
        out[y] = cur
        prior = cur
    return out


def _lane_cumsum(line: np.ndarray, bpp: int) -> np.ndarray:
    n = len(line)
    pad = (-n) % bpp
    lanes = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
    return np.cumsum(lanes, 0, dtype=np.uint8).reshape(-1)[:n]


def _sequential(f: int, line: np.ndarray, prior: np.ndarray,
                bpp: int) -> np.ndarray:
    """Average (3) and Paeth (4): each byte depends on the byte bpp before
    it, so they run byte by byte."""
    cur = bytearray(line.tobytes())
    up = prior.tobytes()
    for x in range(len(cur)):
        a = cur[x - bpp] if x >= bpp else 0
        b = up[x]
        if f == 3:
            cur[x] = (cur[x] + ((a + b) >> 1)) & 0xFF
            continue
        c = up[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[x] = (cur[x] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def decode_png(data: bytes):
    """PNG bytes -> (array, mode, palette). array is (H, W) for L and P,
    (H, W, C) otherwise; palette is (N, 3) uint8 for P, else None."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, idat, hdr, palette = 8, [], None, None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("corrupt PNG: no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = hdr
    if ctype not in _COLOR_TYPES:
        raise ValueError(f"corrupt PNG: colour type {ctype}")
    mode, channels = _COLOR_TYPES[ctype]
    if depth != 8:
        raise ValueError(f"{depth}-bit PNG is not supported (8-bit only)")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not supported")
    if mode == "P" and palette is None:
        raise ValueError("corrupt PNG: palette image without PLTE")
    rows = _unfilter(zlib.decompress(b"".join(idat)), height,
                     width * channels, channels)
    arr = rows.reshape(height, width, channels)
    return (arr[..., 0] if channels == 1 else arr), mode, palette


def encode_png(arr: np.ndarray) -> bytes:
    """(H, W) uint8 (L) or (H, W, 3) uint8 (RGB) -> PNG bytes."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8 or not (arr.ndim == 2 or (arr.ndim == 3
                                                        and arr.shape[2] == 3)):
        raise ValueError(f"PNG encode takes (H, W) or (H, W, 3) uint8, got "
                         f"{arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1)
    up = rows.copy()
    up[1:] -= rows[:-1]          # the Up filter, mod 256
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], 1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ctype = 0 if arr.ndim == 2 else 2
    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# JPEG (host C++)
# ---------------------------------------------------------------------------

@functools.cache
def _jpeg_lib():
    from ..utils.cuda_build import load_host_library

    lib = load_host_library("jpeg_host")
    i, p, sz, cp = ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p
    lib.vt_jpeg_info.argtypes = [p, sz, ctypes.POINTER(i), ctypes.POINTER(i),
                                 ctypes.POINTER(i), cp, i]
    lib.vt_jpeg_decode.argtypes = [p, sz, p, cp, i]
    lib.vt_jpeg_encode.argtypes = [p, i, i, i, i, ctypes.POINTER(p),
                                   ctypes.POINTER(sz), cp, i]
    lib.vt_jpeg_free.argtypes = [p]
    for f in (lib.vt_jpeg_info, lib.vt_jpeg_decode, lib.vt_jpeg_encode):
        f.restype = i
    lib.vt_jpeg_free.restype = None
    return lib


def _check(rc: int, err) -> None:
    if rc != 0:
        raise ValueError(err.value.decode(errors="replace"))


def decode_jpeg(data: bytes) -> np.ndarray:
    """Baseline JPEG bytes -> (H, W) uint8 (one component) or (H, W, 3)
    uint8 RGB, as libjpeg decodes them by default."""
    lib, err = _jpeg_lib(), ctypes.create_string_buffer(256)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(lib.vt_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                            ctypes.byref(c), err, 256), err)
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, 3)
    out = np.empty(shape, np.uint8)
    _check(lib.vt_jpeg_decode(data, len(data), out.ctypes.data, err, 256), err)
    return out


def encode_jpeg(arr: np.ndarray) -> bytes:
    """(H, W) uint8 (L) or (H, W, 3) uint8 (RGB, written YCbCr 4:2:0) ->
    baseline JPEG bytes with PIL's default settings (quality 75)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8 or not (arr.ndim == 2 or (arr.ndim == 3
                                                        and arr.shape[2] == 3)):
        raise ValueError(f"JPEG encode takes (H, W) or (H, W, 3) uint8, got "
                         f"{arr.dtype} {arr.shape}")
    lib, err = _jpeg_lib(), ctypes.create_string_buffer(256)
    ptr, size = ctypes.c_void_p(), ctypes.c_size_t()
    comps = 1 if arr.ndim == 2 else 3
    _check(lib.vt_jpeg_encode(arr.ctypes.data, arr.shape[1], arr.shape[0],
                              comps, JPEG_QUALITY, ctypes.byref(ptr),
                              ctypes.byref(size), err, 256), err)
    try:
        return ctypes.string_at(ptr.value, size.value)
    finally:
        lib.vt_jpeg_free(ptr)


# ---------------------------------------------------------------------------
# files and PIL's conversions
# ---------------------------------------------------------------------------

def _luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's RGB -> L: (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    r, g, b = (rgb[..., k].astype(np.uint32) for k in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def read_image(path: str):
    """A PNG or JPEG file (told apart by its first bytes) -> (array, mode,
    palette), mode one of L, LA, RGB, RGBA, P."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data)
    if data[:2] == b"\xff\xd8":
        arr = decode_jpeg(data)
        return arr, ("L" if arr.ndim == 2 else "RGB"), None
    raise ValueError(f"{path}: neither PNG nor JPEG")


def _to_rgb(arr, mode, palette) -> np.ndarray:
    if mode == "P":
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(palette)] = palette
        return pal[arr]
    if mode in ("L", "LA"):
        grey = arr if mode == "L" else arr[..., 0]
        return np.repeat(grey[..., None], 3, -1)
    return np.ascontiguousarray(arr[..., :3])


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8, as PIL's Image.open(path).convert("RGB")."""
    return _to_rgb(*read_image(path))


def read_l(path: str) -> np.ndarray:
    """(H, W) uint8, as PIL's Image.open(path).convert("L")."""
    arr, mode, palette = read_image(path)
    if mode == "L":
        return arr
    if mode == "LA":
        return np.ascontiguousarray(arr[..., 0])
    return _luma(_to_rgb(arr, mode, palette))

