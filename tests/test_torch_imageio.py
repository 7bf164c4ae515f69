"""The port's PIL-free image I/O (vistracker_tpu_torch/data/imageio.py and
csrc/jpeg_host.cpp) against PIL on this image: JPEG decode bit-equal to
PIL's, the default JPEG encode byte-equal to PIL's default save, PNG
decode bit-equal, PNG encode read back by PIL, refused formats named, and
the uint8 resizes the fixture uses (data/images.py) bit-equal to PIL's
resize."""
import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from vistracker_tpu_torch.data import imageio as vio
from vistracker_tpu_torch.data.images import (resize_uint8_bilinear,
                                              resize_uint8_nearest)

# odd sizes that are not multiples of an MCU, plus tiny and one-pixel ones
SIZES = [(64, 80), (37, 53), (17, 9), (1, 1), (2, 3), (200, 301)]


def _image(kind, h, w, seed=0):
    rs = np.random.RandomState(seed)
    if kind == "noise":          # photo-like worst case for the coder
        return (rs.rand(h, w, 3) * 255).astype(np.uint8)
    if kind == "smooth":
        yy, xx = np.mgrid[:h, :w]
        return np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                         (xx + yy) % 256], -1).astype(np.uint8)
    # flat-shaded, like the fixture's frames: background, two flat regions
    img = np.full((h, w, 3), 46, np.uint8)
    img[h // 4:h // 2 + 1, w // 4:w // 2 + 1] = (140, 114, 102)
    img[h // 2:, w // 2:] = (60, 94, 128)
    return img


def _pil_jpeg(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["noise", "smooth", "flat"])
@pytest.mark.parametrize("opts", [
    {}, {"quality": 50}, {"quality": 95}, {"subsampling": 0},
    {"subsampling": 1}, {"subsampling": 2}, {"restart_marker_blocks": 3},
    {"restart_marker_rows": 1, "quality": 90, "subsampling": 0}],
    ids=["q75-420", "q50", "q95", "444", "422", "420", "restarts",
         "restart-rows-444"])
def test_jpeg_decode_bit_equal_to_pil(kind, opts):
    for h, w in SIZES:
        data = _pil_jpeg(_image(kind, h, w), **opts)
        ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(vio.decode_jpeg(data), ref,
                                      err_msg=f"{kind} {h}x{w} {opts}")


@pytest.mark.parametrize("opts", [{}, {"restart_marker_blocks": 2},
                                  {"quality": 95}])
def test_grey_jpeg_decode_bit_equal_to_pil(opts):
    """BEHAVE masks can be grey JPEGs: one component, read as L."""
    for h, w in SIZES:
        for kind in ("noise", "flat"):
            data = _pil_jpeg(_image(kind, h, w)[..., 0].copy(), **opts)
            ref = np.asarray(Image.open(io.BytesIO(data)))
            assert ref.ndim == 2
            np.testing.assert_array_equal(vio.decode_jpeg(data), ref)


@pytest.mark.parametrize("kind", ["noise", "smooth", "flat"])
def test_jpeg_encode_same_bytes_as_pil_default(kind):
    """PIL's default save: quality 75, 4:2:0, islow, standard Huffman
    tables, JFIF header. Byte for byte, RGB and L."""
    for h, w in SIZES + [(384, 512)]:
        img = _image(kind, h, w, seed=1)
        assert vio.encode_jpeg(img) == _pil_jpeg(img), (kind, h, w)
        grey = img[..., 1].copy()
        assert vio.encode_jpeg(grey) == _pil_jpeg(grey), (kind, h, w)


def _pil_png(img, **kw):
    buf = io.BytesIO()
    img.save(buf, "PNG", **kw)
    return buf.getvalue()


def _modes(a):
    """The 8-bit PNG variants PIL writes for one RGB array (a palette of
    16 colours or fewer would be written with fewer bits unless asked)."""
    return {
        "RGB": (Image.fromarray(a), {}), "L": (Image.fromarray(a[..., 0]), {}),
        "RGBA": (Image.fromarray(np.dstack([a, a[..., 1]]), "RGBA"), {}),
        "LA": (Image.fromarray(np.dstack([a[..., 0], a[..., 2]]), "LA"), {}),
        "P": (Image.fromarray(a).quantize(200), {"bits": 8}),
    }


@pytest.mark.parametrize("kind", ["noise", "smooth", "flat"])
def test_png_decode_bit_equal_to_pil(tmp_path, kind):
    """All five row filters occur (PIL picks one per row); read_l and
    read_rgb convert as PIL's .convert("L") / .convert("RGB")."""
    a = _image(kind, 61, 77)
    for name, (img, kw) in _modes(a).items():
        p = str(tmp_path / f"{name}.png")
        with open(p, "wb") as f:
            f.write(_pil_png(img, **kw))
        for mode, fn in (("L", vio.read_l), ("RGB", vio.read_rgb)):
            np.testing.assert_array_equal(
                fn(p), np.asarray(Image.open(p).convert(mode)),
                err_msg=f"{kind} {name} -> {mode}")


def test_png_filters_and_mask_decode(tmp_path):
    """A fixture-sized mask: PIL writes None, Sub, Up and Paeth rows."""
    m = np.zeros((1536, 2048), np.uint8)
    m[300:1200, 600:1300] = 255
    yy, xx = np.mgrid[:1536, :2048]
    m[((yy - 800) ** 2 + (xx - 1000) ** 2) < 300 ** 2] = 0
    data = _pil_png(Image.fromarray(m))
    arr, mode, _ = vio.decode_png(data)
    assert mode == "L"
    np.testing.assert_array_equal(arr, m)
    rgb = _image("noise", 40, 50)     # noise rows take the Average filter too
    arr, mode, _ = vio.decode_png(_pil_png(Image.fromarray(rgb)))
    np.testing.assert_array_equal(arr, rgb)


@pytest.mark.parametrize("shape", [(61, 77), (61, 77, 3), (1536, 2048)])
def test_png_encode_round_trips_through_pil(shape):
    a = (np.random.RandomState(2).rand(*shape) * 255).astype(np.uint8)
    if len(shape) == 2 and shape[0] > 100:
        a = (a > 200).astype(np.uint8) * 255
    back = np.asarray(Image.open(io.BytesIO(vio.encode_png(a))))
    np.testing.assert_array_equal(back, a)
    arr, _, _ = vio.decode_png(vio.encode_png(a))
    np.testing.assert_array_equal(arr, a)


def _patched_sof(data, byte_at, value):
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    out[i + byte_at] = value
    return bytes(out)


def _interlaced_png():
    raw = _pil_png(Image.fromarray(_image("flat", 8, 8)))
    ihdr = bytearray(raw[16:29])
    ihdr[-1] = 1                                      # Adam7
    chunk = (struct.pack(">I", 13) + b"IHDR" + bytes(ihdr)
             + struct.pack(">I", zlib.crc32(b"IHDR" + bytes(ihdr))))
    return raw[:8] + chunk + raw[33:]


def _rgb_coded(jpeg):
    """The same file with component ids 'R', 'G', 'B' and no JFIF header:
    libjpeg would take its samples as RGB, not YCbCr."""
    out = bytearray(jpeg)
    out[out.index(b"JFIF") - 4 + 1] = 0xE1           # APP0 -> APP1
    i = out.index(b"\xff\xc0")
    for k, cid in enumerate(b"RGB"):
        out[i + 10 + 3 * k] = cid
    j = out.index(b"\xff\xda")
    for k, cid in enumerate(b"RGB"):
        out[j + 5 + 2 * k] = cid
    return bytes(out)


def _refused():
    img = _image("noise", 24, 32)
    base = _pil_jpeg(img)
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
    cmyk = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray((np.arange(64, dtype=np.uint16) * 900).reshape(8, 8)
                    ).save(buf, "PNG")
    png16 = buf.getvalue()
    return {
        "progressive": (_pil_jpeg(img, progressive=True), "progressive"),
        "arithmetic": (_patched_sof(base, 1, 0xC9), "arithmetic"),
        "12-bit": (_patched_sof(base, 4, 12), "12-bit"),
        "cmyk": (cmyk, "CMYK"),
        "sof1": (_patched_sof(base, 1, 0xC1), "extended"),
        "rgb-coded": (_rgb_coded(base), "RGB-coded"),
        "png16": (png16, "16-bit"),
        "png1": (_pil_png(Image.fromarray(img[..., 0] > 128)), "1-bit"),
        "png4": (_pil_png(Image.fromarray(img).quantize(16)), "4-bit"),
        "interlaced": (_interlaced_png(), "interlaced"),
    }


@pytest.mark.parametrize("case", ["progressive", "arithmetic", "12-bit",
                                  "cmyk", "sof1", "rgb-coded", "png16",
                                  "png1", "png4", "interlaced"])
def test_refused_formats_raise_by_name(case):
    data, needle = _refused()[case]
    decode = vio.decode_png if data.startswith(vio.PNG_SIGNATURE) \
        else vio.decode_jpeg
    with pytest.raises(ValueError, match=needle):
        decode(data)


@pytest.mark.parametrize("sizes", [((384, 512), (1536, 2048)),
                                   ((7, 9), (20, 33)), ((30, 40), (12, 17)),
                                   ((5, 5), (5, 11)), ((1, 4), (3, 8))])
def test_uint8_resizes_bit_equal_to_pil(sizes):
    """PIL's BILINEAR on uint8 is two fixed-point passes (horizontal first,
    uint8 between them), not F.interpolate; NEAREST is an affine scan."""
    (h, w), (H, W) = sizes
    rs = np.random.RandomState(3)
    for a in ((rs.rand(h, w, 3) * 255).astype(np.uint8),
              (rs.rand(h, w) * 255).astype(np.uint8)):
        np.testing.assert_array_equal(
            resize_uint8_bilinear(a, (W, H)),
            np.asarray(Image.fromarray(a).resize((W, H), Image.BILINEAR)))
        np.testing.assert_array_equal(
            resize_uint8_nearest(a, (W, H)),
            np.asarray(Image.fromarray(a).resize((W, H), Image.NEAREST)))
