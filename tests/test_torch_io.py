"""tpuimage_torch's file I/O: the PNG codec (``io/png.py``), the image
I/O without PIL (``io/imageio.py``) and the review artifacts
(``io/report.py``) against PIL and tpuimage, on the CPU.

All comparisons are exact:
- ``read_png`` on PIL's own files (gray, RGB, RGBA, gray+alpha; zlib
  levels 0, 6 and 9 with ``optimize``; 61x97, 2x3 and 1x1) gives PIL's
  pixels, through the host library and through the Python fallback;
  so too on files whose rows cycle through all five filters;
- PIL reads ``write_png``'s files back equal;
- palette, 16-bit and interlaced files and a bad CRC raise ValueError;
- without PIL, ``load_image_rgb`` equals PIL's ``convert("RGB")``,
  ``save_image`` writes the preset's zlib level, other formats raise
  ImportError naming PIL;
- ``compare_composite`` byte-equal to tpuimage's, the two report PNGs
  pixel-equal to tpuimage's on the same arrays.
"""
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from tpuimage.io import report as jreport

from tpuimage_torch import native, synth
from tpuimage_torch.io import imageio, png, report

torch.set_num_threads(1)

MODES = {"L": lambda a: a[..., 0], "RGB": lambda a: a,
         "RGBA": lambda a: np.dstack([a, a[..., 1]]),
         "LA": lambda a: np.dstack([a[..., 0], a[..., 2]])}


def _scene(h, w):
    return synth.landscape_scene(7, h, w) if min(h, w) >= 8 else \
        np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _filter_types(path) -> set:
    """The row filters a PNG file uses."""
    data = open(path, "rb").read()
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        elif kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, c = hdr[0], hdr[1], {0: 1, 4: 2, 2: 3, 6: 4}[hdr[3]]
    raw = zlib.decompress(idat)
    return {raw[r * (w * c + 1)] for r in range(h)}


@pytest.fixture(params=["native", "python"])
def unfilter(request, monkeypatch):
    """The Average and Paeth rows through the host library, or through the
    Python loop (the host library made unavailable)."""
    if request.param == "native":
        assert native.load_native() is not None
    else:
        monkeypatch.setattr(native, "load_native", lambda: None)
    return request.param


@pytest.mark.parametrize("shape", [(61, 97), (2, 3), (1, 1)])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_read_png_equals_pil(tmp_path, unfilter, shape, mode):
    arr = np.ascontiguousarray(MODES[mode](_scene(*shape)))
    seen = set()
    for level in (0, 6, 9):
        path = tmp_path / f"{level}.png"
        Image.fromarray(arr, mode).save(path, compress_level=level, optimize=True)
        got = png.read_png(path)
        np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
        np.testing.assert_array_equal(got, arr)
        seen |= _filter_types(path)
    if shape == (61, 97):
        assert seen >= {1, 2, 4}                       # PIL's adaptive filters


def _filtered_png(arr: np.ndarray, kinds) -> bytes:
    """A PNG whose row r is filtered with kinds[r % len(kinds)], by the
    specification's formulas written out per byte."""
    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else arr.shape[2]
    rows = arr.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    for r in range(h):
        kind = kinds[r % len(kinds)]
        out.append(kind)
        for i in range(w * c):
            a = rows[r, i - c] if i >= c else 0
            b = rows[r - 1, i] if r else 0
            cc = rows[r - 1, i - c] if r and i >= c else 0
            p = a + b - cc
            paeth = a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(p - cc) else \
                (b if abs(p - b) <= abs(p - cc) else cc)
            pred = (0, a, b, (a + b) // 2, paeth)[kind]
            out.append((rows[r, i] - pred) % 256)
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(k, body):
        return struct.pack(">I", len(body)) + k + body + struct.pack(">I", zlib.crc32(k + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_read_png_every_filter(tmp_path, unfilter, mode):
    arr = np.ascontiguousarray(MODES[mode](_scene(23, 17)))
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(arr, (3, 4, 0, 1, 2, 4, 3)))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)   # the file is sound
    np.testing.assert_array_equal(png.read_png(path), arr)


@pytest.mark.parametrize("shape", [(61, 97), (1, 1)])
@pytest.mark.parametrize("gray", [False, True])
@pytest.mark.parametrize("smooth", [False, True])
def test_write_png_read_by_pil(tmp_path, shape, gray, smooth):
    arr = _scene(*shape) if smooth else \
        np.random.default_rng(3).integers(0, 256, shape + (3,), dtype=np.uint8)
    if gray:
        arr = np.ascontiguousarray(arr[..., 1])
    for level in (0, 6, 9):
        path = tmp_path / f"{level}.png"
        png.write_png(path, arr, level)
        with Image.open(path) as im:
            assert im.mode == ("L" if gray else "RGB")
            np.testing.assert_array_equal(np.asarray(im), arr)
        np.testing.assert_array_equal(png.read_png(path), arr)
        kinds = _filter_types(path)     # one filter for the whole image
        assert len(kinds) == 1 and (kinds == {2} or not smooth or shape[0] == 1)


def test_write_png_rejects_other_images(tmp_path):
    with pytest.raises(TypeError):
        png.write_png(tmp_path / "a.png", np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        png.write_png(tmp_path / "a.png", np.zeros((4, 4, 4), np.uint8))


def _with_header_byte(path, offset: int, value: int) -> None:
    """Set one IHDR byte and recompute its CRC."""
    data = bytearray(path.read_bytes())
    data[16 + offset] = value
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    path.write_bytes(bytes(data))


def test_read_png_refuses(tmp_path):
    rgb = _scene(20, 30)
    p = tmp_path / "p.png"
    Image.fromarray(rgb).convert("P").save(p)
    with pytest.raises(ValueError, match="palette.*PIL"):
        png.read_png(p)
    p16 = tmp_path / "i16.png"
    Image.fromarray(rgb[..., 0].astype(np.uint16) * 257).save(p16)
    assert Image.open(p16).mode.startswith("I")
    with pytest.raises(ValueError, match="16-bit.*PIL"):
        png.read_png(p16)
    il = tmp_path / "il.png"
    png.write_png(il, rgb)
    _with_header_byte(il, 12, 1)                        # the interlace method
    with pytest.raises(ValueError, match="interlaced.*PIL"):
        png.read_png(il)
    bad = tmp_path / "bad.png"
    png.write_png(bad, rgb)
    data = bytearray(bad.read_bytes())
    data[45] ^= 0x40                                    # a byte of the IDAT data
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(bad)
    jpg = tmp_path / "a.png"
    Image.fromarray(rgb).save(jpg, "JPEG")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(jpg)


def test_imageio_without_pil(tmp_path, monkeypatch):
    rgb = _scene(31, 45)
    want = {}
    for mode, make in MODES.items():
        path = tmp_path / f"{mode}.png"
        Image.fromarray(np.ascontiguousarray(make(rgb)), mode).save(path)
        want[mode] = imageio.load_image_rgb(path)          # through PIL
    np.testing.assert_array_equal(want["RGB"], rgb)
    jpg = tmp_path / "x.jpg"
    Image.fromarray(rgb).save(jpg)
    monkeypatch.setitem(sys.modules, "PIL", None)      # PIL's import fails from here
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError):
        from PIL import Image as _  # noqa: F401
    for mode in MODES:
        np.testing.assert_array_equal(imageio.load_image_rgb(tmp_path / f"{mode}.png"),
                                      want[mode], err_msg=mode)
    with pytest.raises(ImportError, match="PIL"):
        imageio.load_image_rgb(jpg)
    with pytest.raises(FileNotFoundError):
        imageio.load_image_rgb(tmp_path / "missing.png")
    for preset, level in ((None, 6), ("FAST", 1), ("BALANCED", 9)):
        out = tmp_path / "out" / f"{preset}.png"
        imageio.save_image(out, torch.from_numpy(rgb), compression=preset)
        png.write_png(tmp_path / "same.png", rgb, level)
        assert out.read_bytes() == (tmp_path / "same.png").read_bytes()
    with pytest.raises(ImportError, match="PIL"):
        imageio.save_image(tmp_path / "x.jpg", rgb)
    orig_mb, comp_mb = imageio.compress_and_save(rgb, tmp_path / "c.png", "HIGH")
    assert comp_mb < orig_mb
    np.testing.assert_array_equal(png.read_png(tmp_path / "c.png"), rgb)
    with pytest.raises(ImportError, match="PIL"):
        imageio.compress_and_save(rgb, tmp_path / "c.jpg")


def test_compare_composite_equals_tpuimage(tmp_path):
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (60, 40, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (80, 50), dtype=np.uint8)
    ours = report.compare_composite(a, b, labels=("in", "out"))
    ref = jreport.compare_composite(a, b, labels=("in", "out"))
    assert ours.dtype == ref.dtype and ours.tobytes() == ref.tobytes()
    report.write_compare(str(tmp_path / "o.png"), a, b)
    jreport.write_compare(str(tmp_path / "r.png"), a, b)
    assert (tmp_path / "o.png").read_bytes() == (tmp_path / "r.png").read_bytes()


def _pixels(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def test_reports_equal_tpuimage(tmp_path):
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (36, 48, 3), dtype=np.uint8) for _ in range(4)]
    args = ("scene.png", *imgs, 27.5, 0.81, 24.25, 0.72)
    report.landscape_report(str(tmp_path / "o.png"), *args)
    jreport.landscape_report(str(tmp_path / "r.png"), *args)
    np.testing.assert_array_equal(_pixels(tmp_path / "o.png"), _pixels(tmp_path / "r.png"))
    for compare_to in (None, imgs[1]):
        report.night_panel(str(tmp_path / "no.png"), imgs[0], "enhanced", compare_to)
        jreport.night_panel(str(tmp_path / "nr.png"), imgs[0], "enhanced", compare_to)
        np.testing.assert_array_equal(_pixels(tmp_path / "no.png"), _pixels(tmp_path / "nr.png"))
