"""PNG files in numpy and ``zlib``: the port's codec for machines without
PIL (the counterpart of the PNG half of ``tpuimage.io.imageio``, whose
backend is PIL).

``read_png`` takes 8-bit gray, gray+alpha, RGB and RGBA files that are
not interlaced, with every row filter of the PNG specification, and
checks each chunk's CRC. Palette, 16-bit and interlaced files raise
ValueError: PIL reads those. Rows filtered None, Sub or Up are undone in
numpy; Average and Paeth (PIL's encoder picks a filter per row) depend on
the byte just reconstructed to their left, so they go through the host
library's ``tpuimage_png_unfilter`` (``native/png.cpp``), or a Python
loop where it cannot be built.

``write_png`` writes gray or RGB with one filter for the whole image,
None or Up, whichever leaves the smaller sum of absolute signed bytes
(the specification's heuristic, taken per image), at a zlib level.
"""
from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel: gray, gray+alpha, RGB, RGBA
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}


def _chunks(data: bytes, path):
    """(type, body) of each chunk up to IEND, each CRC checked."""
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            break
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: bad CRC in the {kind.decode('latin-1')} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: truncated PNG file (no IEND chunk)")


def _unfilter_row_py(kind: int, line: bytes, prior: bytes, bpp: int) -> bytes:
    """One Average (3) or Paeth (4) row, byte by byte."""
    out = bytearray(line)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 255
    return bytes(out)


def _unfilter(kinds: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """Reconstruct (h, stride) filtered rows with their (h,) filter types."""
    h, stride = rows.shape
    out = np.empty_like(rows)
    if (kinds >= 3).any():
        from tpuimage_torch.native import load_native
        lib = load_native()
        if lib is not None:
            u8p = ctypes.POINTER(ctypes.c_uint8)
            kinds = np.ascontiguousarray(kinds)
            rows = np.ascontiguousarray(rows)
            lib.tpuimage_png_unfilter(kinds.ctypes.data_as(u8p), rows.ctypes.data_as(u8p),
                                      h, stride, bpp, out.ctypes.data_as(u8p))
            return out
    prior = np.zeros(stride, np.uint8)
    for r in range(h):
        kind, line = int(kinds[r]), rows[r]
        if kind == 0:
            out[r] = line
        elif kind == 1:
            out[r] = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            out[r] = line + prior
        else:
            out[r] = np.frombuffer(_unfilter_row_py(kind, line.tobytes(), prior.tobytes(), bpp),
                                   np.uint8)
        prior = out[r]
    return out


def read_png(path) -> np.ndarray:
    """The pixels of an 8-bit PNG file: uint8 (H, W) gray, or (H, W, C)
    with C = 2 (gray+alpha), 3 (RGB) or 4 (RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:len(_SIGNATURE)] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, method, filter_method, interlace = header
    if ctype == 3:
        raise ValueError(f"{path}: a palette PNG; reading it needs PIL")
    if depth != 8:
        raise ValueError(f"{path}: a {depth}-bit PNG; reading it needs PIL")
    if interlace:
        raise ValueError(f"{path}: an interlaced PNG; reading it needs PIL")
    if ctype not in _CHANNELS or method or filter_method:
        raise ValueError(f"{path}: colour type {ctype}, compression {method}, filter "
                         f"method {filter_method}: not a PNG this reader takes")
    c = _CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (w * c + 1):
        raise ValueError(f"{path}: image data holds {len(raw)} bytes, {h * (w * c + 1)} needed")
    rows = np.frombuffer(raw, np.uint8, count=h * (w * c + 1)).reshape(h, w * c + 1)
    kinds = rows[:, 0]
    if (kinds > 4).any():
        raise ValueError(f"{path}: unknown row filter {int(kinds.max())}")
    img = _unfilter(kinds, rows[:, 1:], c)
    return img.reshape((h, w) if c == 1 else (h, w, c))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _cost(rows: np.ndarray) -> int:
    return int(np.abs(rows.view(np.int8).astype(np.int16)).sum(dtype=np.int64))


def write_png(path, img, level: int = 6) -> None:
    """Write a uint8 (H, W) gray or (H, W, 3) RGB array as a PNG file,
    deflated at zlib ``level`` (0-9)."""
    a = np.ascontiguousarray(img)
    if a.dtype != np.uint8:
        raise TypeError(f"write_png: expected uint8, got {a.dtype}")
    if a.ndim == 2:
        ctype, c = 0, 1
    elif a.ndim == 3 and a.shape[2] == 3:
        ctype, c = 2, 3
    else:
        raise ValueError(f"write_png: a gray (H, W) or RGB (H, W, 3) image, not {a.shape}")
    h, w = a.shape[:2]
    rows = a.reshape(h, w * c)
    up = rows.copy()
    up[1:] -= rows[:-1]                      # uint8: the filter's mod-256 difference
    kind, body = (2, up) if _cost(up) < _cost(rows) else (0, rows)
    filtered = np.empty((h, w * c + 1), np.uint8)
    filtered[:, 0] = kind
    filtered[:, 1:] = body
    data = (_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), level))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
