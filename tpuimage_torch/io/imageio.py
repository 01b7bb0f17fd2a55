"""Host-side image I/O and stage-dump helpers (counterpart of
``tpuimage.io.imageio``).

In-memory images are RGB uint8 (H, W, 3) and gray (H, W) numpy arrays.
Files go through PIL where it imports, so they are byte-equal to
tpuimage's. Without PIL a ``.png`` goes through the port's own codec, ``io/png.py``: read as PIL's
``convert("RGB")`` reads it (gray repeated into the three channels, alpha
dropped), written lossless at the zlib level PIL would use. Any other
extension then raises ImportError naming PIL. Also carries the save-size
presets of the reference's ``_compress_and_save``.
"""
from __future__ import annotations

import os
import tempfile
from typing import Dict, Tuple

import numpy as np
import torch

from tpuimage_torch.io import png

COMPRESSION_PRESETS: Dict[str, dict] = {
    "FAST": {"jpg_quality": 95, "png_compression": 1, "optimize": False},
    "BALANCED": {"jpg_quality": 90, "png_compression": 6, "optimize": True},
    "HIGH": {"jpg_quality": 85, "png_compression": 9, "optimize": True},
    "MAXIMUM": {"jpg_quality": 82, "png_compression": 9, "optimize": True},
}


def ensure_dir(path: str) -> None:
    if path:
        os.makedirs(path, exist_ok=True)


def _pil_image():
    """PIL's ``Image`` module, or None where PIL is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _png_only(path, what: str) -> None:
    if os.path.splitext(path)[1].lower() != ".png":
        raise ImportError(f"{what} {path} needs PIL (Pillow), which is not installed; "
                          f"without it only PNG files are read and written")


def _png_level(compression: str | None) -> int:
    """The zlib level PIL's PNG encoder takes: 9 with ``optimize``, else the
    preset's ``png_compression``; 6 (zlib's default) without a preset."""
    if compression is None:
        return 6
    p = COMPRESSION_PRESETS[compression]
    return 9 if p["optimize"] else p["png_compression"]


def load_image_rgb(path) -> np.ndarray:
    """Load as RGB uint8 (H, W, 3). Raises FileNotFoundError for a missing
    file."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"Cannot load image: {path}")
    Image = _pil_image()
    if Image is not None:
        with Image.open(path) as im:
            return np.array(im.convert("RGB"), dtype=np.uint8)
    _png_only(path, "reading")
    a = png.read_png(path)
    if a.ndim == 3 and a.shape[2] >= 3:
        return np.ascontiguousarray(a[..., :3])
    gray = a if a.ndim == 2 else a[..., 0]
    return np.repeat(gray[..., None], 3, axis=-1)


def load_image_gray(path) -> np.ndarray:
    """Load as gray uint8 (H, W) through the port's exact RGB -> gray op
    (cv2.IMREAD_GRAYSCALE's equivalent), on the host."""
    from tpuimage_torch.ops.color import rgb_to_gray
    return rgb_to_gray(torch.from_numpy(load_image_rgb(path))).numpy()


def _host(img) -> np.ndarray:
    return img.cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)


def save_image(path, img, compression: str | None = None) -> None:
    """Save an RGB or gray uint8 array (or tensor, from any device).
    ``compression`` names a preset of COMPRESSION_PRESETS."""
    ensure_dir(os.path.dirname(path))
    Image = _pil_image()
    if Image is None:
        _png_only(path, "writing")
        png.write_png(path, _host(img), _png_level(compression))
        return
    im = Image.fromarray(_host(img))
    ext = os.path.splitext(path)[1].lower()
    if compression is not None:
        p = COMPRESSION_PRESETS[compression]
        if ext in (".jpg", ".jpeg"):
            im.save(path, "JPEG", quality=p["jpg_quality"], optimize=p["optimize"],
                    progressive=True)
            return
        if ext == ".png":
            im.save(path, "PNG", compress_level=p["png_compression"], optimize=p["optimize"])
            return
    im.save(path)


def compress_and_save(img, path, preset: str = "BALANCED") -> Tuple[float, float]:
    """Save ``img`` at ``path`` with a preset; returns (the size in MB of an
    uncompressed save, the size in MB of the saved file)."""
    arr = _host(img)
    ext = os.path.splitext(path)[1].lower()
    Image = _pil_image()
    if Image is None:
        _png_only(path, "writing")
    with tempfile.NamedTemporaryFile(suffix=ext or ".png", delete=False) as tmp:
        temp_path = tmp.name
    try:
        if Image is None:
            png.write_png(temp_path, arr, 0)
        elif ext in (".jpg", ".jpeg"):
            Image.fromarray(arr).save(temp_path, "JPEG", quality=100)
        else:
            Image.fromarray(arr).save(temp_path, "PNG", compress_level=0)
        original = os.path.getsize(temp_path) / (1024 * 1024)
        save_image(path, arr, compression=preset)
        compressed = os.path.getsize(path) / (1024 * 1024)
        return original, compressed
    finally:
        if os.path.exists(temp_path):
            os.remove(temp_path)


def resize_long_side_np(img: np.ndarray, scale_long: int) -> np.ndarray:
    """Host resize keeping the aspect, long side -> scale_long (INTER_AREA),
    through the port's device op on the CPU."""
    from tpuimage_torch.ops.geometry import resize_long_side
    return resize_long_side(torch.from_numpy(np.ascontiguousarray(img)), scale_long).numpy()
