"""The port's Haar cascade detector (``tpuimage_torch.detect.haar``)
against tpuimage's (``tpuimage.detect.haar``): the same boxes exactly,
empty results included, from both evaluators (the C++ one built into the
port's host library and the numpy one), on the committed photo
outputs/scan_02_quad.png, synthetic portraits and a blank image.
"""
import os

import numpy as np
import pytest
import torch

from tpuimage.detect import haar as jhaar

from tpuimage_torch import synth
from tpuimage_torch.detect import haar
from tpuimage_torch.io import imageio as tio
from tpuimage_torch.native import load_native
from tpuimage_torch.ops import color

OUTPUTS = os.path.join(os.path.dirname(__file__), os.pardir, "outputs")
EYE = "haarcascade_eye.xml"


def _gray(rgb):
    return color.rgb_to_gray(torch.from_numpy(np.ascontiguousarray(rgb))).numpy()


def _images():
    scan = _gray(tio.load_image_rgb(os.path.join(OUTPUTS, "scan_02_quad.png")))
    return {"scan_crop": np.ascontiguousarray(scan[:240, :320]),
            "portrait": _gray(synth.portrait(3, 400, 300)[0]),
            "portrait_impulse": _gray(synth.portrait(6, 360, 240, noise="impulse")[0]),
            "blank10x10": np.zeros((10, 10), np.uint8)}


IMAGES = _images()


@pytest.mark.parametrize("impl", ["native", "numpy"])
@pytest.mark.parametrize("min_neighbors,min_size", [(0, (0, 0)), (1, (0, 0)), (5, (30, 30))])
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_detect_multi_scale_matches_tpuimage(name, min_neighbors, min_size, impl):
    gray = IMAGES[name]
    ours = haar.detect_multi_scale_batch([gray], EYE, 1.1, min_neighbors, min_size, impl=impl)[0]
    ref = jhaar.detect_multi_scale_batch([gray], EYE, 1.1, min_neighbors, min_size,
                                         impl=impl)[0]
    assert ours == ref
    assert ours == haar.detect_multi_scale(gray, EYE, 1.1, min_neighbors, min_size)


def test_some_results_are_not_empty():
    """The cases above include boxes: with min_neighbors 0 on the scan crop
    and with 1 on the portrait (so equality is not only of empty lists)."""
    assert len(haar.detect_multi_scale(IMAGES["scan_crop"], EYE, 1.1, 0)) >= 2
    assert len(haar.detect_multi_scale(IMAGES["portrait"], EYE, 1.1, 1)) >= 1
    assert haar.detect_multi_scale(IMAGES["blank10x10"], EYE, 1.1, 0) == []


def test_native_equals_numpy_on_a_batch():
    grays = [IMAGES["scan_crop"], IMAGES["portrait"], IMAGES["portrait_impulse"]]
    native = haar.detect_multi_scale_batch(grays, EYE, 1.1, 0, impl="native")
    assert native == haar.detect_multi_scale_batch(grays, EYE, 1.1, 0, impl="numpy")
    assert native == [haar.detect_multi_scale(g, EYE, 1.1, 0) for g in grays]
    with pytest.raises(ValueError, match="impl"):
        haar.detect_multi_scale_batch(grays, EYE, impl="cuda")


def test_detect_eyes_finds_both_eyes_of_a_full_size_portrait():
    """detect_eyes (scale 1.1, 5 neighbours, 30x30) on a 1280x853 synthetic
    portrait: the two eyes, as tpuimage finds them, each box over its eye."""
    img, boxes = synth.portrait(3)
    gray = _gray(img)
    ours = haar.detect_eyes(gray)
    assert ours == jhaar.detect_eyes(gray) and len(ours) == 2
    assert haar.detect_eyes_batch([gray, gray[:, ::-1].copy()])[0] == ours
    for (x, y, w, h), (bx, by, bw, bh) in zip(sorted(ours), boxes):
        assert x <= bx + bw // 2 <= x + w and y <= by + bh // 2 <= y + h


def test_host_library_holds_both_sources():
    lib = load_native()
    assert lib is not None and hasattr(lib, "tpuimage_haar_level")
    assert hasattr(lib, "tpuimage_trace_contours")


def test_cascade_search_order():
    """The system's cascade directory first, then the package's data/,
    which carries haarcascade_eye.xml unchanged (the Intel licence kept)."""
    data = os.path.join(os.path.dirname(haar.__file__), "data", EYE)
    assert haar._CASCADE_SEARCH_PATHS[0] == "/usr/share/opencv4/haarcascades"
    assert os.path.getsize(data) == 341406
    with open(data, encoding="utf-8") as f:
        assert "Intel License Agreement" in f.read(4000)
    casc = haar.HaarCascade(data)
    ref = jhaar.load_cascade(EYE)
    assert (casc.win_h, casc.win_w) == (ref.win_h, ref.win_w) == (20, 20)
    np.testing.assert_array_equal(casc.rects, ref.rects)
    np.testing.assert_array_equal(casc.leaves, ref.leaves)
    with pytest.raises(FileNotFoundError):
        haar.find_cascade("no_such_cascade.xml")
