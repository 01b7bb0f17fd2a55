"""DocScanner's one-document path (process_document, preprocess), its I/O
helpers and the pipelined serving forms (scan_stream, pipeline_chunk,
fallback_common_shape) of tpuimage_torch, against tpuimage (JAX on the
CPU) on seeded synthetic photos of 480x360 at scale_long 400.

Tolerances: the bilateral preprocess within the float contract (max
|diff| <= 1 on < 0.5% of pixels); ``use_whole`` and the deskew angle
equal; quad corners within 0.5 px; the warped page within the float
bilinear contract; binary pages < 0.2% different (the bound tpuimage holds
its own warp forms to). The port's own forms (stream, chunks) equal
scan_batch exactly.
"""
import dataclasses
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpuimage.io import imageio as jio
from tpuimage.ops import draw as jdraw
from tpuimage.pipelines import docscan as jdoc

from tpuimage_torch import synth
from tpuimage_torch.io import imageio as tio
from tpuimage_torch.ops import draw as tdraw
from tpuimage_torch.pipelines import docscan as tdoc


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs (xdist runs several workers
    side by side); the count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = dataclasses.replace(tdoc.DocScanConfig(), scale_long=400)
JCFG = dataclasses.replace(jdoc.DocScanConfig(), scale_long=400)
GUI = dataclasses.replace(tdoc.GUI_DOCUMENT_CONFIG, scale_long=400)
JGUI = dataclasses.replace(jdoc.GUI_DOCUMENT_CONFIG, scale_long=400)


def _assert_float_contract(a, b):
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.005, (diff > 0).mean()


@pytest.fixture(scope="module")
def photos():
    """A document photo, one with tilted text and table rules, and one
    with no page, 480x360 (height x width)."""
    return [synth.document_photo(61, 480, 360),
            synth.document_photo(62, 480, 360, tilt_deg=4.0, rules=3),
            synth.document_photo(63, 480, 360, with_page=False)]


# ---------------------------------------------------------------------------
# preprocess and process_document
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gaussian_ksize", [0, 5])
def test_preprocess_within_contract(photos, gaussian_ksize):
    ours = tdoc.preprocess(photos[1], 9, 75.0, 75.0, gaussian_ksize, device="cpu")
    ref = jdoc.preprocess(jnp.asarray(photos[1]), 9, 75.0, 75.0, gaussian_ksize)
    assert ours.device.type == "cpu" and ours.shape == (480, 360)
    _assert_float_contract(ours.numpy(), np.asarray(ref))
    # a gray input is filtered as it is
    gray = np.asarray(photos[1][..., 0])
    np.testing.assert_array_equal(
        tdoc.preprocess(torch.from_numpy(gray.copy()), gaussian_ksize=gaussian_ksize).numpy(),
        tdoc.preprocess(gray, gaussian_ksize=gaussian_ksize, device="cpu").numpy())


@pytest.fixture(scope="module", params=[1, 2], ids=["page", "no_page"])
def documents(request, photos, tmp_path_factory):
    """process_document of one photo by both packages, each writing its
    stage files to a directory of its own."""
    photo = photos[request.param]
    ref_dir = tmp_path_factory.mktemp("tpuimage")
    our_dir = tmp_path_factory.mktemp("tpuimage_torch")
    ref = jdoc.process_document(photo, out_dir=str(ref_dir), config=JCFG)
    ours = tdoc.process_document(photo, out_dir=str(our_dir), config=CFG, device="cpu")
    return ref, ours, ref_dir, our_dir


def test_process_document_matches_tpuimage(documents):
    ref, ours, _, _ = documents
    assert ours["use_whole"] == ref["use_whole"]
    assert float(ours["stages"]["deskew_angle"]) == float(ref["stages"]["deskew_angle"])
    assert bool(ours["stages"]["deskew_overflow"]) == bool(ref["stages"]["deskew_overflow"])
    assert (ours["quad"] is None) == (ref["quad"] is None)
    if ours["quad"] is not None:
        np.testing.assert_allclose(ours["quad"], ref["quad"], atol=0.5, rtol=0)
    warped, ref_warped = ours["warped"].numpy(), np.asarray(ref["warped"])
    assert warped.shape == ref_warped.shape
    _assert_float_contract(warped, ref_warped)
    binary, ref_binary = ours["binary"].numpy(), np.asarray(ref["binary"])
    assert binary.shape == ref_binary.shape and binary.dtype == np.uint8
    assert (binary != ref_binary).mean() < 0.002


def test_process_document_writes_the_same_stage_files(documents):
    _, ours, ref_dir, our_dir = documents
    names = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(our_dir)) == names
    assert len(names) == 10 and "scan_01_pre.png" in names and "scan_08_clean.png" in names
    pre = tio.load_image_gray(os.path.join(our_dir, "scan_01_pre.png"))
    _assert_float_contract(pre, jio.load_image_gray(os.path.join(ref_dir, "scan_01_pre.png")))
    overlay = tio.load_image_rgb(os.path.join(our_dir, "scan_02_quad.png"))
    ref_overlay = jio.load_image_rgb(os.path.join(ref_dir, "scan_02_quad.png"))
    if ours["use_whole"]:       # the whole-frame outline: no quad to differ
        np.testing.assert_array_equal(overlay, ref_overlay)
    assert overlay.shape == ref_overlay.shape


def test_process_document_options(photos, tmp_path):
    """A path as input, no stage files without save_stages, OCR recorded
    as an error where pytesseract is missing, the disabled fallback and
    the unported space_mesh."""
    path = str(tmp_path / "in.png")
    tio.save_image(path, photos[2])
    out = tdoc.process_document(path, out_dir=str(tmp_path / "o"), config=CFG,
                                save_stages=False, do_ocr=True, device="cpu")
    assert not (tmp_path / "o").exists() or not os.listdir(tmp_path / "o")
    assert out["use_whole"] and ("ocr_text" in out or "ocr_error" in out)
    with pytest.raises(RuntimeError, match="fallback disabled"):
        tdoc.process_document(photos[2], out_dir=None, device="cpu",
                              config=dataclasses.replace(CFG, fallback_use_whole=False))
    with pytest.raises(NotImplementedError):
        tdoc.process_document(photos[0], out_dir=None, device="cpu", space_mesh=object())


def test_localize_and_perspective_warp(photos):
    stack = np.stack(photos)
    quads = tdoc.localize_batch(stack, CFG, device="cpu")
    ref = jdoc.localize_batch(stack, JCFG)
    for q, r in zip(quads, ref):
        assert (q is None) == (r is None)
        if q is not None:
            np.testing.assert_allclose(q, r, atol=0.5, rtol=0)
    one = tdoc.localize_document(photos[1], CFG, device="cpu")
    np.testing.assert_array_equal(one, quads[1])
    warped = tdoc.perspective_warp(photos[1], quads[1], CFG.page, CFG.scale_long, device="cpu")
    ref_warped = jdoc.perspective_warp(photos[1], ref[1], JCFG.page, JCFG.scale_long)
    assert warped.shape == (400, 283, 3)
    _assert_float_contract(warped.numpy(), np.asarray(ref_warped))


# ---------------------------------------------------------------------------
# I/O and drawing
# ---------------------------------------------------------------------------

def test_imageio_round_trips_equal_tpuimage(photos, tmp_path):
    rgb = photos[0]
    for ext in (".png", ".jpg"):
        ours, ref = str(tmp_path / f"ours{ext}"), str(tmp_path / f"ref{ext}")
        tio.save_image(ours, torch.from_numpy(rgb))
        jio.save_image(ref, rgb)
        np.testing.assert_array_equal(tio.load_image_rgb(ours), jio.load_image_rgb(ref))
        np.testing.assert_array_equal(tio.load_image_gray(ours), jio.load_image_gray(ref))
        for preset in tio.COMPRESSION_PRESETS:
            a = tio.compress_and_save(rgb, str(tmp_path / f"o_{preset}{ext}"), preset)
            b = jio.compress_and_save(rgb, str(tmp_path / f"r_{preset}{ext}"), preset)
            assert a == b
    assert tio.COMPRESSION_PRESETS == jio.COMPRESSION_PRESETS
    np.testing.assert_array_equal(tio.resize_long_side_np(rgb, 200),
                                  jio.resize_long_side_np(rgb, 200))
    with pytest.raises(FileNotFoundError):
        tio.load_image_rgb(str(tmp_path / "missing.png"))


def test_draw_polyline_overlay_equals_tpuimage(photos, rng):
    for pts, closed in ((rng.uniform(-5, 365, (4, 2)), True),
                        (np.array([[0, 0], [359, 0], [359, 479], [0, 479]], np.float32), True),
                        (rng.uniform(0, 300, (5, 2)), False)):
        np.testing.assert_array_equal(
            tdraw.draw_polyline_overlay(photos[0], pts, color=(255, 165, 0), closed=closed),
            jdraw.draw_polyline_overlay(photos[0], pts, color=(255, 165, 0), closed=closed))


# ---------------------------------------------------------------------------
# serving: scan_stream, pipeline_chunk, fallback_common_shape
# ---------------------------------------------------------------------------

def _assert_same_results(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            if k == "binary" or (k == "quad" and x[k] is not None):
                np.testing.assert_array_equal(x[k], y[k])
            else:
                assert x[k] == y[k], k


@pytest.fixture(scope="module")
def served(photos):
    """scan_batch of every photo once, in the streams' order below."""
    return {i: r for i, r in enumerate(tdoc.scan_batch(photos, GUI, device="cpu"))}


@pytest.mark.parametrize("prefetch", [True, False])
def test_scan_stream_equals_scan_batch_in_order(photos, served, prefetch):
    order = [[0, 1, 2], [2, 0], [1]]
    out = list(tdoc.scan_stream(([photos[i] for i in b] for b in order), GUI,
                                device="cpu", prefetch=prefetch))
    assert len(out) == len(order)
    for batch, res in zip(order, out):
        _assert_same_results(res, [served[i] for i in batch])


def test_scan_stream_closed_early_and_checks_eagerly(photos):
    stream = tdoc.scan_stream([photos[:1]] * 5, GUI, device="cpu")
    first = next(stream)
    assert first[0]["binary"].shape == (400, 283)
    stream.close()
    with pytest.raises(NotImplementedError):
        tdoc.scan_stream([photos], GUI, device="cpu", mesh=object())
    assert list(tdoc.scan_stream([], GUI, device="cpu")) == []


def test_scan_batch_pipeline_chunk_equals_unchunked(photos, served):
    inputs = photos + photos[:1]
    _assert_same_results(tdoc.scan_batch(inputs, GUI, device="cpu", pipeline_chunk=2),
                         [served[0], served[1], served[2], served[0]])
    assert tdoc._auto_pipeline_chunk(64) == 0


def test_fallback_common_shape_matches_tpuimage(photos):
    ours = tdoc.scan_batch(photos[1:], GUI, device="cpu", fallback_common_shape=True)
    ref = jdoc.scan_batch(photos[1:], JGUI, fallback_common_shape=True)
    assert "fallback_resized_to" not in ours[0] and not ours[0]["use_whole"]
    assert ours[1]["use_whole"] and ref[1]["use_whole"]
    assert ours[1]["fallback_resized_to"] == ref[1]["fallback_resized_to"] == (400, 283)
    for o, r in zip(ours, ref):
        assert o["binary"].shape == r["binary"].shape == (400, 283)
        assert (o["binary"] != r["binary"]).mean() < 0.002
    for shape, page, want in (((480, 360), "A4", (400, 283)), ((360, 480), "A4", (566, 400)),
                              ((480, 360), "letter", (400, 309)), ((480, 360), "x", (400, 283))):
        assert tdoc._fallback_common_size(shape, page, 400) == \
            jdoc._fallback_common_size(shape, page, 400) == want
