"""The notebook's modules 1-7 and its document restoration on
tpuimage_torch against tpuimage (JAX on the CPU), on seeded inputs
(``synth.shadowed_scene``, ``white_page``, ``document_photo``) and a
240x320 crop of ``outputs/scan_02_quad.png``; the file functions on
files the test writes into ``tmp_path``.

Tolerances, each stated where it is checked:
- exact: module 1 without its CLAHE, modules 2 (median, NLM, sharpen),
  3 (rotate, scale, translate; the automatic perspective correction on a
  document photo) and 4; module 6's edge map; module 7's file sizes
  (the same PIL on the same bytes); the docrestore core's denoise, its
  tail (stretch, unsharp) on tpuimage's CLAHE'd image, and
  ``_segment_and_final`` on tpuimage's gray; ``process_image`` /
  ``main_process`` with tpuimage's CLAHE handed in (every file equal,
  PSNR and SSIM within 1e-5);
- module 6's statistics: within 1e-4 relative (f32 sums in another
  order; the phase's atan2 correctly rounded);
- the stages with a CLAHE (module 1, module 5, the core's CLAHE'd image
  and all after it): the CLAHE-tie contract, max |diff| 2 on the L
  round trip, PATH_TOL after module 5's, and after a stretch and an
  unsharp (module 1, the core's sharpened image) max 6 (module 1;
  measured 6) as the shadow path's GENERAL, and module 1 on the whole
  ``outputs/scan_02_quad.png`` max 7 (MODULE1_PHOTO_TOL), its tail exact
  on tpuimage's CLAHE stage; the core's sharpened image on
  a white page, where the stretch's 255 / (hi - lo) is ~18: any number
  of levels on < 0.5% of values (measured 40 on 23 of 20,736);
- the file path end to end without any handing in: the same files,
  each within those bounds, PSNR within 1e-3 relative and SSIM within
  1e-3 (measured 1.6e-5 and 2.3e-5).
"""
import csv
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpuimage.ops import color as jcolor
from tpuimage.ops import histogram as jhist
from tpuimage.pipelines import docrestore as jdoc
from tpuimage.pipelines import modules as jmod

from tpuimage_torch import synth
from tpuimage_torch.io import imageio
from tpuimage_torch.pipelines import docrestore, modules

from cv2_clahe import program_copy as _program_copy

torch.set_num_threads(1)

PATH_TOL = (4, 0.015, 0.005)
STRETCHED_TOL = (6, 0.015, 0.005)
OUTPUTS = os.path.join(os.path.dirname(__file__), os.pardir, "outputs")


def _t(a):
    return torch.from_numpy(np.array(a))


def _diff(ours, ref):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype, (ours.shape, ref.shape)
    return np.abs(ours.astype(np.int64) - ref.astype(np.int64))


def _exact(ours, ref):
    d = _diff(ours, ref)
    assert d.max() == 0, ((d > 0).sum(), d.size, d.max())


def _assert_within(ours, ref, max_diff, share_any, share_over_1=None):
    d = _diff(ours, ref)
    assert d.max() <= max_diff, d.max()
    assert (d > 0).mean() < share_any, ((d > 0).sum(), d.size)
    if share_over_1 is not None:
        assert (d > 1).mean() < share_over_1, ((d > 1).sum(), d.size)


IMAGES = {"scene": lambda: synth.shadowed_scene(0, 72, 96),
          "page": lambda: synth.white_page(0, 96, 72),
          "scan": lambda: imageio.load_image_rgb(
              os.path.join(OUTPUTS, "scan_02_quad.png"))[:240, :320]}


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_module1_enhance(name):
    x = IMAGES[name]()
    _exact(modules.module1_enhance(x, use_clahe=False, device="cpu"),
           jmod.module1_enhance(jnp.asarray(x), use_clahe=False))
    _exact(modules.module1_enhance(x, use_clahe=False, percentiles=(5, 95), use_unsharp=False,
                                   device="cpu"),
           jmod.module1_enhance(jnp.asarray(x), use_clahe=False, percentiles=(5, 95),
                                use_unsharp=False))
    # whole, against tpuimage's program with cv2's CLAHE stage (the port's
    # CLAHE is cv2's; tpuimage's differs at its ties, which the stretch
    # carried to 7 on the scan crop, past STRETCHED_TOL)
    np.testing.assert_array_equal(_program_copy([jmod], jmod.module1_enhance, jnp.asarray(x),
                                                cv2_stage=False),
                                  np.asarray(jmod.module1_enhance(jnp.asarray(x))))
    _exact(modules.module1_enhance(x, device="cpu"),
           _program_copy([jmod], jmod.module1_enhance, jnp.asarray(x)))


@jax.jit
def _module1_program(rgb):
    """tpuimage's module1_enhance at its defaults, also returning its CLAHE
    stage (its output is checked equal to tpuimage's)."""
    stage = jmod._lab_l_clahe(rgb, 4.0)
    return jmod.module1_enhance.__wrapped__(stage, use_clahe=False), stage


# Module 1 whole on the whole photo: its CLAHE stage differs from
# tpuimage's by the CLAHE's ties (max 2), which the stretch (255 / (hi -
# lo)) and the unsharp (up to 2.2x) carry to max 7 (measured; 0.054% and
# 0.13% of values on the photo and its darkened copy), over STRETCHED_TOL's
# 6, which holds the smaller scenes.
MODULE1_PHOTO_TOL = (7, 0.015, 0.005)


@pytest.mark.parametrize("dark", [False, True])
def test_module1_tail_exact_on_tpuimage_clahe(dark):
    """Module 1 on the whole outputs/scan_02_quad.png (and its copy
    darkened to 1/4): the stretch and the unsharp on the CLAHE stage
    inside tpuimage's program exact, the whole within
    MODULE1_PHOTO_TOL."""
    x = imageio.load_image_rgb(os.path.join(OUTPUTS, "scan_02_quad.png"))
    x = x // 4 if dark else x
    ref = jmod.module1_enhance(jnp.asarray(x))
    final, stage = _module1_program(jnp.asarray(x))
    _exact(np.asarray(final), ref)
    _exact(modules.module1_enhance(np.asarray(stage), use_clahe=False, device="cpu"), ref)
    _assert_within(modules.module1_enhance(x, device="cpu"), ref, *MODULE1_PHOTO_TOL)


@pytest.mark.parametrize("name", ["scene", "page"])
def test_module2_restore(name):
    x = IMAGES[name]()
    _exact(modules.module2_restore(x, use_deblur=True, device="cpu"),
           jmod.module2_restore(jnp.asarray(x), use_deblur=True))
    _exact(modules.module2_restore(x, median_ksize=5, use_nlm=False, device="cpu"),
           jmod.module2_restore(jnp.asarray(x), median_ksize=5, use_nlm=False))


def test_module3_transform_and_auto_perspective():
    x = IMAGES["scene"]()
    _exact(modules.module3_transform(x, 12.0, 0.8, (5, -3), device="cpu"),
           jmod.module3_transform(x, 12.0, 0.8, (5, -3)))
    _exact(modules.module3_transform(x, -7.5, 1.3, (0, 0), device="cpu"),
           jmod.module3_transform(x, -7.5, 1.3, (0, 0)))
    doc = synth.document_photo(3, 240, 180)
    warped = modules.auto_perspective_correction(doc, device="cpu")
    ref = jmod.auto_perspective_correction(doc)
    assert warped.shape != doc.shape          # a quad was found and warped to its own size
    _exact(warped, ref)
    _exact(modules.module3_transform(doc, 3.0, use_perspective=True, device="cpu"),
           jmod.module3_transform(doc, 3.0, use_perspective=True))
    flat = np.full((40, 50, 3), 120, np.uint8)      # no contour: the image back
    _exact(modules.auto_perspective_correction(flat, device="cpu"), flat)


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_module4_segment(name):
    x = IMAGES[name]()
    _exact(modules.module4_segment(x, device="cpu"), jmod.module4_segment(jnp.asarray(x)))
    kw = dict(use_global=True, morph_op="open", morph_iters=2, morph_ksize=5, use_canny=False)
    _exact(modules.module4_segment(x, device="cpu", **kw),
           jmod.module4_segment(jnp.asarray(x), **kw))


@pytest.mark.parametrize("space", ["LAB", "HSV", "YCRCB"])
def test_module5_color(space):
    for name in ("scene", "scan"):
        x = IMAGES[name]()
        _assert_within(modules.module5_color(x, space, device="cpu"),
                       jmod.module5_color(jnp.asarray(x), space), *PATH_TOL)
    g = np.asarray(jcolor.rgb_to_gray(IMAGES["scene"]()))
    _assert_within(modules.module5_color(g, space, device="cpu"),
                   jmod.module5_color(jnp.asarray(g), space), *PATH_TOL)


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_module6_features(name):
    x = IMAGES[name]()
    ours = modules.module6_features(x, device="cpu")
    ref = jmod.module6_features(jnp.asarray(x))
    assert sorted(ours) == sorted(ref)
    _exact(ours["edge_map"], ref["edge_map"])
    for k in ref:
        if k != "edge_map":
            np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-4, err_msg=k)
    batch = modules.module6_features(np.stack([x, x[::-1]]), device="cpu")
    assert batch["grad_magnitude_mean"].shape == (2,)
    np.testing.assert_allclose(float(batch["laplacian_variance"][0]),
                               float(ours["laplacian_variance"]), rtol=1e-6)


def test_module7_compress(tmp_path):
    x = IMAGES["scene"]()
    ours = modules.module7_compress(_t(x), str(tmp_path / "port"))
    ref = jmod.module7_compress(x, str(tmp_path / "tpuimage"))
    assert ours == ref
    for f in ref:
        assert os.path.exists(tmp_path / "port" / f)


# ---------------------------------------------------------------------------
# document restoration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["scene", "page"])
def test_docrestore_core(name):
    x = IMAGES[name]()
    den, cl, sharp = (np.asarray(v) for v in jdoc._enhance_core(jnp.asarray(x)))
    ours = docrestore._enhance_core(_t(x))
    _exact(ours[0], den)
    _assert_within(ours[1], cl, 2, 0.01)
    _exact(docrestore._stretch_sharpen(_t(cl)), sharp)            # on tpuimage's CLAHE'd image
    if name == "page":
        d = _diff(ours[2], sharp)
        assert (d > 0).mean() < 0.005, ((d > 0).sum(), d.size)
    else:
        _assert_within(ours[2], sharp, *STRETCHED_TOL)
    gray = np.asarray(jcolor.rgb_to_gray(sharp))
    for o, r in zip(docrestore._segment_and_final(_t(gray)), jdoc._segment_and_final(gray)):
        _exact(o, r)
    batch = docrestore._enhance_core(_t(np.stack([x, x])))
    _exact(batch[2][1], ours[2])


def _tpuimage_clahe(monkeypatch):
    """Hand tpuimage's CLAHE to the port's docrestore, so that its files
    can be held exact."""
    def clahe(lum, clip_limit, tiles_x, tiles_y):
        planes = np.asarray(lum.reshape(-1, *lum.shape[-2:]))
        out = [np.asarray(jhist.clahe(p, clip_limit=clip_limit, tiles_x=tiles_x,
                                      tiles_y=tiles_y)) for p in planes]
        return torch.from_numpy(np.stack(out)).reshape(lum.shape)
    monkeypatch.setattr(docrestore, "clahe", clahe)


def _inputs(folder):
    os.makedirs(folder)
    imageio.save_image(os.path.join(folder, "doc0.png"), synth.document_photo(10, 240, 180))
    imageio.save_image(os.path.join(folder, "page.jpg"), synth.white_page(2, 200, 150))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _rows(path):
    with open(path) as fh:
        return list(csv.DictReader(fh))


@pytest.mark.parametrize("handed_in", [True, False])
def test_main_process_files_and_metrics(tmp_path, monkeypatch, handed_in):
    """main_process on a document photo and a white page (whose quad
    is a 4x54 strip: its SSIM is NaN in both, the strip under the 7x7
    window): the same files; with tpuimage's CLAHE handed in every file
    is equal and PSNR / SSIM agree within 1e-5, without it within the
    bounds above."""
    _inputs(tmp_path / "in")
    if handed_in:
        _tpuimage_clahe(monkeypatch)
    jdoc.main_process(str(tmp_path / "in"), str(tmp_path / "jax"))
    docrestore.main_process(str(tmp_path / "in"), str(tmp_path / "port"), device="cpu")
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for f in _files(tmp_path / "jax"):
        if not f.endswith(".png"):
            continue
        ours = imageio.load_image_rgb(tmp_path / "port" / f)
        ref = imageio.load_image_rgb(tmp_path / "jax" / f)
        if handed_in:
            _exact(ours, ref)
        elif "_seg" in f or "_final" in f or "overlay" in f:
            d = _diff(ours, ref)                     # thresholds of the tie-moved sharpened gray
            assert (d > 0).mean() < 0.005, (f, (d > 0).sum(), d.size)
        else:
            d = _diff(ours, ref)
            assert d.max() <= 7 and (d > 0).mean() < 0.01, (f, d.max(), (d > 0).sum())
    tol = 1e-5 if handed_in else 1e-3
    for o, r in zip(_rows(tmp_path / "port" / "metrics.csv"),
                    _rows(tmp_path / "jax" / "metrics.csv")):
        assert o["basename"] == r["basename"]
        for k in ("psnr", "ssim"):
            if r[k] == "nan":
                assert o[k] == "nan"
            else:
                np.testing.assert_allclose(float(o[k]), float(r[k]), rtol=tol, atol=tol)


def test_process_image_with_deblur(tmp_path, monkeypatch):
    """The Richardson-Lucy branch: its file within max |diff| 1 on < 0.1%
    of values once the CLAHE is tpuimage's (the convolution's order)."""
    _inputs(tmp_path / "in")
    _tpuimage_clahe(monkeypatch)
    path = str(tmp_path / "in" / "doc0.png")
    ref = jdoc.process_image(path, str(tmp_path / "jax"), do_deblur=True)
    ours = docrestore.process_image(path, str(tmp_path / "port"), do_deblur=True, device="cpu")
    f = os.path.join("enhanced", "doc0_deblurred.png")
    _assert_within(imageio.load_image_rgb(tmp_path / "port" / f),
                   imageio.load_image_rgb(tmp_path / "jax" / f), 1, 0.001)
    assert ours["basename"] == ref["basename"]
    np.testing.assert_allclose(ours["psnr"], ref["psnr"], rtol=1e-3)


def test_entry_points_need_a_card_by_default():
    x = IMAGES["scene"]()
    for fn in () if torch.cuda.is_available() else (modules.module1_enhance, modules.module2_restore, modules.module4_segment,
               modules.module5_color, modules.module6_features, modules.module3_transform):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(x)
