"""The notebook's shadow-protected enhancement on tpuimage_torch (the ops it
needs, its stages, its four presets single and batched, the
categorisation) against tpuimage (JAX on the CPU), on seeded inputs
(``tpuimage_torch.synth.shadowed_scene`` / ``white_page`` /
``night_scene``, random arrays) and a 240x320 crop of
``outputs/scan_02_quad.png``.

Tolerances, each stated where it is checked:
- exact (max |diff| 0): Sobel, Scharr, the Laplacians, YCrCb -> RGB on
  all 2**24 triples, the BGR forms, equalize_hist, the fused f32 blur
  channel-last, unsharp_mask_u8, the arithmetic and bitwise ops, tophat
  and gradient, resize nearest / linear / cubic, the affine and
  perspective warps, sharpen_kernel_3x3, ``percentile`` against
  ``jnp.percentile`` on random f32 rows; the shadow mask, the Retinex
  blend, the stretch and the unsharp blends, each on the values
  tpuimage's program (or its stage jitted alone) blends; the DOCUMENT and
  NIGHT programs whole, single and vmapped; the stages after the CLAHE on
  tpuimage's own CLAHE output; the categories;
- the float stages: magnitude within 1e-6 relative (XLA's sqrt of the
  exact sum of squares differs in the last place on a few values),
  phase within 1e-4 degrees, the Laplacian variance within 1e-5
  relative; the Retinex (a correctly rounded log in place of XLA's) and
  Richardson-Lucy (25 shifted multiply-adds in place of XLA's
  convolution) within max |diff| 1 on < 0.1% of values (measured 0 and
  at most 1 value);
- the stages with a CLAHE (the CLAHE-tie contract of ROADMAP Queue 3):
  the CLAHE stage within PATH_TOL; PORTRAIT whole within PATH_TOL;
  GENERAL whole within SHADOW_GENERAL_TOL, max 6 (measured 6): its
  stretch multiplies an L tie by 255 / (hi - lo) and its unsharp by up
  to 2, shares as PATH_TOL's (measured at most 0.23% and 0.08%).
"""
import functools
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpuimage.core.dtypes import f32 as jf32
from tpuimage.core.dtypes import trunc_u8 as jtrunc_u8
from tpuimage.ops import arith as jarith
from tpuimage.ops import color as jcolor
from tpuimage.ops import edges as jedges
from tpuimage.ops import filters as jfilters
from tpuimage.ops import geometry as jgeo
from tpuimage.ops import histogram as jhist
from tpuimage.ops import morphology as jmorph
from tpuimage.ops import restore as jrestore
from tpuimage.ops.arith import add_weighted as jadd_weighted
from tpuimage.pipelines import shadow as jshadow

from tpuimage_torch import convert, synth
from tpuimage_torch.io import imageio
from tpuimage_torch.ops import (arith, color, edges, filters, geometry, histogram,
                                morphology, restore)
from tpuimage_torch.pipelines import shadow

# one intra-op thread: pytest-xdist runs several workers side by side
torch.set_num_threads(1)

PATH_TOL = (4, 0.015, 0.005)              # max |diff|, share > 0, share > 1
SHADOW_GENERAL_TOL = (6, 0.015, 0.005)
OUTPUTS = os.path.join(os.path.dirname(__file__), os.pardir, "outputs")
PRESET_NAMES = ("DOCUMENT", "NIGHT", "PORTRAIT", "GENERAL")


def _t(a):
    return torch.from_numpy(np.array(a))     # a writable, contiguous copy


def _diff(ours, ref):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype, (ours.shape, ours.dtype,
                                                                 ref.shape, ref.dtype)
    return np.abs(ours.astype(np.float64) - ref.astype(np.float64))


def _exact(ours, ref):
    d = _diff(ours, ref)
    assert d.max() == 0, ((d > 0).sum(), d.size, d.max())


def _assert_within(ours, ref, max_diff, share_any, share_over_1=None):
    d = _diff(ours, ref)
    assert d.max() <= max_diff, d.max()
    assert (d > 0).mean() < share_any, ((d > 0).sum(), d.size)
    if share_over_1 is not None:
        assert (d > 1).mean() < share_over_1, ((d > 1).sum(), d.size)


@functools.lru_cache(maxsize=None)
def _scan_crop():
    return imageio.load_image_rgb(os.path.join(OUTPUTS, "scan_02_quad.png"))[:240, :320]


IMAGES = {"scene72x96": lambda: synth.shadowed_scene(0, 72, 96),
          "page96x72": lambda: synth.white_page(0, 96, 72),
          "scan240x320": _scan_crop}


def _gray(seed=0, shape=(61, 83)):
    return np.asarray(jcolor.rgb_to_gray(synth.shadowed_scene(seed, *shape)))


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,args", [("sobel", (1, 0)), ("sobel", (0, 1)), ("sobel", (2, 0)),
                                       ("sobel", (0, 2)), ("sobel", (1, 1)),
                                       ("scharr", (1, 0)), ("scharr", (0, 1)),
                                       ("laplacian", (1,)), ("laplacian", (3,))])
def test_derivatives_exact(kind, args):
    g = _gray()
    if kind == "laplacian":
        ref = jax.jit(lambda x: jedges.laplacian(x, *args))(g)
        ours = edges.laplacian(_t(g), *args)
    else:
        ksize = -1 if kind == "scharr" else 3
        ref = jax.jit(lambda x: jedges.sobel(x, *args, ksize=ksize))(g)
        ours = edges.sobel(_t(g), *args, ksize=ksize)
    _exact(ours, ref)


def test_magnitude_phase_laplacian_variance():
    g = _gray()
    gx, gy = jedges.sobel(g, 1, 0), jedges.sobel(g, 0, 1)
    mag = np.asarray(jax.jit(jedges.magnitude)(gx, gy))
    ours = edges.magnitude(_t(gx), _t(gy)).numpy()
    np.testing.assert_allclose(ours, mag, rtol=1e-6, atol=0)
    np.testing.assert_allclose(edges.phase(_t(gx), _t(gy)).numpy(),
                               np.asarray(jax.jit(jedges.phase)(gx, gy)), rtol=0, atol=1e-4)
    rad = edges.phase(_t(gx), _t(gy), degrees=False).numpy()
    assert rad.min() >= 0 and rad.max() < 2 * np.pi
    np.testing.assert_allclose(float(edges.laplacian_variance(_t(g))),
                               float(jax.jit(jedges.laplacian_variance)(g)), rtol=1e-5)


def test_ycrcb_to_rgb_on_all_triples():
    grid = np.stack(np.meshgrid(*[np.arange(256, dtype=np.uint8)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    _exact(color.ycrcb_to_rgb(_t(grid)), jax.jit(jcolor.ycrcb_to_rgb)(grid))


def test_bgr_forms_split_merge():
    x = synth.shadowed_scene(1, 37, 53)
    for ours, ref in ((color.bgr_to_gray, jcolor.bgr_to_gray),
                      (color.bgr_to_ycrcb, jcolor.bgr_to_ycrcb),
                      (color.ycrcb_to_bgr, jcolor.ycrcb_to_bgr),
                      (color.bgr_to_hsv, jcolor.bgr_to_hsv),
                      (color.hsv_to_bgr, jcolor.hsv_to_bgr),
                      (color.bgr_to_lab, jcolor.bgr_to_lab)):
        _exact(ours(_t(x)), jax.jit(ref)(x))
    _exact(color.merge(color.split(_t(x))), x)


def test_equalize_hist():
    g = _gray()
    _exact(histogram.equalize_hist(_t(g)), jax.jit(jhist.equalize_hist)(g))
    flat = np.full((9, 13), 77, np.uint8)
    _exact(histogram.equalize_hist(_t(flat)), jhist.equalize_hist(flat))
    batch = np.stack([g, g[::-1], np.full_like(g, 3)])
    ours = histogram.equalize_hist(_t(batch))
    for i in range(3):
        _exact(ours[i], jax.jit(jhist.equalize_hist)(batch[i]))


@pytest.mark.parametrize("q", [1, 2, 5, 98, 99, 0.7, 37.5, 99.5])
def test_percentile_matches_jitted_jnp(q):
    """The position's constants folded as XLA folds them (integer and
    float q differ) and the low product fused: equal on random f32 rows."""
    v = np.random.default_rng(3).standard_normal((3, 20736)).astype(np.float32) * 50
    _exact(histogram.percentile(_t(v), q), jax.jit(lambda a: jnp.percentile(a, q, axis=-1))(v))


def test_gaussian_blur_f32_fused_channels_last():
    x = synth.shadowed_scene(3, 37, 53).astype(np.float32) + 1.0
    for sigma in (80.0,):              # 641 taps, reflect-101 past the image
        ref = jax.jit(lambda a: jfilters.gaussian_blur_f32(a, 0, sigma))(x)
        _exact(filters.gaussian_blur_f32(_t(x), 0, sigma, channels_last=True, fma=True), ref)
    assert filters.gaussian_ksize_from_sigma(80, depth_8u=False) == 641


def test_unsharp_mask_u8():
    x = synth.shadowed_scene(4, 37, 53)
    _exact(filters.unsharp_mask_u8(_t(x), 1.5, sigma=1.0, channels_last=True),
           jax.jit(lambda a: jfilters.unsharp_mask_u8(a, 1.5, sigma=1.0))(x))


def test_arith_and_bitwise_ops():
    rng = np.random.default_rng(5)
    a, b = (rng.integers(0, 256, (37, 53, 3), dtype=np.uint8) for _ in range(2))
    m = rng.random((37, 53)).astype(np.float32)
    for ours, ref in ((arith.add_u8, jarith.add_u8), (arith.absdiff_u8, jarith.absdiff_u8),
                      (arith.min_u8, jarith.min_u8), (arith.bitwise_or, jarith.bitwise_or),
                      (arith.bitwise_and, jarith.bitwise_and)):
        _exact(ours(_t(a), _t(b)), jax.jit(ref)(a, b))
    _exact(arith.multiply_u8(_t(a), _t(b), 0.01), jax.jit(lambda x, y: jarith.multiply_u8(x, y, 0.01))(a, b))
    _exact(arith.bitwise_not(_t(a)), jax.jit(jarith.bitwise_not)(a))
    _exact(arith.add_u8(_t(a), 100), jarith.add_u8(a, 100))
    _exact(arith.blend_mask(_t(a), _t(b), _t(m)), jarith.blend_mask(a, b, m))   # called alone


def test_tophat_gradient():
    g = _gray()
    for shape, k in (("ellipse", 5), ("rect", 3), ("cross", (3, 5))):
        se = jmorph.structuring_element(shape, k)
        _exact(morphology.morph_tophat(_t(g), se), jmorph.morph_tophat(g, se))
        _exact(morphology.morph_gradient(_t(g), se, 2), jmorph.morph_gradient(g, se, 2))


@pytest.mark.parametrize("interp", ["nearest", "linear", "cubic", "area"])
def test_resize_modes(interp):
    x = synth.shadowed_scene(5, 48, 64)
    for oh, ow in ((31, 101), (96, 40), (24, 32)):
        _exact(geometry.resize(_t(x), oh, ow, interp), jgeo.resize(x, oh, ow, interp))


def test_affine_and_perspective_warps():
    """tpuimage runs these op by op: each product and sum rounds alone."""
    x = synth.shadowed_scene(6, 48, 64)
    _exact(geometry.rotate(_t(x), 17.0, 0.9), jgeo.rotate(x, 17.0, 0.9))
    _exact(geometry.rotate(_t(x), -5.0, 1.0, "replicate"), jgeo.rotate(x, -5.0, 1.0, "replicate"))
    _exact(geometry.translate(_t(x), 7.5, -3.25), jgeo.translate(x, 7.5, -3.25))
    M = np.array([[1.1, 0.2, -3.0], [0.1, 0.9, 5.0]])
    _exact(geometry.warp_affine(_t(x), M, 52, 70, border_value=77),
           jgeo.warp_affine(x, M, 52, 70, border_value=77))
    np.testing.assert_array_equal(geometry.get_rotation_matrix_2d((3.5, 2.0), 30.0, 1.2),
                                  jgeo.get_rotation_matrix_2d((3.5, 2.0), 30.0, 1.2))
    P = jgeo.get_perspective_transform([[3, 4], [60, 2], [62, 45], [1, 44]],
                                       [[0, 0], [50, 0], [50, 40], [0, 40]])
    _exact(geometry.warp_perspective(_t(x), P, 41, 51), jgeo.warp_perspective(x, P, 41, 51))
    _exact(geometry.warp_perspective(_t(x[..., 0]), P, 41, 51, border_value=9),
           jgeo.warp_perspective(x[..., 0], P, 41, 51, border_value=9))


@pytest.mark.parametrize("name", ["scene72x96", "page96x72"])
def test_retinex_and_richardson_lucy_within_bound(name):
    x = IMAGES[name]()
    _assert_within(restore.single_scale_retinex(_t(x), 80.0),
                   jax.jit(lambda a: jrestore.single_scale_retinex(a, 80.0))(x), 1, 0.001)
    g = np.asarray(jcolor.rgb_to_gray(x))
    _assert_within(restore.richardson_lucy_gray(_t(g), 15),
                   jrestore.richardson_lucy_gray(g, iterations=15), 1, 0.001)


def test_sharpen_kernel_3x3():
    x = synth.shadowed_scene(7, 37, 53)
    _exact(restore.sharpen_kernel_3x3(_t(x)), jrestore.sharpen_kernel_3x3(x))
    g = x[..., 1]
    _exact(restore.sharpen_kernel_3x3(_t(g)), jrestore.sharpen_kernel_3x3(g))


# ---------------------------------------------------------------------------
# the shadow stages
# ---------------------------------------------------------------------------

def _program_copy(rgb, preset, want):
    """tpuimage's enhance_shadow_protected, also returning the value
    ``want`` names (each from its own copy: returning several at once
    compiles to another program)."""
    cfg, img, seen = preset, rgb, {}
    mask = jshadow.get_shadow_mask_brightness(img, cfg.shadow_v_threshold, cfg.mask_blur_ksize)
    if cfg.use_retinex:
        seen["retinex"] = jrestore.single_scale_retinex(img, sigma=cfg.retinex_sigma)
        img = jadd_weighted(seen["retinex"], cfg.retinex_blend, img, 1.0 - cfg.retinex_blend, 0.0)
        seen["rblend"] = img
    if cfg.use_clahe:
        img = seen["clahe"] = jshadow.adaptive_clahe(img, cfg.clahe_clip, cfg.clahe_tile, mask)
    if cfg.use_contrast_stretch:
        img = seen["stretch"] = jshadow.contrast_stretch_rgb(img, cfg.stretch_percentiles, mask)
    if cfg.use_unsharp:
        img = seen["unsharp"] = jshadow.adaptive_unsharp(img, cfg.unsharp_radius,
                                                         cfg.unsharp_amount, mask)
    m = jnp.clip(mask * cfg.final_shadow_blend_strength, 0.0, 1.0)[..., None]
    final = jtrunc_u8(jf32(img) * (1.0 - m) + jf32(rgb) * m)
    return final, mask, seen[want]


_copy = jax.jit(_program_copy, static_argnames=("preset", "want"))


def _copy_stage(x, name, want):
    """The stage's value inside tpuimage's program, its copy's output first
    checked equal to the program's."""
    ref = jshadow.enhance_shadow_protected(jnp.asarray(x), jshadow.PRESETS[name])
    final, mask, value = _copy(jnp.asarray(x), jshadow.PRESETS[name], want)
    np.testing.assert_array_equal(np.asarray(final), np.asarray(ref[0]))
    return np.asarray(value), np.asarray(ref[1])


@pytest.mark.parametrize("name", ["scene72x96"])
def test_document_stages_on_tpuimage_previous_stage(name):
    """DOCUMENT's mask, Retinex blend, stretch and unsharp, each on the
    previous stage of tpuimage's program: exact. The stretch as the
    unsharp's add reads it fuses its first product, as its blur reads it
    the second (the module docstring's exception)."""
    x = IMAGES[name]()
    p = shadow.PRESETS["DOCUMENT"]
    r, mask = _copy_stage(x, "DOCUMENT", "retinex")
    _exact(shadow.get_shadow_mask_brightness(_t(x), p.shadow_v_threshold, p.mask_blur_ksize), mask)
    _assert_within(restore.single_scale_retinex(_t(x), p.retinex_sigma), r, 1, 0.001)
    rblend, _ = _copy_stage(x, "DOCUMENT", "rblend")
    _exact(arith.add_weighted(_t(r), p.retinex_blend, _t(x), 1.0 - p.retinex_blend), rblend)
    stretched, _ = _copy_stage(x, "DOCUMENT", "stretch")
    _exact(shadow.contrast_stretch_rgb(_t(rblend), p.stretch_percentiles, _t(mask),
                                       fuse_first=True), stretched)
    unsharp, _ = _copy_stage(x, "DOCUMENT", "unsharp")
    blur_view = shadow.contrast_stretch_rgb(_t(rblend), p.stretch_percentiles, _t(mask))
    _exact(shadow.adaptive_unsharp(_t(stretched), p.unsharp_radius, p.unsharp_amount, _t(mask),
                                   blur_view), unsharp)


def _final_blend(x, p, img):
    soft = shadow._shadow_soft(_t(x), p.shadow_v_threshold, p.mask_blur_ksize)
    mf = torch.clamp(soft * float(np.float32(shadow._RECIP_255)
                                  * np.float32(p.final_shadow_blend_strength)), 0.0, 1.0)
    return shadow._shadow_blend(img, _t(x), mf)


@pytest.mark.parametrize("name", ["scene72x96", "page96x72"])
def test_general_tail_exact_on_tpuimage_clahe(name):
    """GENERAL after its CLAHE (stretch, unsharp, final blend), on the
    CLAHE stage of tpuimage's program: exact; so GENERAL's extra levels
    are the CLAHE's ties."""
    x = IMAGES[name]()
    p = shadow.PRESETS["GENERAL"]
    clahed, mask = _copy_stage(x, "GENERAL", "clahe")
    ref = jshadow.enhance_shadow_protected(jnp.asarray(x), jshadow.PRESETS["GENERAL"])[0]
    m = _t(mask)
    blur_view = shadow.contrast_stretch_rgb(_t(clahed), p.stretch_percentiles, m)
    img = shadow.contrast_stretch_rgb(_t(clahed), p.stretch_percentiles, m, fuse_first=True)
    img = shadow.adaptive_unsharp(img, p.unsharp_radius, p.unsharp_amount, m, blur_view)
    _exact(_final_blend(x, p, img), ref)
    # the CLAHE stage itself: the ties
    _assert_within(shadow.adaptive_clahe(_t(x), p.clahe_clip, p.clahe_tile, m), clahed,
                   *PATH_TOL)


def test_portrait_final_blend_on_tpuimage_clahe():
    """PORTRAIT's final blend on the CLAHE stage of tpuimage's program:
    exact. (A copy returning that stage reproduces the program on the
    page; on the scenes it compiles to another program.)"""
    x = IMAGES["page96x72"]()
    p = shadow.PRESETS["PORTRAIT"]
    clahed, _ = _copy_stage(x, "PORTRAIT", "clahe")
    ref = jshadow.enhance_shadow_protected(jnp.asarray(x), jshadow.PRESETS["PORTRAIT"])[0]
    _exact(_final_blend(x, p, _t(clahed)), ref)


@pytest.mark.parametrize("name", ["scene72x96", "page96x72"])
def test_stages_jitted_alone(name):
    """tpuimage's stage functions jitted one by one: the mask, the stretch
    and the unsharp exact (every blend fusing its second product); the
    CLAHE stage within PATH_TOL."""
    x = IMAGES[name]()
    mask = np.asarray(jax.jit(jshadow.get_shadow_mask_brightness, static_argnums=(1, 2))(x, 80, 51))
    _exact(shadow.get_shadow_mask_brightness(_t(x), 80, 51), mask)
    _exact(shadow.contrast_stretch_rgb(_t(x), (2, 98), _t(mask)),
           jax.jit(jshadow.contrast_stretch_rgb, static_argnums=1)(x, (2, 98), mask))
    _exact(shadow.contrast_stretch_rgb(_t(x), (1, 99)),
           jax.jit(jshadow.contrast_stretch_rgb, static_argnums=1)(x, (1, 99), None))
    _exact(shadow.adaptive_unsharp(_t(x), 1, 1.0, _t(mask)),
           jax.jit(jshadow.adaptive_unsharp, static_argnums=(1, 2))(x, 1, 1.0, mask))
    _exact(shadow.adaptive_unsharp(_t(x), 2, 0.5),
           jax.jit(jshadow.adaptive_unsharp, static_argnums=(1, 2))(x, 2, 0.5, None))
    _assert_within(shadow.adaptive_clahe(_t(x), 3.0, (8, 8), _t(mask)),
                   jax.jit(jshadow.adaptive_clahe, static_argnums=(1, 2))(x, 3.0, (8, 8), mask),
                   *PATH_TOL)


# ---------------------------------------------------------------------------
# the programs whole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("image", ["scene72x96", "page96x72", "scan240x320"])
@pytest.mark.parametrize("name", PRESET_NAMES)
def test_enhance_shadow_protected(name, image):
    x = IMAGES[image]()
    final, mask = jshadow.enhance_shadow_protected(jnp.asarray(x), jshadow.PRESETS[name])
    ours, our_mask = shadow.enhance_shadow_protected(x, shadow.PRESETS[name], device="cpu")
    _exact(our_mask, mask)
    if name in ("DOCUMENT", "NIGHT"):
        _exact(ours, final)
    else:
        _assert_within(ours, final, *(SHADOW_GENERAL_TOL if name == "GENERAL" else PATH_TOL))


@pytest.mark.parametrize("name", PRESET_NAMES)
def test_enhance_shadow_batch(name):
    """The vmapped program against the port's batch: the same forms, each
    image its own percentiles; the batch equals the single calls."""
    xs = np.stack([synth.shadowed_scene(0, 72, 96), synth.shadowed_scene(8, 72, 96)])
    final, mask = jshadow.enhance_shadow_batch(jnp.asarray(xs), jshadow.PRESETS[name])
    ours, our_mask = shadow.enhance_shadow_batch(xs, shadow.PRESETS[name], device="cpu")
    _exact(our_mask, mask)
    if name in ("DOCUMENT", "NIGHT"):
        _exact(ours, final)
    else:
        _assert_within(ours, final, *(SHADOW_GENERAL_TOL if name == "GENERAL" else PATH_TOL))
    single = shadow.enhance_shadow_protected(xs[1], shadow.PRESETS[name], device="cpu")[0]
    _exact(ours[1], single)
    with pytest.raises(ValueError, match="B, H, W, 3"):
        shadow.enhance_shadow_batch(xs[0], shadow.PRESETS[name], device="cpu")


def test_presets_carried_across():
    import dataclasses
    for name, p in jshadow.PRESETS.items():
        assert convert.preset_from_tpuimage(dataclasses.asdict(p)) == shadow.PRESETS[name]
    assert dataclasses.asdict(jshadow.ShadowPreset()) == dataclasses.asdict(shadow.ShadowPreset())


# ---------------------------------------------------------------------------
# categorisation
# ---------------------------------------------------------------------------

def _cues_equal(x):
    ref = [np.float32(c) for c in jshadow._categorize_cues(jnp.asarray(x))]
    ours = [np.float32(c) for c in shadow.categorize_cues(x, device="cpu")]
    assert ours == ref, (ours, ref)
    assert shadow.auto_categorize(x, device="cpu") == jshadow.auto_categorize(x)
    return shadow.auto_categorize(x, device="cpu")


def test_auto_categorize_on_scenes():
    assert _cues_equal(synth.night_scene(0, 72, 96)) == "NIGHT"
    assert _cues_equal(synth.white_page(0, 96, 72)) == "DOCUMENT"
    assert _cues_equal(synth.shadowed_scene(0, 72, 96)) == "GENERAL"
    assert _cues_equal(_scan_crop()) in shadow.PRESETS
    x = synth.white_page(1, 96, 72)
    assert shadow.check_document_mode(x, device="cpu") == jshadow.check_document_mode(x)
    assert shadow.check_night_mode(x, device="cpu") == jshadow.check_night_mode(x)
    assert not shadow.check_portrait_mode(x, device="cpu")


def _threshold_scene(v_sum_offset=None, white=None, edges=None, h=60, w=80):
    """Gray images (R = G = B, so gray = V) built to sit at a cue's
    threshold: a flat 80 plane with one pixel moved by ``v_sum_offset``
    (mean V 80 +- 1 / n); or ``white`` pixels at 255 (V > 230, raster
    order) holding ``edges`` isolated 155 dots, the rest a flat 200. A
    dot is exactly one |Laplacian| > 150 (its centre 400, its neighbours
    100): the dots sit 3 apart, 2 or more from the borders and from the
    200s."""
    if v_sum_offset is not None:
        g = np.full((h, w), 80, np.uint8)
        g[0, 0] = 80 + v_sum_offset
        return np.repeat(g[..., None], 3, axis=-1)
    g = np.full(h * w, 200, np.uint8)
    g[:white + edges] = 255
    g = g.reshape(h, w)
    full_rows = (white + edges) // w
    spots = [(y, x) for y in range(2, full_rows - 2, 3) for x in range(2, w - 2, 3)][:edges]
    assert len(spots) == edges
    for y, x in spots:
        g[y, x] = 155
    return np.repeat(g[..., None], 3, axis=-1)


@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_night_threshold_within_one_count(offset):
    assert _cues_equal(_threshold_scene(v_sum_offset=offset)) == ("NIGHT" if offset < 0
                                                                  else "GENERAL")


@pytest.mark.parametrize("white_extra", [-1, 0, 1])
@pytest.mark.parametrize("edge_extra", [-1, 0, 1])
def test_document_thresholds_within_one_count(white_extra, edge_extra):
    """White counts around 0.7 of the pixels and edge counts around 0.015,
    each one count apart (the f32 ratios decide, as in tpuimage)."""
    n = 60 * 80
    x = _threshold_scene(white=int(0.7 * n) + white_extra, edges=int(0.015 * n) + edge_extra)
    v_mean, white, edges = (float(c) for c in shadow.categorize_cues(x, device="cpu"))
    assert white == np.float32(int(0.7 * n) + white_extra) * np.float32(1 / np.float32(n))
    assert edges == np.float32(int(0.015 * n) + edge_extra) * np.float32(1 / np.float32(n))
    _cues_equal(x)


def test_enhance_image_categorises_and_needs_a_card_by_default():
    x = synth.white_page(0, 96, 72)
    final, mask, category = shadow.enhance_image(x, device="cpu")
    jfinal, jmask, jcategory = jshadow.enhance_image(x)
    assert category == jcategory == "DOCUMENT"
    _exact(final, jfinal)
    _exact(mask, jmask)
    assert shadow.enhance_image(x, category="NIGHT", device="cpu")[2] == "NIGHT"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shadow.enhance_shadow_protected(x, shadow.PRESETS["GENERAL"])
