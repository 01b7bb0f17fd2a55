"""The face slice of tpuimage_torch (YCrCb, inRange, the morphological
open, the LUT, and the face pipeline) against tpuimage (JAX on the CPU),
on seeded inputs (``tpuimage_torch.synth.portrait`` and random arrays).

Tolerances, each stated where it is checked:
- exact (max |diff| 0): rgb_to_ycrcb on all 2**24 RGB triples, in_range,
  morph_open, lut_lookup_u8, add_weighted on all byte pairs at face's
  weights, the skin mask, the warmth on every byte, the saturation LUT
  with its HSV round trip, the Gaussian (k 5, 9) and median (3, 5)
  denoisers on RGB, and every truncating blend against the value inside
  tpuimage's jitted program (a copy of the program that also returns its
  intermediates, the copy's outputs checked equal to tpuimage's);
- the kurtosis within 1e-4 relative (tpuimage sums in f32, the port in
  f64; measured up to 2.0e-5), and its branch exactly;
- the bilateral stages (radius 15, d 5): |diff| <= 1 on < 0.5% of values
  (measured exact); the legacy NLM denoisers the same (measured exact);
- CLAHE at 0.5 on the portrait's L and the stages after it: PATH_TOL,
  landscape's (max 4, any < 1.5%, > 1 < 0.5%), where a cvRound tie of the
  blend moves L by one and lab_to_rgb amplifies it;
- the script tail of the gaussian branch, whose sharpening computes
  3 L - 2 blur(L) and so triples a CLAHE tie before lab_to_rgb:
  FACE_SCRIPT_TOL, max 8 with PATH_TOL's shares (measured max 7, > 1 on
  0.18-0.28%); the same tail on tpuimage's CLAHE output is within
  PATH_TOL (measured exact), which shows the extra levels are the ties';
- the eye ROI's CLAHE (clip 0.2, 4x4 tiles, 31-61 px): max 1 on < 1% of
  pixels against tpuimage (measured up to 0.48%), and summed over the
  ROIs no further from cv2 than tpuimage is (cv2 decides the ties);
  the eye pop: max 1 on < 0.5% of values (measured 0.03%).
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpuimage.core.dtypes import f32 as jf32
from tpuimage.core.dtypes import trunc_u8 as jtrunc_u8
from tpuimage.ops import arith as jarith
from tpuimage.ops import color as jcolor
from tpuimage.ops import histogram as jhist
from tpuimage.ops import lut as jlut
from tpuimage.ops import morphology as jmorph
from tpuimage.ops.bilateral import bilateral_filter as jbilateral
from tpuimage.ops.filters import gaussian_blur_u8 as jgauss
from tpuimage.ops.median import median_blur as jmedian
from tpuimage.ops.nlm import nlm_denoise_colored as jnlm
from tpuimage.pipelines import face as jface

from tpuimage_torch import synth
from tpuimage_torch.ops import arith, color, histogram, lut, morphology
from tpuimage_torch.ops.bilateral import bilateral_filter
from tpuimage_torch.ops.filters import gaussian_blur_u8
from tpuimage_torch.ops.median import median_blur
from tpuimage_torch.pipelines import face

# one intra-op thread: pytest-xdist runs several workers side by side
torch.set_num_threads(1)

PATH_TOL = (4, 0.015, 0.005)          # max |diff|, share > 0, share > 1
FACE_SCRIPT_TOL = (8, 0.015, 0.005)   # the gaussian script tail: 3 L - 2 blur(L)
BILATERAL_TOL = (1, 0.005)
KURTOSIS_RTOL = 1e-4
SIZES = {"96x128": (128, 96), "61x97": (97, 61)}       # width x height: (height, width)


def _t(a):
    return torch.from_numpy(np.array(a))     # a writable, contiguous copy


def _diff(ours, ref):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype, (ours.shape, ref.shape)
    return np.abs(ours.astype(np.int64) - ref.astype(np.int64))


def _assert_within(ours, ref, max_diff, share_any, share_over_1=None):
    d = _diff(ours, ref)
    assert d.max() <= max_diff, d.max()
    assert (d > 0).mean() < share_any, ((d > 0).sum(), d.size)
    if share_over_1 is not None:
        assert (d > 1).mean() < share_over_1, ((d > 1).sum(), d.size)


def _exact(ours, ref):
    np.testing.assert_array_equal(ours.numpy() if isinstance(ours, torch.Tensor) else ours,
                                  np.asarray(ref))


@functools.lru_cache(maxsize=None)
def _portrait(size: str, noise: str, seed: int = 5):
    img, eyes = synth.portrait(seed, *SIZES[size], noise=noise)
    return img, tuple(eyes)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def test_rgb_to_ycrcb_on_every_rgb_triple():
    r, g, b = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8),
                          np.arange(256, dtype=np.uint8), indexing="ij")
    rgb = np.stack([r, g, b], axis=-1).reshape(4096, 4096, 3)
    _exact(color.rgb_to_ycrcb(_t(rgb)), jax.jit(jcolor.rgb_to_ycrcb)(rgb))


def test_in_range_matches_tpuimage():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    x[:4, :4] = (0, 133, 77)                     # on the bounds: inside
    x[4:8, :4] = (255, 173, 127)
    x[8:12, :4] = (0, 132, 77)                   # one below: outside
    lo, hi = face.SKIN_MASK_THRESHOLD[:3], face.SKIN_MASK_THRESHOLD[3:]
    ours = arith.in_range(_t(x), lo, hi)
    _exact(ours, jarith.in_range(x, lo, hi))
    assert ours.shape == (37, 53) and (ours == 255).any() and (ours == 0).any()
    _exact(arith.in_range(_t(x[..., 1]), 100, 180), jarith.in_range(x[..., 1], 100, 180))
    two = arith.in_range(_t(np.stack([x, x[::-1]])), lo, hi)
    _exact(two[1], jarith.in_range(x[::-1], lo, hi))


@pytest.mark.parametrize("iterations", [1, 2])
def test_morph_open_matches_tpuimage(iterations):
    rng = np.random.default_rng(2)
    x = ((rng.random((41, 59)) < 0.6) * 255).astype(np.uint8)
    x[10:30, 20:45] = 255
    se = morphology.structuring_element(morphology.MORPH_ELLIPSE, 5)
    np.testing.assert_array_equal(se, jmorph.structuring_element(jmorph.MORPH_ELLIPSE, 5))
    _exact(morphology.morph_open(_t(x), se, iterations),
           jmorph.morph_open(jnp.asarray(x), se, iterations))


def test_lut_lookup_u8_matches_tpuimage():
    rng = np.random.default_rng(3)
    table = rng.integers(0, 256, 256, dtype=np.uint8)
    vals = np.concatenate([np.arange(256, dtype=np.uint8),
                           rng.integers(0, 256, 1019, dtype=np.uint8)]).reshape(25, 51)
    _exact(lut.lut_lookup_u8(_t(table), _t(vals)), jlut.lut_lookup_u8(jnp.asarray(table), vals))


@pytest.mark.parametrize("amount", [2.0, 1.0, 0.5])     # script face, background, eye
def test_add_weighted_on_all_byte_pairs_at_face_weights(amount):
    a, b = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8),
                       indexing="ij")
    alpha, beta = 1.0 + amount, -amount
    ref = jax.jit(lambda a, b: jarith.add_weighted(a, alpha, b, beta, 0.0))(a, b)
    _exact(arith.add_weighted(_t(a), alpha, _t(b), beta), ref)


@pytest.mark.parametrize("amount", [15.0, 10.0])
def test_warmth_on_every_byte(amount):
    x = np.stack([np.arange(256, dtype=np.uint8)] * 3, axis=-1)[None]
    _exact(face.apply_warmth(_t(x), amount),
           jax.jit(jface.apply_warmth, static_argnums=1)(x, amount))


@pytest.mark.parametrize("saturation", [1.2, 1.0])
def test_saturation_lut_and_hsv_round_trip(saturation):
    """On every third RGB value in each channel (1.0 is not the identity:
    the 8-bit HSV round trip quantizes)."""
    grid = np.stack(np.meshgrid(*[np.arange(0, 256, 3, dtype=np.uint8)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 86, 3)
    ours = face.adjust_saturation(_t(grid), saturation)
    _exact(ours, jax.jit(jface.adjust_saturation, static_argnums=1)(grid, saturation))
    if saturation == 1.0:
        assert (ours.numpy() != grid).any()


def test_blend_masked_on_every_byte_triple():
    """All 2**24 (a, b, mask) triples against tpuimage's blend_masked jitted
    alone, which fuses the same product as the face programs (the
    a * m one; the other choice differs on 22,011 triples)."""
    a, b, m = (v.reshape(4096, 4096) for v in np.meshgrid(
        *[np.arange(256, dtype=np.uint8)] * 3, indexing="ij"))
    _exact(face.blend_masked(_t(a), _t(b), _t(m)), jax.jit(jface.blend_masked)(a, b, m))


# ---------------------------------------------------------------------------
# layout: the denoisers filter each channel of an (H, W, 3) image
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op,k", [("gaussian", 5), ("gaussian", 9), ("median", 3),
                                  ("median", 5)])
def test_channel_last_denoisers_at_face_parameters(op, k):
    x, _ = _portrait("61x97", "impulse" if op == "median" else "gaussian")
    if op == "gaussian":
        ref = jax.jit(lambda v: jgauss(v, ksize=k))(x)
        ours = gaussian_blur_u8(_t(x), ksize=k, channels_last=True)
        plane_wise = gaussian_blur_u8(_t(x), ksize=k)
    else:
        ref = jax.jit(lambda v: jmedian(v, k))(x)
        ours = median_blur(_t(x), k, channels_last=True)
        plane_wise = median_blur(_t(x), k)
    _exact(ours, ref)
    assert (plane_wise.numpy() != np.asarray(ref)).mean() > 0.3   # over (W, 3): wrong


def test_polish_bilateral_d5_within_contract():
    x, _ = _portrait("96x128", "gaussian")
    _assert_within(bilateral_filter(_t(x), 5, 20, 20),
                   jax.jit(jbilateral, static_argnums=(1, 2, 3))(x, 5, 20, 20), *BILATERAL_TOL)


# ---------------------------------------------------------------------------
# the noise classifier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("noise", synth.PORTRAIT_NOISE)
@pytest.mark.parametrize("size", sorted(SIZES))
def test_kurtosis_value_and_branch(size, noise):
    x, _ = _portrait(size, noise)
    k_ref = float(jface.noise_kurtosis(x))
    k = float(face.noise_kurtosis(x, device="cpu"))
    assert abs(k - k_ref) <= KURTOSIS_RTOL * abs(k_ref), (k, k_ref)
    assert abs(k_ref - 5.0) > 1.0          # away from the threshold
    assert face.classify_noise_type(x, device="cpu") == jface.classify_noise_type(x) == noise
    gray = color.rgb_to_gray(_t(x))
    assert abs(float(face.noise_kurtosis(gray)) - k) <= 1e-6 * k


# ---------------------------------------------------------------------------
# the blends, against the value inside tpuimage's jitted programs
# ---------------------------------------------------------------------------

def _pre_copy(rgb, noise_type):
    """tpuimage's face_pre_eyes, line for line, also returning the glamour
    bilateral's output (``smooth``)."""
    if noise_type == "gaussian":
        light, strong = jgauss(rgb, ksize=5), jgauss(rgb, ksize=9)
    elif noise_type == "impulse":
        light, strong = jmedian(rgb, 3), jmedian(rgb, 5)
    else:
        light, strong = jnlm(rgb, 10.0, 10.0), jnlm(rgb, 30.0, 30.0)
    mask = jface.get_refined_skin_mask(light)
    combined = jface.blend_masked(light, strong, mask)
    smooth = jbilateral(combined, -1, jface.BILATERAL_SIGMA_COLOR, jface.BILATERAL_SIGMA_SPACE)
    skin = jface.blend_masked(smooth, combined, mask)
    return {"denoised_light": light, "denoised_strong": strong, "skin_mask": mask,
            "denoised_combined": combined, "skin_enhanced": skin, "smooth": smooth}


NOISE_CASES = {"gaussian": ("96x128", "gaussian"), "impulse": ("96x128", "impulse"),
               "nlm": ("61x97", "gaussian")}


@functools.lru_cache(maxsize=None)
def _tpuimage_pre(noise_type: str):
    x, _ = _portrait(*NOISE_CASES[noise_type])
    ref = {k: np.array(v) for k, v in jface.face_pre_eyes(x, noise_type=noise_type).items()}
    return x, ref


@pytest.mark.parametrize("noise_type", sorted(NOISE_CASES))
def test_blends_in_face_pre_eyes(noise_type):
    """Both blends of face_pre_eyes (the denoisers' mix and the glamour
    blend) on the values tpuimage's program blends: exact."""
    x, ref = _tpuimage_pre(noise_type)
    c = {k: np.asarray(v) for k, v in
         jax.jit(_pre_copy, static_argnums=1)(x, noise_type).items()}
    for k in ref:
        _exact(c[k], ref[k])
    _exact(face.blend_masked(_t(c["denoised_light"]), _t(c["denoised_strong"]),
                             _t(c["skin_mask"])), c["denoised_combined"])
    _exact(face.blend_masked(_t(c["smooth"]), _t(c["denoised_combined"]), _t(c["skin_mask"])),
           c["skin_enhanced"])


def _sharpening_copy(rgb, mask, noise_type):
    """tpuimage's face_post_eyes script tail up to its masked sharpening,
    returning the output and the sharpening's two inputs."""
    x = jface.adjust_saturation(rgb, jface.COLOR_SATURATION)
    x = jface.apply_warmth(x, 15.0)
    if noise_type == "gaussian":
        x = jface.apply_histogram_equalization(x)
        x = jbilateral(x, 5, 20, 20)
    else:
        x = jface.apply_contrast_stretching(x)
    fg = jface.enhance_details(x, amount=jface.SHARPEN_AMOUNT)
    bg = jface.enhance_details(x, amount=jface.SHARPEN_AMOUNT * 0.5)
    return jface.blend_masked(fg, bg, mask), fg, bg


@pytest.mark.parametrize("noise_type", ["gaussian", "nlm"])
def test_blend_in_face_post_eyes(noise_type):
    """The masked sharpening's blend (gaussian and legacy script tails):
    exact on the values tpuimage's program blends."""
    _, ref = _tpuimage_pre(noise_type)
    skin, mask = ref["skin_enhanced"], ref["skin_mask"]
    out, fg, bg = jax.jit(_sharpening_copy, static_argnums=2)(skin, mask, noise_type)
    _exact(out, jface.face_post_eyes(skin, mask, noise_type=noise_type, variant="script"))
    _exact(face.blend_masked(_t(fg), _t(bg), _t(mask)), out)


def _eye_copy(roi):
    """tpuimage's _eye_roi_enhance, line for line, returning the output, the
    median (r), the detailed image (enh), the ellipse and its blur."""
    h, w = roi.shape[0], roi.shape[1]
    r = jmedian(roi, 3)
    lab = jcolor.rgb_to_lab(r)
    lum = jhist.clahe(lab[..., 0], clip_limit=0.2, tiles_x=4, tiles_y=4)
    enh = jcolor.lab_to_rgb(jnp.concatenate([lum[..., None], lab[..., 1:]], axis=-1))
    enh = jface.enhance_details(enh, amount=0.5)
    ys = jnp.arange(h, dtype=jnp.float32)[:, None] - (h // 2)
    xs = jnp.arange(w, dtype=jnp.float32)[None, :] - (w // 2)
    ax, ay = max(w // 2, 1), max(h // 2, 1)
    inside = (xs / ax) ** 2 + (ys / ay) ** 2 <= 1.0
    mask = jnp.where(inside, jnp.uint8(255), jnp.uint8(0))
    soft = jgauss(mask, ksize=31, sigma=0.0)
    alpha = (jf32(soft) / 255.0 * 0.1)[..., None]
    out = jtrunc_u8(jf32(enh) * alpha + jf32(r) * (1.0 - alpha))
    return out, r, enh, mask, soft


EYE_SHAPES = [(31, 45), (61, 33)]      # (h, w)


@pytest.mark.parametrize("shape", EYE_SHAPES)
def test_eye_ellipse_and_blend_in_eye_roi_enhance(shape):
    """The ellipse and the alpha blend on the values tpuimage's
    _eye_roi_enhance computes: exact. A copy that returns r, enh and the
    ellipse at once compiles to another program (whose output differs
    from tpuimage's), so r, enh and the ellipse each come from a copy that
    returns them beside the output, each output checked equal to
    tpuimage's."""
    h, w = shape
    img, _ = synth.portrait(8, 400, 300)
    roi = np.ascontiguousarray(img[130:130 + h, 100:100 + w])
    ref = np.asarray(jface._eye_roi_enhance(roi))
    parts = {}
    for names, idx in ((("r",), (1,)), (("enh",), (2,)), (("mask", "soft"), (3, 4))):
        out, *vs = jax.jit(lambda x, idx=idx: (_eye_copy(x)[0],)
                           + tuple(_eye_copy(x)[i] for i in idx))(roi)
        _exact(out, ref)
        parts.update({n: np.asarray(v) for n, v in zip(names, vs)})
    _exact(face.eye_ellipse(h, w), parts["mask"])
    _exact(gaussian_blur_u8(face.eye_ellipse(h, w), ksize=31), parts["soft"])
    _exact(face.eye_blend(_t(parts["enh"]), _t(parts["r"]), _t(parts["soft"])), ref)


# ---------------------------------------------------------------------------
# stages, each on tpuimage's previous stage
# ---------------------------------------------------------------------------

def test_skin_mask_exact():
    x, ref = _tpuimage_pre("gaussian")
    mask = face.get_refined_skin_mask(_t(ref["denoised_light"]))
    _exact(mask, jax.jit(jface.get_refined_skin_mask)(ref["denoised_light"]))
    assert 0.1 < float((mask > 128).float().mean()) < 0.6       # the face and neck


@pytest.mark.parametrize("noise_type", sorted(NOISE_CASES))
def test_pre_eyes_stages_on_tpuimage_previous_stage(noise_type):
    x, ref = _tpuimage_pre(noise_type)
    pre = face.face_pre_eyes(_t(x), noise_type)
    if noise_type == "nlm":
        for k in ("denoised_light", "denoised_strong"):
            _assert_within(pre[k], ref[k], *BILATERAL_TOL)
    else:
        for k in ("denoised_light", "denoised_strong"):
            _exact(pre[k], ref[k])
    _exact(face.get_refined_skin_mask(_t(ref["denoised_light"])), ref["skin_mask"])
    _exact(face.blend_masked(_t(ref["denoised_light"]), _t(ref["denoised_strong"]),
                             _t(ref["skin_mask"])), ref["denoised_combined"])
    _assert_within(face.apply_glamour_skin(_t(ref["denoised_combined"]), _t(ref["skin_mask"])),
                   ref["skin_enhanced"], *BILATERAL_TOL)


@pytest.mark.parametrize("noise_type", sorted(NOISE_CASES))
def test_face_pre_eyes_whole(noise_type):
    x, ref = _tpuimage_pre(noise_type)
    pre = face.face_pre_eyes(x, noise_type, device="cpu")
    assert set(pre) == set(ref)
    for k in ("skin_mask", "denoised_combined", "skin_enhanced"):
        _assert_within(pre[k], ref[k], *BILATERAL_TOL)


def test_post_eyes_stages_on_tpuimage_previous_stage():
    """The gaussian tails' stages: saturation and warmth exact, CLAHE 0.5
    within PATH_TOL, the d 5 bilateral within its contract, the masked
    sharpening exact."""
    _, ref = _tpuimage_pre("gaussian")
    skin, mask = ref["skin_enhanced"], ref["skin_mask"]
    s1 = np.asarray(jax.jit(jface.adjust_saturation, static_argnums=1)(skin, 1.2))
    _exact(face.adjust_saturation(_t(skin), 1.2), s1)
    s2 = np.asarray(jax.jit(jface.apply_warmth, static_argnums=1)(s1, 15.0))
    _exact(face.apply_warmth(_t(s1), 15.0), s2)
    s3 = np.asarray(jax.jit(jface.apply_histogram_equalization)(s2))
    _assert_within(face.apply_histogram_equalization(_t(s2)), s3, *PATH_TOL)
    s4 = np.asarray(jax.jit(jbilateral, static_argnums=(1, 2, 3))(s3, 5, 20, 20))
    _assert_within(bilateral_filter(_t(s3), 5, 20, 20), s4, *BILATERAL_TOL)
    s5 = jax.jit(jface.apply_masked_sharpening, static_argnums=2)(s4, mask, 2.0)
    _exact(face.apply_masked_sharpening(_t(s4), _t(mask), 2.0), s5)
    s6 = jax.jit(jface.apply_contrast_stretching)(s2)
    _exact(face.apply_contrast_stretching(_t(s2)), s6)
    # the script tail from tpuimage's CLAHE output: its extra levels are the CLAHE's ties
    tail = face.apply_masked_sharpening(bilateral_filter(_t(s3), 5, 20, 20), _t(mask), 2.0)
    _assert_within(tail, jface.face_post_eyes(skin, mask, "gaussian", "script"), *PATH_TOL)


@pytest.mark.parametrize("variant", face.VARIANTS)
@pytest.mark.parametrize("noise_type", ["gaussian", "impulse"])
def test_face_post_eyes_both_tails(noise_type, variant):
    _, ref = _tpuimage_pre(noise_type)
    skin, mask = ref["skin_enhanced"], ref["skin_mask"]
    ours = face.face_post_eyes(skin, mask, noise_type, variant, device="cpu")
    tol = FACE_SCRIPT_TOL if (noise_type, variant) == ("gaussian", "script") else PATH_TOL
    _assert_within(ours, jface.face_post_eyes(skin, mask, noise_type=noise_type,
                                              variant=variant), *tol)


def test_face_post_eyes_legacy_tail():
    _, ref = _tpuimage_pre("nlm")
    skin, mask = ref["skin_enhanced"], ref["skin_mask"]
    for variant in face.VARIANTS:
        _assert_within(face.face_post_eyes(_t(skin), _t(mask), "nlm", variant),
                       jface.face_post_eyes(skin, mask, noise_type="nlm", variant=variant),
                       *PATH_TOL)
    with pytest.raises(ValueError, match="variant"):
        face.face_post_eyes(_t(skin), _t(mask), "gaussian", "app")


# ---------------------------------------------------------------------------
# the eye pop
# ---------------------------------------------------------------------------

def test_eye_roi_clahe_within_contract():
    """CLAHE 0.2 at 4x4 tiles on the L of median-filtered eye regions of
    31-61 px (sizes no multiple of 4: the padded geometry): max 1 on < 1%
    of pixels against tpuimage, and summed over the regions no further
    from cv2 than tpuimage is."""
    cv2 = pytest.importorskip("cv2")
    img, eyes = synth.portrait(7, 400, 300)
    rng = np.random.default_rng(1)
    far = {"port": 0, "tpuimage": 0}
    for i in range(4):
        h, w = int(rng.integers(31, 62)), int(rng.integers(15, 31)) * 2 + 1
        ex, ey, ew, eh = eyes[i % 2]
        y0, x0 = max(ey + eh // 2 - h // 2, 0), max(ex + ew // 2 - w // 2, 0)
        r = np.asarray(jmedian(img[y0:y0 + h, x0:x0 + w], 3))
        lum = np.ascontiguousarray(np.asarray(jcolor.rgb_to_lab(r))[..., 0])
        ours = histogram.clahe(_t(lum), 0.2, 4, 4).numpy()
        ref = np.asarray(jax.jit(lambda v: jhist.clahe(v, 0.2, 4, 4))(lum))
        _assert_within(ours, ref, 1, 0.01)
        want = cv2.createCLAHE(0.2, (4, 4)).apply(lum)
        far["port"] += int((ours != want).sum())
        far["tpuimage"] += int((ref != want).sum())
    assert far["port"] <= far["tpuimage"], far


@pytest.mark.parametrize("case", ["detected", "empty", "edge", "overlap"])
def test_pixel_pop_eyes_matches_tpuimage(case):
    """The synth eye boxes; an empty box beside them; boxes cut by the
    image's right and bottom edges; two overlapping boxes (the second sees
    the first's output)."""
    img, eyes = synth.portrait(9, 320, 240)
    eyes = list(eyes)
    if case == "empty":
        eyes = [(10, 10, 0, 35)] + eyes
    elif case == "edge":
        eyes = [(240 - 33, 100, 50, 40), (60, 320 - 35, 44, 60)]
    elif case == "overlap":
        x, y, w, h = eyes[0]
        eyes = [(x - 8, y - 6, w + 16, h + 12), (x + 4, y, w + 16, h + 12)]
    ours = face.pixel_pop_eyes(img, eyes, device="cpu")
    ref = jface.pixel_pop_eyes(img, eyes)
    _assert_within(ours, ref, 1, 0.005)
    assert (ours.numpy() != img).any()


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", face.VARIANTS)
@pytest.mark.parametrize("noise", synth.PORTRAIT_NOISE)
def test_enhance_face_whole(noise, variant):
    """Noise classified, the synth eye boxes given: every output against
    tpuimage's enhance_face."""
    img, eyes = synth.portrait(4, 160, 120, noise=noise)
    ours = face.enhance_face(img, eyes=list(eyes), variant=variant, device="cpu")
    ref = jface.enhance_face(img, eyes=list(eyes), variant=variant)
    assert set(ours) == set(ref)
    assert ours["noise_type"] == ref["noise_type"] == noise and ours["eyes"] == ref["eyes"]
    for k in ("skin_mask", "skin_enhanced", "features_popped"):
        _assert_within(ours[k], ref[k], *BILATERAL_TOL)
    tol = FACE_SCRIPT_TOL if (noise, variant) == ("gaussian", "script") else PATH_TOL
    _assert_within(ours["final"], ref["final"], *tol)


def test_enhance_face_detects_the_eyes():
    """eyes=None: the port's Haar detector on the host finds the boxes
    tpuimage's finds (one of the portrait's eyes at this size)."""
    img, _ = synth.portrait(3, 480, 320)
    ours = face.enhance_face(img, noise_type="impulse", variant="gui", device="cpu")
    ref = jface.enhance_face(img, noise_type="impulse", variant="gui")
    assert ours["eyes"] == ref["eyes"] and len(ours["eyes"]) >= 1
    _assert_within(ours["features_popped"], ref["features_popped"], *BILATERAL_TOL)


def test_enhance_face_runs_on_the_card_unless_asked(monkeypatch):
    x, eyes = synth.portrait(2, 64, 48)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        face.enhance_face(x, eyes=[])
    out = face.enhance_face(x, eyes=list(eyes), device="cpu")
    assert out["final"].device.type == "cpu" and out["final"].shape == x.shape
    again = face.enhance_face(_t(x), eyes=list(eyes))
    assert torch.equal(again["final"], out["final"])


def test_portrait():
    """Seeded; a skin area inside the YCrCb box; boxes on darker eyes."""
    x, eyes = synth.portrait(3, 200, 150)
    y, _ = synth.portrait(3, 200, 150)
    np.testing.assert_array_equal(x, y)
    assert x.shape == (200, 150, 3) and x.dtype == np.uint8 and len(eyes) == 2
    (x0, y0, w0, h0), (x1, y1, w1, h1) = eyes
    assert x0 < x1 and y0 == y1 and (w0, h0) == (w1, h1)
    gray = color.rgb_to_gray(_t(x)).float()
    cheek = gray[y0 + h0:y0 + 3 * h0, x0:x0 + w0].mean()
    assert float(gray[y0:y0 + h0, x0:x0 + w0].min()) < float(cheek) - 60    # the pupils
    with pytest.raises(ValueError, match="noise"):
        synth.portrait(3, 20, 20, noise="speckle")
