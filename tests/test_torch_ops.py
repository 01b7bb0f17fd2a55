"""Parity of tpuimage_torch's ops with tpuimage's (JAX on the CPU).

Every input is made from a seed with numpy and goes through the tpuimage
function and its tpuimage_torch counterpart. Integer ops must agree
exactly (max |diff| 0); the float bilinear ops (warp, rotation,
fractional INTER_AREA) within the README's float contract: max |diff| <= 1
on < 0.5% of pixels.
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpuimage.core import borders as jborders
from tpuimage.core import dtypes as jdtypes
from tpuimage.ops import arith as jarith
from tpuimage.ops import color as jcolor
from tpuimage.ops import edges as jedges
from tpuimage.ops import filters as jfilters
from tpuimage.ops import geometry as jgeom
from tpuimage.ops import histogram as jhist
from tpuimage.ops import hough as jhough
from tpuimage.ops import morphology as jmorph
from tpuimage.ops import threshold as jthresh

from tpuimage_torch.core import borders, dtypes
from tpuimage_torch.ops import (arith, color, edges, filters, geometry,
                                histogram, hough, morphology, threshold)

# one intra-op thread: pytest-xdist runs several workers side by side, and
# PyTorch's default of one spinning thread per core each slows every
# worker many times over
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return np.asarray(a)


def _jit(fn, *args, **static):
    """Run a tpuimage function under jit with its static arguments bound
    (op-by-op eager dispatch of the unrolled filters is slow on the CPU)."""
    return np.asarray(jax.jit(functools.partial(fn, **static))(*args))


def _smooth_image(rng, h, w, scale=8):
    """uint8 image with structure (smoothed noise + steps) so that edges,
    thresholds and extremes are not trivial."""
    g = rng.random((h // scale + 2, w // scale + 2)) * 255
    yy = np.linspace(0, g.shape[0] - 1.001, h)
    xx = np.linspace(0, g.shape[1] - 1.001, w)
    y0, x0 = yy.astype(int), xx.astype(int)
    fy, fx = (yy - y0)[:, None], (xx - x0)[None, :]
    img = (g[y0][:, x0] * (1 - fx) * (1 - fy) + g[y0][:, x0 + 1] * fx * (1 - fy)
           + g[y0 + 1][:, x0] * (1 - fx) * fy + g[y0 + 1][:, x0 + 1] * fx * fy)
    img = img + rng.normal(0, 6, size=(h, w))
    img[h // 3: h // 2, w // 4: w // 2] = 20
    return np.clip(img, 0, 255).astype(np.uint8)


def _assert_float_contract(a, b):
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.005, (diff > 0).mean()


# ---------------------------------------------------------------------------
# core
# ---------------------------------------------------------------------------

def test_saturate_trunc_descale(rng):
    x = np.concatenate([rng.uniform(-20, 280, 1000),
                        np.arange(-3, 260) + 0.5]).astype(np.float32)
    np.testing.assert_array_equal(dtypes.saturate_u8(_t(x)).numpy(),
                                  _j(jdtypes.saturate_u8(jnp.asarray(x))))
    np.testing.assert_array_equal(dtypes.trunc_u8(_t(x)).numpy(),
                                  _j(jdtypes.trunc_u8(jnp.asarray(x))))
    xi = rng.integers(-(1 << 20), 1 << 20, 1000).astype(np.int32)
    for n in (1, 8, 15):
        np.testing.assert_array_equal(dtypes.descale(_t(xi), n).numpy(),
                                      _j(jdtypes.descale(jnp.asarray(xi), n)))


@pytest.mark.parametrize("mode", ["reflect", "edge", "constant"])
def test_pad2d(rng, mode):
    img = rng.integers(0, 256, (7, 5), dtype=np.uint8)
    for pads in [(1, 1, 1, 1), (3, 0, 2, 4), (9, 11, 6, 13)]:
        ours = borders.pad2d(_t(img), *pads, mode=mode, value=7).numpy()
        ref = _j(jborders.pad2d(jnp.asarray(img), *pads, mode=mode, value=7))
        np.testing.assert_array_equal(ours, ref)
    batch = rng.integers(0, 256, (3, 7, 5), dtype=np.uint8)
    ours = borders.pad2d(_t(batch), 2, 3, 4, 1, mode=mode).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            ours[i], _j(jborders.pad2d(jnp.asarray(batch[i]), 2, 3, 4, 1, mode=mode)))


# ---------------------------------------------------------------------------
# color, arith
# ---------------------------------------------------------------------------

def test_rgb_to_gray(rng):
    rgb = rng.integers(0, 256, (2, 33, 47, 3), dtype=np.uint8)
    np.testing.assert_array_equal(color.rgb_to_gray(_t(rgb)).numpy(),
                                  _j(jcolor.rgb_to_gray(jnp.asarray(rgb))))


def test_subtract_max_u8(rng):
    a = rng.integers(0, 256, (40, 50), dtype=np.uint8)
    b = rng.integers(0, 256, (40, 50), dtype=np.uint8)
    np.testing.assert_array_equal(arith.subtract_u8(_t(a), _t(b)).numpy(),
                                  _j(jarith.subtract_u8(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(arith.max_u8(_t(a), _t(b)).numpy(),
                                  _j(jarith.max_u8(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("scale", [255, 1])
def test_divide_u8_full_domain(scale):
    a, b = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8))
    np.testing.assert_array_equal(
        arith.divide_u8(_t(a), _t(b), scale=scale).numpy(),
        _j(jarith.divide_u8(jnp.asarray(a), jnp.asarray(b), scale=scale)))
    with pytest.raises(NotImplementedError):
        arith.divide_u8(_t(a), _t(b), scale=2.5)


def test_normalize_minmax_per_plane(rng):
    """Against the program tpuimage runs: its ops under jax.jit, where XLA
    fuses ``x * scale + offset`` into one multiply-add."""
    imgs = []
    for _ in range(20):
        lo, hi = sorted(rng.integers(0, 256, 2))
        imgs.append(rng.integers(lo, hi + 1, (31, 29)).astype(np.uint8))
    imgs.append(np.full((31, 29), 77, np.uint8))           # constant -> alpha
    batch = np.stack(imgs)
    ours = arith.normalize_minmax(_t(batch)).numpy()
    for i, img in enumerate(imgs):
        np.testing.assert_array_equal(ours[i], _jit(jarith.normalize_minmax, jnp.asarray(img)))
    smin = batch.reshape(len(imgs), -1).min(1).astype(np.float32)
    smax = batch.reshape(len(imgs), -1).max(1).astype(np.float32)
    luts = arith.normalize_minmax_lut(_t(smin), _t(smax)).numpy()
    for i in range(len(imgs)):
        np.testing.assert_array_equal(
            luts[i], _jit(jarith.normalize_minmax_lut, jnp.float32(smin[i]), jnp.float32(smax[i])))
        np.testing.assert_array_equal(luts[i][batch[i]], ours[i])


def _illum_planes(rgb):
    """A photo's gray plane and its divided illumination plane (what
    DocScanner's NORM_MINMAX takes), as tpuimage's XLA ops make them."""
    from tpuimage_torch.pipelines import docscan
    gray = color.rgb_to_gray(_t(rgb)).numpy()
    k = docscan.illum_ksize(*gray.shape, docscan.GUI_DOCUMENT_CONFIG)
    bg = jfilters.gaussian_blur_u8(jnp.asarray(gray), k, impl="xla")
    return np.stack([gray, np.asarray(jarith.divide_u8(jnp.asarray(gray), bg, 255.0))])


def _minmax_input(name):
    from tpuimage_torch import synth
    if name == "A":     # the use-whole photo on which two roundings moved 0.4% of the binary
        return _illum_planes(synth.document_photo(3, 480, 360, with_page=False))
    if name == "B":
        return _illum_planes(synth.page(2, 362, 256, tilt_deg=3.0, rules=4))
    rng = np.random.default_rng(397)
    planes = []
    for _ in range(400):
        lo, hi = sorted(rng.integers(0, 256, 2))
        planes.append(rng.integers(lo, hi + 1, (64, 64)).astype(np.uint8))
    return np.stack(planes)


@pytest.mark.parametrize("name", ["A", "B", "C"])
def test_normalize_minmax_matches_jitted_tpuimage(name):
    """Inputs A (a 480x360 use-whole photo), B (a tilted 362x256 page) and C
    (400 random 64x64 planes with random (min, max)), plane by plane,
    per-pixel form and LUT, exact against jax.jit of tpuimage's ops."""
    planes = _minmax_input(name)
    ours = arith.normalize_minmax(_t(planes)).numpy()
    norm = jax.jit(jarith.normalize_minmax)
    lut_fn = jax.jit(jarith.normalize_minmax_lut)
    flat = planes.reshape(len(planes), -1)
    luts = arith.normalize_minmax_lut(_t(flat.min(1).astype(np.float32)),
                                      _t(flat.max(1).astype(np.float32))).numpy()
    for i, x in enumerate(planes):
        np.testing.assert_array_equal(ours[i], np.asarray(norm(jnp.asarray(x))),
                                      err_msg=f"plane {i}")
        ref_lut = np.asarray(lut_fn(jnp.float32(flat[i].min()), jnp.float32(flat[i].max())))
        np.testing.assert_array_equal(luts[i], ref_lut, err_msg=f"lut {i}")


# ---------------------------------------------------------------------------
# filters, threshold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ksize", [3, 7, 15, 31, 51])
def test_gaussian_tables(ksize):
    np.testing.assert_array_equal(filters.gaussian_kernel_q8(ksize),
                                  jfilters.gaussian_kernel_q8(ksize))
    np.testing.assert_array_equal(filters.get_gaussian_kernel(ksize),
                                  jfilters.get_gaussian_kernel(ksize))


@pytest.mark.parametrize("ksize", [3, 15, 31, 51])
def test_gaussian_blur_u8(rng, ksize):
    img = _smooth_image(rng, 64, 57)
    np.testing.assert_array_equal(
        filters.gaussian_blur_u8(_t(img), ksize=ksize).numpy(),
        _jit(jfilters.gaussian_blur_u8, jnp.asarray(img), ksize=ksize, impl="xla"))


@pytest.mark.parametrize("ksize", [5, 31])
def test_gaussian_blur_f32_bit_exact(rng, ksize):
    """Bit-exact with tpuimage's op order, run op by op. (Under jit, XLA's
    CPU fusion reassociates the taps, so only the cvRounded mean that
    adaptive_threshold uses is compared with the jitted form, below.)"""
    img = _smooth_image(rng, 40, 50).astype(np.float32)
    ours = filters.gaussian_blur_f32(_t(img), ksize=ksize, border="edge").numpy()
    ref = _j(jfilters.gaussian_blur_f32(jnp.asarray(img), ksize=ksize, border="edge"))
    np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))


def test_threshold_binary_and_adaptive(rng):
    img = _smooth_image(rng, 90, 70)
    for t in (-1.0, 0.0, 100.0, 254.5):
        np.testing.assert_array_equal(threshold.threshold_binary(_t(img), t).numpy(),
                                      _j(jthresh.threshold_binary(jnp.asarray(img), t)))
    for bs, c in ((31, 3), (35, 10), (8, 2.5)):
        np.testing.assert_array_equal(
            threshold.adaptive_threshold(_t(img), 255, "gaussian", bs, c).numpy(),
            _jit(jthresh.adaptive_threshold, jnp.asarray(img), max_value=255,
                 method="gaussian", block_size=bs, C=c))


@pytest.mark.parametrize("ksize", [3, 5, 31, 51, 101, 255])
def test_box_filter_u8(rng, ksize):
    """Integer window sums with a replicate border, then the f32 scale and
    cvRound; 51 and up are wider than the 40x37 plane."""
    img = _smooth_image(rng, 40, 37)
    img[:3] = 255
    np.testing.assert_array_equal(
        filters.box_filter_u8(_t(img[None]), ksize).numpy()[0],
        _jit(jfilters.box_filter_u8, jnp.asarray(img), ksize=ksize))


@pytest.mark.parametrize("method", ["gaussian", "mean"])
@pytest.mark.parametrize("inverse", [False, True])
def test_adaptive_threshold_methods(rng, method, inverse):
    img = _smooth_image(rng, 90, 70)
    for bs, c in ((31, 3), (35, 10), (8, 2.5), (15, -2.5), (3, 0.0)):
        np.testing.assert_array_equal(
            threshold.adaptive_threshold(_t(img), 255, method, bs, c, inverse=inverse).numpy(),
            _jit(jthresh.adaptive_threshold, jnp.asarray(img), max_value=255,
                 method=method, block_size=bs, C=c, inverse=inverse),
            err_msg=f"block {bs} C {c}")
    with pytest.raises(ValueError):
        threshold.adaptive_threshold(_t(img), 255, "median", 15, 2.0)


def test_otsu_from_hist(rng):
    hists = [np.bincount(_smooth_image(rng, 60, 50).ravel(), minlength=256)
             for _ in range(10)]
    hists += [np.bincount(rng.integers(0, 256, 5000), minlength=256),
              np.bincount(np.r_[np.zeros(900, int), rng.integers(0, 40, 100)],
                          minlength=256)]
    ours = histogram.otsu_from_hist(_t(np.stack(hists).astype(np.int32))).numpy()
    for i, h in enumerate(hists):
        assert ours[i] == float(_j(jhist.otsu_from_hist(jnp.asarray(h, jnp.int32))))


def test_otsu_takes_the_first_bin_of_a_tie(rng):
    """Two clusters split by empty bins: the between-class variance is the
    same over the whole gap, and the threshold is the gap's first bin (the
    last bin of the lower cluster), as OpenCV's strict ``>`` picks it."""
    hists = np.zeros((3, 256), np.int64)
    for i, (lo, hi) in enumerate(((25, 29), (0, 200), (100, 103))):
        hists[i, max(lo - 15, 0):lo + 1] = rng.integers(50, 5000, lo + 1 - max(lo - 15, 0))
        hists[i, hi:hi + 16] = rng.integers(50, 5000, 16)
    np.testing.assert_array_equal(histogram.otsu_from_hist(_t(hists)).numpy(), [25, 0, 100])


# ---------------------------------------------------------------------------
# morphology
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,ksize", [("rect", (9, 19)), ("rect", (2, 2)),
                                         ("rect", (3, 3)), ("ellipse", (7, 5)),
                                         ("cross", (5, 5))])
def test_morphology(rng, shape, ksize):
    se = morphology.structuring_element(shape, ksize)
    np.testing.assert_array_equal(se, jmorph.structuring_element(shape, ksize))
    img = _smooth_image(rng, 50, 61)
    j = jnp.asarray(img)
    for ours, ref in [(morphology.erode(_t(img), se, 2),
                       _jit(jmorph.erode, j, se=se, iterations=2)),
                      (morphology.dilate(_t(img), se, 1), _jit(jmorph.dilate, j, se=se)),
                      (morphology.morph_close(_t(img), se), _jit(jmorph.morph_close, j, se=se)),
                      (morphology.morph_blackhat(_t(img), se),
                       _jit(jmorph.morph_blackhat, j, se=se, impl="xla"))]:
        np.testing.assert_array_equal(ours.numpy(), ref)


# ---------------------------------------------------------------------------
# edges
# ---------------------------------------------------------------------------

def test_sobel(rng):
    img = _smooth_image(rng, 40, 52)
    for d in ((1, 0), (0, 1)):
        np.testing.assert_array_equal(edges.sobel(_t(img), *d).numpy(),
                                      _j(jedges.sobel(jnp.asarray(img), *d)))


@pytest.mark.parametrize("low,high", [(30, 100), (50, 150)])
def test_canny_batch_exact(rng, low, high):
    imgs = np.stack([_smooth_image(rng, 72, 96, scale=s) for s in (4, 8, 16)])
    ours = edges.canny(_t(imgs), low, high).numpy()
    assert ours.any()
    for i in range(len(imgs)):
        np.testing.assert_array_equal(
            ours[i], _jit(jedges.canny, jnp.asarray(imgs[i]), low=low, high=high,
                          impl="dilate"))


# ---------------------------------------------------------------------------
# hough
# ---------------------------------------------------------------------------

def _edge_maps(rng, n, h, w, density):
    return (rng.random((n, h, w)) < density).astype(np.uint8) * 255


def test_compact_edges_keeps_lowest_indices(rng):
    e = _edge_maps(rng, 3, 20, 30, 0.3)
    e[1] = 0
    xs, ys, counts, overflow = hough.compact_edges(_t(e), 50)
    for b in range(3):
        yy, xx = np.nonzero(e[b])
        n = min(len(yy), 50)
        assert int(counts[b]) == n
        assert bool(overflow[b]) == (len(yy) > 50)
        np.testing.assert_array_equal(xs[b, :n].numpy(), xx[:n])
        np.testing.assert_array_equal(ys[b, :n].numpy(), yy[:n])


def _compact_edges_nonzero(edges, k):
    """The compaction's earlier form: torch.nonzero and index scatters."""
    b, h, w = edges.shape
    flat = edges.reshape(b, h * w) > 0
    true_counts = flat.sum(dim=1)
    counts = torch.clamp(true_counts, max=k)
    kk = max(int(counts.max()) if b else 0, 1)
    rows, idx = torch.nonzero(flat, as_tuple=True)
    starts = torch.cumsum(true_counts, 0) - true_counts
    pos = torch.arange(rows.shape[0]) - starts[rows]
    keep = pos < k
    rows, idx, pos = rows[keep], idx[keep], pos[keep]
    xs = torch.zeros((b, kk), dtype=torch.int32)
    ys = torch.zeros((b, kk), dtype=torch.int32)
    xs[rows, pos] = (idx % w).to(torch.int32)
    ys[rows, pos] = torch.div(idx, w, rounding_mode="floor").to(torch.int32)
    return xs, ys, counts.to(torch.int32), true_counts > k


@pytest.mark.parametrize("p", [0, 1, 1000, 1024, 3 * 1024 + 5])
def test_exclusive_rank_equals_cumsum(rng, p):
    flat = _t(rng.random((3, p)) < 0.4)
    rank, counts = hough.exclusive_rank(flat)
    ref = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat.to(torch.int32)
    assert rank.dtype == torch.int32 and rank.shape == (3, p)
    np.testing.assert_array_equal(rank.numpy(), ref.numpy())
    np.testing.assert_array_equal(counts.numpy(), flat.sum(dim=1).numpy())


@pytest.mark.parametrize("density", [0.02, 0.3])
@pytest.mark.parametrize("k", [7, 150, 10 ** 6])
def test_compact_edges_equals_nonzero_form(rng, density, k):
    """rank_extract's form gives the same widths, slots, zeros past each
    count, counts and overflow flags as the nonzero form."""
    e = _edge_maps(rng, 4, 23, 41, density)
    e[2] = 0
    e[3, :, :5] = 255
    ours = hough.compact_edges(_t(e), k)
    for a, b in zip(ours, _compact_edges_nonzero(_t(e), k)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.is_contiguous()
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("max_edges", [0, 200])
def test_hough_accumulator_and_overflow(rng, max_edges):
    e = _edge_maps(rng, 2, 41, 57, 0.1)
    acc, overflow = hough.hough_accumulator(_t(e), max_edges=max_edges)
    for b in range(2):
        ra, ro = jhough.hough_accumulator(jnp.asarray(e[b]), impl="xla",
                                          max_edges=max_edges, return_overflow=True)
        np.testing.assert_array_equal(acc[b].numpy(), _j(ra))
        assert bool(overflow[b]) == bool(ro)


def test_fold_median_and_lines(rng):
    # sparse edge maps with a few strong straight lines: real peaks
    e = _edge_maps(rng, 3, 90, 120, 0.01)
    e[0, 30, 5:115] = 255
    e[1, np.arange(5, 85), np.arange(10, 90)] = 255
    e[2, 10:80, 60] = 255
    e[2, 40, 10:110] = 255
    ang, _ = hough.hough_fold_median_angle(_t(e), threshold=40)
    lines, ok = hough.hough_lines(_t(e), threshold=30, max_lines=16)
    segs, sok = hough.hough_lines_p_det(_t(e), threshold=30, min_line_length=40.0,
                                        max_lines=16)
    for b in range(3):
        j = jnp.asarray(e[b])
        assert float(ang[b]) == float(_jit(jhough.hough_fold_median_angle, j, threshold=40))
        jl, jok = jax.jit(functools.partial(jhough.hough_lines, threshold=30,
                                            max_lines=16))(j)
        np.testing.assert_array_equal(ok[b].numpy(), _j(jok))
        np.testing.assert_array_equal(lines[b].numpy(), _j(jl))
        js, jsok = jax.jit(functools.partial(
            jhough.hough_lines_p_det, threshold=30, min_line_length=40.0,
            max_lines=16))(j)
        np.testing.assert_array_equal(sok[b].numpy(), _j(jsok))
        m = _j(jsok)
        np.testing.assert_allclose(segs[b].numpy()[m], _j(js)[m], atol=1e-3, rtol=0)
    assert ok.any() and sok.any()


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,out", [((64, 48, 3), (32, 24)),     # integer
                                       ((240, 320, 3), (192, 256)),  # fractional
                                       ((97, 61), (40, 33)),        # fractional
                                       ((30, 20, 3), (45, 30))])    # upscale
def test_resize_area(rng, shape, out):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    ours = geometry.resize(_t(img), *out, "area").numpy()
    ref = _jit(jgeom.resize, jnp.asarray(img), out_h=out[0], out_w=out[1],
               interpolation="area")
    if shape[0] % out[0] == 0 and shape[1] % out[1] == 0:
        np.testing.assert_array_equal(ours, ref)
    else:
        _assert_float_contract(ours, ref)
    big = rng.integers(0, 256, (300, 200, 3), dtype=np.uint8)
    _assert_float_contract(geometry.resize_long_side(_t(big), 256).numpy(),
                           _j(jgeom.resize_long_side(jnp.asarray(big), 256)))


def test_warp_perspective_batch(rng):
    imgs = rng.integers(0, 256, (2, 120, 90, 3), dtype=np.uint8)
    dst = np.array([[0, 0], [63, 0], [63, 89], [0, 89]], np.float32)
    minvs = []
    for _ in range(2):
        quad = np.array([[5, 4], [84, 8], [86, 115], [3, 110]], np.float32) \
            + rng.uniform(-3, 3, (4, 2)).astype(np.float32)
        M = geometry.get_perspective_transform(quad, dst)
        np.testing.assert_array_equal(M, jgeom.get_perspective_transform(quad, dst))
        minvs.append(np.linalg.inv(M))
    minvs = np.stack(minvs).astype(np.float32)
    ours = geometry.warp_perspective_batch(_t(imgs), _t(minvs), 90, 64).numpy()
    ref = _j(jgeom.warp_perspective_batch(jnp.asarray(imgs), jnp.asarray(minvs), 90, 64))
    _assert_float_contract(ours, ref)


@pytest.mark.parametrize("angle", [3.5, -7.25, 0.5])
def test_rotate_pages_matches_rotate_traced_tiled(rng, angle):
    img = (_smooth_image(rng, 120, 85) > 128).astype(np.uint8) * 255
    ours = geometry.rotate_pages(_t(img[None]), _t(np.float32([angle])), 10.0).numpy()[0]
    ref = _jit(jgeom.rotate_traced_tiled, jnp.asarray(img), jnp.float32(angle),
               max_angle=10.0)
    _assert_float_contract(ours, ref)
