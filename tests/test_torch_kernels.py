"""The hand-written kernels of tpuimage_torch (``ops.kernels``).

On the CPU each wrapper takes its plain PyTorch version; those are held
here against tpuimage's references exactly (max |diff| 0): the Pallas
kernels run in interpret mode and the XLA / scatter paths, as tpuimage's
own tests run them. The CUDA kernels themselves run only on the card:
``tests/test_torch_cuda.py`` compares them with the plain versions there.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpuimage.ops import color as jcolor
from tpuimage.ops import histogram as jhist
from tpuimage.ops import hough as jhough
from tpuimage.ops.pallas_kernels import (binary_close3_pallas, blackhat_rect_pallas,
                                         clahe_apply_pallas, gauss_chain_pallas,
                                         gaussian_blur_u8_pallas, gray_erode3_pallas,
                                         hist256_batch_pallas, inkmask_weighted_pallas,
                                         rank_extract_pallas, rgb_to_lab_pallas)

from tpuimage_torch import synth
from tpuimage_torch.ops import color, histogram, hough, kernels

# one intra-op thread: pytest-xdist runs several workers side by side, and
# PyTorch's default of one spinning thread per core each slows every
# worker many times over
torch.set_num_threads(1)


def _planes(rng, n):
    """Histogram inputs like DocScanner's: nearly one-valued (sub_raw and
    blackhat planes are mostly 0), random, and constant."""
    sparse = np.zeros(n, np.uint8)
    hit = rng.random(n) < 0.03
    sparse[hit] = rng.integers(1, 256, hit.sum())
    return np.stack([sparse, rng.integers(0, 256, n, dtype=np.uint8),
                     np.full(n, 255, np.uint8), np.zeros(n, np.uint8)])


@pytest.mark.parametrize("n", [4096, 1003])   # a multiple of 16, and not
def test_hist256_ref_matches_pallas_and_scatter(rng, n):
    planes = _planes(rng, n)
    ours = kernels.hist256_batch(torch.from_numpy(planes)).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(hist256_batch_pallas(jnp.asarray(planes), interpret=True)))
    for i, p in enumerate(planes):
        ref = np.asarray(jhist.hist256(jnp.asarray(p), impl="scatter"))
        np.testing.assert_array_equal(ours[i], ref)
        np.testing.assert_array_equal(histogram.hist256(torch.from_numpy(p)).numpy(), ref)
    assert ours.dtype == np.int32 and (ours.sum(1) == n).all()


def _accumulate(edges):
    """tpuimage_torch's vote path over a (B, H, W) stack (compaction +
    the hough_votes wrapper)."""
    acc = hough.hough_accumulator(torch.from_numpy(edges))
    return acc.numpy()


@pytest.mark.parametrize("shape,density", [((59, 83), 0.02), ((59, 83), 0.15),
                                           ((240, 320), 0.10)])
def test_hough_votes_ref_matches_xla_and_pallas(rng, shape, density):
    edges = (rng.random((2,) + shape) < density).astype(np.uint8) * 255
    ours = _accumulate(edges)
    assert ours.shape == (2, (shape[0] + shape[1]) * 2 + 1, 180)
    for b in range(2):
        e = jnp.asarray(edges[b])
        np.testing.assert_array_equal(
            ours[b], np.asarray(jhough.hough_accumulator(e, impl="xla")))
        np.testing.assert_array_equal(
            ours[b], np.asarray(jhough.hough_accumulator(e, impl="pallas")))


def test_hough_votes_ref_on_a4_page_coordinates(rng):
    """The rho rounding at the page scale: every bin of an A4-sized edge
    map at 5% density against tpuimage's XLA path."""
    edges = (rng.random((1, 1200, 849)) < 0.05).astype(np.uint8) * 255
    ours = _accumulate(edges)
    np.testing.assert_array_equal(
        ours[0], np.asarray(jhough.hough_accumulator(jnp.asarray(edges[0]), impl="xla")))


def test_hough_votes_counts_cap_the_list(rng):
    xs = torch.from_numpy(rng.integers(0, 50, (3, 40)).astype(np.int32))
    ys = torch.from_numpy(rng.integers(0, 30, (3, 40)).astype(np.int32))
    cos_np, sin_np = hough.hough_tables()
    cos_t, sin_t = torch.from_numpy(cos_np), torch.from_numpy(sin_np)
    numrho = (50 + 30) * 2 + 1
    counts = torch.tensor([0, 17, 40], dtype=torch.int32)
    acc = kernels.hough_votes(xs, ys, counts, cos_t, sin_t, numrho, 80)
    np.testing.assert_array_equal(acc.sum(dim=1).numpy(),
                                  np.repeat([[0], [17], [40]], 180, axis=1))
    full = kernels.hough_votes(xs[1:2, :17].contiguous(), ys[1:2, :17].contiguous(),
                               counts[1:2], cos_t, sin_t, numrho, 80)
    np.testing.assert_array_equal(acc[1].numpy(), full[0].numpy())


def test_wrappers_check_inputs_and_count_only_launches():
    kernels.reset_launch_counts()
    x = torch.zeros((2, 64), dtype=torch.uint8)
    kernels.hist256_batch(x)
    rgb = torch.zeros((1, 8, 12, 3), dtype=torch.uint8)
    kernels.rgb_to_lab(rgb, color.lab_tables_on(rgb.device))
    gray, eroded = kernels.gray_erode3(rgb)
    kernels.binary_close3(eroded, torch.zeros(1))
    kernels.clahe_apply(gray, torch.zeros((1, 2, 2, 256), dtype=torch.uint8),
                        torch.zeros((8, 3)), torch.zeros((12, 3)))
    planes = torch.zeros((2, 9, 11), dtype=torch.uint8)
    kernels.gaussian_blur_u8(planes, 5)
    for mode in kernels.GAUSS_CHAIN_MODES:
        kernels.gauss_chain(planes, 5, mode, 3.0)
    kernels.blackhat_rect(planes, 3, 5)
    t2 = torch.zeros(2)
    kernels.inkmask_weighted(planes, planes, planes, t2, t2, 1)
    # sizes past the tiled forms take the kernels' split forms on a card
    kernels.gaussian_blur_u8(planes, 257)
    kernels.blackhat_rect(planes, 129, 255)
    kernels.inkmask_weighted(planes, planes, planes, t2, t2, 9)
    kernels.divide_table("cpu")
    taps, sw = torch.zeros((1, 2), dtype=torch.int32), torch.ones(1)
    lut3 = kernels.color_weight_table(766, -1e-4, "cpu")
    kernels.bilateral(planes, taps, sw, lut3[:256], 0)
    kernels.bilateral(rgb, taps, sw, lut3, 0)
    rank = torch.zeros((6, 2), dtype=torch.int32)
    kernels.rank_extract(rank, rank > 0, 3)
    strong, weak = kernels.canny_pre(planes, 30, 100)
    kernels.hysteresis_check(strong, weak, torch.zeros(2, dtype=torch.int32), 0)
    assert kernels.launch_counts() == {"hist256": 0, "hough_votes": 0, "rgb_to_lab": 0,
                                       "clahe_apply": 0, "gray_erode3": 0,
                                       "binary_close3": 0, "gaussian_blur_u8": 0,
                                       "gauss_chain": 0, "blackhat_rect": 0,
                                       "inkmask_weighted": 0, "bilateral": 0,
                                       "rank_extract": 0, "canny_pre": 0,
                                       "canny_hysteresis": 0}
    # bilateral: dtype, rank, channels, contiguity, table sizes
    with pytest.raises(TypeError):
        kernels.bilateral(planes.to(torch.int32), taps, sw, lut3, 0)
    with pytest.raises(ValueError):
        kernels.bilateral(planes[0], taps, sw, lut3, 0)
    with pytest.raises(ValueError):
        kernels.bilateral(rgb[..., :2].contiguous(), taps, sw, lut3, 0)
    with pytest.raises(ValueError):
        kernels.bilateral(planes.transpose(1, 2), taps, sw, lut3, 0)
    with pytest.raises(ValueError):
        kernels.bilateral(rgb, taps, sw, lut3[:256], 0)
    with pytest.raises(ValueError):
        kernels.bilateral(planes, taps, torch.ones(2), lut3, 0)
    with pytest.raises(TypeError):
        kernels.bilateral(planes, taps.to(torch.int64), sw, lut3, 0)
    # rank_extract: dtypes and shapes; any strides are taken
    with pytest.raises(TypeError):
        kernels.rank_extract(rank.to(torch.int64), rank > 0, 3)
    with pytest.raises(TypeError):
        kernels.rank_extract(rank, rank.to(torch.uint8), 3)
    with pytest.raises(ValueError):
        kernels.rank_extract(rank, rank[:5] > 0, 3)
    with pytest.raises(ValueError):
        kernels.rank_extract(rank, rank > 0, -1)
    assert kernels.rank_extract(rank.t(), rank.t() >= 0, 2).shape == (2, 6)
    with pytest.raises(TypeError):
        kernels.hist256_batch(x.to(torch.int32))
    with pytest.raises(ValueError):
        kernels.hist256_batch(x[0])
    with pytest.raises(ValueError):
        kernels.hist256_batch(torch.zeros((64, 2), dtype=torch.uint8).t())
    # a tensor that is neither on the CPU nor on a card reaches no plain version
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.hist256_batch(torch.zeros((2, 64), dtype=torch.uint8, device="meta"))
    xs = torch.zeros((1, 4), dtype=torch.int32)
    tab = torch.zeros(180, dtype=torch.float32)
    with pytest.raises(ValueError):
        kernels.hough_votes(xs, torch.zeros((1, 5), dtype=torch.int32),
                            torch.zeros(1, dtype=torch.int32), tab, tab, 11, 5)
    with pytest.raises(TypeError):
        kernels.hough_votes(xs, xs, torch.zeros(1, dtype=torch.int64), tab, tab, 11, 5)
    tables = color.lab_tables_on(rgb.device)
    with pytest.raises(ValueError):
        kernels.rgb_to_lab(rgb[..., :2].contiguous(), tables)
    with pytest.raises(ValueError):
        kernels.rgb_to_lab(rgb.transpose(1, 2), tables)
    with pytest.raises(ValueError):
        kernels.rgb_to_lab(rgb, tables[:-1])
    with pytest.raises(TypeError):
        kernels.gray_erode3(rgb.to(torch.int32))
    with pytest.raises(ValueError):
        kernels.gray_erode3(rgb[0])
    with pytest.raises(ValueError):
        kernels.binary_close3(eroded, torch.zeros(2))
    with pytest.raises(TypeError):
        kernels.binary_close3(eroded, torch.zeros(1, dtype=torch.float64))
    with pytest.raises(ValueError):
        kernels.clahe_apply(gray, torch.zeros((1, 2, 2, 256), dtype=torch.uint8),
                            torch.zeros((8, 2)), torch.zeros((12, 3)))
    # the post-warp chain's wrappers: dtype, rank, contiguity, sizes, modes
    with pytest.raises(TypeError):
        kernels.gaussian_blur_u8(planes.to(torch.int32), 5)
    with pytest.raises(ValueError):
        kernels.gaussian_blur_u8(planes[0], 5)
    with pytest.raises(ValueError):
        kernels.gauss_chain(planes.transpose(1, 2), 5, "sub")
    for bad in (4, 0, -3):
        with pytest.raises(ValueError):
            kernels.gaussian_blur_u8(planes, bad)
    with pytest.raises(ValueError):
        kernels.gauss_chain(planes, 5, "none")
    with pytest.raises(ValueError):
        kernels.blackhat_rect(planes, 2, 5)
    with pytest.raises(ValueError):
        kernels.blackhat_rect(planes, 3, -1)
    with pytest.raises(TypeError):
        kernels.blackhat_rect(planes.to(torch.float32), 3, 5)
    with pytest.raises(ValueError):
        kernels.inkmask_weighted(planes, planes, planes, t2, t2, -1)
    with pytest.raises(ValueError):
        kernels.inkmask_weighted(planes, planes[:, :8].contiguous(), planes, t2, t2, 1)
    with pytest.raises(ValueError):
        kernels.inkmask_weighted(planes, planes, planes, torch.zeros(3), t2, 1)
    with pytest.raises(TypeError):
        kernels.inkmask_weighted(planes, planes, planes, t2.to(torch.int32), t2, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.blackhat_rect(planes.to("meta"), 3, 5)
    assert not any(kernels.launch_counts().values())


# ---------------------------------------------------------------------------
# the night and morph_seq kernels' plain versions against tpuimage's Pallas
# kernels (interpreted) and its XLA paths: exact, except the CLAHE apply
# ---------------------------------------------------------------------------

def test_rgb_to_lab_ref_matches_pallas(rng):
    x = np.concatenate([synth.night_scene(2, 40, 72),
                        rng.integers(0, 256, (40, 72, 3), dtype=np.uint8)])
    ours = kernels.rgb_to_lab_ref(torch.from_numpy(x), color.lab_tables_on(torch.device("cpu")))
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(rgb_to_lab_pallas(jnp.asarray(x), interpret=True)))
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(jcolor.rgb_to_lab(jnp.asarray(x), impl="xla")))


@pytest.mark.parametrize("n_pix", [1, 2, 15, 17, 511, 513, 4107])
def test_rgb_to_lab_ref_on_odd_pixel_counts(rng, n_pix):
    """Pixel counts off the card kernel's runs of 16 and 512 (its tails),
    as (1, n, 3) images: the plain version equals tpuimage's Pallas kernel
    (interpreted, rows padded to its 128-lane bands) and XLA path."""
    x = rng.integers(0, 256, (1, n_pix, 3), dtype=np.uint8)
    ours = kernels.rgb_to_lab_ref(torch.from_numpy(x), color.lab_tables_on(torch.device("cpu")))
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(rgb_to_lab_pallas(jnp.asarray(x), interpret=True)))
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(jcolor.rgb_to_lab(jnp.asarray(x), impl="xla")))


@pytest.mark.parametrize("shape", [(128, 160), (97, 131)])
def test_clahe_apply_ref_matches_pallas(rng, shape):
    """Random u8-valued LUTs and tpuimage's blend matrices: max |diff| <= 1
    on < 0.1% of pixels against clahe_apply_pallas (the f32 blend meets
    cvRound .5 boundaries; XLA contracts into fma where the plain version
    rounds each product)."""
    h, w = shape
    _, _, th, tw = histogram.clahe_geometry(h, w, 8, 8)
    gray = rng.integers(0, 256, shape, dtype=np.uint8)
    luts = np.sort(rng.integers(0, 256, (8, 8, 256)), axis=-1).astype(np.uint8)
    R = jhist.clahe_blend_matrix(h, th, 8)
    C = np.ascontiguousarray(jhist.clahe_blend_matrix(w, tw, 8).T)
    ours = kernels.clahe_apply_ref(torch.from_numpy(gray[None]), torch.from_numpy(luts[None]),
                                   *_tables(h, w, th, tw, 8, 8))[0].numpy()
    ref = np.asarray(clahe_apply_pallas(jnp.asarray(gray), jnp.asarray(luts, jnp.float32),
                                        jnp.asarray(R), jnp.asarray(C), th=th, tw=tw,
                                        interpret=True))
    diff = np.abs(ours.astype(np.int32) - ref)
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, ((diff > 0).sum(), diff.size)


@pytest.mark.parametrize("shape,tiles", [((97, 131), (3, 5)), ((64, 96), (6, 4)),
                                         ((40, 50), (1, 1))], ids=["3x5", "6x4", "1x1"])
def test_clahe_apply_ref_matches_pallas_on_other_grids(rng, shape, tiles):
    """Tile grids other than 8x8 (ty != tx, and one tile) with
    random, non-monotone LUTs, so that a wrong tile pick shows: within the
    same contract as at 8x8 (max |diff| <= 1 on < 0.1% of pixels)."""
    h, w = shape
    ty, tx = tiles
    _, _, th, tw = histogram.clahe_geometry(h, w, tx, ty)
    gray = rng.integers(0, 256, shape, dtype=np.uint8)
    luts = rng.integers(0, 256, (ty, tx, 256), dtype=np.uint8)
    R = jhist.clahe_blend_matrix(h, th, ty)
    C = np.ascontiguousarray(jhist.clahe_blend_matrix(w, tw, tx).T)
    ours = kernels.clahe_apply_ref(torch.from_numpy(gray[None]), torch.from_numpy(luts[None]),
                                   *_tables(h, w, th, tw, ty, tx))[0].numpy()
    ref = np.asarray(clahe_apply_pallas(jnp.asarray(gray), jnp.asarray(luts, jnp.float32),
                                        jnp.asarray(R), jnp.asarray(C), th=th, tw=tw,
                                        interpret=True))
    diff = np.abs(ours.astype(np.int32) - ref)
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, ((diff > 0).sum(), diff.size)


def _tables(h, w, th, tw, ty, tx):
    return (torch.from_numpy(histogram.clahe_blend_table(h, th, ty)),
            torch.from_numpy(histogram.clahe_blend_table(w, tw, tx)))


def test_blend_table_keeps_both_edge_weights():
    """The blend table against tpuimage's blend matrix: inside, the two
    tiles' entries are 1 - a and a; at the borders both tiles are one and
    the table keeps both weights, whose f32 sum is the matrix's one entry."""
    m = jhist.clahe_blend_matrix(100, 13, 8)
    tab = histogram.clahe_blend_table(100, 13, 8)
    t1, t2, a = tab[:, 0].astype(int), tab[:, 1].astype(int), tab[:, 2]
    rows = np.arange(100)
    one = np.float32(1)
    assert (t1[:6] == 0).all() and (t2[:6] == 0).all() and (t2[-6:] == 7).all()
    inside, edge = t1 != t2, t1 == t2
    # rows 0-6 (p / 13 - 0.5 < 0) and 98-99 (>= 7) are at the borders
    assert (t2[inside] == t1[inside] + 1).all() and np.nonzero(edge)[0].tolist() == \
        list(range(7)) + [98, 99]
    np.testing.assert_array_equal(m[rows[inside], t1[inside]], one - a[inside])
    np.testing.assert_array_equal(m[rows[inside], t2[inside]], a[inside])
    np.testing.assert_array_equal(m[rows[edge], t1[edge]], (one - a[edge]) + a[edge])
    assert ((m != 0).sum(axis=1) == np.where(inside, 2, 1)).all()


@pytest.mark.parametrize("shape", [(97, 131), (33, 257), (5, 963)])
def test_morph3_refs_match_pallas(rng, shape):
    rgb = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    gray, eroded = kernels.gray_erode3_ref(torch.from_numpy(rgb[None]))
    rg, re = gray_erode3_pallas(jnp.asarray(rgb), interpret=True)
    np.testing.assert_array_equal(gray[0].numpy(), np.asarray(rg))
    np.testing.assert_array_equal(eroded[0].numpy(), np.asarray(re))
    # integer-valued thresholds: tpuimage's kernel truncates its threshold to int32
    for t in (-1.0, 0.0, 117.0, 254.0, 255.0):
        binary, closed = kernels.binary_close3_ref(eroded, torch.tensor([t]))
        rb, rc = binary_close3_pallas(jnp.asarray(eroded[0].numpy()), t, interpret=True)
        np.testing.assert_array_equal(binary[0].numpy(), np.asarray(rb))
        np.testing.assert_array_equal(closed[0].numpy(), np.asarray(rc))


@pytest.mark.parametrize("shape", [(1 + w % 3, w) for w in range(1, 10)] + [(1, 963)])
def test_gray_erode3_ref_matches_pallas_at_edge_widths(rng, shape):
    """Widths 1-9 (a run narrower than a word of pixels) and one-row
    images, where the erosion's 255 border is on every side: exact."""
    rgb = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    gray, eroded = kernels.gray_erode3_ref(torch.from_numpy(rgb[None]))
    rg, re = gray_erode3_pallas(jnp.asarray(rgb), interpret=True)
    np.testing.assert_array_equal(gray[0].numpy(), np.asarray(rg))
    np.testing.assert_array_equal(eroded[0].numpy(), np.asarray(re))


# ---------------------------------------------------------------------------
# the post-warp chain's plain versions against tpuimage's Pallas kernels,
# interpreted, at tiny shapes: exact
# ---------------------------------------------------------------------------

def _tie_image(h, w):
    """A checkerboard of 100 and 101, whose Gaussian mean is 100.5 up to f32
    rounding (every cvRound on a tie), beside a plateau and a ramp."""
    yy, xx = np.mgrid[:h, :w]
    img = (100 + (yy + xx) % 2).astype(np.uint8)
    img[:, w // 2:] = 37
    img[h // 2:, w // 2:] = (xx[h // 2:, w // 2:] * 7 % 256).astype(np.uint8)
    return img


def _chain_inputs(rng, shape):
    """A crop of a synthetic page's gray plane, random bytes, and the tie
    image, each (H, W) uint8."""
    page = synth.page(31, 64, 64, rules=3)[..., 1]
    return [np.ascontiguousarray(page[:shape[0], :shape[1]]),
            rng.integers(0, 256, shape, dtype=np.uint8), _tie_image(*shape)]


@pytest.mark.parametrize("shape", [(40, 60), (17, 23)])
@pytest.mark.parametrize("mode,ksize,C", [("divide", 15, 0.0), ("subtract", 15, 0.0),
                                          ("sub", 15, 0.0), ("adaptive", 7, 2.5),
                                          ("adaptive", 7, 3.0), ("adaptive", 31, 3.0),
                                          ("adaptive", 31, 2.5), ("adaptive", 31, 0.0)])
def test_gauss_chain_ref_matches_pallas(rng, shape, mode, ksize, C):
    for x in _chain_inputs(rng, shape):
        ours = kernels.gauss_chain(torch.from_numpy(x[None]), ksize, mode, C)[0].numpy()
        ref = gauss_chain_pallas(jnp.asarray(x), ksize, mode, C=C, interpret=True)
        np.testing.assert_array_equal(ours, np.asarray(ref))


@pytest.mark.parametrize("shape", [(40, 60), (17, 23)])
def test_gaussian_blur_u8_ref_matches_pallas(rng, shape):
    for x in _chain_inputs(rng, shape):
        ours = kernels.gaussian_blur_u8(torch.from_numpy(x[None]), 15)[0].numpy()
        np.testing.assert_array_equal(
            ours, np.asarray(gaussian_blur_u8_pallas(jnp.asarray(x), 15, interpret=True)))


@pytest.mark.parametrize("shape", [(40, 60), (17, 23)])
@pytest.mark.parametrize("kw,kh", [(9, 19), (7, 5)])
def test_blackhat_rect_ref_matches_pallas(rng, shape, kw, kh):
    for x in _chain_inputs(rng, shape):
        ours = kernels.blackhat_rect(torch.from_numpy(x[None]), kw, kh)[0].numpy()
        np.testing.assert_array_equal(
            ours, np.asarray(blackhat_rect_pallas(jnp.asarray(x), kw, kh, interpret=True)))


@pytest.mark.parametrize("shape", [(40, 60), (17, 23), (9, 849)])
@pytest.mark.parametrize("iters", [0, 1, 3, 8])
def test_inkmask_weighted_ref_matches_pallas(rng, shape, iters):
    sparse = np.where(rng.random(shape) < 0.9, 0,
                      rng.integers(1, 256, shape)).astype(np.uint8)
    sub, bh = sparse, rng.integers(0, 40, shape, dtype=np.uint8)
    adapt = (rng.random(shape) < 0.5).astype(np.uint8) * 255
    for ts, tb in ((20.0, 30.0), (-1.0, 255.0), (255.0, 0.0)):
        mask, weighted = kernels.inkmask_weighted(
            *(torch.from_numpy(a[None]) for a in (sub, bh, adapt)),
            torch.tensor([ts]), torch.tensor([tb]), iters)
        ref_mask, ref_weighted = inkmask_weighted_pallas(
            jnp.asarray(sub), jnp.asarray(bh), jnp.asarray(adapt), ts, tb, iters=iters,
            interpret=True)
        np.testing.assert_array_equal(mask[0].numpy(), np.asarray(ref_mask))
        np.testing.assert_array_equal(weighted[0].numpy(), np.asarray(ref_weighted))


# ---------------------------------------------------------------------------
# rank_extract's plain version against the Pallas kernel (interpreted), on
# the TPU's position-major (N, 128) layout: exact, with and without drops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("density", [0.05, 0.2])
@pytest.mark.parametrize("tight", [False, True])
def test_rank_extract_ref_matches_pallas(rng, density, tight):
    mask = rng.random((1024, 128)) < density
    mask[:, 5] = False                       # an empty band
    mask[:, 9] = True                        # a full one
    pi = mask.astype(np.int32)
    rank = (np.cumsum(pi, axis=0) - pi).astype(np.int32)
    kk = 12 if tight else int(pi.sum(axis=0).max()) + 3
    ref = np.asarray(rank_extract_pallas(jnp.asarray(rank), jnp.asarray(mask), kk,
                                         interpret=True))
    ours = kernels.rank_extract(torch.from_numpy(rank), torch.from_numpy(mask), kk)
    assert ours.dtype == torch.int32 and ours.shape == (kk, 128)
    np.testing.assert_array_equal(ours.numpy(), ref)
    # the same plane given band-major (a transposed view) gives the same slots
    t = kernels.rank_extract(torch.from_numpy(rank.T.copy()).t(),
                             torch.from_numpy(mask.T.copy()).t(), kk)
    np.testing.assert_array_equal(t.numpy(), ref)


# ---------------------------------------------------------------------------
# the inputs the card holds hough_votes and the Gaussian kernels to
# (tpuimage_torch.synth's stress cases): the plain versions the card
# compares against are held to tpuimage on the same inputs here. Exact.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["rows_and_columns", "every_pixel_capped"])
def test_hough_votes_ref_on_stress_lists_matches_xla(case):
    """Whole rows and columns of edges, and a list capped below its count
    (tpuimage keeps the lowest flat indices too), against tpuimage's CPU
    path on the maps the lists came from."""
    _, xs, ys, counts, h, w = next(c for c in synth.hough_stress_cases() if c[0] == case)
    k = xs.shape[1]
    cos_np, sin_np = hough.hough_tables()
    numrho = (h + w) * 2 + 1
    ours = kernels.hough_votes_ref(*(torch.from_numpy(a) for a in (xs, ys, counts, cos_np,
                                                                    sin_np)),
                                   numrho, (numrho - 1) // 2).numpy()
    assert (counts > k).any() == (case == "every_pixel_capped")
    np.testing.assert_array_equal(ours.sum(axis=1), np.repeat(
        np.minimum(counts, k)[:, None], 180, axis=1))
    for b in range(xs.shape[0]):
        if case == "every_pixel_capped":     # the whole map, of which k edges are kept
            edges = np.zeros((h, w), np.uint8)
            edges[:40 if b else h] = 255
        else:
            edges = np.zeros((h, w), np.uint8)
            edges[ys[b, :counts[b]], xs[b, :counts[b]]] = 255
        ref = jhough.hough_accumulator(jnp.asarray(edges), max_edges=k, impl="xla")
        np.testing.assert_array_equal(ours[b], np.asarray(ref))


@pytest.mark.parametrize("shape", [(37, 1), (13, 9), (1, 40)])
@pytest.mark.parametrize("ksize", [1, 3, 43])
def test_gauss_refs_on_stress_shapes_match_pallas(shape, ksize):
    """A width of 1, a plane narrower and shorter than the radius, one row;
    ksize 1 and 3 and the chain's 43: every mode against tpuimage's Pallas
    kernels, interpreted."""
    for x in synth.blur_stress_planes((2,) + shape):
        t = torch.from_numpy(x[None])
        np.testing.assert_array_equal(
            kernels.gaussian_blur_u8_ref(t, ksize)[0].numpy(),
            np.asarray(gaussian_blur_u8_pallas(jnp.asarray(x), ksize, interpret=True)))
        for mode, C in synth.CHAIN_STRESS_MODES:
            ref = gauss_chain_pallas(jnp.asarray(x), ksize, mode, C=C, interpret=True)
            np.testing.assert_array_equal(
                kernels.gauss_chain_ref(t, ksize, mode, C)[0].numpy(), np.asarray(ref))


@pytest.mark.parametrize("sigma", [0.0, 0.01, 0.2, 0.5, 3.0])
def test_q8_taps_match_tpuimage_and_are_weights(sigma):
    """The Gaussian kernels take Q8.8 taps that are >= 0 and sum to 256
    (what the wrapper checks): then the f32 sums are exact and a row sum
    fits 16 bits. Every odd ksize up to 255 and the split form's 257, taps
    equal to tpuimage's; a tiny sigma puts all 256 on the centre tap."""
    from tpuimage.ops.filters import gaussian_kernel_q8 as jax_q8
    from tpuimage_torch.ops.filters import gaussian_kernel_q8
    for ksize in range(1, 259, 2):
        taps = gaussian_kernel_q8(ksize, sigma)
        np.testing.assert_array_equal(taps, np.asarray(jax_q8(ksize, sigma)))
        assert kernels.q8_taps_are_weights(taps), (ksize, sigma, taps.min(), taps.sum())
    if sigma == 0.01:
        assert gaussian_kernel_q8(3, sigma).tolist() == [0, 256, 0]
    assert not kernels.q8_taps_are_weights(np.array([-1, 258, -1]))
    assert not kernels.q8_taps_are_weights(np.array([64, 129, 64]))


@pytest.mark.parametrize("sigma", [0.0, 0.01, 0.2, 0.5, 3.0])
def test_q8_taps_fit_bytes_or_are_one_tap_of_256(sigma):
    """The tensor-core form keeps the taps as bytes: a tap above 255 is 256,
    sits alone (ksize 1, a tiny sigma) and makes the blur the identity,
    which is how the kernel treats it; tpuimage's taps agree."""
    from tpuimage.ops.filters import gaussian_kernel_q8 as jax_q8
    from tpuimage_torch.ops.filters import gaussian_kernel_q8
    big = 0
    for ksize in range(1, 259, 2):
        taps = gaussian_kernel_q8(ksize, sigma)
        if taps.max() > 255:
            big += 1
            assert np.array_equal(taps, np.asarray(jax_q8(ksize, sigma)))
            assert taps[ksize // 2] == 256 and np.count_nonzero(taps) == 1
            x = torch.from_numpy(synth.blur_stress_planes((2, 13, 9)))
            assert torch.equal(kernels.gaussian_blur_u8_ref(x, ksize, sigma), x)
    assert big >= 1                                  # ksize 1 at every sigma
    assert (big > 1) == (sigma in (0.01, 0.2))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()
