"""tpuimage_torch's hand-written CUDA kernels against their plain PyTorch
versions, on the card. The kernels have no CPU mode, so every test here
is marked ``cuda`` and skips where no CUDA device is present.

This file imports neither jax nor tpuimage, so it also runs on a GPU
machine that has only torch (``tests/conftest.py`` imports jax):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import functools

import numpy as np
import pytest
import torch

from tpuimage_torch import synth
from tpuimage_torch.ops import color, histogram, hough, kernels


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _planes(rng, n):
    sparse = np.zeros(n, np.uint8)
    hit = rng.random(n) < 0.03
    sparse[hit] = rng.integers(1, 256, hit.sum())
    return np.stack([sparse, rng.integers(0, 256, n, dtype=np.uint8),
                     np.full(n, 255, np.uint8), np.zeros(n, np.uint8)])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1200 * 849, 4096 + 7])
def test_hist256_kernel_on_card(cuda_device, n):
    planes = torch.from_numpy(_planes(np.random.default_rng(n), n))
    before = kernels.launch_counts()["hist256"]
    out = kernels.hist256_batch(planes.to(cuda_device))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["hist256"] == before + 1
    assert torch.equal(out.cpu(), kernels.hist256_batch_ref(planes))
    # rows that start off a 16-byte boundary: their ends are counted byte by byte
    odd = planes.to(cuda_device).reshape(-1)[1:1 + 3 * 1000].reshape(3, 1000)
    assert torch.equal(kernels.hist256_batch(odd).cpu(),
                       kernels.hist256_batch_ref(odd.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_valued", "clahe_tiles", "one_word", "odd_offsets"])
def test_hist256_kernel_on_edge_rows(cuda_device, case):
    """Rows of one value (0, 255 and 77), 512 rows of CLAHE's tile length (107 x
    160 = 17,120 bytes: one block a row), a single 16-byte row, and rows that
    start off a 16-byte boundary with lengths no multiple of 16 (counted
    byte by byte at both ends)."""
    rng = np.random.default_rng(7)
    if case == "one_valued":
        rows = np.stack([np.zeros(1200 * 849, np.uint8), np.full(1200 * 849, 255, np.uint8),
                         np.full(1200 * 849, 77, np.uint8)])
    elif case == "clahe_tiles":
        rows = rng.integers(0, 256, (512, 107 * 160), dtype=np.uint8)
        rows[::3] = np.clip(rows[::3] // 16 + 120, 0, 255)
    elif case == "one_word":
        rows = rng.integers(0, 256, (1, 16), dtype=np.uint8)
    else:
        flat = torch.from_numpy(rng.integers(0, 256, 5 * 4099 + 3, dtype=np.uint8)).to(cuda_device)
        for off, n in ((3, 4099), (1, 17), (7, 5), (0, 4099), (2, 1)):
            x = flat[off:off + 5 * n].view(5, n)
            out = _count("hist256", lambda: kernels.hist256_batch(x))
            assert torch.equal(out.cpu(), kernels.hist256_batch_ref(x.cpu())), (off, n)
        return
    x = torch.from_numpy(rows)
    out = _count("hist256", lambda: kernels.hist256_batch(x.to(cuda_device)))
    assert torch.equal(out.cpu(), kernels.hist256_batch_ref(x))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,density", [((1200, 849), 0.05), ((240, 320), 0.10)])
def test_hough_votes_kernel_on_card(cuda_device, shape, density):
    rng = np.random.default_rng(shape[0])
    edges = torch.from_numpy((rng.random((2,) + shape) < density).astype(np.uint8) * 255)
    before = kernels.launch_counts()["hough_votes"]
    acc = hough.hough_accumulator(edges.to(cuda_device))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["hough_votes"] == before + 1
    assert torch.equal(acc.cpu(), hough.hough_accumulator(edges))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rows_and_columns", "every_pixel_capped",
                                  "counts_around_a_warp", "photo_numrho",
                                  "many_large_maps", "many_tiny_maps"])
def test_hough_votes_kernel_on_stress_lists(cuda_device, case):
    """Lists that make a warp vote for one bin (whole rows at theta 90,
    whole columns at theta 0), a count capped by the list's width, counts
    around the warp size, the 1600x1200 photo's numrho, more large maps
    than the card has multiprocessors to share out (rho windows taken a
    few thetas at a time), and over a thousand tiny maps."""
    _, xs, ys, counts, h, w = next(c for c in synth.hough_stress_cases() if c[0] == case)
    numrho = (h + w) * 2 + 1
    args = [torch.from_numpy(a) for a in (xs, ys, counts, *hough.hough_tables())]
    out = _count("hough_votes", lambda: kernels.hough_votes(
        *(a.to(cuda_device) for a in args), numrho, (numrho - 1) // 2))
    ref = kernels.hough_votes_ref(*args, numrho, (numrho - 1) // 2)
    assert torch.equal(out.cpu(), ref)
    kept = torch.clamp(args[2], max=xs.shape[1])
    assert torch.equal(ref.sum(dim=1), kept[:, None].expand(-1, 180))


@pytest.mark.cuda
@pytest.mark.parametrize("n_theta", [1, 31, 33, 200])
def test_hough_votes_kernel_at_other_theta_counts(cuda_device, n_theta):
    """Theta tables shorter and longer than the 180 of the paths: one
    theta, both sides of a block's 32, and more than 180."""
    rng = np.random.default_rng(n_theta)
    h, w, numrho = 120, 90, 421
    xs = torch.from_numpy(rng.integers(0, w, (3, 700)).astype(np.int32))
    ys = torch.from_numpy(rng.integers(0, h, (3, 700)).astype(np.int32))
    counts = torch.tensor([700, 0, 333], dtype=torch.int32)
    angles = torch.arange(n_theta, dtype=torch.float64) * (np.pi / n_theta)
    args = [xs, ys, counts, torch.cos(angles).float(), torch.sin(angles).float()]
    out = _count("hough_votes", lambda: kernels.hough_votes(
        *(a.to(cuda_device) for a in args), numrho, (numrho - 1) // 2))
    assert torch.equal(out.cpu(), kernels.hough_votes_ref(*args, numrho, (numrho - 1) // 2))


@pytest.mark.cuda
def test_hough_votes_kernel_refuses_rows_past_shared_memory(cuda_device):
    """A numrho whose row no block's shared memory holds is an error, not
    a wrong answer."""
    xs = torch.zeros((1, 4), dtype=torch.int32, device=cuda_device)
    counts = torch.tensor([4], dtype=torch.int32, device=cuda_device)
    cos_t, sin_t = (torch.from_numpy(a).to(cuda_device) for a in hough.hough_tables())
    with pytest.raises(RuntimeError):
        kernels.hough_votes(xs, xs, counts, cos_t, sin_t, 200001, 100000)


# ---------------------------------------------------------------------------
# the night and morph_seq kernels, at small and odd shapes
# ---------------------------------------------------------------------------

def _count(name, fn):
    before = kernels.launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 853, 1280), (3, 97, 131)])
def test_rgb_to_lab_kernel_on_card(cuda_device, shape):
    rgb = torch.from_numpy(np.random.default_rng(shape[1]).integers(
        0, 256, shape + (3,), dtype=np.uint8))
    out = _count("rgb_to_lab", lambda: color.rgb_to_lab(rgb.to(cuda_device)))
    assert torch.equal(out.cpu(), color.rgb_to_lab(rgb))


@pytest.mark.cuda
def test_lab_to_rgb_l_equals_lab_to_rgb_on_card(cuda_device):
    """tests/test_torch_ops.py's inputs on the card: ~1M seeded Lab triples
    and the 0/255 corners, L and a, b as strided views of one image."""
    corners = np.array(np.meshgrid(*[[0, 255]] * 3, indexing="ij"), np.uint8).reshape(3, -1).T
    rand = np.random.default_rng(26).integers(0, 256, (1025 * 1024 - 8, 3), dtype=np.uint8)
    lab = torch.from_numpy(np.concatenate([rand, corners]).reshape(1025, 1024, 3)).to(cuda_device)
    out = color.lab_to_rgb_l(lab[..., 0], lab[..., 1:])
    assert out.is_cuda and torch.equal(out, color.lab_to_rgb(lab))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 853, 1280), (3, 128, 160), (1, 97, 131)])
def test_clahe_apply_kernel_on_card(cuda_device, shape):
    gray = torch.from_numpy(synth.night_scene(shape[1], shape[1], shape[2])[..., 0].copy())
    gray = gray.expand(shape).contiguous()
    out = _count("clahe_apply", lambda: histogram.clahe(gray.to(cuda_device), 2.0))
    assert torch.equal(out.cpu(), histogram.clahe(gray, 2.0))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 963, 1280), (3, 33, 257), (1, 64, 65)])
def test_morph3_kernels_on_card(cuda_device, shape):
    rgb = torch.from_numpy(np.random.default_rng(shape[2]).integers(
        0, 256, shape + (3,), dtype=np.uint8))
    gray, eroded = _count("gray_erode3", lambda: kernels.gray_erode3(rgb.to(cuda_device)))
    ref_gray, ref_eroded = kernels.gray_erode3_ref(rgb)
    assert torch.equal(gray.cpu(), ref_gray) and torch.equal(eroded.cpu(), ref_eroded)
    thresh = torch.tensor([0.0, 117.0, 254.0][:shape[0]])
    binary, closed = _count("binary_close3", lambda: kernels.binary_close3(
        eroded, thresh.to(cuda_device)))
    ref_binary, ref_closed = kernels.binary_close3_ref(ref_eroded, thresh)
    assert torch.equal(binary.cpu(), ref_binary) and torch.equal(closed.cpu(), ref_closed)


# clahe_apply and gray_erode3 at their edge shapes: tile grids from 1x1 to
# 16x16, widths 1-9 and the paths' widths, planes 1-3 bytes past a word
# boundary (rows then read as narrower words or bytes), random LUTs that
# are not monotone (a wrong tile or level pick shows), and the erosion's
# 255 border on all-0 and all-255 images
_CLAHE_GRIDS = [(1, 1), (1, 8), (3, 5), (8, 8), (16, 16)]
_CLAHE_SHAPES = ([(2, 1 + w % 3, w) for w in range(1, 10)]
                 + [(1, 853, 131), (2, 3, 849), (1, 37, 849), (2, 853, 1280)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _CLAHE_SHAPES)
@pytest.mark.parametrize("grid", _CLAHE_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_clahe_apply_kernel_at_edge_shapes(cuda_device, grid, shape):
    b, h, w = shape
    ty, tx = grid
    _, _, th, tw = histogram.clahe_geometry(h, w, tx, ty)
    rng = np.random.default_rng(h * 1000 + w + ty)
    luts = torch.from_numpy(rng.integers(0, 256, (b, ty, tx, 256), dtype=np.uint8))
    R, C = histogram.blend_tables_on(h, w, th, tw, ty, tx, torch.device("cpu"))
    for off in (0, 1, 2, 3):
        gray = _at_offset(shape, off, off + w, cuda_device)
        out = _count("clahe_apply", lambda: kernels.clahe_apply(
            gray, luts.to(cuda_device), R.to(cuda_device), C.to(cuda_device)))
        ref = kernels.clahe_apply_ref(gray.cpu(), luts, R, C)
        assert torch.equal(out.cpu(), ref), (off, int((out.cpu() != ref).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1.7, 0.3])
@pytest.mark.parametrize("shape,grid", [((2, 853, 1280), (8, 8)), ((1, 37, 131), (3, 5))])
def test_clahe_apply_kernel_with_weights_off_the_unit_range(cuda_device, shape, grid, scale):
    """Blend tables whose fractions are scaled past 1 or below 0 (the
    rows' by ``scale``, the columns' by ``scale - 0.5``): blends outside
    [0, 255], where the kernel clamps as the plain version does (it skips
    the clamp only for fractions in [0, 1], which keep every blend
    inside)."""
    b, h, w = shape
    ty, tx = grid
    _, _, th, tw = histogram.clahe_geometry(h, w, tx, ty)
    rng = np.random.default_rng(w + ty)
    luts = torch.from_numpy(rng.integers(0, 256, (b, ty, tx, 256), dtype=np.uint8))
    R, C = (t.clone() for t in histogram.blend_tables_on(h, w, th, tw, ty, tx,
                                                           torch.device("cpu")))
    R[:, 2] *= scale
    C[:, 2] *= scale - 0.5
    gray = _at_offset(shape, 0, w, cuda_device)
    out = _count("clahe_apply", lambda: kernels.clahe_apply(
        gray, luts.to(cuda_device), R.to(cuda_device), C.to(cuda_device)))
    ref = kernels.clahe_apply_ref(gray.cpu(), luts, R, C)
    assert torch.equal(out.cpu(), ref), int((out.cpu() != ref).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,grid", [((2, 853, 1280), (8, 8)), ((1, 37, 131), (3, 5))])
def test_clahe_apply_kernel_with_tables_of_other_pairs(cuda_device, shape, grid):
    """Blend tables whose tile pairs are not cv2's (any two tiles, the
    same or far apart, a few rows and columns each) and a table of
    cv2's form: the blocks that meet another pair read the LUTs in device
    memory, the others stage their quads; both equal the plain version."""
    b, h, w = shape
    ty, tx = grid
    _, _, th, tw = histogram.clahe_geometry(h, w, tx, ty)
    rng = np.random.default_rng(h + tx)
    luts = torch.from_numpy(rng.integers(0, 256, (b, ty, tx, 256), dtype=np.uint8))
    R, C = (t.clone() for t in histogram.blend_tables_on(h, w, th, tw, ty, tx,
                                                           torch.device("cpu")))
    for tab, n, size in ((R, ty, h), (C, tx, w)):
        pick = torch.from_numpy(rng.choice(size, max(size // 50, 1), replace=False))
        tab[pick, :2] = torch.from_numpy(rng.integers(0, n, (len(pick), 2)).astype(np.float32))
    gray = _at_offset(shape, 0, w, cuda_device)
    out = _count("clahe_apply", lambda: kernels.clahe_apply(
        gray, luts.to(cuda_device), R.to(cuda_device), C.to(cuda_device)))
    ref = kernels.clahe_apply_ref(gray.cpu(), luts, R, C)
    assert torch.equal(out.cpu(), ref), int((out.cpu() != ref).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("w", list(range(1, 10)) + [849, 963, 1280])
def test_gray_erode3_kernel_at_edge_shapes(cuda_device, w, batch):
    """Heights 1-3 (every row on the border) and 17; the RGB buffer 0-3
    bytes past a word boundary; random, all-0 and all-255 images."""
    for h in (1, 2, 3, 17):
        for off in (0, 1, 2, 3):
            rgb = _at_offset((batch, h, w * 3), off, 7 * off + h + w, cuda_device)
            rgb = rgb.view(batch, h, w, 3)
            for fill in (None, 0, 255):
                if fill is not None:
                    rgb.fill_(fill)
                gray, eroded = _count("gray_erode3", lambda: kernels.gray_erode3(rgb))
                ref_gray, ref_eroded = kernels.gray_erode3_ref(rgb.cpu())
                assert torch.equal(gray.cpu(), ref_gray), (h, off, fill)
                assert torch.equal(eroded.cpu(), ref_eroded), (h, off, fill)


# the byte-mask kernels (binary_close3, inkmask_weighted) walk rows as
# aligned words: widths 1-9 and the paths' 849, 963 and 1280, planes of one
# row and of one column, every plane at a byte offset off a word boundary,
# and thresholds below, inside and above the byte range, NaN included
_EDGE_SHAPES = ([(2, 37, w) for w in range(1, 10)]
                + [(1, 1, 849), (1, 1200, 1), (3, 1, 1), (2, 70, 849), (1, 9, 849),
                   (2, 41, 963), (1, 35, 1280), (2, 5, 300)])
_EDGE_THRESHOLDS = (-1.0, -0.5, 0.0, 117.5, 254.0, 255.0, 300.0, float("nan"))


def _at_offset(shape, offset, seed, device):
    """A (B, H, W) uint8 plane whose data starts ``offset`` bytes past a
    word boundary (a contiguous view of a larger buffer): random bytes with
    runs of 0 and 255."""
    n = int(np.prod(shape))
    flat = np.random.default_rng(seed).integers(0, 256, n + offset, dtype=np.uint8)
    flat[offset::7] = 0
    flat[offset + 3::11] = 255
    x = torch.from_numpy(flat).to(device)[offset:].view(shape)
    assert x.data_ptr() % 4 == offset % 4
    return x


def _thresholds(i, b, device):
    return torch.tensor([_EDGE_THRESHOLDS[(i + j) % len(_EDGE_THRESHOLDS)] for j in range(b)],
                        dtype=torch.float32, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _EDGE_SHAPES)
def test_binary_close3_kernel_at_edge_shapes(cuda_device, shape):
    """The plane 1 byte past a word boundary (its rows realigned), and a
    copy of it at the allocation's own alignment, as the outputs are (rows
    in their own words; none realigned where the width is a multiple of 4)."""
    odd = _at_offset(shape, 1, shape[1] * shape[2], cuda_device)
    for x in (odd, odd.clone()):
        for i in range(len(_EDGE_THRESHOLDS)):
            thresh = _thresholds(i, shape[0], cuda_device)
            binary, closed = _count("binary_close3", lambda: kernels.binary_close3(x, thresh))
            ref_binary, ref_closed = kernels.binary_close3_ref(x.cpu(), thresh.cpu())
            assert torch.equal(binary.cpu(), ref_binary), (x.data_ptr() % 4, thresh)
            assert torch.equal(closed.cpu(), ref_closed), (x.data_ptr() % 4, thresh)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", list(range(10)) + [20])
@pytest.mark.parametrize("shape", _EDGE_SHAPES)
def test_inkmask_weighted_kernel_at_edge_shapes(cuda_device, shape, iters):
    """The three planes at byte offsets 1, 2 and 3 (every row realigned),
    and copies of them at the allocation's own alignment, as the outputs
    are (rows worked on in their own words); iters 0-8 in the warp form, 9
    and 20 in the split form."""
    odd = [_at_offset(shape, off, off * 1000 + shape[2] + iters, cuda_device)
           for off in (1, 2, 3)]
    for planes in (odd, [a.clone() for a in odd]):
        for i in range(len(_EDGE_THRESHOLDS)):
            t_sub = _thresholds(i, shape[0], cuda_device)
            t_bh = _thresholds(3 * i + 1, shape[0], cuda_device)
            mask, weighted = _count("inkmask_weighted", lambda: kernels.inkmask_weighted(
                *planes, t_sub, t_bh, iters))
            ref_mask, ref_weighted = kernels.inkmask_weighted_ref(
                *(a.cpu() for a in planes), t_sub.cpu(), t_bh.cpu(), iters)
            assert torch.equal(mask.cpu(), ref_mask), (planes[0].data_ptr() % 4, t_sub, t_bh)
            assert torch.equal(weighted.cpu(), ref_weighted), (planes[0].data_ptr() % 4, t_sub,
                                                               t_bh)


# ---------------------------------------------------------------------------
# the post-warp chain's kernels: at the path's shapes (8 A4 pages of
# 1200x849) and at odd ones, where the halo is wider than the image
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def a4_planes():
    """The gray and the stretched planes of 8 synthetic A4 pages, on the
    CPU, as DocScanner's post-warp chain makes them."""
    from tpuimage_torch.ops.color import rgb_to_gray
    from tpuimage_torch.pipelines import docscan
    pages = np.stack([synth.page(100 + i, 1200, 849, tilt_deg=(3.0 if i % 2 else 0.0),
                                 rules=(3 if i % 2 else 0)) for i in range(8)])
    gray = rgb_to_gray(torch.from_numpy(pages))
    stretched = docscan._illumination(gray, docscan.GUI_DOCUMENT_CONFIG)
    return torch.from_numpy(pages), gray, stretched


def _odd_planes(shape):
    return torch.from_numpy(np.random.default_rng(shape[1] * shape[2]).integers(
        0, 256, shape, dtype=np.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,ksize,C", [("divide", 43, 0.0), ("subtract", 43, 0.0),
                                          ("sub", 51, 0.0), ("adaptive", 31, 3.0)])
def test_gauss_chain_kernel_on_a4_pages(cuda_device, a4_planes, mode, ksize, C):
    _, gray, stretched = a4_planes
    x = gray if mode in ("divide", "subtract") else stretched
    out = _count("gauss_chain", lambda: kernels.gauss_chain(x.to(cuda_device), ksize, mode, C))
    assert torch.equal(out.cpu(), kernels.gauss_chain_ref(x, ksize, mode, C))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 17, 23), (2, 97, 131), (1, 1, 40)])
@pytest.mark.parametrize("mode,ksize,C", [("divide", 15, 0.0), ("subtract", 51, 0.0),
                                          ("sub", 51, 0.0), ("adaptive", 7, 2.5),
                                          ("adaptive", 31, 3.0), ("adaptive", 51, -4.0)])
def test_gauss_chain_kernel_at_odd_shapes(cuda_device, shape, mode, ksize, C):
    x = _odd_planes(shape)
    out = _count("gauss_chain", lambda: kernels.gauss_chain(x.to(cuda_device), ksize, mode, C))
    assert torch.equal(out.cpu(), kernels.gauss_chain_ref(x, ksize, mode, C))


@pytest.mark.cuda
@pytest.mark.parametrize("ksize,sigma", [(43, 0.0), (51, 0.0), (15, 2.5), (255, 0.0)])
def test_gaussian_blur_u8_kernel_on_card(cuda_device, a4_planes, ksize, sigma):
    _, gray, _ = a4_planes
    for x in (gray, _odd_planes((2, 97, 131)), _odd_planes((3, 17, 23))):
        out = _count("gaussian_blur_u8",
                     lambda: kernels.gaussian_blur_u8(x.to(cuda_device), ksize, sigma))
        assert torch.equal(out.cpu(), kernels.gaussian_blur_u8_ref(x, ksize, sigma))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 17, 23), (2, 97, 131), (1, 300, 213)])
@pytest.mark.parametrize("mode,ksize,C", [("none", 257, 0.0), ("divide", 301, 0.0),
                                          ("sub", 257, 0.0), ("adaptive", 257, 3.0)])
def test_gauss_sep_split_form_on_card(cuda_device, shape, mode, ksize, C):
    """Kernels wider than the tiled form (ksize > 255) take the split form,
    one counted launch of the wrapper all the same."""
    x = _odd_planes(shape)
    if mode == "none":
        out = _count("gaussian_blur_u8",
                     lambda: kernels.gaussian_blur_u8(x.to(cuda_device), ksize))
        assert torch.equal(out.cpu(), kernels.gaussian_blur_u8_ref(x, ksize))
        return
    out = _count("gauss_chain", lambda: kernels.gauss_chain(x.to(cuda_device), ksize, mode, C))
    assert torch.equal(out.cpu(), kernels.gauss_chain_ref(x, ksize, mode, C))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", synth.BLUR_STRESS_SHAPES)
@pytest.mark.parametrize("ksize", synth.BLUR_STRESS_KSIZES)
def test_gauss_sep_kernel_on_stress_shapes(cuda_device, shape, ksize):
    """An odd width, a width of 1, planes narrower and shorter than the
    radius, one row, sizes no tile or register block divides; ksize 1 to
    the widest tiled one and the split form's first; every mode."""
    x = torch.from_numpy(synth.blur_stress_planes(shape))
    out = _count("gaussian_blur_u8", lambda: kernels.gaussian_blur_u8(x.to(cuda_device), ksize))
    assert torch.equal(out.cpu(), kernels.gaussian_blur_u8_ref(x, ksize))
    for mode, C in synth.CHAIN_STRESS_MODES:
        out = _count("gauss_chain",
                     lambda: kernels.gauss_chain(x.to(cuda_device), ksize, mode, C))
        assert torch.equal(out.cpu(), kernels.gauss_chain_ref(x, ksize, mode, C)), mode


@pytest.mark.cuda
@pytest.mark.parametrize("ksize,sigma", [(3, 0.01), (5, 0.2), (43, 0.3), (9, 0.5)])
def test_gaussian_blur_u8_with_a_tap_of_256_on_card(cuda_device, ksize, sigma):
    """A tiny sigma puts 256 (or nearly all of it) on the centre tap."""
    from tpuimage_torch.ops.filters import gaussian_kernel_q8
    assert gaussian_kernel_q8(ksize, sigma).max() >= 200
    x = torch.from_numpy(synth.blur_stress_planes((2, 70, 849)))
    out = _count("gaussian_blur_u8",
                 lambda: kernels.gaussian_blur_u8(x.to(cuda_device), ksize, sigma))
    assert torch.equal(out.cpu(), kernels.gaussian_blur_u8_ref(x, ksize, sigma))


@pytest.mark.cuda
def test_divide_table_on_card(cuda_device):
    """The divide epilogue on all 65,536 (num, den) pairs."""
    assert torch.equal(kernels.divide_table(cuda_device).cpu(), kernels.divide_table("cpu"))


def _tie_image(h, w):
    """A checkerboard of 100 and 101 (its Gaussian mean is 100.5 up to f32
    rounding, so every pixel's cvRound sits on a tie, which decides the
    compare for C in (-1, 1]), beside a plateau and a ramp."""
    yy, xx = np.mgrid[:h, :w]
    img = (100 + (yy + xx) % 2).astype(np.uint8)
    img[:, w // 2:] = 37
    img[h // 2:, w // 2:] = (xx[h // 2:, w // 2:] % 256).astype(np.uint8)
    return img


@pytest.mark.cuda
@pytest.mark.parametrize("ksize,C", [(7, 0.0), (31, 1.0), (31, 0.0), (51, 1.0)])
def test_adaptive_on_ties_on_card(cuda_device, ksize, C):
    x = torch.from_numpy(np.stack([_tie_image(240, 320), _tie_image(1200, 849)[:240, :320]]))
    out = _count("gauss_chain", lambda: kernels.gauss_chain(x.to(cuda_device), ksize,
                                                            "adaptive", C))
    ref = kernels.gauss_chain_ref(x, ksize, "adaptive", C)
    assert torch.equal(out.cpu(), ref)
    assert 0 < int((ref == 0).sum()) < ref.numel()   # the ties go both ways


@pytest.mark.cuda
@pytest.mark.parametrize("kw,kh", [(9, 19), (7, 5), (1, 1), (3, 63), (33, 67), (255, 3),
                                   (129, 255), (255, 255)])
def test_blackhat_rect_kernel_on_card(cuda_device, a4_planes, kw, kh):
    _, _, stretched = a4_planes
    for x in (stretched, _odd_planes((3, 17, 23)), _odd_planes((2, 97, 131))):
        out = _count("blackhat_rect", lambda: kernels.blackhat_rect(x.to(cuda_device), kw, kh))
        assert torch.equal(out.cpu(), kernels.blackhat_rect_ref(x, kw, kh))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, w) for w in range(1, 10)]
                         + [(1, 1, 849), (1, 1200, 1), (3, 1, 1), (1, 70, 849), (2, 5, 300)])
@pytest.mark.parametrize("kw,kh", [(9, 19), (1, 1), (7, 5), (33, 67), (255, 3), (3, 63)])
def test_blackhat_rect_kernel_at_edge_shapes(cuda_device, shape, kw, kh):
    """Widths 1-9 and 849, planes of one row and of one column, rectangles
    wider or taller than the plane, and every plane starting 1 byte past a
    word boundary (a contiguous view at an odd offset), so that rows start
    at every alignment."""
    b, h, w = shape
    flat = torch.from_numpy(np.random.default_rng(b * h * w + kw).integers(
        0, 256, b * h * w + 1, dtype=np.uint8))
    flat[1::5] = 255
    x = flat.to(cuda_device)[1:].view(b, h, w)
    assert x.data_ptr() % 2 == 1
    out = _count("blackhat_rect", lambda: kernels.blackhat_rect(x, kw, kh))
    assert torch.equal(out.cpu(), kernels.blackhat_rect_ref(x.cpu(), kw, kh))


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [0, 1, 3, 8, 9, 20])
def test_inkmask_weighted_kernel_on_card(cuda_device, a4_planes, iters):
    _, _, stretched = a4_planes
    from tpuimage_torch.pipelines import docscan
    cfg = docscan.GUI_DOCUMENT_CONFIG
    sub_raw, bh_raw = docscan._ink_planes(stretched, cfg)
    adapt = kernels.gauss_chain_ref(stretched, 31, "adaptive", 3.0)
    t_sub = torch.tensor([12.0, -1.0, 255.0, 0.0, 30.0, 7.0, 3.0, 100.0])
    t_bh = torch.tensor([20.0, 255.0, -1.0, 0.0, 5.0, 9.0, 40.0, 1.0])
    for args in ((sub_raw, bh_raw, adapt, t_sub, t_bh),
                 tuple(_odd_planes((3, 17, 23)) for _ in range(3))
                 + (t_sub[:3].contiguous(), t_bh[:3].contiguous())):
        mask, weighted = _count("inkmask_weighted", lambda: kernels.inkmask_weighted(
            *(a.to(cuda_device) for a in args), iters))
        ref_mask, ref_weighted = kernels.inkmask_weighted_ref(*args, iters)
        assert torch.equal(mask.cpu(), ref_mask) and torch.equal(weighted.cpu(), ref_weighted)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
def test_pre_deskew_on_card(cuda_device, a4_planes, wide):
    """_pre_deskew_stages on the card equals the host's and launches each
    of its kernels once per page batch; "wide" windows (a 33x67 blackhat,
    a 257-tap ink background blur, 9 dilations) take the split forms."""
    import dataclasses
    from tpuimage_torch.pipelines import docscan
    pages = a4_planes[0][:2]
    cfg = docscan.GUI_DOCUMENT_CONFIG
    if wide:
        cfg = dataclasses.replace(cfg, blackhat_ksize=33, mask_blur_ksize=257,
                                  ink_dilate_iters=9)
    host = docscan._pre_deskew_stages(pages, cfg)
    kernels.reset_launch_counts()
    out = docscan._pre_deskew_stages(pages.to(cuda_device), cfg)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "gauss_chain": 3, "blackhat_rect": 1, "inkmask_weighted": 1, "hist256": 1}, counts
    for k, v in host.items():
        assert torch.equal(out[k].cpu(), v), k


# ---------------------------------------------------------------------------
# bilateral and rank_extract; DocScanner's process_document and scan_stream
# ---------------------------------------------------------------------------

def _bilateral_on_card(cuda_device, img, d, sc, ss):
    from tpuimage_torch.ops import bilateral
    out = _count("bilateral", lambda: bilateral.bilateral_filter(img.to(cuda_device), d, sc, ss))
    assert out.shape == img.shape
    # the plain version on the card, with the same tables
    chans = 3 if img.dim() == 4 else 1
    radius, taps, space_w, lut = bilateral.tables_on(d, sc, ss, chans, out.device)
    ref = kernels.bilateral_ref(img.to(cuda_device), taps, space_w, lut, radius)
    assert torch.equal(out, ref)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape,d,sc,ss", [((2, 1600, 1200), 9, 75, 75),
                                           ((3, 97, 131), 9, 75, 75),
                                           ((2, 61, 45), -1, 30, 10),
                                           ((1, 7, 5), 11, 100, 100)])
def test_bilateral_gray_on_card(cuda_device, shape, d, sc, ss):
    """Exact against the plain version on the card (radius 4, 15 and 5;
    the last halo wider than its image)."""
    _bilateral_on_card(cuda_device, _odd_planes(shape), d, sc, ss)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,d,sc,ss", [((2, 853, 1280), 9, 100, 75),
                                           ((2, 97, 131), 11, 100, 100),
                                           ((1, 120, 90), -1, 30, 10)])
def test_bilateral_color_on_card(cuda_device, shape, d, sc, ss):
    imgs = torch.from_numpy(np.stack([synth.document_photo(40 + i, *shape[1:])
                                      for i in range(shape[0])]))
    _bilateral_on_card(cuda_device, imgs, d, sc, ss)


@pytest.mark.cuda
def test_bilateral_card_against_host(cuda_device):
    """The host's plain version (PyTorch's CPU exp in its table) within the
    float contract of the card's."""
    from tpuimage_torch.ops import bilateral
    img = torch.from_numpy(synth.document_photo(3, 240, 180))
    for x in (img, img[..., 1].contiguous()):
        card = bilateral.bilateral_filter(x.to(cuda_device), 9, 75, 75).cpu().numpy()
        host = bilateral.bilateral_filter(x, 9, 75, 75).numpy()
        diff = np.abs(card.astype(np.int32) - host.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.005


@pytest.mark.cuda
@pytest.mark.parametrize("shape,d", [((4, 1600, 1203), 9), ((2, 130, 1031), 9),
                                     ((3, 61, 45), 3), ((1, 5, 4), 3), ((1, 3, 2), 13)])
def test_bilateral_gray_at_run_edges(cuda_device, shape, d):
    """Widths that are no multiple of a thread's run of 8 pixels, in the
    64 x 32 form (the first shape: enough tiles for it) and the 32 x 16
    one; radius 1 (d 3), and images narrower than their halo."""
    _bilateral_on_card(cuda_device, _odd_planes(shape), d, 75, 75)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,d", [((2, 853, 1283), 9), ((1, 70, 131), 9), ((1, 6, 9), 15),
                                     ((2, 9, 7), 3)])
def test_bilateral_color_at_run_edges(cuda_device, shape, d):
    """Colour: widths that are no multiple of a run of 4 pixels in the
    64 x 16 form (the first shape) and the 32 x 16 one, a halo wider than
    the image, radius 1."""
    imgs = torch.from_numpy(np.random.default_rng(shape[2]).integers(
        0, 256, (*shape, 3), dtype=np.uint8))
    _bilateral_on_card(cuda_device, imgs, d, 40, 75)


def _smem_limit(chans, per_tap, lut):
    """The widest radius whose 32 x 16 halo tile, weight table and per-tap
    words fit in 227 KB, with the op's circular tap sets."""
    from tpuimage_torch.ops import bilateral
    fits = [r for r in range(1, 256)
            if 4 * lut + per_tap * len(bilateral._tap_offsets(r))
            + chans * (32 + 2 * r) * (16 + 2 * r) <= 232448]
    return max(fits)


@pytest.mark.cuda
@pytest.mark.parametrize("chans", [1, 3])
def test_bilateral_widest_radius_and_one_past(cuda_device, chans):
    """The widest radius the kernel takes (gray 115, colour 90; the first
    design's tile, table and 8 bytes a tap stopped at 87 and 74) is exact
    against the plain version; one more is refused with an error."""
    from tpuimage_torch.ops import bilateral
    widest = _smem_limit(chans, 4, 256 if chans == 1 else 766)
    assert widest >= _smem_limit(chans, 8, 255 * chans + 1)
    shape = (1, 23, 37, 3) if chans == 3 else (1, 23, 37)
    img = torch.from_numpy(np.random.default_rng(chans).integers(0, 256, shape, dtype=np.uint8))
    _bilateral_on_card(cuda_device, img, 2 * widest + 1, 30, 40)
    radius, taps, space_w, lut = bilateral.tables_on(2 * widest + 3, 30, 40, chans, cuda_device)
    with pytest.raises(RuntimeError, match="bilateral launch failed"):
        kernels.bilateral(img.to(cuda_device), taps, space_w, lut, radius)


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.05, 0.2])
@pytest.mark.parametrize("tight", [False, True])
def test_rank_extract_on_card(cuda_device, density, tight):
    """Both layouts: the TPU's position-major (N, 128) plane and a
    page-major (B, P) plane given as its transposed view."""
    rng = np.random.default_rng(int(density * 100))
    tpu = torch.from_numpy(rng.random((2048, 128)) < density)
    page = torch.from_numpy(rng.random((3, 40000)) < density).t()
    for mask in (tpu, page):
        pi = mask.to(torch.int32)
        rank = torch.cumsum(pi, dim=0, dtype=torch.int32) - pi
        kk = 9 if tight else int(pi.sum(dim=0).max()) + 2
        out = _count("rank_extract", lambda: kernels.rank_extract(
            rank.to(cuda_device), mask.to(cuda_device), kk))
        assert torch.equal(out.cpu(), kernels.rank_extract_ref(rank, mask, kk))


def _rank_plane(mask):
    pi = mask.to(torch.int32)
    return torch.cumsum(pi, dim=0, dtype=torch.int32) - pi


def _rank_extract_exact(cuda_device, rank, mask, kk):
    """The kernel against the plain version, its output allocated over a
    freed block of the same size filled with 0x5a bytes (the kernel must
    write every slot, the zeros past each band's count too)."""
    junk = torch.full((max(kk, 1), rank.shape[1]), 0x5A5A5A5A, dtype=torch.int32,
                      device=cuda_device)
    del junk
    out = _count("rank_extract", lambda: kernels.rank_extract(rank, mask, kk))
    assert torch.equal(out.cpu(), kernels.rank_extract_ref(rank.cpu(), mask.cpu(), kk))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 17, 40001, 1018800, 1018801])
@pytest.mark.parametrize("offset", [0, 1, 7])
def test_rank_extract_page_major_edges(cuda_device, n, offset):
    """compact_edges' layout, each page a band of the transposed plane:
    lengths that are no multiple of 16 (the 16-byte loads' ends), and
    planes whose rows start at byte offset 1 or 7 from a 16-byte boundary."""
    rng = np.random.default_rng(n + offset)
    flat = torch.zeros(3 * n + offset, dtype=torch.bool, device=cuda_device)
    flat[offset:] = torch.from_numpy(rng.random(3 * n) < 0.15).to(cuda_device)
    rows = flat[offset:].view(3, n)
    rank = _rank_plane(rows.t())
    counts = rows.sum(dim=1)
    for kk in (1, max(int(counts.max()) // 2, 1), int(counts.max()) + 3):
        _rank_extract_exact(cuda_device, rank, rows.t(), kk)


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["empty", "all_set"])
@pytest.mark.parametrize("layout", ["page_major", "band_fast"])
def test_rank_extract_empty_and_full(cuda_device, fill, layout):
    """No edge at all, and every position an edge, in both layouts; kk 1,
    inside and past the count."""
    value = fill == "all_set"
    if layout == "page_major":
        mask = torch.full((2, 5003), value, dtype=torch.bool, device=cuda_device).t()
    else:
        mask = torch.full((1037, 128), value, dtype=torch.bool, device=cuda_device)
    rank = _rank_plane(mask)
    for kk in (1, 300, mask.shape[0] + 2):
        _rank_extract_exact(cuda_device, rank, mask, kk)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8192, 128), (1001, 33), (5, 300)])
def test_rank_extract_band_fast(cuda_device, shape):
    """tpuimage's position-major layout (bands the fast axis), with a
    count of positions that is no multiple of the strided form's run."""
    mask = torch.from_numpy(np.random.default_rng(shape[0]).random(shape) < 0.1).to(cuda_device)
    rank = _rank_plane(mask)
    for kk in (1, 7, int(mask.sum(dim=0).max()) + 1):
        _rank_extract_exact(cuda_device, rank, mask, kk)


@pytest.mark.cuda
def test_otsu_on_card_equals_host(cuda_device):
    """Histograms with runs of empty bins (exact ties of the between-class
    variance): the card picks the bins the host picks."""
    rng = np.random.default_rng(9)
    hists = rng.integers(0, 200000, (64, 256)) * (rng.random((64, 256)) < 0.3)
    hists[:, 0] = rng.integers(1, 10 ** 6, 64)
    hists = torch.from_numpy(hists)
    assert torch.equal(histogram.otsu_from_hist(hists.to(cuda_device)).cpu(),
                       histogram.otsu_from_hist(hists))


@pytest.mark.cuda
def test_compact_edges_on_card(cuda_device):
    rng = np.random.default_rng(5)
    e = torch.from_numpy((rng.random((3, 240, 320)) < 0.1).astype(np.uint8) * 255)
    for k in (50, 10 ** 6):
        card = _count("rank_extract", lambda: hough.compact_edges(e.to(cuda_device), k))
        for a, b in zip(card, hough.compact_edges(e, k)):
            assert torch.equal(a.cpu(), b)


@pytest.fixture(scope="module")
def doc_photos():
    """Two document photos (one with tilted text) and one with no page, 480x360."""
    return [synth.document_photo(31, 480, 360),
            synth.document_photo(32, 480, 360, tilt_deg=4.0, rules=3),
            synth.document_photo(33, 480, 360, with_page=False)]


def _assert_same_request(card, host):
    assert card["use_whole"] == host["use_whole"]
    assert (card["quad"] is None) == (host["quad"] is None)
    if card["quad"] is not None:
        assert np.abs(card["quad"] - host["quad"]).max() <= 0.5
    assert card["binary"].shape == host["binary"].shape
    assert (card["binary"] != host["binary"]).mean() < 0.002


@pytest.mark.cuda
def test_process_document_on_card(cuda_device, doc_photos):
    import dataclasses
    from tpuimage_torch.pipelines import docscan
    cfg = dataclasses.replace(docscan.DocScanConfig(), scale_long=400)
    for photo in doc_photos[1:]:
        kernels.reset_launch_counts()
        card = docscan.process_document(photo, out_dir=None, config=cfg)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        for name in ("bilateral", "rank_extract", "hough_votes", "hist256", "gauss_chain",
                     "blackhat_rect", "inkmask_weighted"):
            assert counts[name] > 0, counts
        host = docscan.process_document(photo, out_dir=None, config=cfg, device="cpu")
        assert card["binary"].device.type == "cuda"
        _assert_same_request({k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
                              for k, v in card.items()},
                             {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                              for k, v in host.items()})
        assert float(card["stages"]["deskew_angle"]) == float(host["stages"]["deskew_angle"])


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [True, False])
def test_scan_stream_on_card(cuda_device, doc_photos, prefetch):
    import dataclasses
    from tpuimage_torch.pipelines import docscan
    cfg = dataclasses.replace(docscan.GUI_DOCUMENT_CONFIG, scale_long=400)
    batches = [doc_photos, doc_photos[::-1], doc_photos[1:]]
    kernels.reset_launch_counts()
    card = [r for res in docscan.scan_stream(batches, cfg, prefetch=prefetch) for r in res]
    assert kernels.launch_counts()["rank_extract"] > 0
    host = docscan.scan_batch([p for b in batches for p in b], cfg, device="cpu")
    assert len(card) == len(host) == 8
    for c, h in zip(card, host):
        _assert_same_request(c, h)
        assert c["deskew_angle"] == h["deskew_angle"]


# ---------------------------------------------------------------------------
# NORM_MINMAX (one rounding) and the mean adaptive threshold: card = host
# ---------------------------------------------------------------------------

def _use_whole_photo_planes():
    """The gray and divided illumination planes of a 480x360 photo with no
    page (DocScanner's use-whole input at scale_long 600), on the CPU."""
    from tpuimage_torch.ops.color import rgb_to_gray
    from tpuimage_torch.pipelines import docscan
    gray = rgb_to_gray(torch.from_numpy(synth.document_photo(3, 480, 360, with_page=False)))
    k = docscan.illum_ksize(480, 360, docscan.GUI_DOCUMENT_CONFIG)
    return torch.stack([gray, kernels.gauss_chain_ref(gray[None], k, "divide")[0]])


@pytest.mark.cuda
def test_normalize_minmax_on_card_equals_host(cuda_device):
    from tpuimage_torch.ops import arith
    x = _use_whole_photo_planes()
    assert torch.equal(arith.normalize_minmax(x.to(cuda_device)).cpu(), arith.normalize_minmax(x))
    lo, hi = x.reshape(2, -1).amin(1).float(), x.reshape(2, -1).amax(1).float()
    assert torch.equal(arith.normalize_minmax_lut(lo.to(cuda_device), hi.to(cuda_device)).cpu(),
                       arith.normalize_minmax_lut(lo, hi))


@pytest.mark.cuda
def test_pre_deskew_mean_threshold_on_card(cuda_device, a4_planes):
    """thresh_method="mean" (the integer box filter on plain tensor ops, no
    kernel) inside _pre_deskew_stages: card = host on every stage."""
    import dataclasses
    from tpuimage_torch.pipelines import docscan
    cfg = dataclasses.replace(docscan.GUI_DOCUMENT_CONFIG, thresh_method="mean")
    pages = a4_planes[0][:2]
    host = docscan._pre_deskew_stages(pages, cfg)
    kernels.reset_launch_counts()
    out = docscan._pre_deskew_stages(pages.to(cuda_device), cfg)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "gauss_chain": 2, "blackhat_rect": 1, "inkmask_weighted": 1, "hist256": 1}, counts
    for k, v in host.items():
        assert torch.equal(out[k].cpu(), v), k


# ---------------------------------------------------------------------------
# rgb_to_lab (redesigned: warp runs of 512 pixels staged through shared
# memory, inputs read as aligned 16-byte words) and the landscape slice
# ---------------------------------------------------------------------------

LAB_EDGE_PIXELS = (*range(1, 18), 47, 48, 49, 511, 512, 513, 1537, 4096 + 11,
                   8 * 853 * 1280 + 1)


@pytest.fixture(scope="module")
def lab_bytes():
    n = 3 * LAB_EDGE_PIXELS[-1] + 32
    return torch.from_numpy(np.random.default_rng(17).integers(0, 256, n, dtype=np.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", range(16))
@pytest.mark.parametrize("n_pix", LAB_EDGE_PIXELS)
def test_rgb_to_lab_kernel_at_edge_shapes_and_offsets(cuda_device, lab_bytes, n_pix, offset):
    """Pixel counts around a lane's 16 and a warp's 512, and one past 8
    night scenes of 1280x853; inputs 0-15 bytes past a 16-byte boundary;
    an output written only where it lies."""
    flat = lab_bytes.to(cuda_device)
    x = flat[offset:offset + 3 * n_pix].view(n_pix, 3)
    assert (x.data_ptr() - flat.data_ptr()) == offset and flat.data_ptr() % 16 == 0
    tables = color.lab_tables_on(cuda_device)
    out = _count("rgb_to_lab", lambda: kernels.rgb_to_lab(x, tables))
    assert torch.equal(out, kernels.rgb_to_lab_ref(x, tables))


@pytest.mark.cuda
@pytest.mark.parametrize("tables_kind", ["gamma_x2", "negative_coefficient"])
@pytest.mark.parametrize("offset", [0, 5])
def test_rgb_to_lab_kernel_with_tables_past_the_cube_root(cuda_device, lab_bytes, tables_kind,
                                                         offset):
    """Tables whose cube-root index leaves the table (above it, below 0):
    the kernel's clamped form, equal to the plain version's clamp."""
    t = color.lab_tables_on(torch.device("cpu")).clone()
    if tables_kind == "gamma_x2":
        t[:256] *= 2
    else:
        t[-8] = -t[-8]
    n_pix = 4096 + 11
    x = lab_bytes[offset:offset + 3 * n_pix].view(n_pix, 3)
    out = _count("rgb_to_lab", lambda: kernels.rgb_to_lab(x.to(cuda_device), t.to(cuda_device)))
    assert torch.equal(out.cpu(), kernels.rgb_to_lab_ref(x, t))


@pytest.mark.cuda
def test_rgb_to_lab_kernel_into_an_unaligned_output(cuda_device, lab_bytes):
    """The C entry point with an output 3 bytes past a 16-byte boundary
    (the wrapper allocates aligned outputs; the kernel then stores bytes)."""
    import ctypes
    lib = kernels._load()
    n_pix = 4096 + 11
    x = lab_bytes[:3 * n_pix].to(cuda_device)
    tables = color.lab_tables_on(cuda_device)
    buf = torch.full((3 * n_pix + 32,), 0x5A, dtype=torch.uint8, device=cuda_device)
    rc = lib.tpuimage_rgb_to_lab(x.data_ptr(), buf[3:].data_ptr(), tables.data_ptr(), n_pix,
                                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    assert rc == 0
    assert torch.equal(buf[3:3 + 3 * n_pix], kernels.rgb_to_lab_ref(x.view(n_pix, 3), tables)
                       .reshape(-1))
    assert bool((buf[:3] == 0x5A).all()) and bool((buf[3 + 3 * n_pix:] == 0x5A).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 853, 1280, 3), (48, 64, 3), (3, 37, 53, 3)])
def test_gaussian_blur_u8_channels_last_on_card(cuda_device, shape):
    """landscape's sharpening blur (sigma 1, ksize 7) of (..., H, W, 3)
    images: the kernel on the channel planes, card = host."""
    from tpuimage_torch.ops import filters
    x = torch.from_numpy(np.random.default_rng(len(shape)).integers(0, 256, shape,
                                                                     dtype=np.uint8))
    out = _count("gaussian_blur_u8", lambda: filters.gaussian_blur_u8(
        x.to(cuda_device), ksize=0, sigma=1.0, channels_last=True))
    assert out.shape == x.shape and out.is_contiguous()
    assert torch.equal(out.cpu(), filters.gaussian_blur_u8(x, ksize=0, sigma=1.0,
                                                           channels_last=True))


def _landscape_within(card, host, what):
    """Card against host: the night_rgb tolerance (lab_to_rgb runs in f32
    on both): at most 3 levels on < 0.1% of values."""
    diff = (card.cpu().to(torch.int32) - host.to(torch.int32)).abs()
    assert int(diff.max()) <= 3, (what, int(diff.max()))
    assert int((diff > 0).sum()) < 0.001 * diff.numel(), (what, int((diff > 0).sum()))


@pytest.fixture(scope="module")
def landscape_scenes():
    return np.stack([synth.landscape_scene(700 + i, 120, 176) for i in range(2)])


@pytest.mark.cuda
def test_landscape_gui_on_card_equals_host(cuda_device, landscape_scenes):
    from tpuimage_torch.pipelines import landscape
    kernels.reset_launch_counts()
    card = landscape.landscape_gui(landscape_scenes)          # an array: on the card
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for name in ("bilateral", "rgb_to_lab", "hist256", "clahe_apply", "gaussian_blur_u8"):
        assert counts[name] > 0, (name, counts)
    assert card.device.type == "cuda"
    _landscape_within(card, landscape.landscape_gui(landscape_scenes, device="cpu"), "gui")


@pytest.mark.cuda
def test_landscape_eval_batch_on_card_equals_host(cuda_device, landscape_scenes):
    from tpuimage_torch.pipelines import landscape
    noise = torch.randn(landscape_scenes.shape, generator=torch.Generator().manual_seed(3))
    card = landscape.landscape_eval_batch(landscape_scenes, noise=noise.to(cuda_device))
    host = landscape.landscape_eval_batch(landscape_scenes, noise=noise, device="cpu")
    assert torch.equal(card["degraded"].cpu(), host["degraded"])
    for k in ("enhanced", "restored"):
        _landscape_within(card[k], host[k], k)
    for k in ("psnr_enhanced", "psnr_restored"):
        assert card[k].shape == (2,)
        assert torch.allclose(card[k].cpu(), host[k], rtol=1e-4, atol=0), k
    for k in ("ssim_enhanced", "ssim_restored"):
        assert torch.allclose(card[k].cpu(), host[k], rtol=0, atol=1e-3), k


# ---------------------------------------------------------------------------
# face: the five kernels at face's shapes, the channel-last denoisers, and
# enhance_face card against host
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def face_portraits():
    return [synth.portrait(900 + i, 256, 171, noise=n)
            for i, n in enumerate(synth.PORTRAIT_NOISE)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,sc,ss", [(5, 20.0, 20.0), (-1, 30.0, 10.0)])
def test_bilateral_kernel_at_face_parameters(cuda_device, face_portraits, d, sc, ss):
    """The polish (d 5, 20/20) and the glamour filter (radius 15) on colour
    portraits: the kernel equal to its plain version."""
    from tpuimage_torch.ops import bilateral
    x = torch.from_numpy(np.stack([p[0] for p in face_portraits]))
    radius, taps, space_w, lut = bilateral.tables_on(d, sc, ss, 3, cuda_device)
    out = _count("bilateral", lambda: kernels.bilateral(x.to(cuda_device), taps, space_w, lut,
                                                        radius))
    assert torch.equal(out.cpu(), kernels.bilateral_ref(x, taps.cpu(), space_w.cpu(),
                                                        lut.cpu(), radius))


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["k5_rgb", "k9_rgb", "k21_mask", "sigma3_l", "k31_eyes"])
def test_gaussian_kernel_at_face_shapes(cuda_device, face_portraits, what):
    """face's blurs: k 5 and 9 on each channel of the portraits, k 21 on
    the skin mask, sigma 3 (k 19) on L, k 31 on each eye ellipse."""
    from tpuimage_torch.ops import filters
    from tpuimage_torch.pipelines import face
    x = torch.from_numpy(np.stack([p[0] for p in face_portraits]))
    if what in ("k5_rgb", "k9_rgb"):
        k = int(what[1])
        out = _count("gaussian_blur_u8", lambda: filters.gaussian_blur_u8(
            x.to(cuda_device), ksize=k, channels_last=True))
        assert torch.equal(out.cpu(), filters.gaussian_blur_u8(x, ksize=k, channels_last=True))
        return
    if what == "k31_eyes":
        for h, w in synth.eye_region_shapes():       # 1280 x 853's boxes, then odd sizes
            m = face.eye_ellipse(h, w)
            out = _count("gaussian_blur_u8", lambda: filters.gaussian_blur_u8(
                m.to(cuda_device), ksize=31))
            assert torch.equal(out.cpu(), kernels.gaussian_blur_u8_ref(m[None], 31)[0]), (h, w)
        return
    if what == "k21_mask":
        plane, k, sigma = face.get_refined_skin_mask(x), 21, 0.0
    else:
        plane, k, sigma = color.rgb_to_lab(x)[..., 0].contiguous(), 0, 3.0
    out = _count("gaussian_blur_u8", lambda: filters.gaussian_blur_u8(
        plane.to(cuda_device), ksize=k, sigma=sigma))
    assert torch.equal(out.cpu(), filters.gaussian_blur_u8(plane, ksize=k, sigma=sigma))


@pytest.mark.cuda
def test_lab_hist_clahe_kernels_on_eye_regions(cuda_device):
    """rgb_to_lab, hist256 and clahe_apply at 4x4 tiles on the eye regions
    of a 1280 x 853 portrait (both boxes as the eye pop cuts them, 57 x 69)
    and on synth.EYE_EDGE_SHAPES (31-61 px, odd widths) around the first,
    all slices of a card tensor: each kernel equal to its plain version on
    the same inputs, and the CLAHE on the card equal to the host's."""
    img, eyes = synth.portrait(11)
    img_d = torch.from_numpy(img).to(cuda_device)
    tables = color.lab_tables_on(cuda_device)
    (ex, ey, ew, eh) = eyes[0]
    boxes = list(eyes) + [(ex + ew // 2 - w // 2 - i, ey + eh // 2 - h // 2 + i, w, h)
                          for i, (h, w) in enumerate(synth.EYE_EDGE_SHAPES)]
    assert {(b[3], b[2]) for b in boxes} == set(synth.eye_region_shapes())
    for x0, y0, w, h in boxes:
        roi = img_d[y0:y0 + h, x0:x0 + w].contiguous()
        lab = _count("rgb_to_lab", lambda: kernels.rgb_to_lab(roi, tables))
        assert torch.equal(lab.cpu(), kernels.rgb_to_lab_ref(roi.cpu(), tables.cpu()))
        lum = lab[..., 0].contiguous()[None]
        tiles, th, tw = histogram.clahe_tiles(lum, 4, 4)
        hist = _count("hist256", lambda: kernels.hist256_batch(tiles))
        assert torch.equal(hist.cpu(), kernels.hist256_batch_ref(tiles.cpu()))
        luts = histogram.tile_luts_from_counts(hist, 0.2, th * tw).reshape(1, 4, 4, 256)
        R, C = histogram.blend_tables_on(h, w, th, tw, 4, 4, cuda_device)
        out = _count("clahe_apply", lambda: kernels.clahe_apply(lum, luts, R, C))
        assert torch.equal(out.cpu(), kernels.clahe_apply_ref(lum.cpu(), luts.cpu(), R.cpu(),
                                                              C.cpu()))
        assert torch.equal(histogram.clahe(lum, 0.2, 4, 4).cpu(),
                           histogram.clahe(lum.cpu(), 0.2, 4, 4)), (h, w)


@pytest.mark.cuda
def test_face_kernels_on_a_full_size_portrait(cuda_device):
    """One 1280 x 853 portrait (853 wide) through the path's full-size
    kernels on the inputs the path gives them: the glamour bilateral
    (radius 15) on the denoised image, rgb_to_lab and the 8x8 CLAHE's
    hist256 and clahe_apply (clip 0.5) on the tone stage's input; each
    equal to its plain version run on the card."""
    from tpuimage_torch.ops import bilateral
    from tpuimage_torch.pipelines import face
    img, eyes = synth.portrait(12)
    pre = face.face_pre_eyes(img, "gaussian")                   # on the card
    combined = pre["denoised_combined"][None].contiguous()
    radius, taps, space_w, lut = bilateral.tables_on(-1, 30.0, 10.0, 3, cuda_device)
    out = _count("bilateral", lambda: kernels.bilateral(combined, taps, space_w, lut, radius))
    assert torch.equal(out, kernels.bilateral_ref(combined, taps, space_w, lut, radius))
    toned = face.apply_warmth(face.adjust_saturation(
        face.pixel_pop_eyes(pre["skin_enhanced"], eyes), face.COLOR_SATURATION), 15.0)
    tables = color.lab_tables_on(cuda_device)
    lab = _count("rgb_to_lab", lambda: kernels.rgb_to_lab(toned.contiguous(), tables))
    assert torch.equal(lab, kernels.rgb_to_lab_ref(toned.contiguous(), tables))
    lum = lab[..., 0].contiguous()[None]
    tiles, th, tw = histogram.clahe_tiles(lum, 8, 8)
    hist = _count("hist256", lambda: kernels.hist256_batch(tiles))
    assert torch.equal(hist, kernels.hist256_batch_ref(tiles))
    luts = histogram.tile_luts_from_counts(hist, 0.5, th * tw).reshape(1, 8, 8, 256)
    R, C = histogram.blend_tables_on(1280, 853, th, tw, 8, 8, cuda_device)
    out = _count("clahe_apply", lambda: kernels.clahe_apply(lum, luts, R, C))
    assert torch.equal(out, kernels.clahe_apply_ref(lum, luts, R, C))


@pytest.mark.cuda
@pytest.mark.parametrize("op,k", [("median", 3), ("median", 5), ("gaussian", 5),
                                  ("gaussian", 9)])
def test_channel_last_denoisers_on_card(cuda_device, face_portraits, op, k):
    from tpuimage_torch.ops import filters, median
    x = torch.from_numpy(face_portraits[1][0])
    fn = ((lambda t: median.median_blur(t, k, channels_last=True)) if op == "median" else
          (lambda t: filters.gaussian_blur_u8(t, ksize=k, channels_last=True)))
    card = fn(x.to(cuda_device))
    assert card.shape == x.shape and torch.equal(card.cpu(), fn(x))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["script", "gui"])
@pytest.mark.parametrize("noise", ["gaussian", "impulse"])
def test_enhance_face_on_card_equals_host(cuda_device, face_portraits, noise, variant):
    """The whole path on one small portrait, the synth eye boxes given:
    every image within the night_rgb tolerance of the host's (expected
    equal), and the path's kernels launched."""
    from tpuimage_torch.pipelines import face
    img, eyes = face_portraits[synth.PORTRAIT_NOISE.index(noise)]
    kernels.reset_launch_counts()
    card = face.enhance_face(img, eyes=eyes, variant=variant)     # an array: on the card
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for name in ("bilateral", "rgb_to_lab", "hist256", "clahe_apply", "gaussian_blur_u8"):
        assert counts[name] > 0, (name, counts)
    host = face.enhance_face(img, eyes=eyes, variant=variant, device="cpu")
    assert card["noise_type"] == host["noise_type"] == noise
    for k in ("skin_mask", "skin_enhanced", "features_popped", "final"):
        assert card[k].device.type == "cuda"
        _landscape_within(card[k], host[k], k)


# ---------------------------------------------------------------------------
# classify and route: the cue program's three kernels at its shapes, the
# classifiers, CLIP and the routes, card against host
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def classify_mix():
    return synth.scene_mix(0, 427, 640)


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["landscape_shape", "portrait_shape", "tall_narrow"])
def test_cue_kernels_on_card(cuda_device, classify_mix, group):
    """hist256 (the Otsu rows), rank_extract (the edge compaction at the
    cue budget) and hough_votes (the line count) on the cue program's
    stacks, each exact against its plain version; then the whole cue
    program card = host."""
    from tpuimage_torch.classify import heuristic
    from tpuimage_torch.ops import edges as edgeops
    if group == "tall_narrow":   # 1600 x 200: the budget is the 128 * h term
        imgs = [synth.document_photo(5 + i, 1600, 200) for i in range(2)]
    else:
        imgs = [img for _, img in classify_mix
                if (img.shape[0] < img.shape[1]) == (group == "landscape_shape")]
    stack = torch.from_numpy(np.stack(imgs)).to(cuda_device)
    gray = color.rgb_to_gray(stack)
    b, h, w = gray.shape
    rows = gray.reshape(b, h * w)
    out = _count("hist256", lambda: kernels.hist256_batch(rows))
    assert torch.equal(out.cpu(), kernels.hist256_batch_ref(rows.cpu()))
    flat = edgeops.canny(gray, 50, 150).reshape(b, h * w) > 0
    rank, counts = hough.exclusive_rank(flat)
    budget = heuristic.cue_budget(h, w)
    if group == "tall_narrow":
        assert budget == 128 * h
    kk = max(int(torch.clamp(counts, max=budget).max()), 1)
    ci = _count("rank_extract", lambda: kernels.rank_extract(rank.t(), flat.t(), kk))
    assert torch.equal(ci.cpu(), kernels.rank_extract_ref(rank.t().cpu(), flat.t().cpu(), kk))
    xs, ys, kept, _ = hough.compact_edges(flat.reshape(b, h, w).to(torch.uint8), budget)
    numrho = 2 * (w + h) + 1
    cos_np, sin_np = hough.hough_tables()
    cos_t, sin_t = torch.from_numpy(cos_np).to(cuda_device), torch.from_numpy(sin_np).to(cuda_device)
    votes = _count("hough_votes", lambda: kernels.hough_votes(xs, ys, kept, cos_t, sin_t, numrho,
                                                              (numrho - 1) // 2))
    assert torch.equal(votes.cpu(), kernels.hough_votes_ref(xs.cpu(), ys.cpu(), kept.cpu(),
                                                            cos_t.cpu(), sin_t.cpu(), numrho,
                                                            (numrho - 1) // 2))
    card = heuristic.device_cues(stack)
    host = heuristic.device_cues(stack.cpu())
    for c, hh in zip(card, host):
        assert c.device.type == "cuda" and torch.equal(c.cpu(), hh)


@pytest.mark.cuda
def test_classifiers_on_card_equal_host(cuda_device, classify_mix):
    from tpuimage_torch.classify import heuristic
    imgs = [img for _, img in classify_mix]
    kernels.reset_launch_counts()
    card_w = heuristic.classify_weighted_batch(imgs)          # arrays: on the card
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for name in ("hist256", "rank_extract", "hough_votes"):
        assert counts[name] > 0, (name, counts)
    assert card_w == heuristic.classify_weighted_batch(imgs, device="cpu")
    assert heuristic.classify_priority_batch(imgs) == \
        heuristic.classify_priority_batch(imgs, device="cpu")
    for img, w in zip(imgs[:4], card_w):
        assert heuristic.classify_weighted(img) == w


@pytest.mark.cuda
def test_clip_on_card_equals_host(cuda_device, classify_mix):
    """ViT-B/32 at its full shapes on seeded weights: probabilities on the
    card within 1e-4 of the host's, the argmax equal."""
    from tpuimage_torch.classify import clip
    from tpuimage_torch.classify.tokenizer import SimpleTokenizer
    sd = synth.clip_state_dict(7)
    tokens = SimpleTokenizer(merges=synth.prompt_merges()).tokenize(
        [clip.PROMPTS[label] for label in clip.LABELS])
    tf_card = clip.compute_text_features(sd, tokens)
    tf_host = clip.compute_text_features(sd, tokens, device="cpu")
    assert tf_card.device.type == "cuda"
    assert torch.allclose(tf_card.cpu(), tf_host, rtol=0, atol=2e-4)
    imgs = np.stack([img for _, img in classify_mix if img.shape[0] < img.shape[1]])
    card = clip.ClipZeroShot(sd, tf_host.numpy()).predict_batch(imgs)
    host = clip.ClipZeroShot(sd, tf_host.numpy(), device="cpu").predict_batch(imgs)
    assert card.device.type == "cuda"
    assert torch.allclose(card.cpu(), host, rtol=0, atol=1e-4)
    assert torch.equal(card.argmax(-1).cpu(), host.argmax(-1))
    crop_card = clip.preprocess_crop_u8(torch.from_numpy(imgs).to(cuda_device))
    assert torch.equal(crop_card.cpu(), clip.preprocess_crop_u8(torch.from_numpy(imgs)))


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["nightscape", "landscape", "face", "document"])
def test_routes_on_card_equal_host(cuda_device, classify_mix, label):
    """Each route on the mix's image of its kind: the night_rgb tolerance
    for images (3 levels on < 0.1%), the binary page different on < 0.2%."""
    from tpuimage_torch.classify import router
    img = next(img for kind, img in classify_mix if kind == label)
    card = router.enhance_for_label(label, img)                # an array: on the card
    host = router.enhance_for_label(label, img, device="cpu")
    assert card.device.type == "cuda" and card.dtype == torch.uint8
    if label == "document":
        assert card.shape == host.shape
        assert float((card.cpu() != host).float().mean()) < 0.002
    else:
        assert card.shape == img.shape
        _landscape_within(card, host, label)


# ---------------------------------------------------------------------------
# the notebook pipelines and presets: their four kernels at the slice's
# shapes, and the entry points card against host
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shadow_scenes():
    return np.stack([synth.shadowed_scene(1300 + i, 853, 1280) for i in range(2)])


@pytest.mark.cuda
def test_notebook_kernels_at_their_shapes(cuda_device, shadow_scenes):
    """The unsharp's k 3 channel-last blur of two scenes of 1280x853, k 5 on
    a 1200x1600 gray, sigma 1 (k 7) on a 1200x1600 page's planes,
    rgb_to_lab, hist256 on the CLAHE tiles and the whole L planes, and
    clahe_apply at clip 2, 3 and 4: each equal to its plain version."""
    from tpuimage_torch.ops.filters import gaussian_blur_u8
    scenes = torch.from_numpy(shadow_scenes).to(cuda_device)
    page = torch.from_numpy(synth.white_page(1390)).to(cuda_device)
    for planes, k, sigma in ((scenes.movedim(-1, -3).reshape(-1, 853, 1280), 3, 0.0),
                             (color.rgb_to_gray(page)[None], 5, 0.0),
                             (page.movedim(-1, -3), 7, 1.0)):
        planes = planes.contiguous()
        assert torch.equal(kernels.gaussian_blur_u8(planes, k, sigma).cpu(),
                           kernels.gaussian_blur_u8_ref(planes.cpu(), k, sigma))
    assert torch.equal(gaussian_blur_u8(scenes, 3, channels_last=True).cpu(),
                       gaussian_blur_u8(scenes.cpu(), 3, channels_last=True))
    tables = color.lab_tables_on(cuda_device)
    assert torch.equal(kernels.rgb_to_lab(scenes, tables).cpu(),
                       kernels.rgb_to_lab_ref(scenes.cpu(), tables.cpu()))
    lum = color.rgb_to_lab(scenes)[..., 0].contiguous()
    tiles, th, tw = histogram.clahe_tiles(lum, 8, 8)
    counts = kernels.hist256_batch(tiles)
    assert torch.equal(counts.cpu(), kernels.hist256_batch_ref(tiles.cpu()))
    rows = lum.reshape(2, -1)
    assert torch.equal(kernels.hist256_batch(rows).cpu(), kernels.hist256_batch_ref(rows.cpu()))
    R, C = histogram.blend_tables_on(853, 1280, th, tw, 8, 8, cuda_device)
    for clip in (2, 3, 4):
        luts = histogram.tile_luts_from_counts(counts, clip, th * tw).reshape(-1, 8, 8, 256)
        assert torch.equal(kernels.clahe_apply(lum, luts, R, C).cpu(),
                           kernels.clahe_apply_ref(lum.cpu(), luts.cpu(), R.cpu(), C.cpu()))
    assert torch.equal(histogram.equalize_hist(lum).cpu(), histogram.equalize_hist(lum.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["DOCUMENT", "NIGHT", "PORTRAIT", "GENERAL"])
def test_enhance_shadow_batch_on_card_equals_host(cuda_device, name):
    """Each preset on two scenes of 240x320 (DOCUMENT's 641-tap Retinex
    reflects past them): the mask equal, DOCUMENT and NIGHT equal, the
    presets with a CLAHE within the night_rgb tolerance (expected equal)."""
    from tpuimage_torch.pipelines import shadow
    xs = np.stack([synth.shadowed_scene(1310 + i, 240, 320) for i in range(2)])
    kernels.reset_launch_counts()
    final, mask = shadow.enhance_shadow_batch(xs, shadow.PRESETS[name])   # arrays: on the card
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if shadow.PRESETS[name].use_clahe:
        assert counts["clahe_apply"] > 0 and counts["rgb_to_lab"] > 0, counts
    final_h, mask_h = shadow.enhance_shadow_batch(xs, shadow.PRESETS[name], device="cpu")
    assert final.device.type == "cuda"
    assert torch.equal(mask.cpu(), mask_h)
    if name in ("DOCUMENT", "NIGHT"):
        assert torch.equal(final.cpu(), final_h)
    else:
        _landscape_within(final, final_h, name)


@pytest.mark.cuda
def test_notebook_modules_and_presets_on_card_equal_host(cuda_device):
    """The appliers, modules 1, 3-6 and the docrestore core on small
    inputs: card within the night_rgb tolerance of the host (measured
    equal); the core stage by stage."""
    from tpuimage_torch.pipelines import docrestore, modules
    from tpuimage_torch.presets import apply
    from tpuimage_torch.presets.loader import CategorizationPreset, EnhancementPreset
    x = synth.shadowed_scene(1320, 240, 320)
    every = CategorizationPreset(
        name="every", group="g", brightness_mode="gamma", brightness_gamma=0.9,
        contrast_mode="clahe", saturation_mult=1.2, gray_world=True, chroma_boost_cb=1.1,
        highlight_compression="log", local_contrast=True, invert=True)
    sky = EnhancementPreset(name="sky", group="g", hist_method="equalization",
                            sky_protection_power=3.0, blend_strength=0.55)
    calls = (("categorization", lambda **kw: apply.apply_categorization_preset(x, every, **kw)),
             ("enhancement", lambda **kw: apply.apply_enhancement_preset(x, sky, **kw)),
             ("module1", lambda **kw: modules.module1_enhance(x, **kw)),
             ("module3", lambda **kw: modules.module3_transform(x, 12.0, 0.8, (25, -15), **kw)),
             ("module4", lambda **kw: modules.module4_segment(x, **kw)),
             ("module5", lambda **kw: modules.module5_color(x, "HSV", **kw)),
             ("module6", lambda **kw: modules.module6_features(x, **kw)["edge_map"]))
    for what, fn in calls:
        card = fn()
        assert card.device.type == "cuda", what
        _landscape_within(card, fn(device="cpu"), what)
    doc = synth.white_page(1321, 320, 240)
    den, cl, sharp = docrestore._enhance_core(torch.from_numpy(doc).to(cuda_device))
    # the NLM's f32 exp differs between the card and the host in the last
    # place: 2 levels on ~1e-5 of values; each later stage on the card's
    # previous one is equal
    diff = (den.cpu().to(torch.int32) - docrestore._denoise(torch.from_numpy(doc))).abs()
    assert int(diff.max()) <= 2 and int((diff > 0).sum()) < 1e-4 * diff.numel()
    assert torch.equal(cl.cpu(), docrestore._clahe_l(den.cpu()))
    assert torch.equal(sharp.cpu(), docrestore._stretch_sharpen(cl.cpu()))
    gray = color.rgb_to_gray(sharp)
    for c, h in zip(docrestore._segment_and_final(gray),
                    docrestore._segment_and_final(gray.cpu())):
        assert torch.equal(c.cpu(), h)


# --- the CLIs on the card: PNG files through io/png.py where PIL is absent ---

def _cli(name: str, argv) -> dict:
    """Run a port CLI on the card; its launch counts."""
    import importlib
    kernels.reset_launch_counts()
    importlib.import_module(f"tpuimage_torch.cli.{name}").main(argv)
    torch.cuda.synchronize()
    return kernels.launch_counts()


@pytest.fixture()
def cli_env(monkeypatch):
    """No build cache, a bounded device claim, and PIL's import made to
    fail: the files go through io/png.py, as on a machine without PIL."""
    import sys
    monkeypatch.delenv("TPUIMAGE_XLA_CACHE", raising=False)
    monkeypatch.setenv("TPUIMAGE_DEVICE_TIMEOUT", "60")
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["morphseq", "night", "landscape", "docscan", "classify"])
def test_cli_on_card_writes_its_entry_point(cuda_device, cli_env, tmp_path, name):
    """Each PNG CLI on the card writes exactly what its in-memory entry
    point computes on the card, and launches its path's kernels."""
    from tpuimage_torch.classify.router import classify_and_enhance
    from tpuimage_torch.io.png import read_png, write_png
    from tpuimage_torch.pipelines import docscan, landscape, morphseq, night

    out = tmp_path / "out"

    def img(path):
        return torch.from_numpy(read_png(path)).to(cuda_device)

    def same(fname, tensor):
        np.testing.assert_array_equal(read_png(out / fname), tensor.cpu().numpy(), err_msg=fname)

    if name == "morphseq":
        src = tmp_path / "m.png"
        write_png(src, synth.document_photo(1, 963, 1280))
        counts = _cli(name, [str(src), "--out", str(out)])
        st = morphseq.morphseq_stages(img(src))
        for fname, key in morphseq._STAGE_FILES:
            same(fname, st[key])
        same("morphseq_closed.png", st["step4_closed"])
        need = ("gray_erode3", "hist256", "binary_close3")
    elif name == "night":
        src = tmp_path / "n.png"
        write_png(src, synth.night_scene(2, 853, 1280))
        counts = _cli(name, [str(src), "--out", str(out), "--histograms"])
        st = night.night_rgb(img(src))
        for stage, t in st.items():
            same(f"night_{stage}.png", t)
            hist = np.loadtxt(out / f"night_{stage}_hist.csv", dtype=np.int64)
            np.testing.assert_array_equal(hist, histogram.hist256(color.rgb_to_gray(t)).cpu())
        need = ("rgb_to_lab", "hist256", "clahe_apply")
    elif name == "landscape":
        src = tmp_path / "scenes"
        src.mkdir()
        for i in range(2):
            write_png(src / f"s{i}.png", synth.landscape_scene(i, 427, 640))
        counts = _cli(name, [str(src), "--out", str(out), "--seed", "5"])
        gen = torch.Generator(device=cuda_device).manual_seed(5)
        for i in range(2):
            res = landscape.landscape_eval_step(img(src / f"s{i}.png"), generator=gen)
            for k in ("enhanced", "degraded", "restored"):
                same(f"s{i}_{k}.png", res[k])
        need = ("bilateral", "rgb_to_lab", "hist256", "clahe_apply", "gaussian_blur_u8")
    elif name == "docscan":
        src = tmp_path / "d.png"
        write_png(src, synth.document_photo(3, 1600, 1200))
        counts = _cli(name, [str(src), "--out", str(out), "--gui-preset"])
        res = docscan.process_document(img(src), out_dir=None,
                                       config=docscan.GUI_DOCUMENT_CONFIG)
        same("scan_03_warped.png", res["warped"])
        same("scan_08_clean.png", res["binary"])
        assert len(list(out.glob("scan_*.png"))) == 10
        need = ("bilateral", "rank_extract", "hough_votes", "gauss_chain", "blackhat_rect",
                "hist256", "inkmask_weighted")
    else:
        files = []
        for i, (kind, rgb) in enumerate(synth.scene_mix(0, 427, 640)[::2]):
            files.append(tmp_path / f"{i}_{kind}.png")
            write_png(files[-1], rgb)
        counts = _cli(name, [*map(str, files), "--out", str(out)])
        for f in files:
            label, _, enhanced = classify_and_enhance(img(f))
            same(f"{f.stem}_{label}_enhanced.png", enhanced)
        need = ("hist256", "rank_extract", "hough_votes")
    for k in need:
        assert counts[k] > 0, (name, k, counts)


@pytest.mark.cuda
def test_png_round_trip_full_size(cuda_device, tmp_path):
    """The codec on the card machine's host at DocScanner's photo size."""
    from tpuimage_torch.io.png import read_png, write_png
    rgb = synth.document_photo(5, 1600, 1200)
    for arr in (rgb, np.ascontiguousarray(rgb[..., 1])):
        for level in (1, 6):
            write_png(tmp_path / "a.png", arr, level)
            np.testing.assert_array_equal(read_png(tmp_path / "a.png"), arr)


@pytest.mark.cuda
def test_require_device_on_card(cuda_device):
    from tpuimage_torch.runtime import health
    health.require_device(60, what="a test", device="cuda")
    assert health.device_available(60, device=cuda_device)


def _card_meshes(cuda_device):
    """4 shards on the one card, and the distinct cards where there are
    several."""
    from tpuimage_torch.runtime.mesh import make_mesh
    meshes = [make_mesh(4, ("space",), devices=[cuda_device] * 4)]
    if torch.cuda.device_count() > 1:
        meshes.append(make_mesh(4 if torch.cuda.device_count() >= 4 else 2, ("space",)))
    return meshes


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gui_page", "gui_tilted", "default_close"])
def test_post_warp_spatial_on_card(cuda_device, case):
    """The H-sharded post-warp on the card: every stage equal to
    docscan_post_warp on the card (an A4 page at the GUI config, a tilted
    one so the rotation runs, the default config so the close runs)."""
    from tpuimage_torch.pipelines import docscan
    from tpuimage_torch.runtime.spatial import docscan_post_warp_spatial
    page = synth.page(31, 1200, 849, tilt_deg=4.0 if case == "gui_tilted" else 0.0,
                      rules=3 if case == "gui_tilted" else 0)
    cfg = docscan.DocScanConfig() if case == "default_close" else docscan.GUI_DOCUMENT_CONFIG
    x = torch.from_numpy(page).to(cuda_device)
    ref = docscan.docscan_post_warp(x, cfg)
    if case == "gui_tilted":
        assert float(ref["deskew_angle"]) != 0.0
    for mesh in _card_meshes(cuda_device):
        before = kernels.launch_counts()
        out = docscan_post_warp_spatial(x, cfg, mesh)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        for k in ("gauss_chain", "blackhat_rect", "hist256", "inkmask_weighted",
                  "rank_extract", "hough_votes"):
            assert after[k] > before[k], k
        for k in ref:
            assert torch.equal(out[k].cpu(), ref[k].cpu()), (case, k)


@pytest.mark.cuda
def test_night_spatial_on_card(cuda_device):
    """night_gray_spatial / night_rgb_spatial on 4 shards of the card,
    equal to the unsharded composition on the card."""
    from tpuimage_torch.ops.median import median_blur
    from tpuimage_torch.pipelines import night
    from tpuimage_torch.runtime.spatial import night_gray_spatial, night_rgb_spatial
    rgb = torch.from_numpy(np.stack([synth.night_scene(s, 856, 1280) for s in (1, 2)]))
    rgb = rgb.to(cuda_device)
    for mesh in _card_meshes(cuda_device):
        g = night_gray_spatial(rgb[..., 1], mesh)
        ref = night.night_gray(rgb[..., 1].contiguous())
        for k in ref:
            assert torch.equal(g[k].cpu(), ref[k].cpu()), k
        out = night_rgb_spatial(rgb, mesh)
        filt = median_blur(rgb, 3, channels_last=True).contiguous()
        lab = color.rgb_to_lab(filt)
        l_enh = histogram.clahe(lab[..., 0], clip_limit=2.0, tiles_x=8, tiles_y=8)
        enh = color.lab_to_rgb(torch.cat([l_enh[..., None], lab[..., 1:]], dim=-1), impl="lut")
        assert torch.equal(out["filtered"].cpu(), filt.cpu())
        assert torch.equal(out["enhanced"].cpu(), enh.cpu())


@pytest.mark.cuda
def test_lab_to_rgb_lut_card_equals_host(cuda_device):
    """The integer Lab -> RGB on the whole 256^3 Lab grid, card = host."""
    grid = torch.stack(torch.meshgrid(*[torch.arange(256, dtype=torch.uint8)] * 3,
                                      indexing="ij"), dim=-1).reshape(-1, 3)
    card = color.lab_to_rgb(grid.to(cuda_device), impl="lut").cpu()
    for part in range(4):
        rows = slice(part * (1 << 22), (part + 1) * (1 << 22))
        assert torch.equal(card[rows], color.lab_to_rgb(grid[rows], impl="lut")), part


@pytest.mark.cuda
def test_scan_batch_on_a_card_mesh(cuda_device):
    """scan_batch(mesh=) and scan_stream(mesh=) over 4 shards of the card
    (5 photos: the pad runs) equal the unsharded calls."""
    from tpuimage_torch.pipelines import docscan
    from tpuimage_torch.runtime.mesh import make_mesh
    photos = [synth.document_photo(s, 1600, 1200, tilt_deg=3.0 * (s % 2)) for s in range(5)]
    mesh = make_mesh(4, devices=[cuda_device] * 4)
    ref = docscan.scan_batch(photos, device=cuda_device)
    for got in (docscan.scan_batch(photos, mesh=mesh),
                [r for b in docscan.scan_stream([photos[:3], photos[3:]], mesh=mesh) for r in b]):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert set(a) == set(b)
            np.testing.assert_array_equal(a["binary"], b["binary"])
            assert a["deskew_angle"] == b["deskew_angle"] and a["use_whole"] == b["use_whole"]


# --- the port closed: the repaired forms and the last public names -----------

EVERY_STAGE = dict(brightness_mode="gamma", brightness_gamma=0.9, linear_boost_beta=4.0,
                   contrast_mode="clahe", clahe_clip=2.0, saturation_mult=1.2,
                   saturation_cap=0.5, gray_world=True, chroma_boost_cb=1.1,
                   chroma_boost_cr=1.05, highlight_compression="sqrt", local_contrast=True,
                   lc_radius=2.0, lc_amount=0.6, lc_threshold=1.0, invert=True)


@pytest.mark.cuda
def test_rotation_at_quarter_degrees_card_equals_host(cuda_device):
    """rotate_pages at every quarter degree in +-10 (81 angles) on a
    300x212 page: card = host (cos / sin in f64 rounded to f32, the fused
    products in f64, the rows-first blend in f32 on both)."""
    from tpuimage_torch.ops import geometry
    page = synth.page(41, 300, 212, rules=3)[..., 1]
    angles = torch.arange(-40, 41, dtype=torch.float32) / 4
    stack = torch.from_numpy(np.repeat(page[None], len(angles), 0))
    card = geometry.rotate_pages(stack.to(cuda_device), angles.to(cuda_device), 10.0)
    assert torch.equal(card.cpu(), geometry.rotate_pages(stack, angles, 10.0))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["PORTRAIT", "EVERY_STAGE"])
def test_portrait_and_every_stage_card_equals_host(cuda_device, which):
    """PORTRAIT (its CLAHE blend fusing its first product) and the
    categorisation applier with every stage on (the gray world's tree-reduce
    means, lab_to_rgb's folded constants and sRGB thresholds) on two
    scenes of 240x320: card = host, the CLAHE kernels launched."""
    xs = np.stack([synth.shadowed_scene(1330 + i, 240, 320) for i in range(2)])
    from tpuimage_torch.pipelines import shadow
    from tpuimage_torch.presets import apply
    from tpuimage_torch.presets.loader import CategorizationPreset
    every = CategorizationPreset(name="every", group="g", **EVERY_STAGE)

    def run(**kw):
        if which == "PORTRAIT":
            return shadow.enhance_shadow_batch(xs, shadow.PRESETS["PORTRAIT"], **kw)[0]
        return apply.apply_categorization_preset(xs, every, **kw)
    kernels.reset_launch_counts()
    card = run()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["clahe_apply"] > 0 and counts["rgb_to_lab"] > 0, counts
    assert card.device.type == "cuda"
    assert torch.equal(card.cpu(), run(device="cpu"))


@pytest.mark.cuda
def test_canny_hough_otsu_warp_card_equals_host(cuda_device):
    """canny(l2_gradient=True) on an A4 page's gray, hough_lines(
    return_overflow=True) on its edges at the default budget and at one
    that overflows (rank_extract and hough_votes launched), otsu_threshold
    (hist256 launched), warp_perspective_batch with a replicate and a
    127.5 border: card = host."""
    from tpuimage_torch.ops import edges as edgeops
    from tpuimage_torch.ops import geometry
    gray = color.rgb_to_gray(torch.from_numpy(synth.page(43, 1200, 849, tilt_deg=3.0, rules=4)))
    for l2 in (False, True):
        card = edgeops.canny(gray.to(cuda_device), 50, 150, l2_gradient=l2)
        assert torch.equal(card.cpu(), edgeops.canny(gray, 50, 150, l2_gradient=l2)), l2
    edge = edgeops.canny(gray, 50, 150, l2_gradient=True)[None]
    for budget in (0, 2000):
        kernels.reset_launch_counts()
        card = hough.hough_lines(edge.to(cuda_device), 150, max_edges=budget,
                                 return_overflow=True)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts["rank_extract"] > 0 and counts["hough_votes"] > 0, counts
        host = hough.hough_lines(edge, 150, max_edges=budget, return_overflow=True)
        for c, h in zip(card, host):
            assert torch.equal(c.cpu(), h), budget
        assert bool(host[2][0]) == (budget == 2000)
    before = kernels.launch_counts()["hist256"]
    assert float(histogram.otsu_threshold(gray.to(cuda_device))) == \
        float(histogram.otsu_threshold(gray))
    assert kernels.launch_counts()["hist256"] == before + 1
    rgb = torch.from_numpy(np.stack([synth.shadowed_scene(1340 + i, 300, 400) for i in range(2)]))
    minv = torch.tensor([[[0.9, 0.12, -20.0], [-0.08, 1.1, 15.0], [1e-4, 2e-4, 1.0]],
                         [[1.2, -0.1, 10.0], [0.05, 0.8, -30.0], [-2e-4, 1e-4, 1.0]]])
    for border, value in (("replicate", 0.0), ("constant", 127.5)):
        card = geometry.warp_perspective_batch(rgb.to(cuda_device), minv.to(cuda_device), 320,
                                               420, border=border, border_value=value)
        assert torch.equal(card.cpu(), geometry.warp_perspective_batch(
            rgb, minv, 320, 420, border=border, border_value=value)), border


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 853, 1280), (1, 3000, 4000), (37, 45)])
def test_xla_sum_f32_card_equals_host(cuda_device, shape):
    """XLA's f32 tree sum: its serial levels are one cumsum launch each on
    the card (one thread a column adding in order in f32) and a loop of
    f32 adds on the host. Bytes near 255 so the serial adds round; 2x3
    planes of a scene, one plane of 4000x3000 (three levels; one column
    but the zero one) and one of 45x37 (the last level four values):
    card = host."""
    from tpuimage_torch.core.dtypes import xla_sum_f32
    x = torch.from_numpy(np.random.default_rng(shape[-1]).integers(200, 256, shape,
                                                                  dtype=np.uint8))
    assert torch.equal(xla_sum_f32(x.to(cuda_device)).cpu(), xla_sum_f32(x))


# ---------------------------------------------------------------------------
# Canny: canny_pre and the hysteresis check against their plain versions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _canny_planes(kind, shape, seed):
    """(B, H, W) uint8: random bytes, a binary 0/255 page (the deskew's
    input is one), or the gray of document photos / A4 pages."""
    rng = np.random.default_rng(seed)
    b, h, w = shape
    if kind == "random":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if kind == "binary":
        return ((rng.random(shape) < 0.3) * 255).astype(np.uint8)
    make = synth.document_photo if kind == "photo" else synth.page
    rgb = np.stack([make(seed + i, h, w) for i in range(b)])
    return color.rgb_to_gray(torch.from_numpy(rgb)).numpy()


_CANNY_THRESHOLDS = [(50, 150, False), (30, 100, False), (50, 150, True), (150, 50, False),
                     (20.7, 99.5, True), (20.7, 99.5, False), (0.5, 1.2, True), (-3, 0, False)]


def _canny_pre_exact(cuda_device, x, low, high, l2, row_valid=None):
    out = _count("canny_pre", lambda: kernels.canny_pre(x.to(cuda_device), low, high, l2,
                                                        row_valid))
    ref = kernels.canny_pre_ref(x, low, high, l2, row_valid)
    for o, r, what in zip(out, ref, ("strong", "weak")):
        assert o.dtype == torch.bool and torch.equal(o.cpu(), r), (what, low, high, l2)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", [("random", (2, 97, 131)), ("binary", (2, 1200, 849)),
                                        ("photo", (2, 1080, 1920)), ("page", (2, 1200, 849))])
@pytest.mark.parametrize("low,high,l2", _CANNY_THRESHOLDS)
def test_canny_pre_kernel_on_card(cuda_device, kind, shape, low, high, l2):
    """canny_pre on random bytes, binary pages, document photos at the
    localize's 1920x1080 and pages at the deskew's 849x1200; L1 and L2,
    low > high, thresholds that are not integers (truncated for L1, their
    squares rounded to f32 for L2) and negative ones: equal to the plain
    version's maps."""
    x = torch.from_numpy(_canny_planes(kind, shape, shape[1]))
    _canny_pre_exact(cuda_device, x, low, high, l2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 1, 70), (2, 70, 1), (1, 2, 2), (3, 3, 3),
                                   (2, 33, 65), (1, 31, 63), (2, 65, 129), (1, 49, 961)])
@pytest.mark.parametrize("l2", [False, True])
def test_canny_pre_kernel_at_edge_shapes(cuda_device, shape, l2):
    """One pixel, one row, one column, 2x2, 3x3 (reflect-101 of one and
    two pixels) and planes one past or one short of the 64 x 32 tile."""
    x = torch.from_numpy(_canny_planes("random", shape, sum(shape)))
    _canny_pre_exact(cuda_device, x, 40, 120, l2)
    _canny_pre_exact(cuda_device, x // 32, 1, 3, l2)      # low contrast: most pixels candidates


@pytest.mark.cuda
@pytest.mark.parametrize("l2", [False, True])
def test_canny_pre_kernel_with_row_valid(cuda_device, l2):
    """row_valid as the H-sharded post-warp passes it (halo rows outside
    the image invalid) and scattered invalid rows."""
    x = torch.from_numpy(_canny_planes("page", (2, 300, 849), 4))
    edge_rows = np.ones(300, bool)
    edge_rows[:3] = edge_rows[-3:] = False
    scattered = np.random.default_rng(2).random(300) < 0.5
    for valid in (edge_rows, scattered, torch.from_numpy(scattered)):
        _canny_pre_exact(cuda_device, x, 30, 100, l2, valid)


def _check_flags(flags, slot, changed):
    f = flags.cpu().tolist()
    assert f[1 - slot] == 0 and f[slot] == int(changed), (f, slot, changed)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c[0] for c in synth.hysteresis_stress_maps()])
def test_hysteresis_check_kernel_on_stress_maps(cuda_device, case):
    """One check from the seeds, from a 0/255 map and from the map after 2
    checks (bool and uint8 input, both slots, flags left over from before)
    against the plain version; then the growth after 1, 2 and 7 checks
    (``_hysteresis``'s max_iters) equal to the plain loop's, and at the
    fixpoint equal to the 8-connected components of strong | weak that
    hold a strong pixel."""
    import scipy.ndimage
    from tpuimage_torch.ops import edges as edgeops
    _, strong_np, weak_np = next(c for c in synth.hysteresis_stress_maps() if c[0] == case)
    strong, weak = torch.from_numpy(strong_np), torch.from_numpy(weak_np)
    s_d, w_d = strong.to(cuda_device), weak.to(cuda_device)
    ref = strong
    for i, (s_in, on) in enumerate(((s_d, 1), (s_d.to(torch.uint8) * 255, 255), (None, 1))):
        if s_in is None:
            ref = kernels.hysteresis_check_ref(kernels.hysteresis_check_ref(strong, weak), weak)
            s_in = ref.to(cuda_device)
        slot = i % 2
        flags = torch.tensor([7, 7], dtype=torch.int32, device=cuda_device)
        flags[slot] = 0
        out = _count("canny_hysteresis",
                     lambda: kernels.hysteresis_check(s_in, w_d, flags, slot, on))
        want = kernels.hysteresis_check_ref(ref, weak)
        assert out.dtype == torch.uint8
        assert torch.equal(out.cpu(), want.to(torch.uint8) * on), (case, i)
        _check_flags(flags, slot, bool((want != ref).any()))
    plain = strong
    for n in range(1, 8):
        plain = kernels.hysteresis_check_ref(plain, weak)
        if n in (1, 2, 7):
            assert torch.equal(edgeops._hysteresis(s_d, w_d, n).cpu(), plain), (case, n)
    labels, _ = scipy.ndimage.label(strong_np | weak_np, structure=np.ones((3, 3, 3)) *
                                    np.array([0, 1, 0])[:, None, None])
    keep = np.zeros(labels.max() + 1, bool)
    keep[np.unique(labels[strong_np])] = True
    keep[0] = False
    fix = edgeops._hysteresis(s_d, w_d, 10 ** 6)
    assert torch.equal(fix.cpu(), torch.from_numpy(keep[labels])), case


@pytest.mark.cuda
def test_canny_hysteresis_checks_and_max_iters_on_card(cuda_device):
    """canny on a weak spiral's image: the card's checks, counted, equal
    the host's, and a max_hysteresis_iters cap stops both at the same
    partial map."""
    from tpuimage_torch.ops import edges as edgeops
    from tpuimage_torch.runtime import profiling
    _, strong, weak = next(c for c in synth.hysteresis_stress_maps() if c[0] == "spiral")
    s_d, w_d = torch.from_numpy(strong).to(cuda_device), torch.from_numpy(weak).to(cuda_device)
    checks = []
    for s, w in ((s_d, w_d), (torch.from_numpy(strong), torch.from_numpy(weak))):
        before = profiling.counts().get("canny.hysteresis_checks", 0)
        out = edgeops._hysteresis(s, w, 10 ** 6)
        checks.append(profiling.counts()["canny.hysteresis_checks"] - before)
        assert torch.equal(out.cpu(), torch.from_numpy(strong | weak))
    assert checks[0] == checks[1] > 100, checks
    for cap in (1, 3, 40):
        card = edgeops._hysteresis(s_d, w_d, cap).cpu()
        assert torch.equal(card, edgeops._hysteresis(torch.from_numpy(strong),
                                                     torch.from_numpy(weak), cap))
        assert not torch.equal(card, torch.from_numpy(strong | weak))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape,low,high", [("photo", (8, 1080, 1920), 30, 100),
                                                 ("page", (3, 1200, 849), 50, 150),
                                                 ("binary", (2, 300, 849), 30, 100)])
@pytest.mark.parametrize("l2", [False, True])
def test_canny_on_card_equals_host(cuda_device, kind, shape, low, high, l2):
    """canny and canny_batch end to end, one canny_pre launch and one
    hysteresis launch a check: card = host, byte for byte."""
    from tpuimage_torch.ops import edges as edgeops
    x = torch.from_numpy(_canny_planes(kind, shape, 11))
    kernels.reset_launch_counts()
    card = edgeops.canny_batch(x.to(cuda_device), low, high, l2).cpu()
    counts = kernels.launch_counts()
    assert counts["canny_pre"] == 1 and counts["canny_hysteresis"] >= 1, counts
    assert card.dtype == torch.uint8 and torch.equal(card, edgeops.canny(x, low, high, l2))
    one = edgeops.canny(x[0].to(cuda_device), low, high, l2)
    assert one.shape == x.shape[1:] and torch.equal(one.cpu(), card[0])


@pytest.mark.cuda
def test_canny_docscan_uses_on_card(cuda_device):
    """DocScanner's two Canny uses: localize's edges of 1920x1080 photos
    (its segments' f32 endpoints are not held here) and the deskew's angle
    of weighted A4 pages, card = host, with both kernels launched on each
    route."""
    from tpuimage_torch.pipelines import docscan
    cfg = docscan.GUI_DOCUMENT_CONFIG
    photos = torch.from_numpy(np.stack([synth.document_photo(60 + i, 1080, 1920)
                                        for i in range(2)]))
    kernels.reset_launch_counts()
    card = docscan._localize_device_batch(photos.to(cuda_device), cfg.canny_low, cfg.canny_high)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["canny_pre"] == 1 and counts["canny_hysteresis"] >= 1, counts
    host = docscan._localize_device_batch(photos, cfg.canny_low, cfg.canny_high)
    assert card[0].dtype == torch.uint8 and torch.equal(card[0].cpu(), host[0])
    pages = torch.from_numpy(np.stack([synth.page(70 + i, 1200, 849, tilt_deg=2.0 * i)
                                       for i in range(2)]))
    weighted = docscan._pre_deskew_stages(pages, cfg)["weighted"]
    kernels.reset_launch_counts()
    card = docscan._deskew_angle(weighted.to(cuda_device), cfg.canny_low, cfg.canny_high,
                                 cfg.max_rotate, cfg.deskew_max_edges)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["canny_pre"] == 1 and counts["canny_hysteresis"] >= 1, counts
    for c, h in zip(card, docscan._deskew_angle(weighted, cfg.canny_low, cfg.canny_high,
                                                cfg.max_rotate, cfg.deskew_max_edges)):
        assert torch.equal(c.cpu(), h)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.bool])
def test_canny_refuses_planes_not_uint8_on_card(cuda_device, dtype):
    """cv2.Canny takes 8-bit planes only: a CUDA tensor of another type
    raises, with no fallback."""
    from tpuimage_torch.ops import edges as edgeops
    x = torch.zeros((1, 16, 16), dtype=dtype, device=cuda_device)
    with pytest.raises(TypeError):
        edgeops.canny(x, 50, 150)
    with pytest.raises(TypeError):
        kernels.canny_pre(x, 50, 150)
