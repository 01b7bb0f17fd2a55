"""tpuimage_torch's hand-written CUDA kernels against their plain PyTorch
versions, on the card. The kernels have no CPU mode, so every test here
is marked ``cuda`` and skips where no CUDA device is present.

This file imports neither jax nor tpuimage, so it also runs on a GPU
machine that has only torch (``tests/conftest.py`` imports jax):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
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
    # a row that starts off a 16-byte boundary takes the byte-load variant
    odd = planes.to(cuda_device).reshape(-1)[1:1 + 3 * 1000].reshape(3, 1000)
    assert torch.equal(kernels.hist256_batch(odd).cpu(),
                       kernels.hist256_batch_ref(odd.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,density", [((1200, 849), 0.05), ((240, 320), 0.10)])
def test_hough_votes_kernel_on_card(cuda_device, shape, density):
    rng = np.random.default_rng(shape[0])
    edges = torch.from_numpy((rng.random((2,) + shape) < density).astype(np.uint8) * 255)
    before = kernels.launch_counts()["hough_votes"]
    acc, _ = hough.hough_accumulator(edges.to(cuda_device))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["hough_votes"] == before + 1
    assert torch.equal(acc.cpu(), hough.hough_accumulator(edges)[0])


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
