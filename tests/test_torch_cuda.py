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
