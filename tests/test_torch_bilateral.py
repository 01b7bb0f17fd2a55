"""tpuimage_torch's bilateral filter against tpuimage's (JAX on the CPU).

Tolerance: the float contract, max |diff| <= 1 on < 0.5% of pixels. The
port's plain version rounds each product and sum on its own and reads
its colour weights from a table of PyTorch's exp; tpuimage's XLA CPU
form contracts products into fmas and evaluates XLA's exp, and its scan
and Pallas forms already differ from each other by up to 1. The tables
(radius, tap order, space weights) are exact.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpuimage.ops import bilateral as jbil
from tpuimage.ops.pallas_kernels import bilateral_gray_pallas

from tpuimage_torch import convert, synth
from tpuimage_torch.ops import bilateral as tbil
from tpuimage_torch.ops import kernels


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs (xdist runs several workers
    side by side); the count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_float_contract(a, b):
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.005, (diff > 0).mean()


@pytest.fixture(scope="module")
def photo():
    """An odd-sized (97 x 123) document photo: page edge, text, texture."""
    return synth.document_photo(5, 97, 123)


@pytest.mark.parametrize("d", [-1, 0, 5, 9, 11])
@pytest.mark.parametrize("ss", [1.0, 3.0, 5.0, 7.0, 10.0, 75.0, 0.0])
def test_params_and_taps_equal_tpuimage(d, ss):
    """sigma_space * 1.5 lands on .5 at 1, 3, 5 and 7: Python's
    half-to-even round decides the radius of d <= 0."""
    assert tbil._params(d, 30.0, ss) == jbil._params(d, 30.0, ss)
    radius = tbil._params(d, 30.0, ss)[0]
    assert tbil._tap_offsets(radius) == jbil._tap_offsets(radius)


@pytest.mark.parametrize("d,sc,ss", [(9, 75, 75), (-1, 30, 10), (5, 20, 20), (0, 0, 3)])
def test_bilateral_tables_equal_tpuimage_construction(d, sc, ss):
    """convert.bilateral_tables against the expressions of tpuimage's scan
    form (bilateral.py:91-93) and its colour weight (:74, :83, :106)."""
    tab = convert.bilateral_tables(d, sc, ss, channels=3)
    radius, sc_, ss_ = jbil._params(d, sc, ss)
    taps = jbil._tap_offsets(radius)
    gs = -0.5 / (ss_ * ss_)
    assert tab["radius"] == radius
    np.testing.assert_array_equal(tab["tap_offsets"], [(dy, dx) for dy, dx, _ in taps])
    np.testing.assert_array_equal(
        tab["space_weights"],
        np.asarray([np.float32(np.exp(r * r * gs)) for _, _, r in taps], np.float32))
    gc = np.float32(-0.5 / (sc_ * sc_))
    assert tab["gauss_color"] == gc
    dist = np.arange(766, dtype=np.float32)
    ref = np.asarray(jnp.exp(jnp.asarray(dist * dist * gc)))
    assert tab["color_weights"].shape == (766,) and tab["color_weights"][0] == 1.0
    # within one f32 ulp, and XLA's CPU backend flushes subnormal weights to 0
    np.testing.assert_allclose(tab["color_weights"], ref, rtol=2e-7,
                               atol=np.finfo(np.float32).tiny)


@pytest.mark.parametrize("d,sc,ss", [(9, 75, 75), (5, 20, 20), (-1, 30, 10)])
def test_gray_within_contract_of_scan_and_pallas(photo, d, sc, ss):
    gray = np.ascontiguousarray(photo[..., 1])
    ours = tbil.bilateral_filter(torch.from_numpy(gray), d, sc, ss).numpy()
    scan = jax.jit(lambda x: jbil.bilateral_filter(x, d, sc, ss, impl="scan"))(
        jnp.asarray(gray))
    pallas = bilateral_gray_pallas(jnp.asarray(gray), d, sc, ss, interpret=True)
    assert ours.shape == gray.shape and ours.dtype == np.uint8
    _assert_float_contract(ours, np.asarray(scan))
    _assert_float_contract(ours, np.asarray(pallas))


@pytest.mark.parametrize("d,sc,ss", [(9, 75, 75), (9, 100, 75), (11, 100, 100),
                                     (-1, 30, 10), (0, 40, 3)])
def test_color_within_contract_of_scan(photo, d, sc, ss):
    """Landscape's settings, face's d -1, 30/10 (radius 15, 709 taps) and a
    d of 0 (the radius from sigma_space: round(4.5) = 4)."""
    ours = tbil.bilateral_filter(torch.from_numpy(photo), d, sc, ss).numpy()
    ref = jax.jit(lambda x: jbil.bilateral_filter(x, d, sc, ss, impl="scan"))(
        jnp.asarray(photo))
    assert ours.shape == photo.shape and ours.dtype == np.uint8
    _assert_float_contract(ours, np.asarray(ref))


@pytest.mark.parametrize("color", [False, True])
def test_batch_equals_single_images(rng, color):
    imgs = np.stack([synth.document_photo(s, 41, 37) for s in (7, 8, 9)])
    if not color:
        imgs = np.ascontiguousarray(imgs[..., 0])
    batch = tbil.bilateral_filter(torch.from_numpy(imgs), 9, 75, 75)
    assert batch.shape == imgs.shape
    for i in range(len(imgs)):
        one = tbil.bilateral_filter(torch.from_numpy(imgs[i]), 9, 75, 75)
        np.testing.assert_array_equal(batch[i].numpy(), one.numpy())


@pytest.mark.parametrize("color", [False, True])
def test_ref_with_table_equals_direct_exp(photo, color):
    """The table changes nothing: the plain version with the colour-weight
    table equals the same loop with ``exp(d * d * gc)`` per tap."""
    img = torch.from_numpy(photo if color else np.ascontiguousarray(photo[..., 2]))[None]
    radius, offsets, space_w, gc = tbil.tap_tables(-1, 30.0, 4.0)
    lut = kernels.color_weight_table(766 if color else 256, gc, "cpu")
    ours = kernels.bilateral_ref(img, torch.from_numpy(offsets), torch.from_numpy(space_w),
                                 lut, radius)

    planes = img.movedim(-1, -3) if color else img
    padded = torch.from_numpy(np.pad(planes.numpy(), [(0, 0)] * (planes.dim() - 2)
                                     + [(radius, radius)] * 2, mode="reflect"))
    h, w = planes.shape[-2:]
    num = torch.zeros(planes.shape)
    den = torch.zeros(img.shape[:3])
    for (dy, dx), sw in zip(offsets.tolist(), space_w.tolist()):
        view = padded[..., radius + dy:radius + dy + h, radius + dx:radius + dx + w]
        diff = (view.to(torch.int32) - planes.to(torch.int32)).abs()
        dist = (diff.sum(dim=-3) if color else diff).to(torch.float32)
        wgt = torch.exp(dist * dist * float(gc)) * sw
        num = num + view.to(torch.float32) * (wgt[:, None] if color else wgt)
        den = den + wgt
    ref = torch.clamp(torch.round(num / (den[:, None] if color else den)), 0, 255)
    ref = ref.to(torch.uint8)
    np.testing.assert_array_equal(ours.numpy(), (ref.movedim(-3, -1) if color else ref).numpy())


def test_rejects_what_it_does_not_take():
    with pytest.raises(TypeError):
        tbil.bilateral_filter(torch.zeros((5, 6), dtype=torch.int32), 9, 75, 75)
    with pytest.raises(ValueError):
        tbil.bilateral_filter(torch.zeros((2, 5, 6, 4), dtype=torch.uint8), 9, 75, 75)
    with pytest.raises(ValueError):
        tbil.bilateral_filter(torch.zeros(5, dtype=torch.uint8), 9, 75, 75)
