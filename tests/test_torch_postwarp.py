"""DocScanner's post-warp chain in tpuimage_torch against tpuimage (JAX on
the CPU): the plain versions of the chain's four kernels against
tpuimage's XLA ops at a mid-size shape, also at sizes past the kernels'
tiled forms, the divide on every (num, den) pair, and
``_pre_deskew_stages`` against tpuimage's, all five stages. Every
comparison is exact (max |diff| 0). The plain versions against tpuimage's Pallas kernels
(interpreted) are in ``tests/test_torch_kernels.py``; the kernels against
the plain versions on the card in ``tests/test_torch_cuda.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpuimage.ops import arith as jarith
from tpuimage.ops import filters as jfilters
from tpuimage.ops import morphology as jmorph
from tpuimage.ops import threshold as jthresh
from tpuimage.ops.pallas_kernels import _div255_round_half_even
from tpuimage.pipelines import docscan as jdoc

from tpuimage_torch import synth
from tpuimage_torch.ops import kernels
from tpuimage_torch.ops.color import rgb_to_gray
from tpuimage_torch.pipelines import docscan as tdoc

MID = (300, 453)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (pytest-xdist runs several
    workers side by side, and PyTorch's default of one spinning thread per
    core slows each of them many times over); the count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tie_image(h, w):
    """A checkerboard of 100 and 101 (a Gaussian mean of 100.5 up to f32
    rounding), beside a plateau and a ramp."""
    yy, xx = np.mgrid[:h, :w]
    img = (100 + (yy + xx) % 2).astype(np.uint8)
    img[:, w // 2:] = 37
    img[h // 2:, w // 2:] = (xx[h // 2:, w // 2:] * 7 % 256).astype(np.uint8)
    return img


@pytest.fixture(scope="module")
def mid_planes():
    """A synthetic page's gray plane, its illumination-corrected plane, and
    the tie image, at 300x453."""
    rgb = synth.page(41, *MID, tilt_deg=2.0, rules=3)
    gray = rgb_to_gray(torch.from_numpy(rgb)).numpy()
    bg = np.asarray(jfilters.gaussian_blur_u8(jnp.asarray(gray), 43, impl="xla"))
    illum = np.asarray(jarith.normalize_minmax(jarith.divide_u8(jnp.asarray(gray),
                                                                jnp.asarray(bg), 255.0)))
    return np.stack([gray, illum, _tie_image(*MID)])


def _ours(fn, planes, *args):
    return fn(torch.from_numpy(planes), *args).numpy()


@pytest.mark.parametrize("ksize", [43, 51])
def test_gaussian_blur_u8_ref_matches_xla(mid_planes, ksize):
    ours = _ours(kernels.gaussian_blur_u8, mid_planes, ksize)
    for i, x in enumerate(mid_planes):
        ref = jfilters.gaussian_blur_u8(jnp.asarray(x), ksize, impl="xla")
        np.testing.assert_array_equal(ours[i], np.asarray(ref))


@pytest.mark.parametrize("mode,ksize", [("divide", 43), ("subtract", 43), ("sub", 51),
                                        ("divide", 51)])
def test_gauss_chain_ref_matches_xla_ops(mid_planes, mode, ksize):
    ours = _ours(kernels.gauss_chain, mid_planes, ksize, mode)
    for i, x in enumerate(mid_planes):
        xj = jnp.asarray(x)
        blur = jfilters.gaussian_blur_u8(xj, ksize, impl="xla")
        ref = {"divide": lambda: jarith.divide_u8(xj, blur, 255.0),
               "subtract": lambda: jarith.subtract_u8(xj, blur),
               "sub": lambda: jarith.subtract_u8(blur, xj)}[mode]()
        np.testing.assert_array_equal(ours[i], np.asarray(ref))


@pytest.mark.parametrize("C", [3.0, 2.5, 0.0, 10.0])
def test_gauss_chain_adaptive_ref_matches_xla(mid_planes, C):
    ours = _ours(kernels.gauss_chain, mid_planes, 31, "adaptive", C)
    for i, x in enumerate(mid_planes):
        ref = jthresh.adaptive_threshold(jnp.asarray(x), 255, "gaussian", 31, C)
        np.testing.assert_array_equal(ours[i], np.asarray(ref))


def test_blackhat_rect_ref_matches_xla(mid_planes):
    ours = _ours(lambda x: kernels.blackhat_rect(x, 9, 19), mid_planes)
    se = jmorph.structuring_element("rect", (9, 19))
    for i, x in enumerate(mid_planes):
        ref = jmorph.morph_blackhat(jnp.asarray(x), se, impl="xla")
        np.testing.assert_array_equal(ours[i], np.asarray(ref))


@pytest.mark.parametrize("kw,kh", [(33, 67), (129, 255)])
def test_blackhat_rect_ref_matches_xla_past_tiled_form(mid_planes, kw, kh):
    """Rectangles that the old kernel refused (33x67: blackhat_ksize 33 at
    the default vertical ratio) and one that takes the split form."""
    ours = _ours(lambda x: kernels.blackhat_rect(x, kw, kh), mid_planes)
    se = jmorph.structuring_element("rect", (kw, kh))
    for i, x in enumerate(mid_planes):
        ref = jmorph.morph_blackhat(jnp.asarray(x), se, impl="xla")
        np.testing.assert_array_equal(ours[i], np.asarray(ref))


@pytest.mark.parametrize("iters", [0, 1, 3, 9])
def test_inkmask_weighted_ref_matches_xla_ops(mid_planes, iters):
    """Against tpuimage's ops sequence (threshold_binary, max_u8, the 2x2
    dilate, where), on DocScanner's own raw planes."""
    illum = mid_planes[1:2]
    sub = kernels.gauss_chain(torch.from_numpy(illum), 51, "sub")
    bh = kernels.blackhat_rect(torch.from_numpy(illum), 9, 19)
    adapt = kernels.gauss_chain(torch.from_numpy(illum), 31, "adaptive", 3.0)
    for ts, tb in ((4.0, 9.0), (-1.0, 255.0), (0.0, 0.0)):
        mask, weighted = kernels.inkmask_weighted(sub, bh, adapt, torch.tensor([ts]),
                                                  torch.tensor([tb]), iters)
        js, jb, ja = (jnp.asarray(a[0].numpy()) for a in (sub, bh, adapt))
        ref_mask = jarith.max_u8(jthresh.threshold_binary(js, ts),
                                 jthresh.threshold_binary(jb, tb))
        if iters:
            ref_mask = jmorph.dilate(ref_mask, jmorph.structuring_element("rect", (2, 2)),
                                     iterations=iters)
        ref_weighted = jnp.where(ref_mask == 0, jnp.uint8(255), ja)
        np.testing.assert_array_equal(mask[0].numpy(), np.asarray(ref_mask))
        np.testing.assert_array_equal(weighted[0].numpy(), np.asarray(ref_weighted))


def test_divide_on_every_pair():
    """The divide epilogue on all 65,536 (num, den) pairs against
    tpuimage's divide_u8 and the TPU kernel's quotient."""
    ours = kernels.divide_table("cpu").numpy()
    num, den = (a.astype(np.uint8) for a in np.meshgrid(np.arange(256), np.arange(256),
                                                        indexing="ij"))
    ref = np.asarray(jarith.divide_u8(jnp.asarray(num), jnp.asarray(den), 255.0))
    np.testing.assert_array_equal(ours, ref)
    tpu = _div255_round_half_even(jnp.asarray(num, jnp.int32), jnp.asarray(den, jnp.int32))
    np.testing.assert_array_equal(ours, np.asarray(tpu))
    assert ours[1, 2] == 128 and ours[3, 2] == 255 and (ours[:, 0] == 0).all()


# ---------------------------------------------------------------------------
# _pre_deskew_stages against tpuimage's, all five stages
# ---------------------------------------------------------------------------

STAGES = ("illum", "stretch", "inkmask", "adapt", "weighted")
# "wide": windows past the kernels' tiled forms (a 33x67 blackhat, a
# 257-tap ink background blur, 9 dilations), which take the split forms
_WIDE = dict(blackhat_ksize=33, mask_blur_ksize=257, ink_dilate_iters=9)
CONFIGS = {"gui": (tdoc.GUI_DOCUMENT_CONFIG, jdoc.GUI_DOCUMENT_CONFIG),
           "default": (tdoc.DocScanConfig(), jdoc.DocScanConfig()),
           "mean": (dataclasses.replace(tdoc.GUI_DOCUMENT_CONFIG, thresh_method="mean"),
                    dataclasses.replace(jdoc.GUI_DOCUMENT_CONFIG, thresh_method="mean")),
           "wide": (dataclasses.replace(tdoc.GUI_DOCUMENT_CONFIG, **_WIDE),
                    dataclasses.replace(jdoc.GUI_DOCUMENT_CONFIG, **_WIDE))}


@pytest.fixture(scope="module")
def pages():
    """Three synthetic pages at the page geometry of scale_long 256
    (256x181): flat, and two tilted with table rules."""
    return np.stack([synth.page(11, 256, 181),
                     synth.page(12, 256, 181, tilt_deg=4.0, rules=3),
                     synth.page(13, 256, 181, tilt_deg=-3.0, rules=3)])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pre_deskew_forms_match_tpuimage_xla(pages, name):
    """The port's fused form against tpuimage's impl="xla" (its default)."""
    ours_cfg, ref_cfg = (dataclasses.replace(c, scale_long=256) for c in CONFIGS[name])
    ref_fn = jax.jit(functools.partial(jdoc._pre_deskew_stages, config=ref_cfg, impl="xla"))
    refs = [{k: np.asarray(v) for k, v in ref_fn(jnp.asarray(p)).items()} for p in pages]
    out = tdoc._pre_deskew_stages(torch.from_numpy(pages), ours_cfg)
    for k in STAGES:
        for i in range(len(pages)):
            np.testing.assert_array_equal(out[k][i].numpy(), refs[i][k],
                                          err_msg=f"{k} page {i}")
    assert (out["inkmask"] > 0).any() and (out["adapt"] == 0).any()


def test_pre_deskew_fused_matches_tpuimage_pallas():
    """One tiny page against tpuimage's impl="pallas", its kernels
    interpreted."""
    page = synth.page(14, 64, 48, tilt_deg=2.0, rules=3)
    cfg = dataclasses.replace(tdoc.GUI_DOCUMENT_CONFIG, scale_long=64)
    jcfg = dataclasses.replace(jdoc.GUI_DOCUMENT_CONFIG, scale_long=64)
    ref = jdoc._pre_deskew_stages(jnp.asarray(page), jcfg, impl="pallas")
    ours = tdoc._pre_deskew_stages(torch.from_numpy(page[None]), cfg)
    for k in STAGES:
        np.testing.assert_array_equal(ours[k][0].numpy(), np.asarray(ref[k]), err_msg=k)


def test_pre_deskew_batch_equals_single_calls(pages):
    cfg = dataclasses.replace(tdoc.GUI_DOCUMENT_CONFIG, scale_long=256)
    batch = tdoc._pre_deskew_stages(torch.from_numpy(pages[:2]), cfg)
    for i in range(2):
        one = tdoc._pre_deskew_stages(torch.from_numpy(pages[i:i + 1]), cfg)
        for k in STAGES:
            assert torch.equal(batch[k][i], one[k][0]), (i, k)



# ---------------------------------------------------------------------------
# the whole post-warp program against tpuimage's jitted one
# ---------------------------------------------------------------------------

INTEGER_STAGES = STAGES + ("deskew", "clean")


@pytest.mark.parametrize("name", ["A", "B"])
def test_post_warp_matches_jitted_tpuimage(name):
    """Input A (a 480x360 use-whole photo at scale_long 600, where NORM_MINMAX
    rounded twice moved 0.4% of the binary) and B (a tilted 362x256 page)
    through docscan_post_warp_batch against tpuimage's jitted program: the
    angle and the overflow flag equal, every stage exact when the page is
    not rotated, and the rotated ones within the bilinear contract (max
    |diff| 1 on < 0.01% of pixels)."""
    if name == "A":
        page, scale_long = synth.document_photo(3, 480, 360, with_page=False), 600
    else:
        page, scale_long = synth.page(2, 362, 256, tilt_deg=3.0, rules=4), 362
    cfg = dataclasses.replace(tdoc.GUI_DOCUMENT_CONFIG, scale_long=scale_long)
    jcfg = dataclasses.replace(jdoc.GUI_DOCUMENT_CONFIG, scale_long=scale_long)
    ref = {k: np.asarray(v) for k, v in
           jdoc.docscan_post_warp_batch(jnp.asarray(page[None]), jcfg).items()}
    ours = tdoc.docscan_post_warp_batch(torch.from_numpy(page[None]), cfg)
    assert float(ours["deskew_angle"][0]) == float(ref["deskew_angle"][0])
    assert bool(ours["deskew_overflow"][0]) == bool(ref["deskew_overflow"][0])
    rotated = float(ref["deskew_angle"][0]) != 0.0
    for k in INTEGER_STAGES:
        a, b = ours[k][0].numpy().astype(np.int32), ref[k][0].astype(np.int32)
        if rotated and k in ("deskew", "clean"):
            diff = np.abs(a - b)
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-4, k
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
