"""DocScanner's serving slice in tpuimage_torch against tpuimage (JAX on
the CPU), on seeded synthetic photos and pages (``tpuimage_torch.synth``).

Tolerances: integer stages exact; the deskew rotation within the float
contract (max |diff| <= 1 on < 0.5% of pixels); localize segments within
1e-3 px and quad corners within 0.5 px; end to end, ``use_whole`` equal
and < 0.2% of binary pixels different, the bound tpuimage holds its own
warp forms to.
"""
import dataclasses
import functools
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpuimage.ops import filters as jfilters
from tpuimage.ops import morphology as jmorph
from tpuimage.pipelines import docscan as jdoc

from tpuimage_torch import convert, synth
from tpuimage_torch.ops import histogram
from tpuimage_torch.pipelines import docscan as tdoc
from tpuimage_torch.runtime.mesh import make_mesh

# one intra-op thread: pytest-xdist runs several workers side by side, and
# PyTorch's default of one spinning thread per core each slows every
# worker many times over
torch.set_num_threads(1)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dataclasses.replace(tdoc.GUI_DOCUMENT_CONFIG, scale_long=256)
JCFG = dataclasses.replace(jdoc.GUI_DOCUMENT_CONFIG, scale_long=256)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_float_contract(a, b):
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.005, (diff > 0).mean()


# ---------------------------------------------------------------------------
# state carried across
# ---------------------------------------------------------------------------

def test_config_from_tpuimage():
    for jc in (jdoc.GUI_DOCUMENT_CONFIG, jdoc.DocScanConfig(), JCFG):
        ours = convert.config_from_tpuimage(jc)
        assert dataclasses.asdict(ours) == dataclasses.asdict(jc)
    assert convert.config_from_tpuimage(jdoc.GUI_DOCUMENT_CONFIG) == tdoc.GUI_DOCUMENT_CONFIG
    assert dataclasses.asdict(tdoc.DocScanConfig()) == dataclasses.asdict(jdoc.DocScanConfig())

    @dataclasses.dataclass(frozen=True)
    class Other:
        page: str = "A4"
    with pytest.raises(ValueError):
        convert.config_from_tpuimage(Other())


def test_static_tables_match_tpuimage():
    tab = convert.static_tables(tdoc.GUI_DOCUMENT_CONFIG, (1200, 849))
    # tpuimage's sizes: illum base from min(h, w), odd; mask 51; block 31
    assert len(tab["illum_taps_q8"]) == 43
    np.testing.assert_array_equal(tab["illum_taps_q8"], jfilters.gaussian_kernel_q8(43))
    np.testing.assert_array_equal(tab["mask_taps_q8"], jfilters.gaussian_kernel_q8(51))
    np.testing.assert_array_equal(tab["adaptive_taps_f32"],
                                  jfilters.get_gaussian_kernel(31).astype(np.float32))
    # gauss_chain_pallas's own construction of its adaptive offset
    for cfg in (tdoc.GUI_DOCUMENT_CONFIG, tdoc.DocScanConfig(), dataclasses.replace(
            tdoc.GUI_DOCUMENT_CONFIG, C=2.5)):
        assert convert.static_tables(cfg)["adaptive_idelta"] == math.ceil(cfg.C)
    assert tab["adaptive_idelta"] == 3
    thetas = np.arange(180) * (np.pi / 180)        # hough.py / pallas_kernels.py
    np.testing.assert_array_equal(tab["hough_cos"], np.cos(thetas).astype(np.float32))
    np.testing.assert_array_equal(tab["hough_sin"], np.sin(thetas).astype(np.float32))
    np.testing.assert_array_equal(tab["se_blackhat"], jmorph.structuring_element("rect", (9, 19)))
    np.testing.assert_array_equal(tab["se_ink_dilate"], jmorph.structuring_element("rect", (2, 2)))


def test_import_pulls_in_no_jax_no_pil_and_no_tpuimage():
    code = ("import sys; import tpuimage_torch.pipelines.docscan, tpuimage_torch.convert, "
            "tpuimage_torch.synth, tpuimage_torch.ops.kernels, "
            "tpuimage_torch.pipelines.night, tpuimage_torch.pipelines.morphseq; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'PIL', 'cv2', 'tpuimage')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_host_quad_fit_helpers_match_tpuimage(rng, monkeypatch):
    """The port's copies of the contour walk and the segment rasterizer
    give tpuimage's values, through the C++ path and the numpy fallback."""
    from tpuimage.detect import contours as jcnt
    from tpuimage.ops import draw as jdraw
    from tpuimage_torch import native
    from tpuimage_torch.detect import contours as tcnt
    from tpuimage_torch.ops import draw as tdraw
    edges = ((rng.random((60, 80)) < 0.08) * 255).astype(np.uint8)
    segs = rng.uniform(-5, 85, (6, 4))
    ref_lines = jdraw.draw_segments(edges.shape, segs, thickness=2)
    ref_cont = jcnt.find_external_contours(edges | ref_lines)
    for fallback in (False, True):
        if fallback:
            monkeypatch.setattr(native, "load_native", lambda: None)
            monkeypatch.setattr(tdraw, "load_native", lambda: None)
        lines = tdraw.draw_segments(edges.shape, segs, thickness=2)
        np.testing.assert_array_equal(lines, ref_lines)
        cont = tcnt.find_external_contours(edges | lines)
        assert len(cont) == len(ref_cont)
        for a, b in zip(cont, ref_cont):
            np.testing.assert_array_equal(a, b)
    quad = ref_cont[int(np.argmax(jcnt.contour_areas(ref_cont)))]
    np.testing.assert_array_equal(tcnt.box_points(tcnt.min_area_rect(quad)),
                                  jcnt.box_points(jcnt.min_area_rect(quad)))


# ---------------------------------------------------------------------------
# post-warp program
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pages():
    """A flat page and two tilted ones with table columns (so the deskew
    finds an angle and the rotation runs), at the page geometry of
    scale_long 256 (256x181)."""
    return np.stack([synth.page(11, 256, 181),
                     synth.page(12, 256, 181, tilt_deg=4.0, rules=3),
                     synth.page(13, 256, 181, tilt_deg=-3.0, rules=3)])


@pytest.fixture(scope="module")
def post_warp(pages):
    ref = jax.jit(functools.partial(jdoc.docscan_post_warp_batch, config=JCFG))(
        jnp.asarray(pages))
    ours = tdoc.docscan_post_warp_batch(_t(pages), CFG)
    return {k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in ours.items()}


@pytest.mark.parametrize("stage", ["illum", "stretch", "inkmask", "adapt", "weighted",
                                   "deskew_angle", "deskew_overflow"])
def test_post_warp_stages_exact(post_warp, stage):
    ref, ours = post_warp
    np.testing.assert_array_equal(ours[stage], ref[stage])


def test_post_warp_deskew_rotates_within_contract(post_warp):
    ref, ours = post_warp
    assert (ours["deskew_angle"] != 0).any(), ours["deskew_angle"]
    assert (ours["deskew_angle"] == 0).any(), ours["deskew_angle"]
    for k in ("deskew", "clean"):
        _assert_float_contract(ours[k], ref[k])
    flat = ours["deskew_angle"] == 0            # angle 0 is an exact identity
    np.testing.assert_array_equal(ours["deskew"][flat], ours["weighted"][flat])


def test_post_warp_single_page_equals_batch_row(pages, post_warp):
    _, ours = post_warp
    one = tdoc.docscan_post_warp(_t(pages[1]), CFG)
    for k, v in one.items():
        np.testing.assert_array_equal(v.numpy(), ours[k][1])


def test_raw_otsu_threshold(pages):
    planes = np.stack([synth.page(s, 64, 48)[..., 1] for s in range(4)])
    planes[1] //= 8
    planes[2] = np.where(planes[2] > 100, 0, planes[2])
    hists = histogram.hist256_batch(_t(planes))
    for off in (0, 8):
        ours = tdoc._raw_otsu_threshold(hists, off).numpy()
        for i in range(len(planes)):
            ref = jax.jit(jdoc._raw_otsu_threshold, static_argnums=1)(
                jnp.asarray(hists[i].numpy()), off)
            assert ours[i] == float(ref)


# ---------------------------------------------------------------------------
# localize and the serving path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def photos():
    """Two document photos (one with tilted text) and one with no page,
    320x240 (height x width)."""
    return [synth.document_photo(21, 320, 240),
            synth.document_photo(22, 320, 240, tilt_deg=4.0, rules=3),
            synth.document_photo(23, 320, 240, with_page=False)]


def test_localize(photos):
    stack = np.stack(photos)
    edges, segs, ok = tdoc._localize_device_batch(_t(stack), CFG.canny_low, CFG.canny_high)
    edges, segs, ok = edges.numpy(), segs.numpy(), ok.numpy()
    ref = jax.jit(jdoc._localize_device_batch, static_argnums=(1, 2))(
        jnp.asarray(stack), JCFG.canny_low, JCFG.canny_high)
    r_edges, r_segs, r_ok = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(edges, r_edges)
    np.testing.assert_array_equal(ok, r_ok)
    assert ok[:2].any(axis=1).all()
    np.testing.assert_allclose(segs[ok], r_segs[r_ok], atol=1e-3, rtol=0)
    for i in range(len(photos)):
        q = tdoc._quad_from_localize(edges[i], segs[i], ok[i], stack.shape[1:3], CFG)
        rq = jdoc._quad_from_localize(r_edges[i], r_segs[i], r_ok[i], stack.shape[1:3], JCFG)
        assert (q is None) == (rq is None)
        if q is not None:
            np.testing.assert_allclose(q, rq, atol=0.5, rtol=0)


def test_scan_batch_end_to_end(photos):
    ours = tdoc.scan_batch(photos, CFG, device="cpu")
    ref = jdoc.scan_batch(photos, JCFG)
    assert [r["use_whole"] for r in ours] == [False, False, True]
    for o, r in zip(ours, ref):
        assert o["use_whole"] == r["use_whole"]
        assert o["deskew_overflow"] == r["deskew_overflow"]
        assert (o["quad"] is None) == (r["quad"] is None)
        if o["quad"] is not None:
            np.testing.assert_allclose(o["quad"], r["quad"], atol=0.5, rtol=0)
        assert o["binary"].shape == r["binary"].shape and o["binary"].dtype == np.uint8
        assert (o["binary"] != r["binary"]).mean() < 0.002
    assert ours[0]["binary"].shape == (256, 181)     # A4 at scale_long 256
    assert ours[2]["binary"].shape == (256, 192)     # use-whole, aspect kept


def test_scan_batch_isolates_bad_requests(photos):
    bad = np.zeros((320, 240), np.uint8)              # not RGB
    out = tdoc.scan_batch([photos[0], bad, _t(photos[2])], CFG, device="cpu")
    assert "error" in out[1] and set(out[1]) == {"error"}
    assert out[0]["binary"].shape == (256, 181)
    assert out[2]["use_whole"] and out[2]["binary"].shape == (256, 192)
    with pytest.raises(ValueError, match="not a device of the mesh"):
        tdoc.scan_batch(photos, CFG, device="cpu", mesh=make_mesh(2, devices=["meta"] * 2))
    # the same isolation when the call runs in sub-batches of one
    chunked = tdoc.scan_batch([photos[0], bad, _t(photos[2])], CFG, device="cpu",
                              pipeline_chunk=1)
    assert set(chunked[1]) == {"error"}
    for i in (0, 2):
        np.testing.assert_array_equal(chunked[i]["binary"], out[i]["binary"])


def test_scan_batch_runs_on_the_card_unless_asked(photos, monkeypatch):
    """No device means the card: with none present scan_batch raises and
    names device="cpu", which then runs on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdoc.scan_batch(photos[:1], CFG)
    out = tdoc.scan_batch(photos[:1], CFG, device="cpu")
    assert out[0]["binary"].shape == (256, 181)
