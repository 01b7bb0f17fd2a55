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


def _frame_edges(seed, h=1080, w=1920, k=9, step=3.0, lines=()):
    """A frame's edge map: a k-gon of 1 px edges inset from the border
    with outward spikes every ``step`` px along it, each traced on both
    sides by the outer border (100k+ points at 1920x1080, as localize's
    joined frame border reads on the benchmark's photos), 1% noise pixels,
    and ``lines`` drawn 2 px wide like localize's Hough segments."""
    from tpuimage_torch.ops.draw import draw_segments
    rng = np.random.default_rng(seed)
    ang = np.sort(rng.uniform(0, 2 * np.pi, k))
    c = np.array([w / 2, h / 2])
    poly = c + np.stack([np.cos(ang) * w, np.sin(ang) * h], 1) * rng.uniform(0.36, 0.44, (k, 1))
    segs = []
    for i in range(k):
        p, q = poly[i], poly[(i + 1) % k]
        segs.append(np.r_[p, q])
        d = q - p
        nrm = np.array([d[1], -d[0]]) / np.hypot(*d)
        if nrm @ (p - c) < 0:
            nrm = -nrm
        for f in np.arange(0, 1, step / np.hypot(*d)):
            s = p + f * d
            segs.append(np.r_[s, s + nrm * rng.uniform(20, 90) * h / 1080])
    edges = draw_segments((h, w), segs, thickness=1)
    edges |= ((rng.random((h, w)) < 0.01) * 255).astype(np.uint8)
    if len(lines):
        edges |= draw_segments((h, w), lines, thickness=2)
    return edges


@pytest.fixture(scope="module")
def frame_border():
    """The largest contour of a 1920x1080 frame's edge map."""
    from tpuimage_torch.detect import contours as tcnt
    contour_list = tcnt.find_external_contours(_frame_edges(5))
    c = contour_list[int(np.argmax(tcnt.contour_areas(contour_list)))]
    assert len(c) > 100_000
    return c


def _hull_inputs(name, frame_border):
    rng = np.random.default_rng(20150823)
    if name == "frame_border":
        return frame_border
    if name == "int_cloud_dups":
        return rng.integers(0, 40, (3000, 2))
    if name == "int_disc":
        p = rng.normal(0, 300, (20000, 2))
        return np.round(p[np.hypot(*p.T) < 700]).astype(np.int64)
    if name == "collinear":
        t = rng.integers(-50, 50, 200)
        return np.stack([3 * t + 7, -2 * t + 1], 1)
    if name == "collinear_float":
        return np.stack([np.linspace(0, 1, 50), np.linspace(0, 1, 50) * 0.3], 1)
    if name in ("one", "two", "three"):
        return rng.integers(-9, 9, ({"one": 1, "two": 2, "three": 3}[name], 2))
    if name == "two_same":
        return np.array([[4, 5], [4, 5]])
    if name == "negative":
        return rng.integers(-1000, -10, (5000, 2))
    if name == "float":
        return rng.normal(0, 50, (5000, 2))
    if name == "float_grid":
        return rng.integers(-20, 20, (3000, 2)) * 0.1
    if name == "beyond_2_25":
        return rng.integers(-2 ** 40, 2 ** 40, (3000, 2))
    if name == "list":
        return [[0, 0], [5, 0], [5, 5], [2, 2], [0, 5]]
    if name.startswith("float_on_edge"):
        # points rounded onto a segment, a cloud to one side: the chain's
        # rounded crosses keep some of them, so dropping any changes its
        # output (the prefilter must stay off here)
        rng = np.random.default_rng(int(name.split("_")[-1]))
        a = rng.normal(0, 10, 2)
        b = a + rng.normal(0, 50, 2)
        on = a + rng.uniform(0, 1, (400, 1)) * (b - a)
        nrm = np.array([a[1] - b[1], b[0] - a[0]])
        side = ((a + b) / 2 + nrm * rng.uniform(0.05, 0.5, (50, 1))
                + (b - a) * rng.uniform(-0.3, 0.3, (50, 1)))
        return np.concatenate([on, side, [a, b]])
    raise KeyError(name)


def _rect_bytes(rect):
    (cx, cy), (w, h), ang = rect
    return np.asarray([cx, cy, w, h, ang], np.float64).tobytes()


def _hull_paths(points, monkeypatch):
    """(hull, rect bytes, box points) from the port's default path, its
    numpy fallback and tpuimage's, with the native hull counts of each."""
    from tpuimage.detect import contours as jcnt
    from tpuimage_torch import native
    from tpuimage_torch.detect import contours as tcnt
    from tpuimage_torch.runtime import profiling

    def one(mod):
        before = profiling.counts().get("contours.hull_native", 0)
        hull = mod.convex_hull(points)
        rect = mod.min_area_rect(points)
        out = (hull, _rect_bytes(rect), mod.box_points(rect))
        return out, profiling.counts().get("contours.hull_native", 0) - before

    got = one(tcnt)
    with monkeypatch.context() as m:
        m.setattr(native, "load_native", lambda: None)
        fallback = one(tcnt)
    return got, fallback, one(jcnt)


def _assert_same_bytes(a, b):
    assert a[0].dtype == b[0].dtype == np.float64
    assert a[0].shape == b[0].shape
    assert a[0].tobytes() == b[0].tobytes()
    assert a[1] == b[1]
    assert a[2].dtype == b[2].dtype and a[2].tobytes() == b[2].tobytes()


@pytest.mark.parametrize("name", [
    "frame_border", "int_cloud_dups", "int_disc", "collinear", "collinear_float", "one",
    "two", "two_same", "three", "negative", "float", "float_grid", "beyond_2_25", "list",
    "float_on_edge_2", "float_on_edge_123", "float_on_edge_148"])
def test_convex_hull_native_byte_equal(name, frame_border, monkeypatch):
    """The C++ hull (with the interior prefilter on integer inputs below
    2^25, without it elsewhere) gives the numpy body's bytes and
    tpuimage's; min_area_rect and box_points follow."""
    from tpuimage_torch import native
    assert native.load_native() is not None
    points = _hull_inputs(name, frame_border)
    (got, n_got), (fallback, n_fallback), (ref, _) = _hull_paths(points, monkeypatch)
    assert n_got == 2 and n_fallback == 0       # convex_hull, then min_area_rect's
    _assert_same_bytes(got, fallback)
    _assert_same_bytes(got, ref)
    if name == "frame_border":
        assert 4 < len(got[0]) < 100


@pytest.mark.parametrize("bad", ["nan", "inf", "negative_zero"])
def test_convex_hull_numpy_body_takes_what_native_cannot(bad, monkeypatch):
    """Non-finite coordinates and negative zeros (np.unique folds -0.0
    into 0.0 by the sort's order) take the numpy body, uncounted."""
    from tpuimage.detect import contours as jcnt
    from tpuimage_torch.detect import contours as tcnt
    from tpuimage_torch.runtime import profiling
    pts = np.random.default_rng(7).integers(-20, 20, (400, 2)).astype(np.float64)
    pts[[3, 17]] = {"nan": [np.nan, 1.0], "inf": [np.inf, 2.0], "negative_zero": [-0.0, 5.0]}[bad]
    before = profiling.counts().get("contours.hull_native", 0)
    with np.errstate(invalid="ignore"):
        hull = tcnt.convex_hull(pts)
        assert profiling.counts().get("contours.hull_native", 0) == before
        ref = jcnt.convex_hull(pts)
    assert hull.dtype == ref.dtype and hull.tobytes() == ref.tobytes()


def _triangle_contours(seed, tie_at):
    """Triangles (no 4-gon to find) with the two largest areas equal: a
    translated copy of the largest inserted at ``tie_at``."""
    rng = np.random.default_rng(seed)
    tris = [rng.integers(0, 40, (3, 2)) + rng.integers(0, 200, 2) for _ in range(12)]
    from tpuimage_torch.detect import contours as tcnt
    big = tris[int(np.argmax([tcnt.contour_area(t) for t in tris]))]
    tris.insert(tie_at, big + np.array([300, 7]))
    return tris


@pytest.mark.parametrize("seed,tie_at", [(1, 0), (2, 5), (3, 12), (4, 13)])
def test_quad_fit_fallback_takes_the_first_largest_contour(seed, tie_at, monkeypatch):
    """The fallback's one area pass (the first argmax of the areas the
    filter computed) picks the contour ``max(contour_list,
    key=contour_area)`` picks, ties included."""
    from tpuimage_torch.detect import contours as tcnt
    contour_list = _triangle_contours(seed, tie_at)
    areas = [tcnt.contour_area(c) for c in contour_list]
    assert areas.count(max(areas)) == 2
    want = max(contour_list, key=tcnt.contour_area)
    picked, min_area_rect = [], tcnt.min_area_rect
    monkeypatch.setattr(tdoc.cnt, "find_external_contours", lambda binary: contour_list)
    monkeypatch.setattr(tdoc.cnt, "min_area_rect",
                        lambda c: picked.append(c) or min_area_rect(c))
    edges = np.zeros((400, 600), np.uint8)
    segs, ok = np.zeros((1, 4), np.float32), np.zeros(1, bool)
    quad = tdoc._quad_from_localize(edges, segs, ok, edges.shape, CFG)
    assert len(picked) == 1 and picked[0] is want
    np.testing.assert_array_equal(
        quad, tdoc.order_quad_points(tcnt.box_points(min_area_rect(want))))


def test_quad_fit_fallback_end_to_end_native_and_numpy(monkeypatch):
    """_quad_from_localize on a frame whose fit falls back: the native
    path, the numpy fallbacks and tpuimage's give equal quads."""
    from tpuimage_torch import native
    from tpuimage_torch.ops import draw as tdraw
    from tpuimage_torch.runtime import profiling
    h, w = 270, 480
    lines = np.array([[0, 20, 479, 31], [40, 0, 52, 269], [300, 269, 479, 150]], np.float32)
    edges = _frame_edges(9, h, w, step=4.0, lines=lines[:1])
    segs = np.concatenate([lines, np.zeros((5, 4), np.float32)])
    ok = np.arange(len(segs)) < len(lines)

    def fit():
        c0 = profiling.counts()
        q = tdoc._quad_from_localize(edges, segs, ok, (h, w), CFG)
        c1 = profiling.counts()
        return q, {k: c1.get(k, 0) - c0.get(k, 0)
                   for k in ("docscan.quad_fallbacks", "contours.hull_native")}

    quad, n = fit()
    assert n == {"docscan.quad_fallbacks": 1, "contours.hull_native": 1}
    with monkeypatch.context() as m:
        m.setattr(native, "load_native", lambda: None)
        m.setattr(tdraw, "load_native", lambda: None)
        quad_numpy, n_numpy = fit()
    assert n_numpy == {"docscan.quad_fallbacks": 1, "contours.hull_native": 0}
    ref = jdoc._quad_from_localize(edges, segs, ok, (h, w), JCFG)
    assert quad.dtype == quad_numpy.dtype == ref.dtype
    assert quad.tobytes() == quad_numpy.tobytes() == ref.tobytes()


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
