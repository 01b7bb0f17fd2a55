"""tpuimage_torch.runtime.spatial and the entry points that reach it
(``process_document(space_mesh=)``, ``scan_batch(mesh=)``,
``scan_stream(mesh=)``) on host meshes of 2, 4 and 8 shards, against the
port's unsharded programs and tpuimage's sharded ones on its 8 virtual
CPU devices (tests/conftest.py).

Tolerances, each stated where it is checked:
- the global reductions, the integer Lab -> RGB, every DocScanner stage
  and the served results: exact (max |diff| 0), against both;
- night_*_spatial: exact against the port's unsharded forms; against
  tpuimage's night_*_spatial the CLAHE-tie contract, since tpuimage's
  sharded apply is its matrix form (``clahe_apply_matrix``), whose f32
  rounding at cvRound .5 boundaries differs from the port's
  ``clahe_apply``: max |diff| 1 on < 0.1% of L values (gray), and up to 3
  on < 0.1% of RGB values where the integer Lab -> RGB carries a step of
  L (as tests/test_torch_night.py holds night_rgb); ``filtered`` exact.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from tpuimage.ops import arith as jarith
from tpuimage.ops import color as jcolor
from tpuimage.pipelines import docscan as jdoc
from tpuimage.runtime import mesh as jrt
from tpuimage.runtime import spatial as jsp

from tpuimage_torch import synth
from tpuimage_torch.ops import arith, color, histogram, median
from tpuimage_torch.pipelines import docscan as tdoc
from tpuimage_torch.pipelines import night
from tpuimage_torch.runtime import mesh as rt
from tpuimage_torch.runtime import spatial as sp


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs (xdist runs several workers
    side by side); the count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GUI = tdoc.GUI_DOCUMENT_CONFIG
JGUI = jdoc.GUI_DOCUMENT_CONFIG
DEFAULT = tdoc.DocScanConfig(mask_blur_ksize=31, block_size=31)   # the close runs
JDEFAULT = jdoc.DocScanConfig(mask_blur_ksize=31, block_size=31)


def _space(n):
    return rt.make_mesh(n, ("space",), devices=["cpu"] * 8)


def _jspace(n):
    return jrt.make_mesh(n, axis_names=("space",))


def _tilted(h=256, w=192):
    """Near-vertical stripes tilted 3 degrees: a nonzero deskew angle, so
    the rotation runs (tests/test_runtime.py's page)."""
    yy, xx = np.mgrid[0:h, 0:w]
    stripes = (xx - yy * np.tan(np.deg2rad(3.0))) % 24 < 3
    return np.repeat(np.where(stripes, 40, 230).astype(np.uint8)[..., None], 3, axis=-1)


def _random_page(seed=5, h=256, w=192):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 3), dtype=np.uint8)


def _assert_stages_equal(ours, ref, what=""):
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(ref[k]),
                                      err_msg=f"{what} stage {k}")


# ---------------------------------------------------------------------------
# global reductions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 8])
def test_global_reductions_match_unsharded_and_tpuimage(rng, n):
    img = rng.integers(10, 240, size=(128, 64), dtype=np.uint8)
    shards = rt.split_to(torch.from_numpy(img), ["cpu"] * n)
    hist = sp.global_hist256(shards)
    np.testing.assert_array_equal(hist[0].numpy(), histogram.hist256(torch.from_numpy(img)).numpy())
    assert int(sp.global_min(shards)[-1]) == img.min() and int(sp.global_max(shards)[1]) == img.max()
    norm = torch.cat(sp.global_normalize_minmax(shards)).numpy()
    np.testing.assert_array_equal(norm, arith.normalize_minmax(torch.from_numpy(img)).numpy())
    np.testing.assert_array_equal(norm, np.asarray(jax.jit(jarith.normalize_minmax)(img)))

    def local(g):
        return jsp.global_hist256(g, "space"), jsp.global_min(g, "space"), \
            jsp.global_max(g, "space")

    jh, jlo, jhi = jax.shard_map(local, mesh=_jspace(n), in_specs=(P("space", None),),
                                 out_specs=(P(), P(), P()))(jnp.asarray(img))
    np.testing.assert_array_equal(hist[0].numpy(), np.asarray(jh))
    assert int(jlo) == img.min() and int(jhi) == img.max()
    # per plane of a batch: each plane's own min and max over all shards
    batch = rng.integers(0, 256, size=(3, 64, 48), dtype=np.uint8)
    batch[1] //= 4
    shards = rt.split_to(torch.from_numpy(batch), ["cpu"] * n, 1)
    np.testing.assert_array_equal(torch.cat(sp.global_normalize_minmax(shards), 1).numpy(),
                                  arith.normalize_minmax(torch.from_numpy(batch)).numpy())


def test_lab_to_rgb_lut_matches_tpuimage():
    """The integer Lab -> RGB, exact against tpuimage's _lab_to_rgb_lut on
    every L value crossed with a and b at stride 5, and on a grid of all
    three at stride 3; its tables equal tpuimage's."""
    for ours, ref in zip(color.lab_inv_tables(), jcolor._lab_inv_tables()):
        np.testing.assert_array_equal(ours, ref)
    ab = np.arange(0, 256, 5)
    g1 = np.stack(np.meshgrid(np.arange(256), ab, ab, indexing="ij"), -1).reshape(-1, 3)
    g3 = np.stack(np.meshgrid(*[np.arange(0, 256, 3)] * 3, indexing="ij"), -1).reshape(-1, 3)
    lut = jax.jit(lambda x: jcolor.lab_to_rgb(x, impl="lut"))
    for grid in (g1, g3):
        grid = grid.astype(np.uint8)
        np.testing.assert_array_equal(color.lab_to_rgb(torch.from_numpy(grid), impl="lut").numpy(),
                                      np.asarray(lut(jnp.asarray(grid))))
    with pytest.raises(ValueError, match="impl"):
        color.lab_to_rgb(torch.from_numpy(g3[:4].astype(np.uint8)), impl="xla")


# ---------------------------------------------------------------------------
# night
# ---------------------------------------------------------------------------

def _within(ours, ref, max_diff, max_share):
    diff = np.abs(np.asarray(ours).astype(np.int32) - np.asarray(ref).astype(np.int32))
    assert diff.max() <= max_diff, diff.max()
    assert (diff > 0).mean() < max_share, ((diff > 0).sum(), diff.size)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_night_gray_spatial(n):
    scenes = np.stack([synth.night_scene(s, 128, 160)[..., 1] for s in (3, 4)])
    out = sp.night_gray_spatial(scenes, _space(n))
    _assert_stages_equal(out, night.night_gray(scenes, device="cpu"))
    if n == 4:
        ref = jsp.night_gray_spatial(jnp.asarray(scenes[0]), _jspace(4))
        np.testing.assert_array_equal(out["filtered"][0].numpy(), np.asarray(ref["filtered"]))
        _within(out["enhanced"][0], ref["enhanced"], 1, 0.001)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_night_rgb_spatial(n):
    """Against the unsharded composition with the integer Lab -> RGB, as
    tpuimage's own test composes it."""
    scenes = np.stack([synth.night_scene(s, 128, 160) for s in (3, 4)])
    out = sp.night_rgb_spatial(scenes, _space(n))
    x = torch.from_numpy(scenes)
    filt = median.median_blur(x, 3, channels_last=True).contiguous()
    lab = color.rgb_to_lab(filt)
    l_enh = histogram.clahe(lab[..., 0], clip_limit=2.0, tiles_x=8, tiles_y=8)
    ref = color.lab_to_rgb(torch.cat([l_enh[..., None], lab[..., 1:]], dim=-1), impl="lut")
    _assert_stages_equal(out, {"original": x, "filtered": filt, "enhanced": ref})
    if n == 4:
        jref = jsp.night_rgb_spatial(jnp.asarray(scenes[1]), _jspace(4))
        np.testing.assert_array_equal(out["filtered"][1].numpy(), np.asarray(jref["filtered"]))
        _within(out["enhanced"][1], jref["enhanced"], 3, 0.001)


def test_night_spatial_refuses_untiled_shapes():
    gray = np.zeros((60, 48), np.uint8)
    with pytest.raises(ValueError, match="tile-divisible"):
        sp.night_gray_spatial(gray, _space(2))
    with pytest.raises(ValueError, match="tiles_y=8 must be divisible by the space axis"):
        sp.night_rgb_spatial(np.zeros((96, 48, 3), np.uint8), _space(3))


# ---------------------------------------------------------------------------
# DocScanner's post-warp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
def test_post_warp_spatial_random_page(n):
    page = _random_page()
    out = sp.docscan_post_warp_spatial(page, GUI, _space(n))
    _assert_stages_equal(out, tdoc.docscan_post_warp(torch.from_numpy(page), GUI), "port")
    _assert_stages_equal(out, jsp.docscan_post_warp_spatial(jnp.asarray(page), JGUI, _jspace(n)),
                         "tpuimage")


@pytest.mark.parametrize("n", [2, 4, 8])
def test_post_warp_spatial_rotation_and_close(n):
    """The tilted page under the GUI config (the rotation runs) and a
    random page under the default config (the close runs)."""
    for page, cfg, jcfg in ((_tilted(), GUI, JGUI), (_random_page(6), DEFAULT, JDEFAULT)):
        ref = tdoc.docscan_post_warp(torch.from_numpy(page), cfg)
        out = sp.docscan_post_warp_spatial(torch.from_numpy(page), cfg, _space(n))
        _assert_stages_equal(out, ref, "port")
        if n == 4:
            _assert_stages_equal(
                out, jsp.docscan_post_warp_spatial(jnp.asarray(page), jcfg, _jspace(4)),
                "tpuimage")
    assert float(tdoc.docscan_post_warp(torch.from_numpy(_tilted()), GUI)["deskew_angle"]) != 0


def test_post_warp_spatial_tightest_height():
    """The GUI config's widest halo is the ink blur's 25 rows: 4 shards of
    26 rows (H 104) still fit, in both packages; 25 rows do not."""
    page = _random_page(7, 104)
    out = sp.docscan_post_warp_spatial(page, GUI, _space(4))
    _assert_stages_equal(out, tdoc.docscan_post_warp(torch.from_numpy(page), GUI), "port")
    _assert_stages_equal(out, jsp.docscan_post_warp_spatial(jnp.asarray(page), JGUI, _jspace(4)),
                         "tpuimage")
    msg = "ink halo 25 >= shard height 25: use fewer shards or a taller page"
    with pytest.raises(ValueError, match=msg):
        sp.docscan_post_warp_spatial(page[:100], GUI, _space(4))
    with pytest.raises(AssertionError, match=msg):
        jsp.docscan_post_warp_spatial(jnp.asarray(page[:100]), JGUI, _jspace(4))
    with pytest.raises(ValueError, match="H=102 must divide the space axis"):
        sp.docscan_post_warp_spatial(page[:102], GUI, _space(4))


def test_post_warp_spatial_batch_on_a_data_space_mesh():
    """(data 2, space 4): each data row holds a tilted and a flat page, so
    a row rotates one page and leaves the other; every page equals its
    unsharded run."""
    batch = np.stack([_tilted(), _random_page(8), _tilted(), _random_page(9)])
    mesh = rt.make_mesh(8, ("data", "space"), (2, 4), devices=["cpu"] * 8)
    out = sp.docscan_post_warp_spatial_batch(batch, GUI, mesh)
    angles = []
    for i in range(4):
        ref = tdoc.docscan_post_warp(torch.from_numpy(batch[i]), GUI)
        _assert_stages_equal({k: v[i] for k, v in out.items()}, ref, f"page {i}")
        angles.append(float(ref["deskew_angle"]))
    assert angles[0] != 0 and angles[1] == 0
    with pytest.raises(ValueError, match="must divide the data axis"):
        sp.docscan_post_warp_spatial_batch(batch[:3], GUI, mesh)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

CFG400 = dataclasses.replace(GUI, scale_long=400)


@pytest.fixture(scope="module")
def photos():
    return [synth.document_photo(61, 480, 360),
            synth.document_photo(62, 480, 360, tilt_deg=4.0, rules=3),
            synth.document_photo(63, 480, 360, with_page=False)]


def test_process_document_space_mesh(photos):
    """Sharded where the warped height (400) divides the axis, equal to
    the unsharded call; on 3 shards it warns in tpuimage's words and runs
    unsharded."""
    unsharded = []
    for photo in photos[:2]:
        a = tdoc.process_document(photo, out_dir=None, config=CFG400, device="cpu")
        b = tdoc.process_document(photo, out_dir=None, config=CFG400, space_mesh=_space(4))
        _assert_stages_equal(b["stages"], a["stages"])
        np.testing.assert_array_equal(a["warped"].numpy(), b["warped"].numpy())
        assert a["use_whole"] == b["use_whole"] and a["stages"]["clean"].shape == (400, 283)
        unsharded.append(a)
    with pytest.warns(UserWarning, match=r"warped height 400 does not divide the space axis "
                                         r"\(3\); running the post-warp stages unsharded"):
        c = tdoc.process_document(photos[0], out_dir=None, config=CFG400,
                                  space_mesh=_space(3), device="cpu")
    _assert_stages_equal(c["stages"], unsharded[0]["stages"])


def _same_results(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            if k == "binary" or (k == "quad" and x[k] is not None):
                np.testing.assert_array_equal(x[k], y[k])
            else:
                assert x[k] == y[k], k


def test_scan_batch_and_stream_on_a_mesh(photos):
    """11 requests (two page shapes: 6 quad pages and 5 use-whole ones,
    each group padded to a multiple of 8 shards), then the stream over
    batches of 4, 4 and 3: each equal to the unsharded call."""
    inputs = (photos * 4)[:11]
    ref = tdoc.scan_batch(inputs, CFG400, device="cpu")
    mesh = rt.make_mesh(8, ("data",), devices=["cpu"] * 8)
    _same_results(tdoc.scan_batch(inputs, CFG400, mesh=mesh), ref)
    stream = list(tdoc.scan_stream([inputs[:4], inputs[4:8], inputs[8:]], CFG400,
                                   device="cpu", mesh=rt.make_mesh(4, devices=["cpu"] * 4)))
    _same_results([r for batch in stream for r in batch], ref)
    _same_results(tdoc.scan_batch(inputs[:5], CFG400, pipeline_chunk=2, mesh=_space(2)), ref[:5])


def test_device_and_mesh_must_agree(photos):
    meta = rt.make_mesh(2, ("space",), devices=["meta"] * 2)
    for call in (lambda: tdoc.scan_batch(photos[:1], CFG400, device="cpu", mesh=meta),
                 lambda: tdoc.scan_stream([photos[:1]], CFG400, device="cpu", mesh=meta),
                 lambda: tdoc.process_document(photos[0], out_dir=None, config=CFG400,
                                               device="cpu", space_mesh=meta)):
        with pytest.raises(ValueError, match="not a device of the mesh"):
            call()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = tdoc.scan_batch(photos[2:], CFG400, device="cpu:0", mesh=_space(2))
    assert out[0]["use_whole"]
