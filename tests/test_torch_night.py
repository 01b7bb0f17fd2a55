"""The night slice of tpuimage_torch (RGB -> Lab, Lab -> RGB, median,
CLAHE, night_gray / night_rgb) against tpuimage (JAX on the CPU), on
seeded inputs (``tpuimage_torch.synth.night_scene`` and random arrays).

Tolerances, each stated where it is checked:
- Lab forward, median blur and the CLAHE tile LUTs: exact (max |diff| 0);
- Lab -> RGB: exact against tpuimage's jitted lab_to_rgb, on every
  (L, a, b) byte triple;
- CLAHE and the night paths: max |diff| <= 1 on < 0.1% of pixels (the
  blend's f32 rounding at cvRound .5 boundaries: tpuimage's own gather,
  matrix and Pallas forms differ from one another by as much); night_rgb
  up to 3 levels where lab_to_rgb amplifies a step of L.
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpuimage.ops import color as jcolor
from tpuimage.ops import histogram as jhist
from tpuimage.ops import median as jmedian
from tpuimage.ops.pallas_kernels import clahe_apply_pallas, rgb_to_lab_pallas
from tpuimage.pipelines import night as jnight

from tpuimage_torch import convert, synth
from tpuimage_torch.ops import color, histogram, kernels, median
from tpuimage_torch.pipelines import night

# one intra-op thread: pytest-xdist runs several workers side by side, and
# PyTorch's default of one spinning thread per core each slows every
# worker many times over
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))     # a writable, contiguous copy


def _assert_within(ours, ref, max_diff, max_share):
    diff = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    assert diff.max() <= max_diff, diff.max()
    assert (diff > 0).mean() < max_share, ((diff > 0).sum(), diff.size)


def _inputs(kind, shape, seed=7):
    if kind == "scene":
        return synth.night_scene(seed, *shape)
    return np.random.default_rng(seed).integers(0, 256, shape + (3,), dtype=np.uint8)


# ---------------------------------------------------------------------------
# state carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,tiles", [((853, 1280), (8, 8)), ((128, 160), (8, 8)),
                                         ((97, 131), (4, 6))])
def test_night_tables_match_tpuimage(shape, tiles):
    tab = convert.night_tables(shape, tiles)
    np.testing.assert_array_equal(tab["lab_gamma"], jcolor._GAMMA_TAB_NP)
    np.testing.assert_array_equal(tab["lab_cbrt"], jcolor._CBRT_TAB_NP)
    np.testing.assert_array_equal(tab["lab_coeffs"], jcolor._LAB_COEFFS)
    h, w = shape
    tx, ty = tiles
    # tpuimage's own geometry (histogram.py clahe), then its blend matrices
    if h % ty == 0 and w % tx == 0:
        th, tw = h // ty, w // tx
    else:
        th, tw = (h + ty - h % ty) // ty, (w + tx - w % tx) // tx
    assert tab["clahe_tile"] == (th, tw)
    np.testing.assert_array_equal(tab["clahe_R"], jhist.clahe_blend_matrix(h, th, ty))
    np.testing.assert_array_equal(tab["clahe_C"], jhist.clahe_blend_matrix(w, tw, tx).T)
    # the port's blend tables hold the same weights, both kept at the edges
    for table, n, m in ((tab["clahe_rows"], ty, tab["clahe_R"]),
                        (tab["clahe_cols"], tx, tab["clahe_C"].T)):
        rebuilt = np.zeros((len(table), n), np.float32)
        rows = np.arange(len(table))
        rebuilt[rows, table[:, 0].astype(int)] += np.float32(1) - table[:, 2]
        rebuilt[rows, table[:, 1].astype(int)] += table[:, 2]
        np.testing.assert_array_equal(rebuilt, m)


def test_night_tile_shape_at_nightview_size():
    """1280x853: 853 is not divisible by 8, so both dims pad and the
    width gains a full extra tile: tiles of 107x161 = 17,227 pixels."""
    assert histogram.clahe_geometry(853, 1280, 8, 8) == (3, 8, 107, 161)


# ---------------------------------------------------------------------------
# colour
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["scene", "random"])
def test_rgb_to_lab_exact(kind):
    x = _inputs(kind, (61, 83))
    ours = color.rgb_to_lab(_t(x)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jcolor.rgb_to_lab(jnp.asarray(x), impl="xla")))
    np.testing.assert_array_equal(ours, np.asarray(rgb_to_lab_pallas(jnp.asarray(x), interpret=True)))


def test_rgb_to_lab_exact_on_a_colour_grid():
    """Every 8th level of each channel (32^3 colours) plus the extremes,
    against tpuimage's XLA path: max |diff| 0."""
    lv = np.r_[np.arange(0, 256, 8), 255]
    grid = np.stack(np.meshgrid(lv, lv, lv, indexing="ij"), -1).reshape(-1, 3).astype(np.uint8)
    grid = grid.reshape(33, 33 * 33, 3)
    ours = color.rgb_to_lab(_t(grid)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jcolor.rgb_to_lab(jnp.asarray(grid), impl="xla")))


def test_rgb_to_lab_batch_and_strides():
    x = np.stack([_inputs("scene", (40, 52), s) for s in range(3)])
    ours = color.rgb_to_lab(_t(x).transpose(1, 2)).numpy()     # a non-contiguous view
    for i in range(3):
        np.testing.assert_array_equal(
            ours[i], np.asarray(jcolor.rgb_to_lab(jnp.asarray(x[i].transpose(1, 0, 2)),
                                                  impl="xla")))


def test_lab_to_rgb_within_contract():
    """Random Lab bytes (65,536 pixels) and the Lab of a night scene:
    exact against tpuimage's jitted f32 path."""
    rnd = np.random.default_rng(3).integers(0, 256, (256, 256, 3), dtype=np.uint8)
    lab_scene = np.asarray(jcolor.rgb_to_lab(jnp.asarray(synth.night_scene(4, 128, 160)),
                                             impl="xla"))
    for lab in (rnd, lab_scene):
        ours = color.lab_to_rgb(_t(lab)).numpy()
        ref = np.asarray(jax.jit(jcolor.lab_to_rgb)(jnp.asarray(lab)))
        np.testing.assert_array_equal(ours, ref)


def test_lab_to_rgb_on_every_lab_triple():
    """All 2**24 (L, a, b) bytes, 64 values of L at a time: exact against
    tpuimage's jitted lab_to_rgb (XLA folds its constants, fuses a / 500
    and b / 200 into fx and fz and one product of each matrix row; its f32
    pow is libm's powf). The op-by-op form with PyTorch's f32 pow differed
    on 90 of 5,636,096 triples, and by where an element fell in a vector."""
    ab = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"), -1)
    jit = jax.jit(jcolor.lab_to_rgb)
    for l0 in range(0, 256, 64):
        lab = np.concatenate([np.broadcast_to(np.arange(l0, l0 + 64)[:, None, None, None],
                                              (64, 256, 256, 1)),
                              np.broadcast_to(ab, (64, 256, 256, 2))], -1).astype(np.uint8)
        np.testing.assert_array_equal(color.lab_to_rgb(_t(lab)).numpy(),
                                      np.asarray(jit(jnp.asarray(lab))), err_msg=str(l0))


def test_srgb_thresholds_match_xla():
    """color._SRGB_THRESHOLD_BITS against tpuimage's jitted sRGB tail: its
    byte is monotone over every f32 of the pow branch, (0.0031308, 1], and
    each threshold is the first value of its byte (the linear branch is a
    correctly rounded product, monotone by construction)."""
    from tpuimage.core.dtypes import saturate_u8 as jsat

    tail = jax.jit(lambda r: jsat(jnp.where(r <= 0.0031308, r * 12.92,
                                            1.055 * r ** (1.0 / 2.4) - 0.055) * 255.0))
    thr = np.array(color._SRGB_THRESHOLD_BITS, np.uint32).view(np.float32)
    lo, hi = np.float32(0.0031308).view(np.uint32) + 1, np.float32(1.0).view(np.uint32)
    pow_branch = np.arange(lo, hi + 1, dtype=np.uint32).view(np.float32)
    byte = np.asarray(tail(jnp.asarray(pow_branch))).astype(np.int32)
    assert (np.diff(byte) >= 0).all()
    step = np.nonzero(np.diff(byte))[0] + 1
    np.testing.assert_array_equal(thr[byte[step] - 1], pow_branch[step])
    below = np.nextafter(thr, np.float32(0))
    np.testing.assert_array_equal(np.asarray(tail(jnp.asarray(thr))), np.arange(1, 256))
    np.testing.assert_array_equal(np.asarray(tail(jnp.asarray(below))), np.arange(0, 255))


# ---------------------------------------------------------------------------
# median
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ksize", [3, 5])
@pytest.mark.parametrize("channels", [0, 3])
def test_median_blur_exact(ksize, channels):
    x = _inputs("scene", (97, 131))
    x = x if channels else np.ascontiguousarray(x[..., 1])
    ours = median.median_blur(_t(x), ksize, channels_last=bool(channels)).numpy()
    ref = np.asarray(jax.jit(functools.partial(jmedian.median_blur, ksize=ksize))(jnp.asarray(x)))
    np.testing.assert_array_equal(ours, ref)


def test_median_blur_batch_and_rejects_even_ksize():
    x = _t(np.stack([_inputs("random", (33, 47), s)[..., 0] for s in range(3)]))
    ours = median.median_blur(x, 3)
    for i in range(3):
        assert torch.equal(ours[i], median.median_blur(x[i], 3))
    with pytest.raises(ValueError):
        median.median_blur(x, 4)
    assert median.median_blur(x, 1) is x


# ---------------------------------------------------------------------------
# CLAHE
# ---------------------------------------------------------------------------

def _tiles(img, tiles_x=8, tiles_y=8):
    """tpuimage's tile rows (histogram.py clahe) of an (H, W) image, and the tile area."""
    h, w = img.shape
    ph, pw, th, tw = histogram.clahe_geometry(h, w, tiles_x, tiles_y)
    p = np.pad(img, ((0, ph), (0, pw)), mode="reflect")
    return (p.reshape(tiles_y, th, tiles_x, tw).transpose(0, 2, 1, 3)
            .reshape(tiles_y * tiles_x, th * tw)), th * tw


def test_clahe_tiles_match_tpuimage_layout():
    x = synth.night_scene(5, 97, 131)[..., 0]
    tiles, th, tw = histogram.clahe_tiles(_t(np.stack([x, x[::-1]])), 8, 8)
    ref, area = _tiles(x)
    assert (th * tw, tiles.is_contiguous()) == (area, True)
    np.testing.assert_array_equal(tiles[:64].numpy(), ref)
    np.testing.assert_array_equal(tiles[64:].numpy(), _tiles(x[::-1])[0])


@pytest.mark.parametrize("clip_limit", [2.0, 40.0, 0.0])
def test_tile_luts_exact(clip_limit):
    tiles, area = _tiles(synth.night_scene(5, 97, 131)[..., 0])
    ours = histogram.tile_luts_from_counts(kernels.hist256_batch(_t(tiles)), clip_limit,
                                           area).numpy()
    for impl in ("scatter", "pallas"):
        ref = np.asarray(jhist._clahe_tile_luts(jnp.asarray(tiles), clip_limit, area, impl=impl))
        np.testing.assert_array_equal(ours, ref, err_msg=impl)


@pytest.mark.parametrize("shape", [(128, 160), (213, 301)])   # divisible, and not
@pytest.mark.parametrize("kind", ["scene", "random"])
def test_clahe_within_contract(shape, kind):
    """Against tpuimage's CPU ``auto`` (gather) form, its matrix form and
    its Pallas kernel interpreted: max |diff| <= 1 on < 0.1% of pixels."""
    x = _inputs(kind, shape)[..., 0].copy()
    ours = histogram.clahe(_t(x), 2.0, 8, 8).numpy()
    for impl in ("gather", "mxu", "pallas"):
        ref = np.asarray(jhist.clahe(jnp.asarray(x), 2.0, 8, 8, impl=impl))
        _assert_within(ours, ref, 1, 1e-3)


@pytest.mark.parametrize("shape", [(128, 160), (213, 301)])   # divisible, and not
def test_clahe_within_contract_on_a_5x3_grid(shape):
    """tiles_x=5, tiles_y=3 (ty != tx), against the same three forms of
    tpuimage's clahe: max |diff| <= 1 on < 0.1% of pixels."""
    x = _inputs("scene", shape)[..., 0].copy()
    ours = histogram.clahe(_t(x), 2.0, tiles_x=5, tiles_y=3).numpy()
    for impl in ("gather", "mxu", "pallas"):
        ref = np.asarray(jhist.clahe(jnp.asarray(x), 2.0, 5, 3, impl=impl))
        _assert_within(ours, ref, 1, 1e-3)


def test_clahe_apply_ref_matches_pallas_with_the_same_luts():
    """The apply step alone, fed tpuimage's own LUTs (and the Pallas
    kernel its blend matrices, the port its blend tables): max |diff| <= 1
    on < 0.1% of pixels against clahe_apply_pallas."""
    x = synth.night_scene(6, 213, 301)[..., 0].copy()
    h, w = x.shape
    tiles, area = _tiles(x)
    luts = np.asarray(jhist._clahe_tile_luts(jnp.asarray(tiles), 2.0, area, impl="scatter"))
    _, _, th, tw = histogram.clahe_geometry(h, w, 8, 8)
    R = jhist.clahe_blend_matrix(h, th, 8)
    C = np.ascontiguousarray(jhist.clahe_blend_matrix(w, tw, 8).T)
    ours = kernels.clahe_apply(_t(x[None]), _t(luts.reshape(1, 8, 8, 256)),
                               _t(histogram.clahe_blend_table(h, th, 8)),
                               _t(histogram.clahe_blend_table(w, tw, 8)))[0]
    ref = np.asarray(clahe_apply_pallas(jnp.asarray(x), jnp.asarray(luts, jnp.float32)
                                        .reshape(8, 8, 256), jnp.asarray(R), jnp.asarray(C),
                                        th=th, tw=tw, interpret=True))
    _assert_within(ours.numpy(), ref, 1, 1e-3)


# ---------------------------------------------------------------------------
# the pipelines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scenes():
    """Two night scenes of 240x352: CLAHE tiles of 30x44 pixels. (Smaller
    tiles put more pixels on cvRound .5 boundaries, where every form of
    the blend, tpuimage's own included, rounds its own way.)"""
    return np.stack([synth.night_scene(20 + i, 240, 352) for i in range(2)])


def _tpu_night_gray(gray):
    """tpuimage's night_gray as its ``auto`` dispatch runs it on the TPU
    (Pallas CLAHE), with the kernels interpreted."""
    f = jmedian.median_blur(jnp.asarray(gray), 3)
    return np.asarray(jhist.clahe(f, 2.0, 8, 8, impl="pallas"))


def _tpu_night_rgb(rgb):
    """tpuimage's night_rgb as its ``auto`` dispatch runs it on the TPU
    (Pallas Lab and CLAHE), with the kernels interpreted."""
    f = jmedian.median_blur(jnp.asarray(rgb), 3)
    lab = jcolor.rgb_to_lab(f, impl="pallas")
    l_enh = jhist.clahe(lab[..., 0], 2.0, 8, 8, impl="pallas")
    return np.asarray(jcolor.lab_to_rgb(jnp.concatenate([l_enh[..., None], lab[..., 1:]], -1)))


def _share(a, b):
    return float((a != b).mean())


def test_night_gray_whole(scenes):
    """filtered exact. enhanced: against tpuimage's TPU form, max |diff|
    <= 1 on < 0.1% of pixels; against its CPU ``auto`` (gather) form, max
    |diff| <= 1 on no more than 0.1% beyond the pixels where tpuimage's
    two forms already differ from each other."""
    gray = np.ascontiguousarray(scenes[..., 1])
    ours = night.night_gray_batch(gray, device="cpu")
    for i in range(len(gray)):
        ref = jnight.night_gray(jnp.asarray(gray[i]))
        tpu = _tpu_night_gray(gray[i])
        enh = ours["enhanced"][i].numpy()
        np.testing.assert_array_equal(ours["original"][i].numpy(), gray[i])
        np.testing.assert_array_equal(ours["filtered"][i].numpy(), np.asarray(ref["filtered"]))
        _assert_within(enh, tpu, 1, 1e-3)
        _assert_within(enh, np.asarray(ref["enhanced"]), 1, 1.0)
        assert _share(enh, np.asarray(ref["enhanced"])) <= \
            _share(tpu, np.asarray(ref["enhanced"])) + 1e-3


def test_night_rgb_whole(scenes):
    """filtered exact. enhanced: a CLAHE step of 1 on L moves RGB through
    lab_to_rgb by up to 3 levels; against tpuimage's TPU form, max |diff|
    <= 3 on < 0.1% of values; against its CPU ``auto`` form, max |diff|
    <= 3 on no more than 0.1% beyond where tpuimage's two forms differ."""
    ours = night.night_rgb_batch(scenes, device="cpu")
    for i in range(len(scenes)):
        ref = jnight.night_rgb(jnp.asarray(scenes[i]))
        tpu = _tpu_night_rgb(scenes[i])
        enh = ours["enhanced"][i].numpy()
        np.testing.assert_array_equal(ours["filtered"][i].numpy(), np.asarray(ref["filtered"]))
        _assert_within(enh, tpu, 3, 1e-3)
        _assert_within(enh, np.asarray(ref["enhanced"]), 3, 1.0)
        assert _share(enh, np.asarray(ref["enhanced"])) <= \
            _share(tpu, np.asarray(ref["enhanced"])) + 1e-3
    assert night.night_gui is night.night_rgb


def test_night_batch_equals_single(scenes):
    batch = night.night_rgb_batch(_t(scenes))
    gray = night.night_gray_batch(_t(scenes[..., 0]))
    for i in range(len(scenes)):
        one = night.night_rgb(_t(scenes[i]))
        one_g = night.night_gray(_t(scenes[i, ..., 0]))
        for k in ("original", "filtered", "enhanced"):
            assert torch.equal(batch[k][i], one[k]), k
            assert torch.equal(gray[k][i], one_g[k]), k


@pytest.mark.parametrize("entry", ["night_gray", "night_rgb"])
def test_night_runs_on_the_card_unless_asked(monkeypatch, entry):
    """An array goes to the card by default, and with no card that raises;
    device="cpu" and a CPU tensor run on the host."""
    fn = getattr(night, entry)
    x = synth.night_scene(9, 24, 40)
    x = x if entry == "night_rgb" else np.ascontiguousarray(x[..., 0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(x)
    on_host = fn(x, device="cpu")
    assert on_host["enhanced"].device.type == "cpu"
    assert torch.equal(fn(_t(x))["enhanced"], on_host["enhanced"])
