"""The preset loaders and appliers of tpuimage_torch against tpuimage's
(JAX on the CPU). The preset JSON databases are not in the repository,
so the loaders read a file the test writes in the schema tpuimage's
loader parses, and the appliers take presets built as tpuimage
dataclasses and carried across by ``convert.preset_from_tpuimage``.

Inputs: a colour grid (every R, G on a step of 5, B on a step of 7),
``synth.shadowed_scene`` at 72x96 and a 240x320 crop of
``outputs/scan_02_quad.png``.

Tolerances, each stated where it is checked:
- exact: every stage without a CLAHE (brightness linear and gamma 0.8 /
  1.2 / 2.2, alpha, saturation, gray world, chroma boost, highlight sqrt
  / log / mild_sqrt, local contrast, invert; equalisation, the
  sky-protection and blend tables, invert) on the scene and the crop;
  the gray enhancement path (no Lab round trip) on all of them; the
  luminance tables on all 65,536 (L, L') pairs against the value inside
  tpuimage's jitted applier;
- the Lab-L stages without a CLAHE on the colour grid: max |diff| 1 on <
  1e-4 of values (measured at most 41 of 1,477,632): tpuimage's own
  lab_to_rgb, jitted alone, differs from the port's by 1 on 25 of the
  5,680,128 values of a Lab grid (XLA fuses its products);
- the stages with a CLAHE, and everything at once: PATH_TOL (the
  CLAHE-tie contract, ROADMAP Queue 3).
"""
import dataclasses
import json

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpuimage.ops import color as jcolor
from tpuimage.ops import histogram as jhist
from tpuimage.presets import apply as japply
from tpuimage.presets import loader as jloader

from tpuimage_torch import convert, synth
from tpuimage_torch.io import imageio
from tpuimage_torch.presets import apply, loader

torch.set_num_threads(1)

PATH_TOL = (4, 0.015, 0.005)
LAB_GRID_TOL = (1, 1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _diff(ours, ref):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    return np.abs(ours.astype(np.int64) - ref.astype(np.int64))


def _exact(ours, ref):
    d = _diff(ours, ref)
    assert d.max() == 0, ((d > 0).sum(), d.size, d.max())


def _assert_within(ours, ref, max_diff, share_any, share_over_1=None):
    d = _diff(ours, ref)
    assert d.max() <= max_diff, d.max()
    assert (d > 0).mean() < share_any, ((d > 0).sum(), d.size)
    if share_over_1 is not None:
        assert (d > 1).mean() < share_over_1, ((d > 1).sum(), d.size)


def _grid():
    return np.stack(np.meshgrid(np.arange(256, dtype=np.uint8),
                                np.arange(0, 256, 5, dtype=np.uint8),
                                np.arange(0, 256, 7, dtype=np.uint8), indexing="ij"),
                    axis=-1).reshape(64, -1, 3)


IMAGES = {"grid": _grid,
          "scene": lambda: synth.shadowed_scene(0, 72, 96),
          "scan": lambda: imageio.load_image_rgb("outputs/scan_02_quad.png")[:240, :320]}


def _across(p):
    """A tpuimage preset -> the port's, as plain data (a JSON round trip)."""
    return convert.preset_from_tpuimage(json.loads(json.dumps(dataclasses.asdict(p))))


CATEGORIZATION_STAGES = {
    "linear": dict(brightness_mode="linear", brightness_beta=12.5, linear_boost_beta=3.0),
    "gamma0.8": dict(brightness_mode="gamma", brightness_gamma=0.8),
    "gamma1.2": dict(brightness_mode="gamma", brightness_gamma=1.2),
    "gamma2.2": dict(brightness_mode="gamma", brightness_gamma=2.2),
    "alpha": dict(contrast_mode="alpha", contrast_alpha=1.15),
    "clahe": dict(contrast_mode="clahe", clahe_clip=2.5, clahe_tiles=(4, 6)),
    "saturation": dict(saturation_mult=1.3, saturation_cap=0.2),
    "gray_world": dict(gray_world=True, gain_clamp=(0.9, 1.1)),
    "chroma": dict(chroma_boost_cb=1.2, chroma_boost_cr=1.1),
    "chroma_doc": dict(chroma_boost_cb=1.5, chroma_boost_cr=1.5),
    "sqrt": dict(highlight_compression="sqrt"),
    "log": dict(highlight_compression="log"),
    "mild_sqrt": dict(highlight_compression="mild_sqrt"),
    "local_contrast": dict(local_contrast=True, lc_radius=2.0, lc_amount=0.5, lc_threshold=2.0),
    "local_contrast_0": dict(local_contrast=True, lc_radius=1.5, lc_amount=0.8,
                             lc_threshold=0.0),
    "invert": dict(invert=True),
}
EVERY_STAGE = dict(brightness_mode="gamma", brightness_gamma=0.9, linear_boost_beta=4.0,
                   contrast_mode="clahe", clahe_clip=2.0, saturation_mult=1.2,
                   saturation_cap=0.5, gray_world=True, chroma_boost_cb=1.1,
                   chroma_boost_cr=1.05, highlight_compression="sqrt", local_contrast=True,
                   lc_radius=2.0, lc_amount=0.6, lc_threshold=1.0, invert=True)
LAB_L_STAGES = ("sqrt", "log", "mild_sqrt", "local_contrast", "local_contrast_0")


@pytest.mark.parametrize("stage", sorted(CATEGORIZATION_STAGES))
def test_categorization_one_stage_at_a_time(stage):
    jp = jloader.CategorizationPreset(name=stage, group="g", **CATEGORIZATION_STAGES[stage])
    p = _across(jp)
    for name, make in IMAGES.items():
        x = make()
        ref = japply.apply_categorization_preset(jnp.asarray(x), jp)
        ours = apply.apply_categorization_preset(x, p, device="cpu")
        if stage == "clahe":
            _assert_within(ours, ref, *PATH_TOL)
        elif name == "grid" and stage in LAB_L_STAGES:
            _assert_within(ours, ref, *LAB_GRID_TOL)
        else:
            _exact(ours, ref)


def test_categorization_every_stage_and_batch():
    jp = jloader.CategorizationPreset(name="all", group="g", **EVERY_STAGE)
    p = _across(jp)
    xs = np.stack([synth.shadowed_scene(0, 72, 96), synth.shadowed_scene(5, 72, 96)])
    ours = apply.apply_categorization_preset(xs, p, device="cpu")
    for i in range(2):
        _assert_within(ours[i], japply.apply_categorization_preset(jnp.asarray(xs[i]), jp),
                       *PATH_TOL)
    # the gray-world gains are each image's own
    jg = jloader.CategorizationPreset(name="gw", group="g", gray_world=True)
    ours = apply.apply_categorization_preset(xs, _across(jg), device="cpu")
    for i in range(2):
        _exact(ours[i], japply.apply_categorization_preset(jnp.asarray(xs[i]), jg))


ENHANCEMENT_STAGES = {
    "alpha": dict(contrast_alpha=1.2),
    "equalization": dict(hist_method="equalization"),
    "clahe": dict(hist_method="clahe", clahe_clip=3.0, clahe_tiles=(8, 8)),
    "eq_sky2": dict(hist_method="equalization", sky_protection_power=2.0, blend_strength=0.6),
    "eq_sky1.5": dict(hist_method="equalization", sky_protection_power=1.5, blend_strength=0.7),
    "eq_blend": dict(hist_method="equalization", blend_strength=0.6),
    "clahe_sky3": dict(hist_method="clahe", sky_protection_power=3.0, blend_strength=0.55),
    "invert": dict(invert=True, contrast_alpha=0.9),
}


@pytest.mark.parametrize("stage", sorted(ENHANCEMENT_STAGES))
def test_enhancement_one_stage_at_a_time(stage):
    jp = jloader.EnhancementPreset(name=stage, group="g", **ENHANCEMENT_STAGES[stage])
    p = _across(jp)
    for name, make in IMAGES.items():
        x = make()
        ref = japply.apply_enhancement_preset(jnp.asarray(x), jp)
        ours = apply.apply_enhancement_preset(x, p, device="cpu")
        if "clahe" in stage:
            _assert_within(ours, ref, *PATH_TOL)
        elif name == "grid" and stage != "alpha" and stage != "invert":
            _assert_within(ours, ref, *LAB_GRID_TOL)
        else:
            _exact(ours, ref)
        # a gray plane: tpuimage's 2-D path, no Lab round trip
        g = np.asarray(jcolor.rgb_to_gray(x))
        ref = japply.apply_enhancement_preset(jnp.asarray(g), jp)
        ours = apply.apply_enhancement_preset(g, p, gray=True, device="cpu")
        if "clahe" in stage:
            _assert_within(ours, ref, *PATH_TOL)
        else:
            _exact(ours, ref)


def _blend_forms(power, blend):
    """The blend of every (L, L') pair cvRounded in f32 with each of its
    two products fused into the add: (l * (1 - w) fused, l' * w fused)."""
    f, r = np.float32, np.float32(1) / np.float32(255)
    lo = np.arange(256, dtype=f)[:, None]
    lc = np.arange(256, dtype=f)[None, :]
    if power > 0:
        w = (f(1) - np.asarray(jnp.power(lo * r, f(power)))) * f(blend)
        if power in (2.0, 3.0):            # XLA writes pow by 2 or 3 as products, fused
            left, right = (lo * r, lo * r) if power == 2.0 else (lo * r, (lo * r) * (lo * r))
            w = _fma_np(-left, right, f(1)) * f(blend)
    else:
        w = np.full_like(lo, f(blend))
    a = np.clip(np.rint(_fma_np(lo, f(1) - w, lc * w)), 0, 255)
    b = np.clip(np.rint(_fma_np(lc, w, lo * (f(1) - w))), 0, 255)
    return a.astype(np.uint8), b.astype(np.uint8)


def _fma_np(x, y, z):
    return (np.float64(x) * np.float64(y) + np.float64(z)).astype(np.float32)


def _equalising_to(a, b, n=1000):
    """A gray plane of n pixels (0s, then a, then 255s) whose equalisation
    maps L = a to b, or None."""
    for c0 in range(1, n // 2):
        for ca in range(1, n - c0):
            if np.rint(ca * (np.float32(255.0) / np.float32(n - c0))) == b:
                plane = np.full(n, 255, np.uint8)
                plane[:c0], plane[c0:c0 + ca] = 0, a
                plane = plane.reshape(20, n // 20)
                if np.asarray(jhist.equalize_hist(plane)).flat[c0] == b:
                    return plane, c0
    return None


@pytest.mark.parametrize("power,blend", [(2.0, 0.6), (3.0, 0.55), (1.5, 0.7), (0.0, 0.6)])
def test_luminance_tables_on_all_pairs(power, blend):
    """Each table on all 65,536 (L, L') pairs: equal to both fused forms
    wherever they agree; where they differ (2 pairs at power 3, blend
    0.55), tpuimage's applier itself decides, on a gray plane whose
    equalisation maps that L to that L' (the blend's lines jitted alone
    fuse the other product there, so a copy cannot decide)."""
    table = apply.luminance_blend_table(power, blend)
    a, b = _blend_forms(power, blend)
    same = a == b
    _exact(table[same], a[same])
    kw = dict(hist_method="equalization", blend_strength=blend)
    if power > 0:
        kw["sky_protection_power"] = power
    jp = jloader.EnhancementPreset(name="t", group="g", **kw)
    disputed = np.argwhere(~same)
    assert len(disputed) == (2 if power == 3.0 else 0)
    for l, l2 in disputed:
        plane, at = _equalising_to(int(l), int(l2))
        ref = np.asarray(japply.apply_enhancement_preset(jnp.asarray(plane), jp))
        assert ref.flat[at] == table[l, l2], (l, l2, ref.flat[at], table[l, l2])
        _exact(apply.apply_enhancement_preset(plane, _across(jp), gray=True, device="cpu"), ref)


CAT_JSON = {
    "HumanEnhancementPresets": {
        "Warm": {"brightness": {"beta": 10}, "contrast": {"mode": "clahe", "clip_limit": 2.5,
                                                          "tile_grid": [4, 4]},
                 "saturation": {"multiplier": 1.3, "cap": 0.2},
                 "white_balance": {"gray_world": True, "gain_clamp": [0.85, 1.15]},
                 "chroma_boost": {"Cb": 1.1, "Cr": 1.2}, "description": "warm skin"},
        "Soft": {"brightness": {"gamma": 0.9}, "contrast": {"alpha": 1.1},
                 "saturation": {"enabled": False},
                 "local_contrast": {"enabled": True, "radius": 3, "amount": 0.4,
                                    "threshold": 2}},
    },
    "DocumentEnhancementPresets": {
        "Scan": {"enhancement": {"gamma": 1.2, "clahe_clip_limit": 3.0,
                                 "clahe_tile_grid": [8, 8], "chroma_boost": 4,
                                 "highlight_compression": "mild_sqrt",
                                 "color_space": "LAB"},
                 "invert": True, "linear_boost": {"beta": 5}},
        "Fax": {"enhancement": {"chroma_boost": {"Cb": 1.5, "Cr": 1.4},
                                "highlight_compression": {"mode": "log"}}},
    },
}
ENH_JSON = {
    "SceneEnhancementPresets": {
        "Sky": {"contrast_stretch": {"alpha": 1.1},
                "histogram_modification": {"method": "equalization", "channel": "luminance"},
                "sky_protection": {"power": 2, "threshold": 0.6}, "blend_strength": 0.55},
        "Clahe": {"clahe": {"clip_limit": 2.2, "tile_grid_size": [8, 8]}, "invert": True},
    },
}


def test_loaders_on_a_written_file(tmp_path):
    cat, enh = tmp_path / "categorization_presets.json", tmp_path / "enhancement_presets.json"
    cat.write_text(json.dumps(CAT_JSON))
    enh.write_text(json.dumps(ENH_JSON))
    for ours, ref in ((loader.load_categorization_presets(str(cat)),
                       jloader.load_categorization_presets(str(cat))),
                      (loader.load_enhancement_presets(str(enh)),
                       jloader.load_enhancement_presets(str(enh)))):
        assert sorted(ours) == sorted(ref)
        for key in ref:
            assert dataclasses.asdict(ours[key]) == dataclasses.asdict(ref[key])
            assert _across(ref[key]) == ours[key]
    x = synth.shadowed_scene(2, 72, 96)
    for key, p in jloader.load_categorization_presets(str(cat)).items():
        ref = japply.apply_categorization_preset(jnp.asarray(x), p)
        _assert_within(apply.apply_categorization_preset(x, _across(p), device="cpu"), ref,
                       *PATH_TOL)
    assert loader.GROUPS == jloader.GROUPS and loader.GROUP_LABELS == jloader.GROUP_LABELS


def test_loaders_default_path_is_the_packages_absent_data_dir():
    with pytest.raises(FileNotFoundError):
        loader.load_categorization_presets()
    with pytest.raises(FileNotFoundError):
        loader.load_enhancement_presets()


def test_appliers_need_a_card_by_default():
    p = loader.EnhancementPreset(name="a", group="g", contrast_alpha=1.1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            apply.apply_enhancement_preset(np.zeros((4, 4, 3), np.uint8), p)
    with pytest.raises(ValueError, match="no preset class"):
        convert.preset_from_tpuimage({"name": "x"})
