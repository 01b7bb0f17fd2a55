"""tpuimage_torch's CLAHE (``ops.histogram.clahe``: the ``hist256`` tile
histograms, the LUTs, the ``clahe_apply`` blend in cv2's order) against
``cv2.createCLAHE(clip, tiles).apply`` and against tpuimage's jitted
``histogram.clahe``.

Tolerance: none. The port equals cv2 on every pixel of every case: the L,
gray and darkened L of the whole ``outputs/scan_02_quad.png`` and the
gray A4 page ``outputs/scan_03_warped.png`` at 8x8 tiles, face's 4x4 eye
regions (57x69 and 69x57, geometries cv2 pads), random bytes at sizes the
tiles do not divide. tpuimage's forms round some cvRound .5 ties of the
blend the other way; wherever the port differs from one of them, that
form differs from cv2.
"""
import dataclasses
import functools
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuimage.ops import histogram as jhist

from tpuimage_torch.io import imageio
from tpuimage_torch.ops import color, histogram

from cv2_clahe import program_copy

torch.set_num_threads(1)

OUTPUTS = os.path.join(os.path.dirname(__file__), os.pardir, "outputs")


@functools.lru_cache(maxsize=None)
def _plane(name: str) -> np.ndarray:
    if name == "page gray":
        page = imageio.load_image_rgb(os.path.join(OUTPUTS, "scan_03_warped.png"))
        return color.rgb_to_gray(torch.from_numpy(page)).numpy()
    photo = imageio.load_image_rgb(os.path.join(OUTPUTS, "scan_02_quad.png"))
    if name == "photo gray":
        return color.rgb_to_gray(torch.from_numpy(photo)).numpy()
    lum = color.rgb_to_lab(torch.from_numpy(photo))[..., 0].numpy()
    if name == "photo L / 4":
        return lum // 4
    if name.startswith("eye "):
        h, w = (int(v) for v in name[4:].split("x"))
        return np.ascontiguousarray(lum[300:300 + h, 200:200 + w])
    assert name == "photo L", name
    return lum


def _random(h: int, w: int) -> np.ndarray:
    return np.random.default_rng(h * 1000 + w).integers(0, 256, (h, w), dtype=np.uint8)


CASES = ([(name, clip, 8) for name in ("photo L", "photo gray", "photo L / 4", "page gray")
          for clip in (2.0, 3.0, 4.0, 40.0)]
         + [("eye 57x69", 0.2, 4), ("eye 69x57", 0.2, 4)]
         + [(f"random {h}x{w}", clip, 8) for h, w in ((101, 203), (37, 45), (250, 333))
            for clip in (2.0, 40.0)])


def _input(name: str) -> np.ndarray:
    if name.startswith("random "):
        return _random(*(int(v) for v in name[7:].split("x")))
    return _plane(name)


@pytest.mark.parametrize("name,clip,tiles", CASES, ids=[f"{n}-{c}-{t}x{t}" for n, c, t in CASES])
def test_clahe_equals_cv2(name, clip, tiles):
    x = _input(name)
    ours = histogram.clahe(torch.from_numpy(x), clip, tiles, tiles).numpy()
    np.testing.assert_array_equal(ours, cv2.createCLAHE(clip, (tiles, tiles)).apply(x))


@pytest.mark.parametrize("name", ["photo L", "photo gray", "photo L / 4", "page gray"])
def test_differences_from_tpuimage_are_its_own_from_cv2(name):
    """At clip 2, 3 and 40, against tpuimage's jitted CLAHE in its CPU
    form (``gather``) and its matrix form (``mxu``): every pixel where the
    port differs from that form is one where the form differs from cv2,
    and each form differs from cv2 somewhere on the whole images (its own
    ties), where the port does not."""
    x = _plane(name)
    seen = 0
    for clip in (2.0, 3.0, 40.0):
        want = cv2.createCLAHE(clip, (8, 8)).apply(x)
        ours = histogram.clahe(torch.from_numpy(x), clip).numpy()
        for impl in ("gather", "mxu"):
            ref = np.asarray(jax.jit(functools.partial(jhist.clahe, clip_limit=clip,
                                                       impl=impl))(jnp.asarray(x)))
            apart = ours != ref
            assert (ref[apart] != want[apart]).all()
            assert np.abs(ours.astype(int) - ref).max() <= 1
            seen += int(apart.sum())
    assert seen > 0


# The paths whose stages after the CLAHE equal tpuimage's when handed the
# same CLAHE stage, on the whole photo and its copy darkened to 1/4:
# against a copy of tpuimage's jitted program whose CLAHE stage is cv2's
# (tests/cv2_clahe.py), first checked equal to tpuimage's with its own
# stage. (Landscape's sky blend and the shadow presets' blends fuse
# another product when the stage comes from a host callback, so a copy of
# theirs is not tpuimage's program; their tests keep their bounds.)
EVERY_STAGE = dict(brightness_mode="gamma", brightness_gamma=0.9, linear_boost_beta=4.0,
                   contrast_mode="clahe", clahe_clip=2.0, saturation_mult=1.2,
                   saturation_cap=0.5, gray_world=True, chroma_boost_cb=1.1,
                   chroma_boost_cr=1.05, highlight_compression="sqrt", local_contrast=True,
                   lc_radius=2.0, lc_amount=0.6, lc_threshold=1.0, invert=True)


def _path(name):
    """(the port's function of an image, tpuimage's module and jitted
    function, its static arguments, whether the input is gray, the key of
    the output in a dict of stages or None)."""
    from tpuimage.pipelines import modules as jmod
    from tpuimage.pipelines import night as jnight
    from tpuimage.presets import apply as japply
    from tpuimage.presets import loader as jloader
    from tpuimage_torch import convert
    from tpuimage_torch.pipelines import modules, night
    from tpuimage_torch.presets import apply
    if name == "night_gray":
        return (lambda x: night.night_gray(x, device="cpu")["enhanced"], jnight,
                jnight.night_gray, {}, True, "enhanced")
    if name == "night_rgb":
        return (lambda x: night.night_rgb(x, device="cpu")["enhanced"], jnight,
                jnight.night_rgb, {}, False, "enhanced")
    if name == "module1_enhance":
        return (lambda x: modules.module1_enhance(x, device="cpu"), jmod, jmod.module1_enhance,
                {}, False, None)
    jp = jloader.CategorizationPreset(name="every", group="g", **EVERY_STAGE)
    p = convert.preset_from_tpuimage(dataclasses.asdict(jp))
    return (lambda x: apply.apply_categorization_preset(x, p, device="cpu"), japply,
            japply.apply_categorization_preset, {"preset": jp}, False, None)


PATHS = ["night_gray", "night_rgb", "module1_enhance", "every_stage_preset"]


@pytest.mark.parametrize("image", ["photo", "dark"])
@pytest.mark.parametrize("name", PATHS)
def test_paths_equal_tpuimage_with_cv2_clahe(name, image):
    ours_fn, module, fn, static, gray, key = _path(name)
    photo = imageio.load_image_rgb(os.path.join(OUTPUTS, "scan_02_quad.png"))
    x = photo if image == "photo" else photo // 4
    if gray:
        x = color.rgb_to_gray(torch.from_numpy(x)).numpy()
    xj = jnp.asarray(x)
    pick = (lambda out: out[key]) if key else (lambda out: out)
    ref = np.asarray(pick(jax.jit(functools.partial(fn, **static))(xj)))
    np.testing.assert_array_equal(pick(program_copy([module], fn, xj, cv2_stage=False,
                                                    **static)), ref)
    ours = ours_fn(x).numpy()
    np.testing.assert_array_equal(ours, pick(program_copy([module], fn, xj, **static)))
    assert (ours != ref).any()
