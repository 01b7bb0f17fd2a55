"""Each path of tpuimage_torch that runs a CLAHE against tpuimage's jitted
program on the CPU: the max |diff| and the count of differing values,
against tpuimage's program and against a copy of it whose CLAHE stage is
cv2's (``cv2_clahe.program_copy``); first the CLAHE alone on the photo's
L, the port's and tpuimage's gather and matrix forms, against cv2.

    python tests/clahe_path_report.py

Inputs: the whole ``outputs/scan_02_quad.png`` (672x478) and its copy
darkened to 1/4; the sharded night on its top 672x472 (tile-divisible) at
4 shards. One line a path and input. Runs in a few minutes on one core.
"""
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import dataclasses  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import cv2  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from cv2_clahe import program_copy  # noqa: E402
from tpuimage.ops import histogram as jhist  # noqa: E402
from tpuimage.pipelines import face as jface  # noqa: E402
from tpuimage.pipelines import landscape as jland  # noqa: E402
from tpuimage.pipelines import modules as jmod  # noqa: E402
from tpuimage.pipelines import night as jnight  # noqa: E402
from tpuimage.pipelines import shadow as jshadow  # noqa: E402
from tpuimage.presets import apply as japply  # noqa: E402
from tpuimage.presets import loader as jloader  # noqa: E402
from tpuimage.runtime import mesh as jrt  # noqa: E402
from tpuimage.runtime import spatial as jsp  # noqa: E402

from tpuimage_torch import convert  # noqa: E402
from tpuimage_torch.io import imageio  # noqa: E402
from tpuimage_torch.ops import color, histogram  # noqa: E402
from tpuimage_torch.pipelines import face, landscape, modules, night, shadow  # noqa: E402
from tpuimage_torch.presets import apply  # noqa: E402
from tpuimage_torch.runtime import mesh as rt  # noqa: E402
from tpuimage_torch.runtime import spatial as sp  # noqa: E402

# tests/test_torch_presets.py's preset with every stage on
EVERY_STAGE = dict(brightness_mode="gamma", brightness_gamma=0.9, linear_boost_beta=4.0,
                   contrast_mode="clahe", clahe_clip=2.0, saturation_mult=1.2,
                   saturation_cap=0.5, gray_world=True, chroma_boost_cb=1.1,
                   chroma_boost_cr=1.05, highlight_compression="sqrt", local_contrast=True,
                   lc_radius=2.0, lc_amount=0.6, lc_threshold=1.0, invert=True)


def _line(path: str, image: str, ours, ref, cv2_ref=None, against: str = "tpuimage") -> None:
    d = np.abs(np.asarray(ours).astype(np.int64) - np.asarray(ref).astype(np.int64))
    text = (f"{path}, {image}: against {against} max |diff| {int(d.max())}, "
            f"{int((d > 0).sum())} of {d.size} values differ")
    if cv2_ref is not None:
        c = np.abs(np.asarray(ours).astype(np.int64) - np.asarray(cv2_ref).astype(np.int64))
        text += (f"; against tpuimage with cv2's CLAHE max |diff| {int(c.max())}, "
                 f"{int((c > 0).sum())} differ")
    print(text, flush=True)


def main() -> int:
    torch.set_num_threads(1)
    photo = imageio.load_image_rgb(os.path.join(os.path.dirname(HERE), "outputs",
                                                "scan_02_quad.png"))
    images = {"photo": photo, "dark": photo // 4}
    every = jloader.CategorizationPreset(name="every", group="g", **EVERY_STAGE)
    lum = color.rgb_to_lab(torch.from_numpy(photo))[..., 0].numpy()
    for clip in (2.0, 40.0):
        want = cv2.createCLAHE(clip, (8, 8)).apply(lum)
        _line(f"CLAHE clip {clip} of the photo's L", "the port",
              histogram.clahe(torch.from_numpy(lum), clip), want, against="cv2")
        for impl in ("gather", "mxu"):
            _line(f"CLAHE clip {clip} of the photo's L", f"tpuimage's {impl} form",
                  jax.jit(functools.partial(jhist.clahe, clip_limit=clip, impl=impl))(
                      jnp.asarray(lum)), want, against="cv2")
    for image, x in images.items():
        xj = jnp.asarray(x)
        gray = np.asarray(jax.jit(lambda a: jnp.round(
            a[..., 0] * 0.299 + a[..., 1] * 0.587 + a[..., 2] * 0.114).astype(jnp.uint8))(xj))
        _line("night_gray enhanced", image, night.night_gray(gray, device="cpu")["enhanced"],
              jax.jit(jnight.night_gray)(jnp.asarray(gray))["enhanced"],
              program_copy([jnight], jnight.night_gray, jnp.asarray(gray))["enhanced"])
        _line("night_rgb enhanced", image, night.night_rgb(x, device="cpu")["enhanced"],
              jnight.night_rgb(xj)["enhanced"],
              program_copy([jnight], jnight.night_rgb, xj)["enhanced"])
        _line("landscape enhance_image", image, landscape.enhance_image(x, device="cpu"),
              jland.enhance_image(xj),
              program_copy([jland], jland.enhance_image, xj))
        _line("landscape_gui", image, landscape.landscape_gui(x, device="cpu"),
              jland.landscape_gui(xj), program_copy([jland], jland.landscape_gui, xj))
        _line("face apply_histogram_equalization", image,
              face.apply_histogram_equalization(x, device="cpu"),
              jface.apply_histogram_equalization(xj),
              program_copy([jface], jface.apply_histogram_equalization, xj))
        _line("module1_enhance", image, modules.module1_enhance(x, device="cpu"),
              jmod.module1_enhance(xj), program_copy([jmod], jmod.module1_enhance, xj))
        for name in ("GENERAL", "PORTRAIT"):
            jp = jshadow.PRESETS[name]
            _line(f"shadow {name}", image,
                  shadow.enhance_image(x, category=name, device="cpu")[0],
                  jshadow.enhance_shadow_protected(xj, jp)[0],
                  program_copy([jshadow], jshadow.enhance_shadow_protected, xj, preset=jp)[0])
        _line("every-stage preset", image,
              apply.apply_categorization_preset(
                  x, convert.preset_from_tpuimage(json.loads(json.dumps(dataclasses.asdict(every)))),
                  device="cpu"),
              japply.apply_categorization_preset(xj, every),
              program_copy([japply], japply.apply_categorization_preset, xj, preset=every))
    crop = np.ascontiguousarray(photo[:, :472, 1][None])
    ours = sp.night_gray_spatial(crop, rt.make_mesh(4, ("space",), devices=["cpu"] * 4))
    ref = jsp.night_gray_spatial(jnp.asarray(crop[0]), jrt.make_mesh(4, axis_names=("space",)))
    _line("night_gray_spatial enhanced (4 shards)", "photo green 672x472",
          ours["enhanced"][0], ref["enhanced"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
