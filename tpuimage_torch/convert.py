"""The state carried across from tpuimage.

No pipeline has learned weights. DocScanner's state is its config plus
static tables (the Q8 Gaussian taps, the f32 adaptive-threshold taps and
its integer offset, the Hough cos/sin tables, the structuring elements
and the preprocess's bilateral taps and weights); the night paths' is
the Lab tables and CLAHE's blend matrices. The tables are built from
numpy exactly as tpuimage builds them. The CLIP classifier's weights come
across from tpuimage's Flax parameters (``clip_params_from_tpuimage``),
and its presets (the shadow pipeline's and the two databases') as plain
dicts (``preset_from_tpuimage``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from tpuimage_torch.ops.bilateral import tap_tables
from tpuimage_torch.ops.color import lab_tables
from tpuimage_torch.ops.filters import gaussian_kernel_q8, get_gaussian_kernel
from tpuimage_torch.ops.histogram import clahe_blend_matrix, clahe_geometry
from tpuimage_torch.ops.hough import hough_tables
from tpuimage_torch.ops.kernels import color_weight_table
from tpuimage_torch.pipelines.docscan import (INK_DILATE_SE, DocScanConfig,
                                              adaptive_block, blackhat_se,
                                              illum_ksize, mask_ksize)
from tpuimage_torch.pipelines.shadow import ShadowPreset
from tpuimage_torch.presets.loader import CategorizationPreset, EnhancementPreset


def config_from_tpuimage(cfg) -> DocScanConfig:
    """A tpuimage ``DocScanConfig`` (read by ``dataclasses.asdict``; tpuimage
    itself is not imported) -> the port's ``DocScanConfig``."""
    fields = dataclasses.asdict(cfg)
    ours = {f.name for f in dataclasses.fields(DocScanConfig)}
    if set(fields) != ours:
        raise ValueError(f"config fields differ: {sorted(set(fields) ^ ours)}")
    return DocScanConfig(**fields)


def preset_from_tpuimage(d: dict):
    """``dataclasses.asdict`` of a tpuimage ``ShadowPreset``,
    ``CategorizationPreset`` or ``EnhancementPreset`` -> the port's
    dataclass of the same fields (lists, as a JSON round trip leaves
    them, become tuples)."""
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    for cls in (ShadowPreset, CategorizationPreset, EnhancementPreset):
        if set(fields) == {f.name for f in dataclasses.fields(cls)}:
            return cls(**fields)
    raise ValueError(f"no preset class has the fields {sorted(fields)}")


def static_tables(config: DocScanConfig, page_shape=(1200, 849)) -> dict:
    """The static tables the post-warp program uses on a page of
    ``page_shape`` (H, W)."""
    cos_t, sin_t = hough_tables()
    tables = {
        "illum_taps_q8": gaussian_kernel_q8(illum_ksize(*page_shape, config)),
        "mask_taps_q8": gaussian_kernel_q8(mask_ksize(config)),
        "adaptive_taps_f32": get_gaussian_kernel(adaptive_block(config)).astype(np.float32),
        "adaptive_idelta": math.ceil(config.C),
        "hough_cos": cos_t,
        "hough_sin": sin_t,
        "se_blackhat": blackhat_se(config),
        "se_ink_dilate": INK_DILATE_SE,
    }
    return tables


def bilateral_tables(d: int, sigma_color: float, sigma_space: float,
                     channels: int = 1) -> dict:
    """The bilateral filter's tables for cv2.bilateralFilter(d, sigma_color,
    sigma_space) on 1 or 3 channels: the (T, 2) int32 (dy, dx) tap offsets
    in tpuimage's tap order and the (T,) float32 space weights, built from
    numpy as tpuimage builds them, and the float32 colour weights of every
    distance 0..255 * channels (the plain version's expression, on the
    CPU)."""
    radius, offsets, space_w, gc = tap_tables(d, sigma_color, sigma_space)
    return {
        "radius": radius,
        "tap_offsets": offsets,
        "space_weights": space_w,
        "gauss_color": gc,
        "color_weights": color_weight_table(255 * channels + 1, gc, "cpu").numpy(),
    }


def night_tables(shape=(853, 1280), tiles=(8, 8)) -> dict:
    """The static tables of the night paths on an (H, W) image with
    ``tiles`` = (tiles_x, tiles_y): the Lab gamma and cube-root tables and
    fixed-point coefficients, and CLAHE's tile size and blend matrices
    R (H, ty) and C (tx, W)."""
    h, w = shape
    tiles_x, tiles_y = tiles
    gamma, cbrt, coeffs = lab_tables()
    _, _, th, tw = clahe_geometry(h, w, tiles_x, tiles_y)
    return {
        "lab_gamma": gamma,
        "lab_cbrt": cbrt,
        "lab_coeffs": coeffs,
        "clahe_tile": (th, tw),
        "clahe_R": clahe_blend_matrix(h, th, tiles_y),
        "clahe_C": clahe_blend_matrix(w, tw, tiles_x).T,
    }


def _clip_block(p: dict, prefix: str) -> dict:
    """One Flax ``_Block``'s parameters -> open_clip's keys under ``prefix``:
    a ``Dense`` kernel is the torch weight transposed."""
    sd = {f"{prefix}.attn.in_proj_weight": p["attn"]["in_proj"]["kernel"].T,
          f"{prefix}.attn.in_proj_bias": p["attn"]["in_proj"]["bias"]}
    for name, dense in (("attn.out_proj", p["attn"]["out_proj"]), ("mlp.c_fc", p["mlp_fc"]),
                        ("mlp.c_proj", p["mlp_proj"])):
        sd[f"{prefix}.{name}.weight"] = dense["kernel"].T
        sd[f"{prefix}.{name}.bias"] = dense["bias"]
    for ln in ("ln_1", "ln_2"):
        sd.update(_clip_ln(p[ln], f"{prefix}.{ln}"))
    return sd


def _clip_ln(p: dict, prefix: str) -> dict:
    return {f"{prefix}.weight": p["scale"], f"{prefix}.bias": p["bias"]}


def clip_params_from_tpuimage(params) -> dict:
    """tpuimage's CLIP parameters ``{"vision": ..., "text": ...}`` (Flax
    trees; leaves numpy or jax arrays) -> the open_clip-layout state dict
    the port's towers load, float32 numpy.
    Undoes ``convert_openclip_state_dict``: Dense kernels transposed back,
    the NHWC patch kernel (kh, kw, C, D) -> (D, C, kh, kw), LayerNorm
    ``scale`` -> ``weight``."""
    v, t = _as_numpy_tree(params["vision"]), _as_numpy_tree(params["text"])
    sd = {"visual.conv1.weight": v["patch_embed"]["kernel"].transpose(3, 2, 0, 1),
          "token_embedding.weight": t["token_embedding"]["embedding"]}
    for name in ("class_embedding", "positional_embedding", "proj"):
        sd[f"visual.{name}"] = v[name]
    for name in ("positional_embedding", "text_projection"):
        sd[name] = t[name]
    for ln in ("ln_pre", "ln_post"):
        sd.update(_clip_ln(v[ln], f"visual.{ln}"))
    sd.update(_clip_ln(t["ln_final"], "ln_final"))
    for i in range(_n_blocks(v)):
        sd.update(_clip_block(v[f"block_{i}"], f"visual.transformer.resblocks.{i}"))
    for i in range(_n_blocks(t)):
        sd.update(_clip_block(t[f"block_{i}"], f"transformer.resblocks.{i}"))
    return {k: np.ascontiguousarray(v, dtype=np.float32) for k, v in sd.items()}


def _as_numpy_tree(tree):
    if hasattr(tree, "items"):
        return {k: _as_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _n_blocks(tower: dict) -> int:
    return sum(1 for k in tower if k.startswith("block_"))
