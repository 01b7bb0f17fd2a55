"""Loaders for the two JSON preset databases (counterpart of
``tpuimage.presets.loader``, which holds no JAX; the port keeps its own
copy).

``enhancement_presets.json`` and ``categorization_presets.json`` (5 groups
x 6-12 presets each) parse into typed dataclasses, and
``tpuimage_torch.presets.apply`` turns a preset into an op chain. The
default search path is this package's ``data/`` directory; pass ``path=``
to read a file elsewhere.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

_REPO_DEFAULT_PATHS = [
    os.path.join(os.path.dirname(__file__), "data"),
]

GROUPS = ("HumanEnhancementPresets", "SceneEnhancementPresets",
          "SpecialEnhancementPresets", "GeneralEnhancementPresets",
          "DocumentEnhancementPresets")

# group -> default scene label (for routing integration)
GROUP_LABELS = {
    "HumanEnhancementPresets": "face",
    "SceneEnhancementPresets": "landscape",
    "SpecialEnhancementPresets": "nightscape",
    "GeneralEnhancementPresets": "landscape",
    "DocumentEnhancementPresets": "document",
}


def _find(name: str) -> str:
    for base in _REPO_DEFAULT_PATHS:
        p = os.path.join(base, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(name)


@dataclasses.dataclass(frozen=True)
class CategorizationPreset:
    """One preset of categorization_presets.json (the richer DB):
    brightness -> contrast -> saturation -> white balance -> chroma boost ->
    highlight compression -> local contrast, in that order."""
    name: str
    group: str
    brightness_mode: str = "none"        # none | linear | gamma
    brightness_beta: float = 0.0
    brightness_gamma: float = 1.0
    contrast_mode: str = "none"          # none | alpha | clahe
    contrast_alpha: float = 1.0
    clahe_clip: float = 2.0
    clahe_tiles: Tuple[int, int] = (8, 8)
    saturation_mult: float = 1.0
    saturation_cap: float = 1.0          # max relative increase
    gray_world: bool = False
    gain_clamp: Tuple[float, float] = (0.9, 1.1)
    chroma_boost_cb: float = 1.0
    chroma_boost_cr: float = 1.0
    highlight_compression: str = "none"  # none | sqrt | log
    local_contrast: bool = False
    lc_radius: float = 2.0
    lc_amount: float = 0.5
    lc_threshold: float = 0.0
    linear_boost_beta: float = 0.0
    invert: bool = False
    color_space: str = "RGB"
    description: str = ""


@dataclasses.dataclass(frozen=True)
class EnhancementPreset:
    """One preset of enhancement_presets.json (contrast-stretch / histogram
    modification parameters)."""
    name: str
    group: str
    contrast_alpha: float = 1.0
    hist_method: str = "none"            # none | equalization | clahe
    hist_channel: str = "luminance"
    clahe_clip: float = 2.0
    clahe_tiles: Tuple[int, int] = (8, 8)
    sky_protection_power: float = 0.0
    sky_protection_threshold: float = 0.0
    blend_strength: float = 1.0
    invert: bool = False


def load_categorization_presets(path: Optional[str] = None) -> Dict[str, CategorizationPreset]:
    """Parse categorization_presets.json -> {"Group/Name": preset}."""
    with open(path or _find("categorization_presets.json")) as fh:
        raw = json.load(fh)
    out: Dict[str, CategorizationPreset] = {}
    for group, presets in raw.items():
        for name, p in presets.items():
            kw = dict(name=name, group=group)
            b = p.get("brightness", {})
            if "beta" in b:
                kw.update(brightness_mode="linear", brightness_beta=float(b["beta"]))
            elif "gamma" in b:
                kw.update(brightness_mode="gamma", brightness_gamma=float(b["gamma"]))
            c = p.get("contrast") or p.get("contrast_method") or {}
            if c.get("mode") == "clahe" or "clip_limit" in c:
                kw.update(contrast_mode="clahe", clahe_clip=float(c.get("clip_limit", 2.0)),
                          clahe_tiles=tuple(c.get("tile_grid", (8, 8))))
            elif "alpha" in c:
                kw.update(contrast_mode="alpha", contrast_alpha=float(c["alpha"]))
            s = p.get("saturation", {})
            if s and s.get("enabled", True):
                kw.update(saturation_mult=float(s.get("multiplier", 1.0)),
                          saturation_cap=float(s.get("cap", 1.0)))
            wb = p.get("white_balance", {})
            if wb.get("gray_world"):
                kw.update(gray_world=True,
                          gain_clamp=tuple(wb.get("gain_clamp", (0.9, 1.1))))
            cb = p.get("chroma_boost", {})
            if cb:
                kw.update(chroma_boost_cb=float(cb.get("Cb", 1.0)),
                          chroma_boost_cr=float(cb.get("Cr", 1.0)))
            hc = p.get("highlight_compression", {})
            if hc:
                kw.update(highlight_compression=hc.get("mode", "none"))
            lc = p.get("local_contrast", {})
            if lc.get("enabled"):
                kw.update(local_contrast=True, lc_radius=float(lc.get("radius", 2)),
                          lc_amount=float(lc.get("amount", 0.5)),
                          lc_threshold=float(lc.get("threshold", 0)))
            lb = p.get("linear_boost", {})
            if lb:
                kw.update(linear_boost_beta=float(lb.get("beta", 0)))
            if p.get("invert"):
                kw.update(invert=True)
            enh = p.get("enhancement", {})
            if enh:  # Document presets nest their params under "enhancement"
                if "gamma" in enh:
                    kw.update(brightness_mode="gamma",
                              brightness_gamma=float(enh["gamma"]))
                if "clahe_clip_limit" in enh:
                    kw.update(contrast_mode="clahe",
                              clahe_clip=float(enh["clahe_clip_limit"]),
                              clahe_tiles=tuple(enh.get("clahe_tile_grid", (8, 8))))
                cb2 = enh.get("chroma_boost")
                if isinstance(cb2, dict):
                    kw.update(chroma_boost_cb=float(cb2.get("Cb", 1.0)),
                              chroma_boost_cr=float(cb2.get("Cr", 1.0)))
                elif cb2 is not None:
                    # Document presets use a scalar strength (2..10):
                    # interpret as a symmetric Cb/Cr gain of 1 + s/10
                    g2 = 1.0 + float(cb2) / 10.0
                    kw.update(chroma_boost_cb=g2, chroma_boost_cr=g2)
                if "highlight_compression" in enh:
                    hc2 = enh["highlight_compression"]
                    kw.update(highlight_compression=hc2.get("mode", "none")
                              if isinstance(hc2, dict) else str(hc2))
                if "color_space" in enh:
                    kw.update(color_space=enh["color_space"])
            if "description" in p:
                kw.update(description=p["description"])
            out[f"{group}/{name}"] = CategorizationPreset(**kw)
    return out


def load_enhancement_presets(path: Optional[str] = None) -> Dict[str, EnhancementPreset]:
    """Parse enhancement_presets.json -> {"Group/Name": preset}."""
    with open(path or _find("enhancement_presets.json")) as fh:
        raw = json.load(fh)
    out: Dict[str, EnhancementPreset] = {}
    for group, presets in raw.items():
        for name, p in presets.items():
            kw = dict(name=name, group=group)
            cs = p.get("contrast_stretch", {})
            if cs:
                kw.update(contrast_alpha=float(cs.get("alpha", 1.0)))
            hm = p.get("histogram_modification", {})
            if hm:
                kw.update(hist_method=hm.get("method", "none"),
                          hist_channel=hm.get("channel", "luminance"),
                          clahe_clip=float(hm.get("clip_limit", 2.0)))
            cl = p.get("clahe", {})
            if cl:
                kw.update(hist_method="clahe", clahe_clip=float(cl.get("clip_limit", 2.0)),
                          clahe_tiles=tuple(cl.get("tile_grid_size", (8, 8))))
            sp = p.get("sky_protection", {})
            if sp:
                kw.update(sky_protection_power=float(sp.get("power", 0)),
                          sky_protection_threshold=float(sp.get("threshold", 0)))
            if "blend_strength" in p:
                kw.update(blend_strength=float(p["blend_strength"]))
            if p.get("invert"):
                kw.update(invert=True)
            out[f"{group}/{name}"] = EnhancementPreset(**kw)
    return out
