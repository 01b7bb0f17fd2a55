"""CLIP ViT-B/32 zero-shot scene classifier as torch modules (counterpart of
``tpuimage.classify.clip``).

The reference GUI classifies a photo with open_clip's ViT-B-32
(laion2b_s34b_b79k): the softmax of 100 x the cosine of the image's
embedding with each of four fixed prompts' embeddings. The modules here
take open_clip's torch state-dict layout directly (``visual.conv1.weight``,
``visual.transformer.resblocks.{i}.attn.in_proj_weight``, ...; the layout
tpuimage's ``convert_openclip_state_dict`` reads), so a converted ``.npz``
loads into either package. ``tpuimage_torch.convert.clip_params_from_tpuimage``
carries tpuimage's Flax parameters across.

Numerics follow tpuimage's towers: LayerNorm eps 1e-5, exact (erf) GELU
or quick GELU, q / k / v split by rows of ``in_proj``, scores divided by
sqrt(head width), the causal ``-1e9`` mask, end-of-text pooling at the
highest token id. The 32x32 stride-32 patch embedding is a reshape to
patches and one product (the same function as the convolution, and no
cuDNN TF32 flag applies to it). The products run in float32 through
``torch.matmul``: tpuimage computes attention and the MLP as plain XLA
products, and no Pallas kernel, so no kernel of the port stands behind
them.

Preprocessing is open_clip's eval transform, the uint8 stage bit-exact:
torchvision ``Resize(224, BICUBIC)`` (Pillow's resample,
``ops.pil_resize``), ``CenterCrop(224)``, then ToTensor and Normalize in
float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpuimage_torch.core.device import as_input, resolve_device
from tpuimage_torch.ops.pil_resize import pil_resize_bicubic

LABELS = ["nightscape", "landscape", "document", "face"]
# the reference GUI's prompts, one a label
PROMPTS = {
    "nightscape": "a night cityscape photograph with bright lights and dark sky and road",
    "landscape": "lake",
    "document": "a scanned paper document page with text on a white background",
    "face": "a human face portrait photograph",
}

# OpenAI CLIP's normalisation constants (open_clip's ViT-B-32 transform)
_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
_LN_EPS = 1e-5        # torch nn.LayerNorm's default, which CLIP trains with
_IMAGE = 224


class _MHA(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, d = x.shape
        hd = d // self.heads
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).split(d, dim=-1)
        q, k, v = (t.reshape(b, n, self.heads, hd).transpose(1, 2) for t in (q, k, v))
        att = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        if mask is not None:
            att = att + mask
        out = torch.matmul(torch.softmax(att, dim=-1), v)
        return self.out_proj(out.transpose(1, 2).reshape(b, n, d))


class _MLP(nn.Module):
    def __init__(self, width: int, quick_gelu: bool):
        super().__init__()
        self.quick_gelu = quick_gelu
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.c_fc(x)
        # OpenAI-pretrained checkpoints train with quick GELU, laion2b with exact GELU
        h = h * torch.sigmoid(1.702 * h) if self.quick_gelu else F.gelu(h)
        return self.c_proj(h)


class _Block(nn.Module):
    def __init__(self, width: int, heads: int, quick_gelu: bool = False):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=_LN_EPS)
        self.attn = _MHA(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=_LN_EPS)
        self.mlp = _MLP(width, quick_gelu)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, quick_gelu: bool):
        super().__init__()
        self.resblocks = nn.ModuleList(_Block(width, heads, quick_gelu) for _ in range(layers))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x, mask)
        return x


class _PatchEmbed(nn.Module):
    """The (width, 3, patch, patch) weight of open_clip's ``conv1``."""

    def __init__(self, width: int, patch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(width, 3, patch, patch))


class VisionTower(nn.Module):
    """ViT-B/32 image encoder: (B, 224, 224, 3) normalised -> (B, out_dim)."""

    def __init__(self, width: int = 768, layers: int = 12, heads: int = 12, patch: int = 32,
                 out_dim: int = 512, quick_gelu: bool = False):
        super().__init__()
        self.patch = patch
        grid = _IMAGE // patch
        self.conv1 = _PatchEmbed(width, patch)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(torch.zeros(grid * grid + 1, width))
        self.ln_pre = nn.LayerNorm(width, eps=_LN_EPS)
        self.transformer = _Transformer(width, layers, heads, quick_gelu)
        self.ln_post = nn.LayerNorm(width, eps=_LN_EPS)
        self.proj = nn.Parameter(torch.zeros(width, out_dim))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        b, h, w, c = pixels.shape
        p = self.patch
        # patches in row-major order over the grid, each flattened (ky, kx, channel)
        x = pixels.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (h // p) * (w // p), p * p * c)
        kernel = self.conv1.weight.permute(0, 2, 3, 1).reshape(self.conv1.weight.shape[0], -1)
        x = torch.matmul(x, kernel.t())
        cls = self.class_embedding.expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.transformer(self.ln_pre(x))
        return torch.matmul(self.ln_post(x[:, 0]), self.proj)


class TextTower(nn.Module):
    """CLIP text encoder: (B, ctx) BPE token ids -> (B, out_dim)."""

    def __init__(self, vocab: int = 49408, ctx: int = 77, width: int = 512, layers: int = 12,
                 heads: int = 8, out_dim: int = 512, quick_gelu: bool = False):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab, width)
        self.positional_embedding = nn.Parameter(torch.zeros(ctx, width))
        self.transformer = _Transformer(width, layers, heads, quick_gelu)
        self.ln_final = nn.LayerNorm(width, eps=_LN_EPS)
        self.text_projection = nn.Parameter(torch.zeros(width, out_dim))
        self.register_buffer("mask", torch.triu(torch.full((ctx, ctx), -1e9), diagonal=1),
                             persistent=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding(tokens) + self.positional_embedding
        x = self.ln_final(self.transformer(x, self.mask))
        eot = torch.argmax(tokens, dim=-1)          # the highest id is end-of-text
        return torch.matmul(x[torch.arange(x.shape[0], device=x.device), eot],
                            self.text_projection)


def load_tower(tower: nn.Module, state_dict, prefix: str = "") -> nn.Module:
    """Copy the tower's tensors from an open_clip-layout state dict (numpy
    arrays or tensors; keys the tower does not hold are ignored, a key it
    holds that is missing raises KeyError) and set it to eval mode."""
    tower.load_state_dict({k: torch.as_tensor(np.asarray(state_dict[prefix + k]))
                           for k in tower.state_dict()})
    return tower.eval()


def _resize_output_size(h: int, w: int, short: int = _IMAGE) -> Tuple[int, int]:
    """torchvision ``Resize(int)`` geometry: the short side to ``short``, the
    long side to int(short * long / short_in), truncated."""
    if w <= h:
        return int(short * h / w), short
    return short, int(short * w / h)


def _center_crop_origin(size: int, crop: int) -> int:
    """torchvision ``CenterCrop``'s offset int(round((size - crop) / 2.0)):
    Python 3's round half to even on odd margins."""
    return int(round((size - crop) / 2.0))


def preprocess_crop_u8(img: torch.Tensor) -> torch.Tensor:
    """Resize(224, BICUBIC) + CenterCrop(224) on a (..., H, W, 3) uint8
    tensor, bit-exact against Pillow and torchvision."""
    h, w = int(img.shape[-3]), int(img.shape[-2])
    nh, nw = _resize_output_size(h, w)
    out = pil_resize_bicubic(img, nh, nw)
    top, left = _center_crop_origin(nh, _IMAGE), _center_crop_origin(nw, _IMAGE)
    return out[..., top:top + _IMAGE, left:left + _IMAGE, :]


def preprocess_batch(rgb_batch: torch.Tensor) -> torch.Tensor:
    """open_clip's eval transform on a (B, H, W, 3) or (H, W, 3) uint8
    tensor -> (B, 224, 224, 3) float32: the crop, then ToTensor and
    Normalize."""
    x = preprocess_crop_u8(rgb_batch if rgb_batch.dim() == 4 else rgb_batch[None])
    mean = torch.from_numpy(_MEAN).to(x.device)
    std = torch.from_numpy(_STD).to(x.device)
    return (x.to(torch.float32) / 255.0 - mean) / std


class ClipZeroShot:
    """Zero-shot scene classifier over :data:`LABELS`: an open_clip-layout
    state dict (``visual.*`` read) and the four prompts' text features
    (normalised once here). Runs on ``device``, the card by default."""

    def __init__(self, state_dict, text_features, logit_scale: float = 100.0,
                 quick_gelu: bool = False, device=None):
        if text_features is None:
            raise ValueError("text_features required (precompute them with "
                             "compute_text_features, or ship them beside the checkpoint)")
        self.device = resolve_device(device)
        self.vision = load_tower(VisionTower(quick_gelu=quick_gelu), state_dict,
                                 "visual.").to(self.device)
        self.logit_scale = logit_scale
        tf = torch.as_tensor(np.asarray(text_features), dtype=torch.float32).to(self.device)
        self.text_features = tf / torch.linalg.vector_norm(tf, dim=-1, keepdim=True)

    @torch.inference_mode()
    def predict_batch(self, rgb_batch) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, 4) float32 probabilities over LABELS,
        on the model's device."""
        feats = self.vision(preprocess_batch(as_input(rgb_batch, self.device)))
        feats = feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
        return torch.softmax(self.logit_scale * torch.matmul(feats, self.text_features.t()),
                             dim=-1)

    def predict_array(self, rgb) -> Tuple[str, Dict[str, float]]:
        """One (H, W, 3) uint8 image -> (label, {label: probability})."""
        probs = self.predict_batch(as_input(rgb, self.device)[None])[0].cpu().numpy()
        return LABELS[int(np.argmax(probs))], {k: float(p) for k, p in zip(LABELS, probs)}


@torch.inference_mode()
def compute_text_features(state_dict, tokens, quick_gelu: bool = False,
                          device=None) -> torch.Tensor:
    """The text tower over tokenized prompts: (B, 77) ids -> (B, 512)
    float32 on ``device`` (the card by default), before normalisation.

    With real weights, ``tokens = SimpleTokenizer(bpe_path).tokenize([PROMPTS[l]
    for l in LABELS])``; the result is what a converted ``.npz`` stores
    under ``__text_features__``. The prompts are fixed, so this runs once
    a checkpoint, never per image."""
    dev = resolve_device(device)
    tower = load_tower(TextTower(quick_gelu=quick_gelu), state_dict).to(dev)
    return tower(torch.as_tensor(np.asarray(tokens), dtype=torch.int64).to(dev))


def load_from_checkpoint(path: str, device=None) -> ClipZeroShot:
    """A converted ``.npz`` checkpoint: open_clip's state-dict arrays, the
    four prompts' ``__text_features__`` (4, 512), and optionally
    ``__logit_scale__`` (default 100) and ``__quick_gelu__ = 1`` (OpenAI
    pretrained weights; laion2b's use exact GELU)."""
    with np.load(path) as f:
        data = dict(f)
    tf = data.pop("__text_features__")
    scale = float(data.pop("__logit_scale__", 100.0))
    quick = bool(data.pop("__quick_gelu__", np.asarray(0)))
    return ClipZeroShot(data, tf, logit_scale=scale, quick_gelu=quick, device=device)
