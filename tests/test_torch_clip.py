"""CLIP on tpuimage_torch (Pillow's bicubic resize, the eval transform, the
towers, the zero-shot classifier, the tokenizer and the weight
converter) against tpuimage (JAX and Flax on the CPU), on seeded inputs
and seeded random weights (``synth.clip_state_dict``: ViT-B/32's real
shapes; the real laion2b weights are not in the repository).

Tolerances, each stated where it is checked:
- ``pil_resize_bicubic`` and ``preprocess_crop_u8``: exact, against
  tpuimage and against Pillow;
- ``preprocess_batch``: within 1e-6 (float32 rounding of the divisions);
- the towers: within 2e-4 absolute, tpuimage's own bound against its
  float64 oracle (``tests/test_clip_numerics.py``);
- ``ClipZeroShot`` probabilities: within 1e-5 absolute, the argmax equal;
- the tokenizer and the converter: exact.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tpuimage.classify import clip as JC
from tpuimage.classify.tokenizer import SimpleTokenizer as JTokenizer
from tpuimage.ops.pil_resize import pil_resize_bicubic as jresize

from tpuimage_torch import convert, synth
from tpuimage_torch.classify import clip as C
from tpuimage_torch.classify.tokenizer import SimpleTokenizer
from tpuimage_torch.ops.pil_resize import pil_resize_bicubic

# one intra-op thread: pytest-xdist runs several workers side by side
torch.set_num_threads(1)

TOWER_ATOL = 2e-4
PROBS_ATOL = 1e-5

# upscale, downscale, identity, odd and prime, extreme aspect, a page, and
# near-224 odd margins (the banker's rounding of the crop)
SHAPES = [(480, 640), (640, 480), (224, 224), (211, 173), (100, 300), (1200, 849),
          (97, 97), (225, 227)]


def _rgb(shape, seed=0):
    return np.random.default_rng(seed + shape[0] * shape[1]).integers(
        0, 256, shape + (3,), dtype=np.uint8)


@pytest.fixture(scope="module")
def state_dict():
    return synth.clip_state_dict(7)


# ---------------------------------------------------------------------------
# Pillow's resize and the eval transform
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_pil_resize_matches(shape):
    img = _rgb(shape)
    try:
        from PIL import Image
    except ImportError:
        Image = None
    for th, tw in [(224, 224), (224, 301), (150, 224), shape]:
        ours = pil_resize_bicubic(torch.from_numpy(img), th, tw).numpy()
        np.testing.assert_array_equal(ours, np.asarray(jresize(jnp.asarray(img), th, tw)))
        if Image is not None:
            np.testing.assert_array_equal(
                ours, np.asarray(Image.fromarray(img).resize((tw, th), Image.BICUBIC)))
    # a batch resizes image by image
    two = np.stack([img, img[::-1]])
    out = pil_resize_bicubic(torch.from_numpy(two), 150, 224).numpy()
    np.testing.assert_array_equal(out[1], pil_resize_bicubic(torch.from_numpy(two[1]),
                                                             150, 224).numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_preprocess_crop_u8_exact(shape):
    img = _rgb(shape, 1)
    ours = C.preprocess_crop_u8(torch.from_numpy(img)).numpy()
    assert ours.shape == (224, 224, 3)
    np.testing.assert_array_equal(ours, np.asarray(JC.preprocess_crop_u8(jnp.asarray(img))))


def test_preprocess_batch_matches():
    imgs = np.stack([_rgb((480, 640), i) for i in range(3)])
    ours = C.preprocess_batch(torch.from_numpy(imgs))
    assert ours.dtype == torch.float32 and ours.shape == (3, 224, 224, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(JC.preprocess_batch(jnp.asarray(imgs))),
                               rtol=0, atol=1e-6)
    one = C.preprocess_batch(torch.from_numpy(imgs[1]))
    assert one.shape == (1, 224, 224, 3) and torch.equal(one[0], ours[1])


# ---------------------------------------------------------------------------
# the towers
# ---------------------------------------------------------------------------

def _jitter(tree, seed):
    """Flax's init leaves LayerNorm at scale 1, bias 0 and Dense biases at
    0: move every leaf, so a swapped or misread parameter shows."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(
        np.float32) * 0.05, tree)


def _tokens(n, vocab, ctx=77, seed=0):
    """(n, ctx) ids: start-of-text, a few words, end-of-text (the highest
    id) at a different place in each row, zero padding."""
    rng = np.random.default_rng(seed)
    t = np.zeros((n, ctx), np.int32)
    for i in range(n):
        k = 2 + 5 * i
        t[i, 0] = vocab - 2
        t[i, 1:k] = rng.integers(1, vocab - 2, k - 1)
        t[i, k] = vocab - 1
    return t


@pytest.mark.parametrize("quick_gelu", [False, True], ids=["exact_gelu", "quick_gelu"])
def test_narrow_towers_match_flax(quick_gelu):
    """Width 64, 2 layers, 4 heads, both towers, weights carried across by
    convert.clip_params_from_tpuimage from a Flax init."""
    jv = JC.VisionTower(width=64, layers=2, heads=4, out_dim=32, quick_gelu=quick_gelu)
    jt = JC.TextTower(vocab=1000, width=64, layers=2, heads=4, out_dim=32,
                      quick_gelu=quick_gelu)
    pixels = np.random.default_rng(1).standard_normal((2, 224, 224, 3)).astype(np.float32)
    tokens = _tokens(3, 1000)
    pv = _jitter(jv.init(jax.random.PRNGKey(0), jnp.asarray(pixels))["params"], 1)
    pt = _jitter(jt.init(jax.random.PRNGKey(1), jnp.asarray(tokens))["params"], 2)
    sd = convert.clip_params_from_tpuimage({"vision": pv, "text": pt})
    vision = C.load_tower(C.VisionTower(width=64, layers=2, heads=4, out_dim=32,
                                        quick_gelu=quick_gelu), sd, "visual.")
    text = C.load_tower(C.TextTower(vocab=1000, width=64, layers=2, heads=4, out_dim=32,
                                    quick_gelu=quick_gelu), sd)
    with torch.no_grad():
        ov = vision(torch.from_numpy(pixels)).numpy()
        ot = text(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(ov, np.asarray(jv.apply({"params": pv}, jnp.asarray(pixels))),
                               rtol=0, atol=TOWER_ATOL)
    np.testing.assert_allclose(ot, np.asarray(jt.apply({"params": pt}, jnp.asarray(tokens))),
                               rtol=0, atol=TOWER_ATOL)


def test_full_width_vision_tower_matches_flax(state_dict):
    """768 wide, 12 heads, patch 32, out 512, 2 layers, on the open_clip
    layout both packages read."""
    params = JC.convert_openclip_state_dict(state_dict)
    pixels = np.random.default_rng(2).standard_normal((2, 224, 224, 3)).astype(np.float32)
    ref = np.asarray(JC.VisionTower(layers=2).apply({"params": params["vision"]},
                                                     jnp.asarray(pixels)))
    tower = C.load_tower(C.VisionTower(layers=2), state_dict, "visual.")
    with torch.no_grad():
        ours = tower(torch.from_numpy(pixels)).numpy()
    assert ours.shape == (2, 512)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOWER_ATOL)


def test_converter_inverts_tpuimage_s(state_dict):
    """clip_params_from_tpuimage(convert_openclip_state_dict(sd)) == sd."""
    back = convert.clip_params_from_tpuimage(JC.convert_openclip_state_dict(state_dict))
    assert set(back) == set(state_dict)
    for k, v in state_dict.items():
        assert back[k].flags.c_contiguous and np.array_equal(back[k], v), k


# ---------------------------------------------------------------------------
# the zero-shot classifier and the tokenizer
# ---------------------------------------------------------------------------

def test_tokenizer_matches():
    merges = synth.prompt_merges()
    ours, ref = SimpleTokenizer(merges=merges), JTokenizer(merges=merges)
    texts = [C.PROMPTS[label] for label in C.LABELS] + [
        "Zq café — ünïcode &amp; 42 cats!", "lake " * 60]
    np.testing.assert_array_equal(ours.tokenize(texts), ref.tokenize(texts))
    assert ours.encode("zq") == ref.encode("zq")
    with pytest.raises(ValueError):
        SimpleTokenizer()


@pytest.fixture(scope="module")
def text_features(state_dict):
    tokens = SimpleTokenizer(merges=synth.prompt_merges()).tokenize(
        [C.PROMPTS[label] for label in C.LABELS])
    ours = C.compute_text_features(state_dict, tokens, device="cpu")
    ref = JC.compute_text_features(JC.convert_openclip_state_dict(state_dict), tokens)
    return ours, ref


def test_text_features_match(text_features):
    ours, ref = text_features
    assert ours.shape == (4, 512) and ours.device.type == "cpu"
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=TOWER_ATOL)


def test_zero_shot_matches(state_dict, text_features, tmp_path):
    """ClipZeroShot at ViT-B/32's full shapes, and the same model from an
    .npz checkpoint the test writes (open_clip's arrays and the text
    features), against tpuimage's ClipZeroShot."""
    ours_tf, ref_tf = text_features
    imgs = np.stack([img for _, img in synth.scene_mix(0, 240, 320)[:2]])
    ref = JC.ClipZeroShot(JC.convert_openclip_state_dict(state_dict), ref_tf).predict_batch(imgs)
    model = C.ClipZeroShot(state_dict, ours_tf.numpy(), device="cpu")
    ours = model.predict_batch(imgs)
    assert ours.shape == (2, 4) and ours.device.type == "cpu"
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=PROBS_ATOL)
    assert (ours.numpy().argmax(-1) == ref.argmax(-1)).all()
    label, probs = model.predict_array(imgs[1])
    assert label == C.LABELS[int(ref[1].argmax())] and list(probs) == C.LABELS
    np.testing.assert_allclose(list(probs.values()), ref[1], rtol=0, atol=PROBS_ATOL)

    path = tmp_path / "clip.npz"
    np.savez(path, __text_features__=ours_tf.numpy(),
             **{k: v for k, v in state_dict.items() if k.startswith("visual.")})
    loaded = C.load_from_checkpoint(str(path), device="cpu")
    assert loaded.logit_scale == 100.0 and not loaded.vision.transformer.resblocks[0].mlp.quick_gelu
    assert torch.equal(loaded.predict_batch(imgs), ours)
    with pytest.raises(ValueError, match="text_features"):
        C.ClipZeroShot(state_dict, None, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        C.ClipZeroShot(state_dict, ours_tf.numpy())
