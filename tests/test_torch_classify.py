"""Classify and route on tpuimage_torch (the heuristic cue program, the
classifiers and the label router) against tpuimage (JAX on the CPU), on
seeded inputs (``tpuimage_torch.synth``).

Tolerances, each stated where it is checked:
- the cue program against tpuimage's jitted ``_device_cues`` and
  ``_device_cues_batch``: gray, Otsu binary, line count and overflow
  equal, the white ratio equal as float32 (tpuimage's mean under jit is
  the count times the f32 reciprocal of the pixel count);
- ``hough_line_count`` equal, counts and overflow;
- both classifiers and both batch forms: labels equal, probabilities
  equal as floats (``==``);
- the routes, each within its pipeline's contract: night_rgb max |diff|
  <= 3 on < 0.1% of values (``tests/test_torch_night.py``), landscape_gui
  and the face GUI tail PATH_TOL (max 4, any < 1.5%, > 1 < 0.5%;
  ``tests/test_torch_landscape.py``, ``tests/test_torch_face.py``), the
  document route's binary page different on < 0.2% of pixels
  (``tests/test_torch_process.py``).
"""
import dataclasses
import importlib
import os
import types
import warnings

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tpuimage.classify import heuristic as jheur
from tpuimage.classify import router as jrouter
from tpuimage.ops import color as jcolor
from tpuimage.ops.edges import canny as jcanny
from tpuimage.ops.hough import hough_line_count as jhough_line_count
from tpuimage.pipelines import docscan as jdoc

import tpuimage.classify as jclassify
import tpuimage_torch.classify as tclassify
from tpuimage_torch import synth
from tpuimage_torch.classify import heuristic, router
from tpuimage_torch.detect import haar
from tpuimage_torch.ops import color
from tpuimage_torch.ops.edges import canny
from tpuimage_torch.ops.hough import hough_line_count
from tpuimage_torch.pipelines import docscan

# one intra-op thread: pytest-xdist runs several workers side by side
torch.set_num_threads(1)

PATH_TOL = (4, 0.015, 0.005)     # max |diff|, share > 0, share > 1
NIGHT_TOL = (3, 0.001)           # max |diff|, share > 0
BINARY_TOL = 0.002               # share of binary pixels that may differ


def _grid(h=200, w=300):
    """A light page ruled with 60 dark lines: > 50 Hough lines, white
    ratio > 0.5, so the document rule fires on its line count."""
    g = np.full((h, w, 3), 230, np.uint8)
    g[10:h - 10:3, 10:w - 10] = 20
    return g


MIX = synth.scene_mix(0, 200, 300)
CUE_INPUTS = {
    **{f"{kind}_{i}": img for i, (kind, img) in enumerate(MIX[:4])},
    # budget from the 128 * h term: 1600 * 100 * 9 / 16 < 128 * 1600
    "tall_narrow": synth.document_photo(4, 1600, 100),
    "night_213x320": synth.night_scene(2, 213, 320),
    "random_128": np.random.default_rng(3).integers(0, 256, (128, 128, 3), dtype=np.uint8),
    "ruled_grid": _grid(),
}


def _t(a):
    return torch.from_numpy(np.array(a))     # a writable, contiguous copy


def _assert_cues_equal(ours, ref):
    """ours: (white_ratio, line_count, binary, overflow, gray) of one image;
    ref: tpuimage's (white_ratio, line_count, brightness, binary, overflow,
    gray)."""
    wr, lc, binary, ovf, gray = ours
    assert np.float32(wr) == np.float32(np.asarray(ref[0])), (wr, ref[0])
    assert int(lc) == int(ref[1])
    np.testing.assert_array_equal(binary, np.asarray(ref[3]))
    assert bool(ovf) == bool(ref[4])
    np.testing.assert_array_equal(gray, np.asarray(ref[5]))


def test_cue_budget_terms():
    assert heuristic.cue_budget(200, 300) == 200 * 300 * 9 // 16
    assert heuristic.cue_budget(1600, 100) == 128 * 1600
    assert heuristic.cue_budget(2000, 1500) == 524288


@pytest.mark.parametrize("name", list(CUE_INPUTS))
def test_device_cues_match_jitted(name):
    img = CUE_INPUTS[name]
    ours = [v[0].numpy() for v in heuristic.device_cues(_t(img)[None])]
    _assert_cues_equal(ours, jheur._device_cues(jnp.asarray(img)))
    # a gray stack is taken as gray
    g = np.asarray(jcolor.rgb_to_gray(jnp.asarray(img)))
    ours_g = [v[0].numpy() for v in heuristic.device_cues(_t(g)[None])]
    _assert_cues_equal(ours_g, jheur._device_cues(jnp.asarray(g)))


@pytest.mark.parametrize("group", ["landscape_shape", "portrait_shape"])
def test_device_cues_batch_match_jitted(group):
    imgs = [img for _, img in MIX if (img.shape[0] < img.shape[1]) == (group == "landscape_shape")]
    stack = np.stack(imgs)
    ref = jheur._device_cues_batch(
        jnp.asarray(stack), canny_impl=jheur.CUE_SCHEDULE["canny"],
        theta_pack=jheur.CUE_SCHEDULE["theta_pack"], unroll=jheur.CUE_SCHEDULE["unroll"],
        vote_lo=jheur.CUE_SCHEDULE["vote_lo"])
    ours = [v.numpy() for v in heuristic.device_cues(_t(stack))]
    for j in range(len(imgs)):
        _assert_cues_equal([v[j] for v in ours], [np.asarray(r)[j] for r in ref])


@pytest.mark.parametrize("max_lines", [64, 256])
@pytest.mark.parametrize("max_edges", [0, 500])
@pytest.mark.parametrize("name", ["ruled_grid", "tall_narrow", "random_128"])
def test_hough_line_count_matches(name, max_lines, max_edges):
    """Default and tight edge budgets (500 overflows all three)."""
    gray = np.asarray(jcolor.rgb_to_gray(jnp.asarray(CUE_INPUTS[name])))
    ref_n, ref_ovf = jhough_line_count(jcanny(jnp.asarray(gray), 50, 150), threshold=150,
                                       max_lines=max_lines, max_edges=max_edges,
                                       return_overflow=True)
    n, ovf = hough_line_count(canny(_t(gray)[None], 50, 150), threshold=150,
                              max_lines=max_lines, max_edges=max_edges, return_overflow=True)
    assert n.dtype == torch.int32 and n.shape == (1,)
    assert int(n[0]) == int(ref_n) and bool(ovf[0]) == bool(ref_ovf)
    assert bool(ovf[0]) == (max_edges == 500)


CLASSIFY_INPUTS = [img for _, img in MIX] + [CUE_INPUTS["ruled_grid"],
                                             CUE_INPUTS["random_128"]]


def test_classifiers_match_tpuimage():
    """Per image and batched, labels and probabilities equal to
    tpuimage's; the batch forms equal the per-image forms. The inputs
    reach every label: the face_photo of the mix is found by the face
    cascade, the document photos and the ruled grid score as documents."""
    ours_w = heuristic.classify_weighted_batch(CLASSIFY_INPUTS, device="cpu")
    ours_p = heuristic.classify_priority_batch(CLASSIFY_INPUTS, device="cpu")
    assert ours_w == jheur.classify_weighted_batch(CLASSIFY_INPUTS)
    assert ours_p == jheur.classify_priority_batch(CLASSIFY_INPUTS)
    for img, w, p in zip(CLASSIFY_INPUTS, ours_w, ours_p):
        assert heuristic.classify_weighted(img, device="cpu") == w == jheur.classify_weighted(img)
        assert heuristic.classify_priority(img, device="cpu") == p == jheur.classify_priority(img)
    assert {label for label, _ in ours_w} == set(heuristic.LABELS)
    assert set(ours_p) == set(heuristic.LABELS)


def test_document_cues_and_large_rect():
    """document_cues equal to tpuimage's; the rectangle cue finds the
    page of a document photo in both packages, and none in a night scene."""
    photo = synth.document_photo(21, 400, 300)
    for img, rect in ((photo, True), (CUE_INPUTS["night_213x320"], False)):
        ours = heuristic.document_cues(img, device="cpu")
        assert ours == jheur.document_cues(img)
        assert ours[2] is rect
    binary = heuristic.device_cues(_t(photo)[None])[2][0].numpy()
    assert heuristic._large_rect(binary) is jheur._large_rect(binary) is True


def test_face_found_skips_the_cue_program(monkeypatch):
    """classify_priority returns "face" without running the cue program
    when the face cascade finds a face."""
    face = MIX[2][1]
    assert len(haar.detect_faces(color.rgb_to_gray(_t(face)).numpy())) > 0

    def no_cues(*args, **kwargs):
        raise AssertionError("the cue program ran")

    monkeypatch.setattr(heuristic, "device_cues", no_cues)
    assert heuristic.classify_priority(face, device="cpu") == "face" == \
        jheur.classify_priority(face)


def test_overflow_warns(monkeypatch):
    """An edge budget the image's edges overflow warns, in every form."""
    monkeypatch.setattr(heuristic, "cue_budget", lambda h, w: 64)
    img = CUE_INPUTS["ruled_grid"]
    for call in (lambda: heuristic.document_cues(img, device="cpu"),
                 lambda: heuristic.classify_weighted(img, device="cpu"),
                 lambda: heuristic.classify_priority(img, device="cpu"),
                 lambda: heuristic.classify_weighted_batch([img, img], device="cpu"),
                 lambda: heuristic.classify_priority_batch([img], device="cpu")):
        with pytest.warns(RuntimeWarning, match="edge budget overflowed"):
            call()
    monkeypatch.undo()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        heuristic.classify_weighted_batch([img], device="cpu")


def test_entry_points_run_on_the_card_unless_asked():
    img = CUE_INPUTS["random_128"]
    for call in (heuristic.classify_weighted, heuristic.classify_priority,
                 heuristic.document_cues, lambda x: router.enhance_for_label("landscape", x),
                 router.classify_and_enhance):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(img)
    # a CPU tensor runs where it is
    assert heuristic.classify_weighted(_t(img)) == heuristic.classify_weighted(img, device="cpu")
    with pytest.raises(ValueError, match="unknown label"):
        router.enhance_for_label("portrait", img, device="cpu")


def test_public_names():
    """Every public name of tpuimage.classify and its four modules but the
    TPU schedule knobs and the Flax converter."""
    exports = {"LABELS", "classify_priority", "classify_weighted", "document_cues",
               "enhance_for_label", "classify_and_enhance"}
    assert exports <= set(vars(jclassify)) and exports <= set(vars(tclassify))
    for mod in ("heuristic", "router", "clip", "tokenizer"):
        j = importlib.import_module(f"tpuimage.classify.{mod}")
        t = importlib.import_module(f"tpuimage_torch.classify.{mod}")
        public = {n for n, v in vars(j).items() if not n.startswith("_")
                  and not isinstance(v, types.ModuleType)
                  and getattr(v, "__module__", j.__name__) == j.__name__}
        public -= {"CUE_SCHEDULE", "convert_openclip_state_dict"}
        assert public <= set(vars(t)), (mod, sorted(public - set(vars(t))))


def test_gray_to_rgb_matches():
    g = np.random.default_rng(0).integers(0, 256, (2, 5, 7), dtype=np.uint8)
    np.testing.assert_array_equal(color.gray_to_rgb(_t(g)).numpy(),
                                  np.asarray(jcolor.gray_to_rgb(jnp.asarray(g))))


def test_find_cascade_in_package_data(monkeypatch):
    """With the system's OpenCV directory hidden, both cascades the port
    uses come from the package's data/ and load."""
    data = os.path.join(os.path.dirname(haar.__file__), "data")
    monkeypatch.setattr(haar, "_CASCADE_SEARCH_PATHS", ["/nonexistent/haarcascades", data])
    for name in ("haarcascade_eye.xml", "haarcascade_frontalface_default.xml"):
        path = haar.find_cascade(name)
        assert path == os.path.join(data, name)
        assert haar.HaarCascade(path).win_w > 0
    with pytest.raises(FileNotFoundError):
        haar.find_cascade("haarcascade_missing.xml")


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

def _diff(a, b):
    return np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))


def _assert_route_within(label, ours, ref):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype == np.uint8
    d = _diff(ours, ref)
    if label == "document":
        assert (d > 0).mean() < BINARY_TOL
        assert (ours[..., 0] == ours[..., 1]).all() and (ours[..., 1] == ours[..., 2]).all()
    elif label == "nightscape":
        assert d.max() <= NIGHT_TOL[0] and (d > 0).mean() < NIGHT_TOL[1]
    else:
        assert d.max() <= PATH_TOL[0] and (d > 0).mean() < PATH_TOL[1]
        assert (d > 1).mean() < PATH_TOL[2]


@pytest.fixture()
def small_document_pages(monkeypatch):
    """The GUI's document config with its pages warped to 400 px on the long
    side in both packages (1200 at the GUI's own), to keep the CPU run short."""
    monkeypatch.setattr(docscan, "GUI_DOCUMENT_CONFIG",
                        dataclasses.replace(docscan.GUI_DOCUMENT_CONFIG, scale_long=400))
    monkeypatch.setattr(jdoc, "GUI_DOCUMENT_CONFIG",
                        dataclasses.replace(jdoc.GUI_DOCUMENT_CONFIG, scale_long=400))


ROUTE_INPUTS = {"nightscape": lambda: synth.night_scene(3, 96, 128),
                "landscape": lambda: synth.landscape_scene(11, 48, 64),
                "face": lambda: synth.portrait(4, 160, 120)[0],
                "document": lambda: synth.document_photo(61, 480, 360)}


@pytest.mark.parametrize("label", list(ROUTE_INPUTS))
def test_enhance_for_label_matches(label, small_document_pages):
    img = ROUTE_INPUTS[label]()
    ours = router.enhance_for_label(label, img, device="cpu")
    assert ours.device.type == "cpu"
    _assert_route_within(label, ours, jrouter.enhance_for_label(label, img))


@pytest.mark.parametrize("classifier", ["weighted", "priority"])
def test_classify_and_enhance_matches(classifier, small_document_pages):
    """The whole GUI flow on a night scene and on the mix's face photo
    (found by the cascade, so the face route runs)."""
    for img, want in ((ROUTE_INPUTS["nightscape"](), "nightscape"), (MIX[2][1], "face")):
        label, probs, out = router.classify_and_enhance(img, classifier=classifier,
                                                        device="cpu")
        ref_label, ref_probs, ref_out = jrouter.classify_and_enhance(img, classifier=classifier)
        assert label == ref_label == want and probs == ref_probs
        _assert_route_within(label, out, ref_out)
