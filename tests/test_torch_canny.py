"""Canny's kernel wrappers on the CPU (``ops/kernels.py`` canny_pre and
hysteresis_check): on CPU tensors they return their plain versions'
results, and those equal the eager Canny the port ran before the kernels,
kept word for word in ``portbench/reference/ops/edges.py`` (the
benchmark's frozen reference), on the same inputs. ``edges.canny``,
``canny_batch``, ``canny_pre`` and ``_hysteresis`` keep their names,
signatures and results; ``canny.hysteresis_checks`` counts the checks.
The kernels themselves are held to the same plain versions on the card in
``tests/test_torch_cuda.py``."""
import functools

import numpy as np
import pytest
import torch

from portbench.reference.ops import edges as eager
from tpuimage_torch import synth
from tpuimage_torch.ops import color, edges, kernels
from tpuimage_torch.runtime import profiling

torch.set_num_threads(1)

THRESHOLDS = [(50, 150, False), (30, 100, False), (50, 150, True), (150, 50, False),
              (20.7, 99.5, True), (20.7, 99.5, False), (0.5, 1.2, True), (-3, 0, False)]
SHAPES = [(1, 1, 1), (2, 1, 70), (2, 70, 1), (1, 2, 2), (3, 3, 3), (2, 33, 65), (1, 49, 131)]


@functools.lru_cache(maxsize=None)
def _planes(kind, shape, seed):
    rng = np.random.default_rng(seed)
    b, h, w = shape
    if kind == "random":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if kind == "binary":
        return ((rng.random(shape) < 0.3) * 255).astype(np.uint8)
    make = synth.document_photo if kind == "photo" else synth.page
    rgb = np.stack([make(seed + i, h, w) for i in range(b)])
    return color.rgb_to_gray(torch.from_numpy(rgb)).numpy()


KINDS = [("random", (2, 57, 83)), ("binary", (2, 60, 85)), ("photo", (2, 108, 192)),
         ("page", (2, 120, 85))]


@pytest.mark.parametrize("kind,shape", KINDS)
@pytest.mark.parametrize("low,high,l2", THRESHOLDS)
def test_canny_pre_wrapper_on_cpu_is_the_eager_form(kind, shape, low, high, l2):
    """kernels.canny_pre on a CPU tensor = canny_pre_ref = the eager
    canny_pre from before the kernels; edges.canny_pre the same."""
    x = torch.from_numpy(_planes(kind, shape, shape[1]))
    want = eager.canny_pre(x, low, high, l2)
    for got in (kernels.canny_pre(x, low, high, l2), kernels.canny_pre_ref(x, low, high, l2),
                edges.canny_pre(x, low, high, l2)):
        for g, e in zip(got, want, strict=True):
            assert g.dtype == torch.bool and torch.equal(g, e)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("l2", [False, True])
def test_canny_pre_at_edge_shapes_is_the_eager_form(shape, l2):
    """One pixel, one row, one column, 2x2, 3x3 and planes off the tile
    sizes, with and without row_valid; a 2-D plane keeps its shape."""
    x = torch.from_numpy(_planes("random", shape, sum(shape)))
    for xx, lo, hi in ((x, 40, 120), (x // 32, 1, 3)):
        for g, e in zip(kernels.canny_pre(xx, lo, hi, l2), eager.canny_pre(xx, lo, hi, l2)):
            assert torch.equal(g, e)
        valid = np.random.default_rng(shape[1]).random(shape[1]) < 0.5
        for g, e in zip(edges.canny_pre(xx, lo, hi, l2, valid),
                        eager.canny_pre(xx, lo, hi, l2, valid)):
            assert torch.equal(g, e)
    for g, e in zip(edges.canny_pre(x[0], 40, 120, l2), eager.canny_pre(x[0], 40, 120, l2)):
        assert g.shape == x.shape[1:] and torch.equal(g, e)


def test_canny_pre_takes_other_dtypes_on_cpu():
    """On the CPU the plain version takes any real planes, as the eager
    form did (only a CUDA tensor must be uint8)."""
    x = _planes("random", (2, 40, 50), 3)
    for dtype in (torch.float32, torch.int32, torch.int16):
        t = torch.from_numpy(x).to(dtype)
        for g, e in zip(edges.canny_pre(t, 30, 90), eager.canny_pre(t, 30, 90)):
            assert torch.equal(g, e)


@pytest.mark.parametrize("case", [c[0] for c in synth.hysteresis_stress_maps()
                                  if c[0] != "spiral_across_tiles"])
def test_hysteresis_check_wrapper_on_cpu(case):
    """One check from bool and from 0/255 maps, both slots: the plain
    version's map as 0 / on, flags[slot] set exactly where the map changed
    and flags[1 - slot] zeroed; equal to the eager loop's 8 steps."""
    _, strong_np, weak_np = next(c for c in synth.hysteresis_stress_maps() if c[0] == case)
    strong, weak = torch.from_numpy(strong_np), torch.from_numpy(weak_np)
    want = strong
    for _ in range(eager._STEPS_PER_CHECK):
        want = want | (weak & eager.dilate8_bool(want))
    assert torch.equal(kernels.hysteresis_check_ref(strong, weak), want)
    changed = bool((want != strong).any())
    for slot, s_in, on in ((0, strong, 1), (1, strong.to(torch.uint8) * 255, 255)):
        flags = torch.tensor([7, 7], dtype=torch.int32)
        flags[slot] = 0
        out = kernels.hysteresis_check(s_in, weak, flags, slot, on)
        assert out.dtype == torch.uint8 and torch.equal(out, want.to(torch.uint8) * on)
        assert flags.tolist()[1 - slot] == 0 and flags.tolist()[slot] == int(changed)


@pytest.mark.parametrize("case", ["spiral", "band_seeded_at_a_corner", "dense_random",
                                  "one_row", "one_column", "two_by_two", "three_by_three"])
@pytest.mark.parametrize("checks", [0, 1, 2, 5, 10 ** 6])
def test_hysteresis_after_n_checks_is_the_eager_loop(case, checks):
    """_hysteresis after exactly 0, 1, 2, 5 checks and at the fixpoint
    equals the eager loop's, bool in and bool out; the counter adds the
    checks made."""
    _, strong_np, weak_np = next(c for c in synth.hysteresis_stress_maps() if c[0] == case)
    if case == "band_seeded_at_a_corner" and checks > 5:
        strong_np, weak_np = strong_np[:, :, :300], weak_np[:, :, :300]
    strong, weak = torch.from_numpy(strong_np), torch.from_numpy(weak_np)
    before = profiling.counts().get("canny.hysteresis_checks", 0)
    got = edges._hysteresis(strong, weak, checks)
    made = profiling.counts().get("canny.hysteresis_checks", 0) - before
    assert got.dtype == torch.bool and torch.equal(got, eager._hysteresis(strong, weak, checks))
    assert 0 <= made <= checks and (made > 0) == (checks > 0)


def test_spiral_needs_many_checks_and_a_cap_stops_it():
    """A weak spiral grows one pixel a step: hundreds of checks to its
    fixpoint, counted, and max_hysteresis_iters stops canny's growth at
    the eager loop's partial map."""
    _, strong_np, weak_np = next(c for c in synth.hysteresis_stress_maps() if c[0] == "spiral")
    strong, weak = torch.from_numpy(strong_np), torch.from_numpy(weak_np)
    before = profiling.counts().get("canny.hysteresis_checks", 0)
    full = edges._hysteresis(strong, weak, 10 ** 6)
    made = profiling.counts()["canny.hysteresis_checks"] - before
    assert torch.equal(full, strong | weak) and made > 100
    for cap in (1, 3, 40):
        part = edges._hysteresis(strong, weak, cap)
        assert torch.equal(part, eager._hysteresis(strong, weak, cap))
        assert not torch.equal(part, full)


@pytest.mark.parametrize("kind,shape", KINDS)
@pytest.mark.parametrize("low,high,l2", THRESHOLDS[:4])
@pytest.mark.parametrize("iters", [None, 1, 2])
def test_canny_is_the_eager_form(kind, shape, low, high, l2, iters):
    """canny and canny_batch (uint8 0/255, any leading dims) equal the
    eager form's, at the default cap and at 1 and 2 checks."""
    x = torch.from_numpy(_planes(kind, shape, shape[2]))
    want = eager.canny(x, low, high, l2, iters)
    got = edges.canny_batch(x, low, high, l2, iters)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    assert torch.equal(edges.canny(x[0], low, high, l2, iters), want[0])
    assert torch.equal(edges.canny(x[None], low, high, l2, iters), want[None])


def test_canny_kernels_are_counted_launches():
    """The two kernels are among the counted launches (none on the CPU)."""
    kernels.reset_launch_counts()
    edges.canny(torch.from_numpy(_planes("page", (2, 120, 85), 120)), 30, 100)
    counts = kernels.launch_counts()
    assert counts["canny_pre"] == 0 and counts["canny_hysteresis"] == 0
    assert profiling.counts()["canny.hysteresis_checks"] >= 1


def test_canny_wrappers_refuse_bad_arguments():
    """hysteresis_check's shapes, dtypes, flags and slot are checked."""
    s = torch.zeros((1, 4, 4), dtype=torch.bool)
    flags = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        kernels.hysteresis_check(s.float(), s, flags, 0)
    with pytest.raises(ValueError):
        kernels.hysteresis_check(s, s[:, :3], flags, 0)
    with pytest.raises(ValueError):
        kernels.hysteresis_check(s, s, flags, 2)
    with pytest.raises(TypeError):
        kernels.hysteresis_check(s, s, flags.float(), 0)
