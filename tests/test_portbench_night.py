"""The benchmark's night cell (``night.lol_b8``) on the CPU: the port's
``night_gui`` equal to the plain reference (``portbench/reference/night.py``)
on seeded night scenes at LOL's 600x400 and at sizes whose CLAHE grid
divides and does not; the reference's median, a sort of the shifted
views, against numpy's sort and the port's transposition network; the
frozen scene generator equal to the port's and inside the classifier's
night rule; the entry's refusal of settings the route does not run; the
new reader silent on a program without the night spans; and, in a
process of its own (this one has JAX loaded, which makes every run of the
harness not correct), a rehearsal of the cell through ``run.run_cell``
and its control, which has to come out not correct."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import run, spans
from portbench import trace as tr
from portbench.entries import night_gui as entry
from portbench.images import night_scene
from portbench.reference import night as ref_night
from portbench.reference.ops import median as ref_median
from tpuimage_torch import synth
from tpuimage_torch.ops import color
from tpuimage_torch.ops.median import median_blur
from tpuimage_torch.pipelines import night
from tpuimage_torch.runtime import profiling

ROOT = Path(__file__).resolve().parents[1]
CELL = "night.lol_b8"
SETTINGS = json.loads((ROOT / "portbench" / "configs" / "night_gui_lol.json")
                      .read_text())["settings"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenes(seed, n, h, w):
    rng = np.random.default_rng(seed)
    return np.stack([night_scene.make(int(s), h, w, np.random.default_rng(int(s)), {}, "cpu")
                     for s in rng.integers(0, 2 ** 62, size=n)])


@pytest.mark.parametrize("n, h, w", [(1, 400, 600),    # LOL: 8x8 tiles of 75x50, unpadded
                                     (2, 64, 96),      # divisible
                                     (2, 45, 61),      # padded on both dims
                                     (1, 37, 200)])    # padded, one dim divisible
def test_port_night_gui_equals_the_reference(n, h, w):
    photos = _scenes(2 ** 31 + h * w, n, h, w)
    got = night.night_gui(photos, device="cpu")["enhanced"].numpy()
    want = ref_night.night_gui(torch.from_numpy(photos), SETTINGS).numpy()
    assert got.shape == photos.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert all(entry.Entry.compare(g, r) == {"max_diff": 0.0, "diff_share": 0.0}
               for g, r in zip(got, want))


def _numpy_median(img, k):
    """The median of each k x k window with the border replicated, by
    numpy's sort, on the last two dims."""
    r = k // 2
    pad = [(0, 0)] * (img.ndim - 2) + [(r, r), (r, r)]
    p = np.pad(img, pad, mode="edge")
    h, w = img.shape[-2:]
    views = np.stack([p[..., dy:dy + h, dx:dx + w] for dy in range(k) for dx in range(k)])
    return np.sort(views, axis=0)[k * k // 2]


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (7, 1), (17, 29), (3, 40, 33)])
def test_reference_median_equals_a_sort_and_the_ports_network(k, shape):
    img = np.random.default_rng(sum(shape) * k).integers(0, 256, size=shape, dtype=np.uint8)
    got = ref_median.median_blur(torch.from_numpy(img), k).numpy()
    np.testing.assert_array_equal(got, _numpy_median(img, k))
    np.testing.assert_array_equal(got, median_blur(torch.from_numpy(img), k).numpy())


def test_reference_median_channels_last_on_a_scene():
    rgb = _scenes(11, 2, 31, 47)
    got = ref_median.median_blur(torch.from_numpy(rgb), 3, channels_last=True).numpy()
    np.testing.assert_array_equal(got, np.moveaxis(_numpy_median(np.moveaxis(rgb, -1, -3), 3),
                                                   -3, -1))
    np.testing.assert_array_equal(
        got, median_blur(torch.from_numpy(rgb), 3, channels_last=True).numpy())
    with pytest.raises(ValueError):
        ref_median.median_blur(torch.from_numpy(rgb), 4)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 3, 2 ** 62 - 1])
def test_frozen_scenes_equal_the_ports_and_meet_the_night_rule(seed):
    img = night_scene.make(seed, 400, 600, np.random.default_rng(seed), {}, "cpu")
    np.testing.assert_array_equal(img, synth.night_scene(seed, 400, 600))
    gray = color.rgb_to_gray(torch.from_numpy(img)).double().mean().item()
    assert 15.7 <= gray <= 17.7 < 80.0
    assert (img <= 60).mean() > 0.98


def test_the_entry_refuses_settings_the_route_does_not_run():
    assert SETTINGS == entry.ROUTE
    for key, value in [("median_ksize", 5), ("clahe_clip_limit", 3.0),
                       ("clahe_tile_grid", [4, 4])]:
        with pytest.raises(ValueError):
            entry.Entry({**SETTINGS, key: value}, "cpu")


def test_the_median_reader_is_silent_without_night_spans(monkeypatch):
    reader = run._module("metrics", "median_ms_per_request")
    t = tr.Trace(1.0, [], [], 3, 24)
    profiling.reset_counts()
    assert reader.read(t) is None
    monkeypatch.setattr(spans, "recorder", lambda: None)
    assert reader.read(t) is None


_REHEARSAL = """
import json, torch
torch.set_num_threads(2)
from portbench import control, run, spans
over = {"pool": 2, "batch": 2}
out = {}
for trace in (False, True):
    r = run.run_cell("night.lol_b8", 2 ** 31 + 5, 0.5, trace, device="cpu", shape=(45, 61),
                     cell_overrides=over)
    out[str(trace)] = {"line": run.result_line(r, 1, "cpu rehearsal", trace),
                       "requests": r["requests"], "counts": spans.counts()}
r = control.run_control("night.lol_b8", 2 ** 31 + 6, 0.3, "cpu", (45, 61), over)
out["control"] = {"readings": r["readings"], "limits": r["limits"], "correct": r["correct"]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def rehearsal():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    r = subprocess.run([sys.executable, "-c", _REHEARSAL], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_prints_the_contracts_line(rehearsal, trace):
    got = rehearsal[str(trace)]
    line = got["line"]
    assert list(line) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1
    assert line["checks"] == {"max_diff": {"value": 0.0, "limit": 2.0},
                              "diff_share": {"value": 0.0, "limit": 0.005}}
    if trace:
        # no card here: the host-clock rate and the span reader read; the
        # launch count has no device trace to read
        assert set(line["metrics"]) == {"images_per_s.host_bound", "median_ms_per_request"}
        assert all(m["value"] > 0 for m in line["metrics"].values())
        assert line["device"]["window_s"] > 0
        assert got["counts"] == {"median.exchanges": 36 * got["requests"]}
    else:
        # the cell is held to the card's kernel time, which no CPU run reads
        assert set(line["metrics"]) == {"setup_s"}
        assert line["metrics"]["setup_s"]["value"] > 0


def test_the_control_is_not_correct(rehearsal):
    c = rehearsal["control"]
    assert not c["correct"]
    assert c["limits"] == {"max_diff": 2.0, "diff_share": 0.005}
    assert c["readings"]["max_diff"] > c["limits"]["max_diff"]
    assert c["readings"]["diff_share"] > c["limits"]["diff_share"]
