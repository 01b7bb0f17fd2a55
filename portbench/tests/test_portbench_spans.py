"""The four per-layer metrics read from the port's own spans and counters
(``portbench/spans.py``), rehearsed on the CPU through
``run_cell(trace=True)``: each reported in the cells ``BENCHMARK.json``
lists it for and nowhere else, ``program_idle_share`` at most
``device_idle_share`` (the CPU has no card, so the test lays a device
interval over the first half of each window), and every reader silent,
not raising, on a program without the recorder (the parent's)."""
import json
from pathlib import Path

import pytest
import torch

from portbench import run, spans
from portbench import trace as tr
from portbench.tests.test_portbench_run import TINY

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ("quad_fit_ms_per_image", "quad_fallback_share", "dispatch_ms_per_request",
       "program_idle_share")


def _listed(workload):
    return {m["name"] for m in BENCH["per_layer"]
            if m["name"] in NEW and workload in m["workloads"]}


@pytest.fixture()
def laid_card(monkeypatch):
    """``trace.read`` with one device interval over the first half of a
    window that has none."""
    real = tr.read

    def read(*args, **kwargs):
        t = real(*args, **kwargs)
        if not t.device:
            t.device = [(0.0, t.window_s / 2, "laid over")]
        return t

    monkeypatch.setattr(tr, "read", read)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", list(TINY))
def test_the_new_metrics_are_reported_where_listed(workload, laid_card):
    shape, overrides = TINY[workload]
    r = run.run_cell(workload, 2 ** 31 + 11, 0.5, True, device="cpu", shape=shape,
                     cell_overrides=overrides)
    assert r["correct"]
    got = r["metrics"]
    assert set(got) & set(NEW) == _listed(workload)
    t = r["trace"]
    for name in set(NEW) - _listed(workload) - {"program_idle_share"}:
        assert run._module("metrics", name).read(t) is None, name
    if "quad_fit_ms_per_image" in got:
        assert got["quad_fit_ms_per_image"]["value"] > 0
        assert 0 <= got["quad_fallback_share"]["value"] <= 100
        assert spans.counts()["docscan.quads"] >= r["images"]
    if "dispatch_ms_per_request" in got:
        per_request = 1e3 * t.window_s / t.requests
        assert 0 < got["dispatch_ms_per_request"]["value"] < per_request
        assert 0 < got["program_idle_share"]["value"] <= got["device_idle_share"]["value"]
    # the spans lie inside the window once mapped onto the trace's clock
    mapped = spans.on_trace(t)
    assert mapped and all(0 <= s <= e <= t.window_s for s, e, _ in mapped)


def test_idle_time_split_by_the_innermost_span():
    from types import SimpleNamespace as NS

    def sp(i, name, parent):
        return NS(id=i, name=name, parent=parent)

    top, child, other = sp(1, "top", None), sp(2, "child", 1), sp(3, "other", None)
    mapped = [(0.0, 6.0, top), (1.0, 3.0, child), (7.0, 8.0, other)]
    t = tr.Trace(10.0, [(2.0, 5.0, "k"), (7.5, 9.0, "k")], [], 1, 1)
    # idle: [0, 2), [5, 7.5), [9, 10)
    split = spans.idle_by_span(t, mapped)
    assert split == pytest.approx({"top": 1.0 + 1.0, "child": 1.0, spans.OUTSIDE: 1.0 + 1.0,
                                   "other": 0.5})
    assert sum(split.values()) == pytest.approx(sum(e - s for s, e in t.gaps()))
    assert spans.idle_covered(t, mapped) == pytest.approx({"top": 3.0, "child": 1.0,
                                                           "other": 0.5})


def test_readers_are_silent_without_the_recorder(monkeypatch):
    monkeypatch.setattr(spans, "recorder", lambda: None)
    t = tr.Trace(1.0, [(0.0, 0.5, "k")], [(0.1, 0.2, "tpuimage.clock.1")], 2, 2)
    for name in NEW:
        assert run._module("metrics", name).read(t) is None, name
