"""The harness end to end on the CPU at a tiny size (the rehearsal path,
which the command line cannot reach): each cell's result line, the
faults that have to make ``correct`` false, the refusal without a card,
and that nothing of JAX or the JAX package is loaded."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
TINY = {"docscan.smartdoc_b8": ((144, 256), {"pool": 2, "batch": 2, "check_images": 2}),
        "landscape.div2k_b8": ((68, 102), {"pool": 4, "batch": 4}),
        "docscan.a4pages_b8": ((240, 170), {"pool": 2, "batch": 2}),
        "landscape.div2k_b1": ((68, 102), {"pool": 4})}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _rehearse(workload, trace=False, entry_hook=None, seconds=0.5):
    shape, overrides = TINY[workload]
    return run.run_cell(workload, 2 ** 31 + 5, seconds, trace, device="cpu", shape=shape,
                        cell_overrides=overrides, entry_hook=entry_hook)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", list(TINY))
def test_rehearsal_prints_the_contracts_line(workload, trace):
    r = _rehearse(workload, trace)
    line = run.result_line(r, 1, "cpu rehearsal", trace)
    assert list(line) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    json.dumps(line, allow_nan=False)
    spec = run.load_cell(workload)
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
        assert line["device"]["window_s"] > 0
    else:
        # the rehearsal has no card, so no metric read from the device
        want = {m["name"] for m in spec["end_to_end"] if m["source"] == "host_clock"}
        assert set(line["metrics"]) == want
        assert all(m["value"] > 0 for m in line["metrics"].values())


class _Altered:
    """The entry with each request's first answer altered where it is made."""

    def __init__(self, entry):
        self._entry = entry

    def __getattr__(self, name):
        return getattr(self._entry, name)

    def request(self, payload):
        res = self._entry.request(payload)
        first = res[0]
        if isinstance(first, np.ndarray):
            res[0] = first ^ np.uint8(4)
        else:
            key = "binary" if "binary" in first else "clean"
            res[0] = {**first, key: 255 - first[key]}
        return res


class _HalfLeftOut(_Altered):
    """The entry answering only the first half of each batch."""

    def request(self, payload):
        res = self._entry.request(payload)
        return res[:max(1, len(res) // 2)] if len(res) > 1 else []


@pytest.mark.parametrize("fault", [_Altered, _HalfLeftOut])
@pytest.mark.parametrize("workload", ["docscan.smartdoc_b8", "landscape.div2k_b8",
                                      "docscan.a4pages_b8", "landscape.div2k_b1"])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    r = _rehearse(workload, entry_hook=fault)
    assert not r["correct"]


def test_requests_cycle_through_the_pool_in_a_seeded_order():
    cell = {"pool": 8, "batch": 8}
    a, b = run.layout(cell, 5), run.layout(cell, 5)
    assert a == b and all(sorted(p) == list(range(8)) for p in a)
    assert a != run.layout(cell, 6)
    one = run.layout({"pool": 8, "batch": 1}, 5)
    assert sorted(p[0] for p in one) == list(range(8))
    order = run.request_order(8, 5)
    first = [next(order) for _ in range(16)]
    assert sorted(first[:8]) == list(range(8)) and sorted(first[8:]) == list(range(8))


def test_set_up_warms_one_payload_of_each_shape():
    a, b = np.zeros((8, 4, 6, 3), np.uint8), np.zeros((8, 6, 4, 3), np.uint8)
    warmed = run.one_of_each_shape([a, a.copy(), b, a])
    assert len(warmed) == 2 and warmed[0] is a and warmed[1] is b
    photos = [[np.zeros((4, 6, 3), np.uint8)] * 2, [np.zeros((4, 6, 3), np.uint8)] * 2,
              [np.zeros((4, 6, 3), np.uint8), np.zeros((6, 4, 3), np.uint8)]]
    warmed = run.one_of_each_shape(photos)
    assert len(warmed) == 2 and warmed[0] is photos[0] and warmed[1] is photos[2]


def test_device_times_sum_kernels_and_copies_and_take_the_union():
    from types import SimpleNamespace as NS

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, start_us, end_us, dev=cuda):
        return NS(name=name, device_type=dev, time_range=NS(start=start_us, end=end_us))

    prof = NS(events=lambda: [ev("gauss_sep_kernel", 0, 10), ev("elementwise", 5, 20),
                              ev("Memcpy HtoD (Pageable -> Device)", 30, 40),
                              ev("Memset (Device)", 40, 41), ev("cudaLaunchKernel", 0, 50, cpu)])
    t = run.device_times(prof)
    assert t["kernels"] == pytest.approx(25e-6) and t["copies"] == pytest.approx(10e-6)
    assert t["busy"] == pytest.approx(31e-6) and t["events"] == 4


def test_the_same_seed_makes_the_same_pool():
    cell = run.load_cell("docscan.a4pages_b8")["cell"]
    a = run.make_pool({**cell, "pool": 2}, 2 ** 31 + 9, "cpu", (60, 40))
    b = run.make_pool({**cell, "pool": 2}, 2 ** 31 + 9, "cpu", (60, 40))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def _python(code, cwd):
    env = {**os.environ, "PYTHONPATH": str(cwd)}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_no_module_of_jax_or_the_jax_package_is_loaded():
    code = ("import torch; torch.set_num_threads(2)\n"
            "from portbench import run\n"
            "for w in ('docscan.a4pages_b8', 'landscape.div2k_b1'):\n"
            "    run.run_cell(w, 3, 0.3, True, device='cpu', shape=(64, 48),\n"
            "                 cell_overrides={'pool': 2, 'batch': 1})\n"
            "print(sorted({m.split('.')[0] for m in __import__('sys').modules}))\n")
    r = _python(code, ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    top = set(json.loads(r.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert not top & {"jax", "jaxlib", "flax", "tpuimage"}
    assert "tpuimage_torch" in top


def test_without_a_card_the_run_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "docscan.a4pages_b8", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == run.EXIT_NO_CARD
    assert not any(l.startswith("{") for l in r.stdout.splitlines())


def test_a_checkout_without_the_program_fails(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "docscan.a4pages_b8", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert r.returncode != 0
    assert not any(l.startswith("{") for l in r.stdout.splitlines())


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", list(TINY))
def test_each_cell_is_correct_on_the_card(card, workload):
    r = run.run_cell(workload, 2 ** 31 + 77, 1.0, False, device=card)
    assert r["correct"], (r["readings"], r["limits"])
