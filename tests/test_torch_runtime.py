"""tpuimage_torch's runtime services on the CPU: ``profiling`` (the
throughput record and log line against tpuimage's, ``sync``, a profiler
trace written to a file), ``health`` (no card: the claim refused at once;
the CPU always available) and ``cache`` (``TPUIMAGE_XLA_CACHE`` read as
tpuimage reads it; the directory both builds then use; refused after a
library is loaded). All checks are exact; the device claim is held to
one second.
"""
import json
import logging
import subprocess
import time
from pathlib import Path

import jax
import pytest
import torch

from tpuimage.runtime import profiling as jprofiling

from tpuimage_torch import native
from tpuimage_torch.ops import kernels
from tpuimage_torch.runtime import cache, health, profiling

torch.set_num_threads(1)


def _stages(module, monkeypatch):
    """Three stages of one Throughput under a clock that ticks 0.25 s a
    read, and what it logs."""
    ticks = iter(range(100))
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks) * 0.25)
    tp = module.Throughput()
    with tp.stage("docscan", megapixels=1.92, images=1):
        pass
    with tp.stage("docscan", megapixels=1.92, images=1):
        pass
    with tp.stage("warm"):
        pass
    return tp.report()


def test_throughput_matches_tpuimage(monkeypatch, caplog):
    with caplog.at_level(logging.INFO, logger="tpuimage"):
        ref = _stages(jprofiling, monkeypatch)
        ref_lines = [r.getMessage() for r in caplog.records]
        caplog.clear()
        ours = _stages(profiling, monkeypatch)
        our_lines = [r.getMessage() for r in caplog.records]
    assert ours == ref
    assert ours["docscan"] == {"calls": 2, "seconds": 0.5, "megapixels": 3.84, "images": 2,
                               "mp_per_s": 7.68, "images_per_s": 4.0}
    assert ours["warm"] == {"calls": 1, "seconds": 0.25, "megapixels": 0.0, "images": 0}
    assert our_lines == ref_lines
    assert our_lines[0] == "stage docscan: " + json.dumps(ours["docscan"])


def test_sync_on_cpu_tensors_and_trees():
    a, b = torch.ones(3), torch.zeros(2)
    trees = [a, {"z": [b], "a": (1, {"x": a})}, [None, (2.0, b)], {}, [], "text", None]
    for tree in trees:
        assert profiling.sync(tree) is None
    # the leaf it waits on is the one jax's tree order puts first
    for tree in trees[:3]:
        first = [x for x in jax.tree_util.tree_leaves(tree) if isinstance(x, torch.Tensor)][0]
        assert profiling._first_tensor(tree) is first
    assert profiling._first_tensor({"k": [1, "s"]}) is None


def test_trace_written(tmp_path):
    with pytest.raises(RuntimeError, match="no trace"):
        profiling.stop_trace()
    profiling.start_trace(str(tmp_path / "trace"))
    try:
        with pytest.raises(RuntimeError, match="already running"):
            profiling.start_trace(str(tmp_path / "other"))
        with profiling.trace_annotation("tpuimage_stage"):
            torch.ones(64, 64).sum()
    finally:
        path = profiling.stop_trace()
    assert Path(path).parent == tmp_path / "trace"
    events = json.loads(Path(path).read_text())["traceEvents"]
    assert any(e.get("name") == "tpuimage_stage" for e in events)


def test_health_without_a_card():
    assert not torch.cuda.is_available()
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="--device cpu"):
        health.require_device(600, what="a test", device="cuda")
    assert not health.device_available(600, device="cuda")
    assert time.perf_counter() - t0 < 1.0
    assert health.device_available(0, device="cpu")
    health.require_device(0, device="cpu")
    with pytest.raises(ValueError):
        health.device_available(1, device="meta")


@pytest.fixture()
def build_dirs(monkeypatch):
    """Each build directory restored after the test; no library loaded."""
    monkeypatch.setattr(kernels, "BUILD_DIR", kernels.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(native, "_lib", None)
    return kernels.BUILD_DIR, native.BUILD_DIR


def _outputs_of_builds(monkeypatch) -> dict:
    """The files each build would write, with its compilers replaced by
    ones that fail (nothing is built)."""
    monkeypatch.setattr(kernels, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.build()
    seen = {}

    def g_plus_plus(cmd, **kw):
        seen["host"] = Path(cmd[cmd.index("-o") + 1])
        return subprocess.CompletedProcess(cmd, 1)

    monkeypatch.setattr(subprocess, "run", g_plus_plus)
    assert native._build() is None
    return seen


@pytest.mark.parametrize("value", [None, "", "0", "1", "dir"])
def test_compile_cache_variable(value, build_dirs, monkeypatch, tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if value is None:
        monkeypatch.delenv("TPUIMAGE_XLA_CACHE", raising=False)
    else:
        monkeypatch.setenv("TPUIMAGE_XLA_CACHE", str(tmp_path / "c") if value == "dir" else value)
    got = cache.maybe_enable_compile_cache()
    want = {"1": tmp_path / "home" / ".cache" / "tpuimage-torch-build",
            "dir": tmp_path / "c"}.get(value)
    if want is None:
        assert got is None
        assert (kernels.BUILD_DIR, native.BUILD_DIR) == build_dirs
        return
    assert Path(got) == want and want.is_dir()
    assert kernels.BUILD_DIR == native.BUILD_DIR == want
    seen = _outputs_of_builds(monkeypatch)
    assert seen["host"].parent == want
    assert [p.suffix for p in want.glob("libtpuimage_torch_kernels_*")] == [".log"]
    assert not any(p.suffix == ".so" for p in want.iterdir())


def test_compile_cache_after_a_load(build_dirs, tmp_path):
    for module in (kernels, native):
        module._lib = object()
        with pytest.raises(RuntimeError, match="before the first build"):
            cache.enable_compile_cache(str(tmp_path))
        module._lib = None
    assert (kernels.BUILD_DIR, native.BUILD_DIR) == build_dirs
    assert cache.enable_compile_cache(str(tmp_path / "x")) == str(tmp_path / "x")
