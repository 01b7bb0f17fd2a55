"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell's files are found by name:
``portbench/cells/<cell>.json`` (the traffic), the configuration it names
in ``portbench/configs/``, the entry driver in ``portbench/entries/``, the
image generator in ``portbench/images/``, the per-layer readers in
``portbench/metrics/`` and the metrics themselves in ``BENCHMARK.json``.

Set-up: the card is claimed (a machine without enough cards exits 3 and
prints no result), the port's two compiled libraries are built or found
in ``portbench/.cache/build``, the pool of images is made from the seed
(or the cell's ``content_seed``), the request payloads are laid out in
host memory, and one payload of each distinct input shape is run once,
which also builds the kernels. Then one client sends requests in a closed
loop for ``--seconds``: each starts from its host arrays and ends with its
results in host memory. With ``--trace 1`` the window runs
under ``torch.profiler`` (at most the cell's ``trace_seconds``) and the
per-layer metrics are read from the trace; a cell with an end-to-end
metric read from the card (``"source": "device_trace"``) runs its
untraced window under a profiler of the card's activity alone.

After the window the peak device memory is read, the run checks that
neither JAX nor the JAX package was loaded, and a seeded sample of the
answers is compared with the plain reference (``portbench/reference``);
each number compared and its limit go to the last lines of standard
error and under ``checks`` in the result. The result is the last line of
standard output."""
from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "tpuimage")
EXIT_NO_CARD = 3
EXIT_BANNED = 4


def _module(kind: str, name: str):
    """``portbench/<kind>/<name>.py``, loaded by path (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str) -> dict:
    """The cell's traffic, its configuration, and its metrics as
    ``BENCHMARK.json`` lists them."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if spec is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = json.loads((HERE / "cells" / f"{workload}.json").read_text())
    config = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())

    def listed(m):
        return "workloads" not in m or workload in m["workloads"]

    return {"name": workload, "chips": spec["chips"], "cell": cell, "config": config,
            "end_to_end": [m for m in bench["end_to_end"] if listed(m)],
            "per_layer": [m for m in bench["per_layer"] if listed(m)]}


def make_pool(cell: dict, seed: int, device, shape=None) -> list:
    """The cell's pool of images in host memory, each from its own seed
    drawn from ``seed``, or from the cell's ``content_seed`` where the work
    of an image depends on its content, so that every run does the same
    work (the run's seed then orders the requests and draws the sample);
    ``shape`` overrides the cell's (height, width)."""
    spec = cell["images"]
    h, w = shape or (spec["height"], spec["width"])
    gen = _module("images", spec["kind"])
    seeds = np.random.default_rng(cell.get("content_seed", seed)).integers(
        0, 2 ** 62, size=cell["pool"])

    def one(s):
        return gen.make(int(s), h, w, np.random.default_rng(int(s)), spec, device)

    with ThreadPoolExecutor(max_workers=min(8, len(seeds))) as ex:
        return list(ex.map(one, seeds))


def layout(cell: dict, seed: int) -> list:
    """The pool indices of each request payload: ``pool`` payloads of
    ``batch`` images, every image in ``batch`` of them, each payload in a
    seeded order."""
    rng = np.random.default_rng([seed, 1])
    n, b = cell["pool"], cell["batch"]
    order = rng.permutation(n)
    return [[int(i) for i in rng.permutation([order[(j * b + k) % n] for k in range(b)])]
            for j in range(n)]


def shape_of(payload) -> tuple:
    """The input shapes of one payload: a stack's, or each image's of a list."""
    if isinstance(payload, np.ndarray):
        return tuple(payload.shape)
    return tuple(tuple(x.shape) for x in payload)


def one_of_each_shape(payloads: list) -> list:
    """The first payload of each distinct input shape: what set-up warms."""
    seen = {}
    for p in payloads:
        seen.setdefault(shape_of(p), p)
    return list(seen.values())


def request_order(n_payloads: int, seed: int):
    """Payload indices in a seeded order, a fresh permutation each cycle."""
    rng = np.random.default_rng([seed, 2])
    while True:
        yield from (int(i) for i in rng.permutation(n_payloads))


class Sample:
    """A seeded reservoir of ``k`` finished requests: (payload index,
    results)."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.kept = k, 0, []
        self._rng = np.random.default_rng([seed, 3])

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = int(self._rng.integers(0, self.seen))
            if j < self.k:
                self.kept[j] = item


def host_clocks() -> dict:
    """The host's clocks that say how much of the wall time this process
    had: its CPU seconds (all threads), the calling thread's CPU seconds,
    and the machine's steal seconds (time the hypervisor gave the virtual
    CPUs to others), None where the system does not keep it."""
    out = {"wall": time.perf_counter(), "cpu": time.process_time(),
           "thread_cpu": time.thread_time(), "steal": None}
    try:
        fields = Path("/proc/stat").read_text().split("\n", 1)[0].split()
        out["steal"] = int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return out


def clock_deltas(a: dict, b: dict) -> dict:
    return {k: (b[k] - a[k] if a[k] is not None and b[k] is not None else None) for k in a}


def device_times(prof) -> dict:
    """Seconds of the card's activity in a ``torch.profiler`` window
    that recorded only the device: ``kernels`` (the sum of kernel
    times), ``copies`` (memcpy) and ``busy`` (the union of every event,
    memsets too, so overlap counts once)."""
    import torch

    from portbench.trace import Trace, is_memcpy

    cuda = torch.autograd.DeviceType.CUDA
    ev = [(e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
          for e in prof.events() if e.device_type == cuda]
    kernels = sum(t - s for s, t, n in ev if not is_memcpy(n) and not n.lower().startswith("memset"))
    copies = sum(t - s for s, t, n in ev if is_memcpy(n))
    return {"kernels": kernels, "copies": copies,
            "busy": Trace(0.0, ev, [], 0, 0).busy(), "events": len(ev)}


def measure(entry, payloads, order, seconds: float, sample: Sample, batch: int,
            trace: bool = False, device_profile: bool = False) -> dict:
    """The closed loop: one client sends the next request once the last
    has its results in host memory, until ``seconds`` have passed; the
    window closes when the last request sent has finished, so every
    request in it is whole. With ``trace`` the window runs under the
    profiler and the work of each request is kept; with
    ``device_profile`` (and no ``trace``) under a profiler of the card's
    activity alone, for the end-to-end metrics read from the device."""
    import torch

    lat, attempted, failed, images, work = [], 0, 0, 0, {}
    prof = dev_prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        from portbench.trace import REQUEST_SPAN, WINDOW_SPAN
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if torch.cuda.is_available() else [])
        prof = profile(activities=acts)
        prof.__enter__()
        window_span = record_function(WINDOW_SPAN)
        window_span.__enter__()
    elif device_profile:
        from torch.profiler import ProfilerActivity, profile
        dev_prof = profile(activities=[ProfilerActivity.CUDA])
        dev_prof.__enter__()
    clocks = host_clocks()
    t_start = clocks["wall"]
    try:
        while time.perf_counter() - t_start < seconds:
            j = next(order)
            attempted += 1
            t0 = time.perf_counter()
            try:
                if trace:
                    with record_function(REQUEST_SPAN):
                        res = entry.request(payloads[j])
                else:
                    res = entry.request(payloads[j])
            except Exception as e:  # noqa: BLE001 — a failed request counts and the loop goes on
                print(f"request failed: {type(e).__name__}: {e}", file=sys.stderr)
                failed += 1
                continue
            t1 = time.perf_counter()
            if len(res) != batch or entry.failures(res):
                print(f"request failed: {len(res)} answers for {batch} images, "
                      f"{entry.failures(res)} of them errors", file=sys.stderr)
                failed += 1
                continue
            lat.append(t1 - t0)
            images += batch
            sample.offer((j, res))
            if trace:
                for stage, shapes in entry.work(res).items():
                    work.setdefault(stage, []).extend(shapes)
        if (trace or device_profile) and torch.cuda.is_available():
            torch.cuda.synchronize()
        clocks = clock_deltas(clocks, host_clocks())
    finally:
        if trace:
            window_span.__exit__(None, None, None)
            prof.__exit__(None, None, None)
        elif dev_prof is not None:
            dev_prof.__exit__(None, None, None)
    return {"latencies": lat, "attempted": attempted, "failed": failed, "images": images,
            "window": clocks["wall"], "clocks": clocks, "profile": prof,
            "device_times": device_times(dev_prof) if dev_prof is not None else None,
            "work": work, "requests": len(lat)}


def check(entry, pool, idx, sample: Sample, cell: dict, config: dict, seed: int,
          device) -> tuple:
    """The sampled answers against the plain reference of their images:
    ({number: largest reading}, {number: limit}, correct). Only the
    images of a seeded subset of ``check_images`` are compared; the
    reference runs once per image."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng([seed, 4])
    checked = set(int(i) for i in rng.permutation(len(pool))[:cell["check_images"]])
    refs, worst = {}, {}
    for j, results in sample.kept:
        for pos, res in enumerate(results):
            i = idx[j][pos]
            if i not in checked:
                continue
            if i not in refs:
                refs[i] = entry.reference(pool[i], device)
            for k, v in entry.compare(res, refs[i]).items():
                worst[k] = max(worst.get(k, 0.0), float(v))
    limits = config["limits"][cell["entry"]]
    correct = bool(worst) and all(worst.get(k, float("inf")) <= lim
                                  for k, lim in limits.items())
    return worst, limits, correct


def nvidia_smi() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
                            "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             shape=None, cell_overrides=None, entry_hook=None) -> dict:
    """Set-up, the window, the checks: the result's fields. ``device``,
    ``shape``, ``cell_overrides`` (keys of the cell file replaced) and
    ``entry_hook`` (a function that may wrap the entry) are for
    rehearsals on the CPU; the command line always takes the card."""
    import torch

    spec = load_cell(workload)
    cell, config = {**spec["cell"], **(cell_overrides or {})}, spec["config"]
    from tpuimage_torch.ops import kernels

    entry_mod = _module("entries", config["entries"][cell["entry"]])
    entry = entry_mod.Entry(config["settings"], device)
    if entry_hook is not None:
        entry = entry_hook(entry)
    phases = {"loaded": time.perf_counter() - PROCESS_START}
    pool = make_pool(cell, seed, device, shape)
    idx = layout(cell, seed)
    payloads = [entry.payload([pool[i] for i in ids]) for ids in idx]
    phases["pool"] = time.perf_counter() - PROCESS_START
    for p in one_of_each_shape(payloads):   # every shape the traffic uses, and the builds
        entry.request(p)
    if trace:                               # the profiler's own first start, on one small op
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]
                     + ([ProfilerActivity.CUDA] if device != "cpu" else [])):
            torch.ones(8, device=device).sum().item()
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - PROCESS_START

    kernels.reset_launch_counts()
    sample = Sample(cell["check_requests"], seed)
    m = measure(entry, payloads, request_order(len(payloads), seed),
                min(seconds, cell.get("trace_seconds", seconds)) if trace else seconds,
                sample, cell["batch"], trace,
                device_profile=device != "cpu" and any(d["source"] == "device_trace"
                                                       for d in spec["end_to_end"]))
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0

    out = {"attempted": m["attempted"], "failed": m["failed"], "setup_s": setup_s,
           "setup_phases": phases,
           "memory_peak_bytes": int(peak), "launches": launches,
           "requests": m["requests"], "images": m["images"], "window": m["window"],
           "clocks": m["clocks"], "device_times": m["device_times"]}
    if trace:
        from portbench import trace as tr
        t = tr.read(m["profile"], m["requests"], m["images"], m["work"], config["settings"])
        out["trace"] = t
        out["breakdown"] = tr.breakdown(t)
        metrics = {}
        for mdef in spec["per_layer"]:
            v = _module("metrics", mdef["name"]).read(t)
            if v is not None:
                metrics[mdef["name"]] = {"value": float(v), "unit": mdef["unit"]}
    else:
        lat = np.asarray(m["latencies"])
        per_image = 1e3 / m["images"] if m["images"] else None
        dt = m["device_times"]
        values = {"setup_s": setup_s,
                  "images_per_s": m["images"] / m["window"],
                  "request_p95_ms": float(np.percentile(lat, 95)) * 1e3 if lat.size else None,
                  "kernel_ms_per_image": per_image and dt and dt["kernels"] * per_image}
        out["latency_ms"] = {"n": int(lat.size)} if not lat.size else {
            "n": int(lat.size), "median": float(np.median(lat)) * 1e3,
            "p95": float(np.percentile(lat, 95)) * 1e3, "max": float(lat.max()) * 1e3}
        metrics = {d["name"]: {"value": float(values[d["name"]]), "unit": d["unit"]}
                   for d in spec["end_to_end"] if values.get(d["name"]) is not None}
    out["metrics"] = metrics
    m.clear()
    if device != "cpu":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    worst, limits, correct = check(entry, pool, idx, sample, cell, config, seed, device)
    found = banned_modules()
    out.update(readings=worst, limits=limits, banned=found,
               correct=correct and not found and out["failed"] == 0,
               check_s=time.perf_counter() - t_check)
    return out


def result_line(r: dict, chips: int, kind: str, trace: bool) -> dict:
    """The contract's last line: correct, attempted, failed, metrics,
    device, with ``trace`` the breakdown, and the numbers compared with
    their limits last."""
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": r["memory_peak_bytes"]}
    result = {"correct": r["correct"], "attempted": r["attempted"], "failed": r["failed"],
              "metrics": r["metrics"], "device": device}
    if trace:
        device["busy_s"] = r["trace"].busy()
        device["window_s"] = r["trace"].window_s
        result["breakdown"] = r["breakdown"]
    result["checks"] = {k: {"value": r["readings"].get(k), "limit": lim}
                        for k, lim in r["limits"].items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")
    spec = load_cell(args.workload)
    import torch
    from tpuimage_torch.runtime.cache import enable_compile_cache

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"this cell needs {spec['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return EXIT_NO_CARD
    enable_compile_cache(str(HERE / ".cache" / "build"))

    r = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    if r["banned"]:
        print(f"modules of JAX or the JAX package were loaded: {r['banned']}", file=sys.stderr)
        return EXIT_BANNED
    print("set-up, seconds from process start: " + ", ".join(
        f"{k} {v:.3f}" for k, v in r["setup_phases"].items()) + f", warmed {r['setup_s']:.3f}")
    print(f"kernel launches in the window (the port's own counter): {r['launches']}")
    print(f"requests {r['requests']} of {r['attempted']} in {r['window']:.6f} s, images "
          f"{r['images']}; " + (f"latency ms {r['latency_ms']}" if "latency_ms" in r else
                                f"trace: {len(r['trace'].device)} device events, busy "
                                f"{r['trace'].busy():.6f} s of {r['trace'].window_s:.6f} s"))
    print("host clocks over the window, s: " + ", ".join(
        f"{k} {v:.6f}" for k, v in r["clocks"].items() if v is not None)
        + (f"; card, s: {r['device_times']}" if r["device_times"] else ""))
    print(f"peak device memory {r['memory_peak_bytes']} bytes; card after the window: "
          f"{nvidia_smi()}", flush=True)
    result = result_line(r, spec["chips"], torch.cuda.get_device_name(0), bool(args.trace))
    readings = {k: v for k, v in r["readings"].items() if k not in r["limits"]}
    print(f"reference check {r['check_s']:.3f} s; readings not compared: {readings}",
          file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
