"""Every public name of every tpuimage module against its tpuimage_torch
counterpart: the names a module defines (a package's ``__init__`` also
those it imports, its surface) exist in the port, and every parameter of
a shared function or class that a caller can pass by keyword, past the
first (the input, which callers pass by position), exists in the port's,
but for the names that are TPU devices or have a stated replacement
(ROADMAP.md, Queue 1):

- the names ``TPU_NAMES`` and the parameters ``TPU_PARAMS``: the TPU
  layouts, schedules and serving forms;
- ``CUE_SCHEDULE``, the module default of the ``schedule=`` knob;
- ``key`` / ``keys`` of landscape's ``degrade_image`` and of the two
  functions that pass it on: a JAX PRNG key, for which the port takes a
  ``torch.Generator`` or the noise itself;
- the CLIP towers' ``parent`` and ``name`` (the fields Flax adds to every
  Module) and ``params`` (the Flax tree ``convert_openclip_state_dict``
  makes; the port takes open_clip's state dict);
- the mesh collectives' ``x`` / ``local`` and ``axis_name``: tpuimage's run
  on one shard inside ``shard_map`` over a named axis, the port's take the
  list of shards (PyTorch has no sharding object; ``batch_sharding``).

``native/build.py``'s counterpart is ``tpuimage_torch/native/__init__.py``;
each Pallas kernel of ``ops/pallas_kernels.py`` has a wrapper and a plain
``*_ref`` version in ``tpuimage_torch/ops/kernels.py`` (the
``*_applicable`` VMEM gates are TPU devices).
"""
import ast
import importlib
import inspect
import os
import types

import pytest

TPU_NAMES = {"perspective_tiles_plan", "rotate_traced", "rotate_traced_tiled",
             "warp_perspective_tiled_batch", "clahe_apply_matrix", "band_compact_coords",
             "theta_windows", "docscan_post_warp_batch_serve", "localize_batch_dev", "WARP_IMPL",
             "batch_sharding", "convert_openclip_state_dict", "CUE_SCHEDULE"}
TPU_PARAMS = {"impl", "chunk", "theta_pack", "unroll", "vote_lo", "schedule"}
REPLACED_PARAMS = {
    ("pipelines.landscape", "degrade_image"): {"key"},
    ("pipelines.landscape", "landscape_eval_step"): {"key"},
    ("pipelines.landscape", "landscape_eval_batch"): {"keys"},
    ("classify.clip", "VisionTower"): {"parent", "name"},
    ("classify.clip", "TextTower"): {"parent", "name"},
    ("classify.clip", "ClipZeroShot"): {"params"},
    ("classify.clip", "compute_text_features"): {"params"},
    ("runtime.mesh", "halo_exchange"): {"x", "axis_name"},
    **{("runtime.spatial", n): {"local", "axis_name"}
       for n in ("global_hist256", "global_min", "global_max", "global_normalize_minmax")},
}
COUNTERPART = {"native.build": "native"}
ROOT = os.path.join(os.path.dirname(__file__), os.pardir, "tpuimage")


def _modules():
    out = []
    for base, _, files in os.walk(ROOT):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(base, f), ROOT)[:-3].replace(os.sep, ".")
                rel = rel[:-len("__init__")].rstrip(".") if rel.endswith("__init__") else rel
                if rel != "ops.pallas_kernels":
                    out.append(rel)
    return sorted(out)


def _import(package, rel):
    return importlib.import_module(package + ("." + rel if rel else ""))


def _public(mod):
    imported = set()
    if not mod.__file__.endswith("__init__.py"):
        imported = {a.asname or a.name.split(".")[0] for node in ast.parse(inspect.getsource(mod)).body
                    if isinstance(node, (ast.Import, ast.ImportFrom)) for a in node.names}
    return {n: v for n, v in vars(mod).items()
            if not n.startswith("_") and n not in imported and not isinstance(v, types.ModuleType)
            and getattr(v, "__module__", mod.__name__) == mod.__name__}


def _keyword_params(sig):
    return {p.name for p in list(sig.parameters.values())[1:]
            if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}


@pytest.mark.parametrize("rel", _modules())
def test_public_names_and_parameters(rel):
    j = _import("tpuimage", rel)
    t = _import("tpuimage_torch", COUNTERPART.get(rel, rel))
    public = {n: v for n, v in _public(j).items() if n not in TPU_NAMES}
    missing = sorted(set(public) - set(vars(t)))
    assert not missing, missing
    for name, value in public.items():
        if not callable(value):
            continue
        try:
            ours = inspect.signature(getattr(t, name))
            theirs = inspect.signature(value)
        except (TypeError, ValueError):      # a builtin without a signature
            continue
        wanted = _keyword_params(theirs) - TPU_PARAMS - REPLACED_PARAMS.get((rel, name), set())
        assert wanted <= set(ours.parameters), (name, sorted(wanted - set(ours.parameters)))


def test_pallas_kernels_have_wrappers_and_plain_versions():
    """The 12 Pallas kernels (each function of pallas_kernels.py that
    reaches pl.pallas_call) -> kernels.<name> and kernels.<name>_ref."""
    j = importlib.import_module("tpuimage.ops.pallas_kernels")
    t = importlib.import_module("tpuimage_torch.ops.kernels")
    pallas = sorted(n for n in _public(j) if n.endswith("_pallas"))
    assert len(pallas) == 12, pallas
    for n in pallas:
        ours = {"bilateral_gray": "bilateral"}.get(n[:-len("_pallas")], n[:-len("_pallas")])
        assert callable(getattr(t, ours, None)) and callable(getattr(t, ours + "_ref", None)), n
