"""cv2's CLAHE as a stage of tpuimage's jitted programs, for the tests
that hold a tpuimage_torch path with a CLAHE against tpuimage.

tpuimage_torch's CLAHE apply blends in cv2's order and equals
``cv2.createCLAHE().apply`` on every pixel; tpuimage's own CLAHE forms
round some cvRound .5 ties the other way. So where a whole path differs
from tpuimage's by those ties, the test holds it against a copy of
tpuimage's jitted program whose CLAHE stage is cv2's: the same function,
traced afresh with its module's ``clahe`` replaced by a host callback.
"""
import functools

import cv2
import jax
import jax.numpy as jnp
import numpy as np


def cv2_clahe(gray, clip_limit: float = 40.0, tiles_x: int = 8, tiles_y: int = 8):
    """``cv2.createCLAHE(clip_limit, (tiles_x, tiles_y)).apply`` on each (H,
    W) plane of a (..., H, W) uint8 array, as a JAX host callback
    (tpuimage's ``histogram.clahe`` signature)."""
    def host(a):
        a = np.asarray(a)
        op = cv2.createCLAHE(float(clip_limit), (int(tiles_x), int(tiles_y)))
        planes = a.reshape((-1,) + a.shape[-2:])
        return np.stack([op.apply(np.ascontiguousarray(p)) for p in planes]).reshape(a.shape)
    return jax.pure_callback(host, jax.ShapeDtypeStruct(gray.shape, jnp.uint8), gray,
                             vmap_method="broadcast_all")


def program_copy(modules, fn, *args, cv2_stage: bool = True, **static):
    """tpuimage's jitted ``fn`` run as a fresh program (``jax.jit`` of its
    ``__wrapped__`` with ``static`` bound) whose CLAHE stage is cv2's, or,
    with ``cv2_stage=False``, tpuimage's own (the copy a test first checks
    equal to tpuimage's output). ``modules``: the tpuimage modules whose
    ``clahe`` the program calls, replaced while it is traced."""
    body = getattr(fn, "__wrapped__", fn)
    saved = [m.clahe for m in modules]
    try:
        for m in modules:
            m.clahe = cv2_clahe if cv2_stage else m.clahe
        out = jax.jit(functools.partial(body, **static))(*args)
    finally:
        for m, c in zip(modules, saved):
            m.clahe = c
    return jax.tree_util.tree_map(np.asarray, out)
