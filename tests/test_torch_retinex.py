"""The Retinex's logarithm and the DOCUMENT preset on whole images, against
tpuimage (JAX on the CPU).

tpuimage's ``single_scale_retinex`` takes ``log(I + 1)`` and ``log(blur +
1)`` in f32 inside a jitted program, where XLA's CPU compiler evaluates
Cephes' logf polynomial, not the correctly rounded log (they differ on
5.8% of the f32 values the Retinex meets). The port's ``_log_f32`` is that
polynomial, with XLA's fused multiply-adds (the form XLA emits for an
x86-64 CPU with FMA; it is in ``tpuimage_torch/ops/restore.py``). It is held
on every f32 of the Retinex's domain, [1, 257], and DOCUMENT whole
(Retinex, blend, stretch, unsharp, final blend) exact on the A4 page
``outputs/scan_03_warped.png`` and a 251x377 crop of
``outputs/scan_02_quad.png``, where the correctly rounded log gave max
|diff| 4 and 5.
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from tpuimage.ops import restore as jrestore
from tpuimage.pipelines import shadow as jshadow

from tpuimage_torch.io import imageio
from tpuimage_torch.ops import restore
from tpuimage_torch.pipelines import shadow

torch.set_num_threads(1)


def test_log_on_every_f32_of_the_retinex_domain():
    lo, hi = np.float32(1.0).view(np.uint32), np.float32(257.0).view(np.uint32)
    jlog = jax.jit(jnp.log)
    step = 1 << 24
    for start in range(int(lo), int(hi) + 1, step):
        x = np.arange(start, min(start + step, int(hi) + 1), dtype=np.uint32).view(np.float32)
        np.testing.assert_array_equal(restore._log_f32(torch.from_numpy(x)).numpy(),
                                      np.asarray(jlog(jnp.asarray(x))), err_msg=str(start))


def test_document_exact_on_the_page_and_the_crop():
    page = imageio.load_image_rgb("outputs/scan_03_warped.png")
    crop = imageio.load_image_rgb("outputs/scan_02_quad.png")[3:3 + 251, 5:5 + 377]
    for x in (page, crop):
        ref = jshadow.enhance_shadow_protected(jnp.asarray(x), jshadow.PRESETS["DOCUMENT"])[0]
        ours = shadow.enhance_shadow_protected(x, shadow.PRESETS["DOCUMENT"], device="cpu")[0]
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    small = page[37:37 + 301, 11:11 + 253]
    for x in (crop, small):
        np.testing.assert_array_equal(
            restore.single_scale_retinex(torch.from_numpy(np.array(x)), 80.0).numpy(),
            np.asarray(jax.jit(jrestore.single_scale_retinex, static_argnums=1)(
                jnp.asarray(x), 80.0)))
