"""tpuimage_torch — the PyTorch + CUDA port of tpuimage.

The layout mirrors ``tpuimage`` so each module's counterpart is easy to
find:

  core/       uint8 storage, f32/i32 compute, OpenCV-exact rounding,
              saturation and border padding
  ops/        the op layer on (..., H, W) tensors with leading batch dims;
              ``ops.kernels`` builds and binds the hand-written CUDA
              kernels in ``csrc/``
  pipelines/  DocScanner's serving path (``pipelines.docscan.scan_batch``)
  convert     the state carried across from tpuimage (config + tables)
  synth       seeded numpy generator of document photos

The package imports ``torch`` and never ``jax``. On a CPU tensor every
kernel wrapper takes its plain PyTorch version; on a CUDA tensor it
launches the kernel built from ``csrc/`` or raises.
"""

__version__ = "0.1.0"
