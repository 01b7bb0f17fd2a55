"""tpuimage_torch — the PyTorch + CUDA port of tpuimage.

The layout mirrors ``tpuimage`` so each module's counterpart is easy to
find:

  core/       uint8 storage, f32/i32 compute, OpenCV-exact rounding,
              saturation and border padding
  ops/        the op layer on (..., H, W) tensors with leading batch dims;
              ``ops.kernels`` builds and binds the hand-written CUDA
              kernels in ``csrc/``
  pipelines/  DocScanner, night, morph_seq, landscape, face and the
              notebook's shadow enhancement, modules 1-7 and document
              restoration
  presets/    the preset databases' loaders and appliers
  detect/     the host's contours and Haar cascades (``native/`` in C++)
  classify/   the heuristic scene classifiers, CLIP ViT-B/32 zero-shot
              and the label router over the four enhancement pipelines
  convert     the state carried across from tpuimage (config, tables,
              CLIP weights, presets)
  synth       seeded numpy generators of test images and CLIP weights

The package imports ``torch`` and never ``jax``. On a CPU tensor every
kernel wrapper takes its plain PyTorch version; on a CUDA tensor it
launches the kernel built from ``csrc/`` or raises.
"""

__version__ = "0.1.0"
