"""Op layer on (..., H, W) tensors: the counterparts of ``tpuimage.ops``
on DocScanner's serving path. Leading dims are a batch; every op keeps
tpuimage's per-image semantics on each (H, W) plane."""
