"""Host-side image I/O (counterpart of ``tpuimage.io``)."""
