"""Runtime services of the CLIs (counterpart of ``tpuimage.runtime``):
``profiling`` (sync, trace annotations, throughput counters, a profiler
trace), ``health`` (a device claim with a deadline) and ``cache`` (where
the compiled libraries are kept). ``mesh`` and ``spatial`` are not
ported yet."""
from tpuimage_torch.runtime.profiling import (  # noqa: F401
    Throughput, sync, trace_annotation,
)
