"""Runtime services (counterpart of ``tpuimage.runtime``): ``profiling``
(sync, spans recorded while a profiler runs, counters, throughput
counters, a profiler trace),
``health`` (a device claim with a deadline), ``cache`` (where the
compiled libraries are kept), ``mesh`` (the single-controller device
mesh: batch sharding, halo exchange and collectives over shard lists) and
``spatial`` (night and DocScanner's post-warp stages H-sharded over a
mesh, with global statistics)."""
from tpuimage_torch.runtime.mesh import (  # noqa: F401
    Mesh, make_mesh, shard_batch, pad_to_multiple, run_data_parallel, halo_exchange,
    spatial_map, dp_spatial_map,
)
from tpuimage_torch.runtime.profiling import (  # noqa: F401
    Throughput, sync, trace_annotation,
)
