"""Several ranks on torch.distributed (port of `st_dadk_tpu/parallel/`):
rank meshes, the data-parallel step, processes of a cluster, and tensor
parallelism over the basis axis."""
from st_dadk_tpu_torch.parallel.mesh import (  # noqa: F401
    lane_sharding, make_mesh, replicated)
from st_dadk_tpu_torch.parallel.data_parallel import (  # noqa: F401
    make_dp_train_step)
from st_dadk_tpu_torch.parallel.multihost import (  # noqa: F401
    experiment_mesh_auto,
    hybrid_mesh,
    maybe_initialize_distributed,
    process_lane_slice,
    shard_lanes_multihost,
)
