"""Device meshes: data, explicit-collective, tensor and pipeline
parallelism on `torch.distributed` (the JAX package's `parallel/`).

`mesh` and `collectives` import nothing of the models; `shard_map_step`
and `pipeline` are imported on first use, since the models themselves
import `collectives`."""

from differential_equations_resnet_tpu_torch import lazy_names
from differential_equations_resnet_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    create_mesh,
    initialize_multihost,
    local_batch_slice,
    replicated_sharding,
    shard_batch,
    shard_params,
)

_LAZY = {
    "make_shard_map_train_step": "shard_map_step",
    "pipeline_blocks_apply": "pipeline",
    "pipeline_scan": "pipeline",
}

__getattr__ = lazy_names(__name__, _LAZY)
