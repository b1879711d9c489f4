from densepoints_tpu_torch.parallel.mesh import (
    PATCH_AXIS,
    Mesh,
    make_mesh,
    replicate,
    shard_patches,
)
from densepoints_tpu_torch.parallel.distributed import (
    distributed_insert,
    distributed_refine_step,
    pad_views,
    refine_step_impl,
    shard_state,
    viewsharded_insert,
)
from densepoints_tpu_torch.parallel.multihost import (
    densify_multihost,
    global_mesh,
    initialize_multihost,
)
