from densepoints_tpu_torch.ba.ba import (
    BAProblem,
    reprojection_rmse,
    rodrigues,
    run_ba,
    run_ba_sharded,
)
