from densepoints_tpu_torch.pmvs.patch import PatchState
from densepoints_tpu_torch.pmvs.visibility import classify_views, compute_color
from densepoints_tpu_torch.pmvs.optimize import (
    filter_by_error,
    optimize_patches,
    parametrize,
    patch_ncc_scores,
    photometric_objective,
    unparametrize,
)
