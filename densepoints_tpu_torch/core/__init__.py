from densepoints_tpu_torch.core.cameras import (
    Cameras,
    decompose_projection_matrix,
    is_inside,
    project_point_all_views,
    project_points,
)
from densepoints_tpu_torch.core.scores import NCC_MIN_DENOM, ncc_score
