from densepoints_tpu_torch.surface.tsdf import (
    extract_surface,
    fuse_tsdf,
    marching_tetrahedra,
)
