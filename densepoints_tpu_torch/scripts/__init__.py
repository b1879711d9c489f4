"""Programs of the port, run with `python -m`:

  dtu_scale_run        densify a DTU-shaped sphere scene (49 views of
                       1600 x 1200 by default) and grade the cloud;
  dtu_layout_run       the same through an on-disk DTU tree with
                       photometric nuisances;
  occlusion_run        a self-occluding scene through the on-disk path,
                       with the occlusion filter's forensics;
  kernel_ablate        the window-relative warp + NCC kernel, variant by
                       variant (`ops.window_ncc`);
  kernel_paged_ablate  the centred-texture kernel, variant by variant
                       (`ops.window_textures`).

The first three run on a CUDA card unless given `--device cpu`; the two
ablation programs time kernels and have no CPU mode.
"""
