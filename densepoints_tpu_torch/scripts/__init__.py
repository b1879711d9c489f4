"""Measurement programs of the port, run with `python -m`:

  kernel_ablate        the window-relative warp + NCC kernel, variant by
                       variant (`ops.window_ncc`);
  kernel_paged_ablate  the centred-texture kernel, variant by variant
                       (`ops.window_textures`).

Both need a CUDA card; they time kernels and have no CPU mode.
"""
