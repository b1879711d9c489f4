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
                       (`ops.window_textures`);
  expand_profile       one expansion round of the bench sphere, phase by
                       phase;
  kernel_bench         the slot kernel alone against the scoring pass
                       around it;
  kernel_paged_bench   the all-views pass against the chunked pass;
  kernel_roofline      the all-views and slot kernels against their bounds;
  prescreen_ab         the expansion pre-screen's three modes end to end;
  scaling_overhead     the multi-process driver's overhead per round and
                       the efficiency model built on it;
  scaling_measure      jobs of 1, 2 and 4 `scaling_worker` processes on a
                       fixed device total;
  scaling_bench        the distributed refine step's throughput at N ranks;
  bench                refine throughput, one all-views pass against its
                       bound, and end-to-end densification of the bench
                       sphere, each with its spread over several runs.

The end-to-end, profile, pre-screen, scaling and bench programs run on a CUDA
card unless given `--device cpu`; the kernel-timing programs (the two
ablation programs, `kernel_bench`, `kernel_paged_bench`,
`kernel_roofline`) have no CPU mode. A program writes its record only to
`--out`, and its scratch to a fresh temporary directory unless told
otherwise.
"""
