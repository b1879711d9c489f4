"""densepoints-tpu on PyTorch and CUDA: the PMVS densification pipeline
(seed -> optimize -> expand -> filter -> export) for NVIDIA GPUs.

The package mirrors the layout and function names of the JAX package
`densepoints_tpu`, which stays the numerical reference:

  core/       batched cameras, photometric scores, grid cells
  geometry/   fundamental matrices, epipolar lines, masked DLT
              triangulation, homographies
  ops/        warp/sampling, the warp+NCC scoring passes (CUDA kernels on
              the GPU, plain torch on the CPU), batched Nelder-Mead
  features/   Harris and FAST detectors, BRIEF descriptors, Hamming and
              epipolar matching, tracks
  scripts/    kernel ablation programs (`python -m`)
  pmvs/       patch state, visibility, optimization, organizer, expansion,
              filtering, the `densify` driver (checkpoint / resume, debug
              dumps, profile trace)
  multiscale/ image pyramids and coarse-to-fine expansion
  ba/         bundle adjustment (Levenberg-Marquardt, Schur-complement CG)
  surface/    TSDF fusion and marching tetrahedra (`--mesh`)
  io/         scene JSON reader, PLY, DTU / COLMAP converters
  utils/      stage metrics, checkpoints, debug dumps, accuracy /
              completeness
  native/     ctypes binding to the C++ host runtime (union-find, PLY),
              built with g++ at first use
  csrc/       CUDA C++ sources, built with nvcc at first use

Tensors live on an explicit `device` (`densify(..., device=...)`,
`load_scene(..., device=...)`, `cli --device`).
"""

import torch as _torch

__version__ = "0.1.0"

# f32 geometry stays f32: projective geometry computed in TF32 (about three
# decimal digits) moves pixel coordinates by whole pixels. Both matmul and
# cuDNN TF32 are turned off at import.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
