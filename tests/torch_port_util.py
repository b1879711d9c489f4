"""Shared helpers of the PyTorch-port parity tests.

Each test feeds identical numpy state to the JAX package (the reference)
and to `densepoints_tpu_torch`, through `densepoints_tpu_torch.interop`.
"""
import numpy as np
import pytest
import torch

from densepoints_tpu_torch.interop import (
    cameras_from_numpy,
    patch_state_from_numpy,
)

# The tier-1 run puts several test workers on one machine.
torch.set_num_threads(2)


def torch_cameras(jax_cams, device="cpu"):
    """The port's Cameras holding exactly the JAX Cameras' values."""
    return cameras_from_numpy(
        *(np.asarray(getattr(jax_cams, f))
          for f in ("P", "K", "E", "C", "x_axis", "width", "height")),
        device=device,
    )


def torch_state(jax_state, device="cpu"):
    """The port's PatchState holding exactly the JAX PatchState's values."""
    return patch_state_from_numpy(
        *(np.asarray(getattr(jax_state, f))
          for f in ("position", "normal", "ref", "vis", "cand", "alive",
                    "color")),
        device=device,
    )


@pytest.fixture()
def cuda_device():
    """A CUDA device, or skip: kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")
