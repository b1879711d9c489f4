"""The port's entry points (`densepoints_tpu_torch.entry`) against
the root `__graft_entry__.py` of the JAX package, on the CPU.

  * `_tiny_problem`: the same images and patches bitwise, the same
    cameras within 1e-6 (each package decomposes the same f64 projection
    matrices).
  * `entry()`: one refine step of the tiny problem, the JAX `fn` jitted on
    the conftest's 8-device CPU mesh, the port's eager on the CPU. The
    alive counts and the visibility are equal, the positions agree within
    1e-3 (the port's tolerance after Nelder-Mead: NCC determines a plane
    patch's position weakly, ROADMAP C).
  * `dryrun_multichip(n)` at n = 2 and 8: the JAX dry run on n devices of
    that mesh, the port's on n gloo processes. The printed lines are equal:
    the refined count is the state's capacity and the inserted count is
    integer work decided by global ids, so both are exact.
  * `python -m densepoints_tpu_torch.entry --device cpu` runs both.
"""
import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from densepoints_tpu_torch import entry
from tests import torch_port_util  # noqa: F401  (torch threads)

POSITION_ATOL = 1e-3  # refined positions, port vs JAX
CAMERA_ATOL = 1e-6  # K, E, C and x axes of the two decompositions


def test_tiny_problem_matches_graft_entry():
    j_images, j_cams, j_state = graft._tiny_problem()
    images, cams, state = entry._tiny_problem(device="cpu")
    assert np.array_equal(np.asarray(j_images), images.numpy())
    for name in ("position", "normal", "ref", "vis", "alive"):
        assert np.array_equal(np.asarray(getattr(j_state, name)),
                              getattr(state, name).numpy()), name
    for name in ("P", "K", "E", "C", "x_axis", "width", "height"):
        np.testing.assert_allclose(getattr(cams, name).numpy(),
                                   np.asarray(getattr(j_cams, name)),
                                   atol=CAMERA_ATOL, rtol=0, err_msg=name)


def test_entry_matches_graft_entry():
    j_fn, j_args = graft.entry()
    want = jax.jit(j_fn)(*j_args)
    fn, args = entry.entry("cpu")
    assert all(a.device.type == "cpu" for a in (args[0], args[2].position))
    got = fn(*args)
    assert got.capacity == want.capacity == 16
    assert int(got.alive.sum()) == int(np.asarray(want.alive).sum())
    assert np.array_equal(got.vis.numpy(), np.asarray(want.vis))
    np.testing.assert_allclose(got.position.numpy(),
                               np.asarray(want.position),
                               atol=POSITION_ATOL, rtol=0)
    assert torch.isfinite(got.position).all()


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_matches_graft_entry(n, capsys):
    graft.dryrun_multichip(n)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert want.startswith(f"dryrun_multichip({n}): refined ")
    counts = entry.dryrun_multichip(n, device="cpu")
    assert capsys.readouterr().out.strip().splitlines()[-1] == want
    assert want == (f"dryrun_multichip({n}): refined {counts[0]} patches, "
                    f"{counts[1]} inserted")


def test_main_runs_entry_and_dryrun(capsys):
    assert entry.main(["--device", "cpu", "--ranks", "2"]) == 0
    assert capsys.readouterr().out.splitlines() == [
        "entry(): ok", "dryrun_multichip(2): refined 16 patches, 4 inserted"]


def test_dryrun_refuses_other_devices():
    """The port runs on cuda or cpu; any other device is a `ValueError`
    before a rank starts."""
    with pytest.raises(ValueError):
        entry.dryrun_multichip(2, device="mps")
