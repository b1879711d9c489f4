"""Debug dumps of the port against the JAX package's on the same inputs:
every PNG pixel-equal, every PLY byte-equal. The port's dumps take tensors
(the pipeline's state) as well as numpy arrays."""
import numpy as np
import pytest
import torch
from PIL import Image

from densepoints_tpu.pmvs.patch import PatchState as JaxPatchState
from densepoints_tpu.utils import debug as jax_debug
from densepoints_tpu_torch.pmvs.organizer import OccupancyGrids
from densepoints_tpu_torch.utils import debug
from tests.torch_port_util import torch_state


def _same_files(got_dir, want_dir):
    got = sorted(p.relative_to(got_dir) for p in got_dir.rglob("*.*"))
    want = sorted(p.relative_to(want_dir) for p in want_dir.rglob("*.*"))
    assert got == want and got
    for rel in got:
        if rel.suffix == ".png":
            np.testing.assert_array_equal(
                np.asarray(Image.open(got_dir / rel)),
                np.asarray(Image.open(want_dir / rel)),
            )
        else:
            assert (got_dir / rel).read_bytes() == (want_dir / rel).read_bytes()
    return got


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_dump_keypoints_and_matches(tmp_path, rng, as_tensor):
    images = rng.uniform(0, 255, (2, 40, 60)).astype(np.float32)
    xy = rng.uniform(5, 35, (2, 10, 2)).astype(np.float32)
    valid = np.ones((2, 10), bool)
    valid[1, 3] = False
    matches = np.full((1, 10), -1, np.int32)
    matches[0, :5] = np.arange(5)
    wrap = torch.as_tensor if as_tensor else (lambda a: a)
    debug.dump_keypoints(tmp_path / "got", wrap(images), wrap(xy),
                         wrap(valid))
    debug.dump_matches(tmp_path / "got", wrap(images), wrap(xy),
                       wrap(np.array([[0, 1]])), wrap(matches))
    jax_debug.dump_keypoints(tmp_path / "want", images, xy, valid)
    jax_debug.dump_matches(tmp_path / "want", images, xy, [[0, 1]], matches)
    names = {p.name for p in _same_files(tmp_path / "got", tmp_path / "want")}
    assert {"kp_0.png", "kp_1.png", "matches_0_1.png"} == names


@pytest.mark.parametrize("slots", [1, 3])
def test_dump_occupancy_and_cloud(tmp_path, rng, slots):
    shape = (2, 8, 10) + ((slots,) if slots > 1 else ())
    cells = rng.integers(-1, 5, shape)

    class JaxGrids:  # the JAX package's grids hold int32 patch ids
        pass

    JaxGrids.cells = cells.astype(np.int32)
    grids = OccupancyGrids(cells=torch.as_tensor(cells),
                           cols=torch.full((2,), 10), rows=torch.full((2,), 8))
    debug.dump_occupancy(tmp_path / "got", grids)
    jax_debug.dump_occupancy(tmp_path / "want", JaxGrids)

    jstate = JaxPatchState.create(
        rng.standard_normal((6, 3)).astype(np.float32),
        rng.standard_normal((6, 3)).astype(np.float32),
        np.zeros(6, np.int32),
        np.ones((6, 3), bool),
        alive=np.array([1, 0, 1, 1, 0, 1], bool),
        color=rng.uniform(-20, 300, (6, 3)).astype(np.float32),
    )
    debug.dump_cloud(tmp_path / "got", "after_expand", torch_state(jstate))
    jax_debug.dump_cloud(tmp_path / "want", "after_expand", jstate)
    names = {str(p) for p in _same_files(tmp_path / "got", tmp_path / "want")}
    assert {"view_0.png", "view_1.png", "points/after_expand.ply"} == names


def test_dump_textures(tmp_path, rng):
    tex = rng.uniform(-10, 270, (70, 3, 11, 11)).astype(np.float32)
    valid = np.ones((70, 3), bool)
    debug.dump_textures(tmp_path / "got", torch.as_tensor(tex), valid)
    jax_debug.dump_textures(tmp_path / "want", tex, valid)
    assert len(_same_files(tmp_path / "got", tmp_path / "want")) == 64
