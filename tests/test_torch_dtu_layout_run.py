"""The port's on-disk DTU-layout program (`densepoints_tpu_torch.scripts.
dtu_layout_run`) against the JAX package, on the CPU at a tiny size.

The tree the port's program writes is read back through the JAX package's
`dtu_to_scene_json` and `load_scene`: the same projection matrices (1e-9)
and images (exact). The JAX `densify` then runs on that scene with the
program's config dict; the two runs agree in final patch count within 5%
and in the median exact distance to the sphere within 10% (batch shapes
round the Nelder-Mead objective, ROADMAP C).
"""
import jax.numpy as jnp  # noqa: F401  (keeps jax on the CPU backend here)
import numpy as np
import pytest

from densepoints_tpu.config import load_config as jax_load_config
from densepoints_tpu.io.datasets import dtu_to_scene_json as jax_dtu_json
from densepoints_tpu.io.scene import load_scene as jax_load_scene
from densepoints_tpu.io.scene import read_scene_json as jax_read_scene_json
from densepoints_tpu.pmvs.pipeline import densify as jax_densify
from densepoints_tpu_torch.io.scene import load_scene
from densepoints_tpu_torch.scripts import dtu_layout_run
from tests import torch_port_util  # noqa: F401  (torch threads)

COUNT_RTOL = 0.05  # final patches, port vs JAX
EXACT_MEDIAN_RTOL = 0.10  # median | |p| - r |, port vs JAX

# 9 views of 240 x 180 with the sphere ~90 px across, nuisances on: 2
# rounds give ~360 final patches in both packages.
TINY = ("--device cpu --views 9 --width 240 --height 180 --focal 1000 "
        "--kp 512 --max-rounds 2 --expand-nm-iters 20").split()


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The program at the tiny size with its tree and checkpoints kept;
    returns (args, scene generator, images before the PNGs, artifact)."""
    layout = tmp_path_factory.mktemp("layout")
    ckpt = tmp_path_factory.mktemp("ckpt")
    args = dtu_layout_run.parse_args(
        TINY + ["--layout-dir", str(layout), "--checkpoint-dir", str(ckpt)])
    scene_gen, images = dtu_layout_run.make_images(args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dtu_layout_run, "make_images",
                   lambda args: (scene_gen, images.copy()))
        artifact = dtu_layout_run.run(args)
    return args, scene_gen, images, artifact


def test_tree_reads_back_through_jax(port_run, tmp_path):
    args, scene_gen, images, _ = port_run
    root = args.layout_dir
    path = jax_dtu_json(f"{root}/Calibration", f"{root}/Rectified",
                        tmp_path / "scene.json")
    np.testing.assert_allclose(
        jax_read_scene_json(path).projection_matrices, scene_gen.P,
        rtol=0, atol=1e-9 * np.abs(scene_gen.P).max())
    want = jax_load_scene(path)
    got = load_scene(f"{root}/scene.json", device="cpu")
    np.testing.assert_array_equal(got.cameras.P.numpy(),
                                  np.asarray(want.cameras.P))
    pixels = np.clip(images, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(want.images), pixels)
    np.testing.assert_array_equal(got.images, np.asarray(want.images))
    np.testing.assert_array_equal(got.colors, np.asarray(want.colors))


def test_dtu_layout_run_matches_jax(port_run):
    args, _, _, artifact = port_run
    root = args.layout_dir
    want = jax_densify(jax_load_scene(f"{root}/scene.json"),
                       jax_load_config(dtu_layout_run.config_dict(args)))
    n_jax, n_port = want.patches.capacity, artifact["patches"]
    med_jax = float(np.median(np.abs(
        np.linalg.norm(want.positions, axis=1) - args.radius)))
    med_port = artifact["quality_mm"]["accuracy_exact_median"]
    print(f"final patches: jax {n_jax}, port {n_port}; exact median: jax "
          f"{med_jax:.4f}, port {med_port:.4f}")
    assert n_jax >= 200
    assert abs(n_port - n_jax) <= COUNT_RTOL * n_jax
    assert abs(med_port - med_jax) <= EXACT_MEDIAN_RTOL * med_jax
    assert artifact["scene"]["nuisances"] == dtu_layout_run.NUISANCES
    assert artifact["counters"]["patches_final"] == n_port
    assert "color" in artifact["stage_seconds"]
