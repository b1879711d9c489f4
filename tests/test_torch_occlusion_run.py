"""The port's occlusion program (`densepoints_tpu_torch.scripts.
occlusion_run`) against the JAX package, on the CPU at a tiny size.

The JAX `densify` runs on the tree the port's program wrote, with the
program's config dict; the runs agree in final patch count within 5% and
in the median exact distance to the surface union within 10% (batch
shapes round the Nelder-Mead objective, ROADMAP C). The forensics' kill
and keep masks on the run's `expanded.npz`, and on that state with
floaters added in front of some patches, equal those of the JAX
package's `filter_occlusion` exactly.
"""
import jax.numpy as jnp  # noqa: F401  (keeps jax on the CPU backend here)
import numpy as np
import pytest

from densepoints_tpu.config import load_config as jax_load_config
from densepoints_tpu.io.scene import load_scene as jax_load_scene
from densepoints_tpu.pmvs.filter import filter_occlusion as jax_filter_occ
from densepoints_tpu.pmvs.pipeline import densify as jax_densify
from densepoints_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
)
from densepoints_tpu_torch.config import load_config
from densepoints_tpu_torch.interop import patch_state_from_numpy
from densepoints_tpu_torch.io.scene import load_scene
from densepoints_tpu_torch.scripts import occlusion_run
from densepoints_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from tests import torch_port_util  # noqa: F401  (torch threads)

COUNT_RTOL = 0.05  # final patches, port vs JAX
EXACT_MEDIAN_RTOL = 0.10  # median distance to the union, port vs JAX

# 9 views of 400 x 300 (the scene's focal is fixed at 1450 px): 2 rounds
# give ~830 final patches in both packages.
TINY = ("--device cpu --views 9 --width 400 --height 300 --kp 1024 "
        "--max-rounds 2").split()


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The program at the tiny size with its tree and checkpoints kept;
    returns (args, scene generator, artifact)."""
    layout = tmp_path_factory.mktemp("layout")
    ckpt = tmp_path_factory.mktemp("ckpt")
    args = occlusion_run.parse_args(
        TINY + ["--layout-dir", str(layout), "--checkpoint-dir", str(ckpt)])
    sc, images = occlusion_run.make_images(args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(occlusion_run, "make_images",
                   lambda args: (sc, images.copy()))
        artifact = occlusion_run.run(args)
    return args, sc, artifact


def test_occlusion_run_matches_jax(port_run):
    args, sc, artifact = port_run
    want = jax_densify(jax_load_scene(f"{args.layout_dir}/scene.json"),
                       jax_load_config(occlusion_run.config_dict(args)))
    n_jax, n_port = want.patches.capacity, artifact["patches"]
    med_jax = float(np.median(sc.distance_to_surface(want.positions)))
    med_port = artifact["quality_mm"]["accuracy_exact_median"]
    print(f"final patches: jax {n_jax}, port {n_port}; exact median: jax "
          f"{med_jax:.4f}, port {med_port:.4f}")
    assert n_jax >= 400
    assert abs(n_port - n_jax) <= COUNT_RTOL * n_jax
    assert abs(med_port - med_jax) <= EXACT_MEDIAN_RTOL * med_jax
    forensics = artifact["occlusion_filter"]
    assert forensics["expanded_patches"] == artifact["counters"][
        "patches_after_expand"]
    assert (forensics["killed"]["count"] + forensics["kept"]["count"]
            == forensics["expanded_patches"])


def _with_floaters(path, out, cameras_C):
    """The checkpoint at `path` plus, for every third alive patch, a copy
    moved a tenth of the way toward its reference camera: it hides its
    original in the views both claim."""
    state, meta, cams = load_checkpoint(path, device="cpu")
    alive = np.nonzero(state.alive.numpy())[0][::3]
    pos = state.position.numpy()
    ref = state.ref.numpy()
    moved = pos[alive] + 0.1 * (cameras_C[ref[alive]] - pos[alive])

    def cat(a, extra):
        return np.concatenate([a, extra])

    fields = {f: getattr(state, f).numpy() for f in
              ("position", "normal", "ref", "vis", "cand", "alive", "color")}
    fields["position"] = cat(fields["position"], moved.astype(np.float32))
    for f in ("normal", "ref", "vis", "cand", "alive", "color"):
        fields[f] = cat(fields[f], fields[f][alive])
    save_checkpoint(out, patch_state_from_numpy(**fields), stage="expanded",
                    cameras=cams)
    return out


@pytest.mark.parametrize("floaters", [False, True])
def test_forensics_masks_match_jax_filter(port_run, tmp_path, floaters):
    args, sc, _ = port_run
    path = f"{args.checkpoint_dir}/expanded.npz"
    scene = load_scene(f"{args.layout_dir}/scene.json", device="cpu")
    if floaters:
        path = _with_floaters(path, tmp_path / "floaters.npz",
                              scene.cameras.C.numpy())
    config = load_config({**occlusion_run.config_dict(args)})
    state, _, _ = load_checkpoint(path, device="cpu")
    alive, killed, kept = occlusion_run.occlusion_kills(
        scene.cameras, state, config)

    jscene = jax_load_scene(f"{args.layout_dir}/scene.json")
    jstate, _, _ = jax_load_checkpoint(path)
    jcfg = jax_load_config(occlusion_run.config_dict(args))
    filtered = jax_filter_occ(
        jscene.cameras, jstate, grid_scale=jcfg.organizer.grid_scale,
        occlusion_slack=jcfg.filter.occlusion_slack,
        min_visible_views=jcfg.optimize.min_visible_views)
    j_alive = np.asarray(jstate.alive)
    j_survives = np.asarray(filtered.alive)
    np.testing.assert_array_equal(alive, j_alive)
    np.testing.assert_array_equal(killed, j_alive & ~j_survives)
    np.testing.assert_array_equal(kept, j_alive & j_survives)
    if floaters:
        assert killed.sum() > 0

    got = occlusion_run.occlusion_forensics(
        sc, scene.cameras, path, config, args.threshold_mm, "cpu")
    assert got["expanded_patches"] == int(j_alive.sum())
    assert got["killed"]["count"] == int((j_alive & ~j_survives).sum())
    assert got["kept"]["count"] == int((j_alive & j_survives).sum())
