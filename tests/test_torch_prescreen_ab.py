"""The port's pre-screen A/B (`densepoints_tpu_torch.scripts.prescreen_ab`)
against the JAX package, on the CPU at a tiny size.

The JAX program's `main` is never called: it writes into the repo's root.
Per mode, both packages run what the programs run for their warm run
(seeds moved by 1e-4 -> NCC filter -> compaction -> Nelder-Mead ->
`_densify_from` from `seeds_optimized`; the port's
`prescreen_ab.densify_from_seeds`) on the same small sphere, seeds and
config dict; the port's `run` is held to its record's form.

Tolerance: per mode, the patches after expansion and the final patches
agree within 5% (batch shapes round the Nelder-Mead objective, ROADMAP
C, so clouds are not compared point for point).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densepoints_tpu.config import load_config as jax_load_config
from densepoints_tpu.core.cameras import Cameras as JaxCameras
from densepoints_tpu.io.scene import Scene as JaxScene
from densepoints_tpu.pmvs.optimize import (
    filter_by_error as jax_filter_by_error,
    optimize_patches as jax_optimize_patches,
)
from densepoints_tpu.pmvs.pipeline import _densify_from as jax_densify_from
from densepoints_tpu.pmvs.seed import (
    create_patches_from_points as jax_create_patches,
)
from densepoints_tpu.utils import StageMetrics as JaxStageMetrics
from densepoints_tpu_torch.config import load_config
from densepoints_tpu_torch.core.cameras import Cameras
from densepoints_tpu_torch.io.scene import Scene
from densepoints_tpu_torch.scripts import _rigs, prescreen_ab
from tests import torch_port_util  # noqa: F401  (torch threads)

COUNT_RTOL = 0.05  # patches after expansion and final, port vs JAX

# 12 views of 256 x 192 at half the bench focal length, 1 round: a few
# hundred patches per mode, the pre-screen dropping some candidates.
TINY_CONFIG = {"seeds": 500, "views": 12, "width": 256, "height": 192,
               "focal": 225, "tex_size": 512, "max_rounds": 1,
               "nm_iters": 15, "expand_nm_iters": 10}
TINY = ["--device", "cpu", "--config", json.dumps(TINY_CONFIG)]


@pytest.fixture(scope="module")
def scene():
    c = prescreen_ab.parse_args(TINY).config
    return c, *_rigs.sphere_scene(
        num_views=c["views"], width=c["width"], height=c["height"],
        focal=c["focal"], tex_size=c["tex_size"])


def jax_warm_run(c, sc, images, mode):
    """The JAX program's warm run of `mode`: (after expand, final)."""
    cfg = jax_load_config(prescreen_ab.config_dict(c, mode))
    cams = JaxCameras.from_projection_matrices(sc.P, widths=sc.width,
                                               heights=sc.height)
    scene = JaxScene(cameras=cams, images=images, colors=None)
    dimages = jnp.asarray(images)
    seeds = _rigs.sphere_seeds(c["seeds"]) + 1e-4
    st = jax_create_patches(cams, seeds, cfg.optimize, cfg.seed)
    st = jax_filter_by_error(dimages, cams, st, cfg.seed.texture_size,
                             cfg.optimize).compact()
    st = jax_optimize_patches(dimages, cams, st, cfg.seed.texture_size,
                              cfg.optimize)
    metrics = JaxStageMetrics()
    res = jax_densify_from(dimages, cams, scene, cfg, metrics, st,
                           "seeds_optimized")
    return (int(metrics.counters["patches_after_expand"]),
            res.patches.capacity)


@pytest.mark.parametrize("mode", prescreen_ab.MODES)
def test_mode_counts_match_jax(scene, mode):
    c, sc, images = scene
    cams = Cameras.from_projection_matrices(sc.P, sc.width, sc.height)
    res, metrics = prescreen_ab.densify_from_seeds(
        torch.as_tensor(images), cams, Scene(cameras=cams, images=images),
        load_config(prescreen_ab.config_dict(c, mode)),
        _rigs.sphere_seeds(c["seeds"]) + 1e-4)
    got = (int(metrics.counters["patches_after_expand"]),
           res.patches.capacity)
    after, final = jax_warm_run(c, sc, images, mode)
    assert final > 50
    assert abs(got[0] - after) <= COUNT_RTOL * after, (got, after)
    assert abs(got[1] - final) <= COUNT_RTOL * final, (got, final)


def test_record(scene, monkeypatch):
    """`run` goes through every mode, twice, and records each."""
    _, sc, images = scene
    monkeypatch.setattr(_rigs, "sphere_scene", lambda **kw: (sc, images))
    record = prescreen_ab.run(prescreen_ab.parse_args(
        ["--device", "cpu", "--config",
         json.dumps({**TINY_CONFIG, "seeds": 60, "max_rounds": 1})]))
    modes = record["modes"]
    assert list(modes) == list(prescreen_ab.MODES)
    # The pre-screen only drops candidates: no mode expands further than
    # `off`.
    assert modes["claim"]["patches_after_expand"] <= \
        modes["off"]["patches_after_expand"]
    assert modes["free"]["patches_after_expand"] <= \
        modes["off"]["patches_after_expand"]
    for entry in modes.values():
        for key in ("densify_seconds_cold", "densify_seconds_warm",
                    "e2e_patches_per_sec"):
            assert np.isfinite(entry[key]) and entry[key] > 0
        assert set(entry["stage_seconds"]) >= {"expand", "filter"}
        assert entry["allview_ncc_launches"] == 0  # the CPU: plain calls
    assert record["plain_calls"] > 0 and record["device"] == "cpu"
    json.dumps(record)  # a JSON record
