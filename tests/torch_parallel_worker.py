"""One rank of a `densepoints_tpu_torch.parallel` job on the CPU (gloo).

    python tests/torch_parallel_worker.py TASK RANK WORLD PORT IN.npz OUT.npz

Joins the job at 127.0.0.1:PORT (`initialize_multihost` on the CPU, or
on the device named by the input `device`, with a finite timeout), runs
TASK on the inputs in IN.npz and writes what it got to
OUT.npz (with the rank as a suffix, `OUT.<rank>.npz`). A job of world size
1 is a process group of one rank. Imports the port and `synthetic.py`
only, never JAX: the tests run the JAX side themselves and compare.
One thread per process, so parallel test workers share the machine.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from densepoints_tpu_torch.config import (  # noqa: E402
    MatchingConfig,
    MultiscaleConfig,
    OptimizeConfig,
    OrganizerConfig,
    PipelineConfig,
    RuntimeConfig,
)
from densepoints_tpu_torch.core.cameras import Cameras  # noqa: E402
from densepoints_tpu_torch.interop import (  # noqa: E402
    ba_problem_from_numpy,
    cameras_from_numpy,
    patch_state_from_numpy,
)
from densepoints_tpu_torch.io.scene import Scene  # noqa: E402
from densepoints_tpu_torch.parallel import distributed, mesh as pmesh  # noqa: E402
from densepoints_tpu_torch.pmvs.organizer import (  # noqa: E402
    candidate_cells,
    make_grids,
)

CAM_FIELDS = ("P", "K", "E", "C", "x_axis", "width", "height")
STATE_FIELDS = ("position", "normal", "ref", "vis", "cand", "alive", "color")
BA_FIELDS = ("K", "R0", "C0", "points0", "obs_point", "obs_view", "obs_xy",
             "obs_mask")


def _cams(inp, prefix="cam_"):
    return cameras_from_numpy(*(inp[prefix + f] for f in CAM_FIELDS))


def _state(inp, prefix="st_"):
    return patch_state_from_numpy(*(inp[prefix + f] for f in STATE_FIELDS))


def _state_out(state, prefix):
    return {prefix + f: getattr(state, f).numpy() for f in STATE_FIELDS}


def _gather_grid(mesh, local):
    return pmesh.all_gather(mesh, local.cells).numpy()


def task_insert(mesh, inp):
    """distributed_insert, viewsharded_insert (K = 1 and 2, twice, the
    second round against the filled grids) and pad_views."""
    cams = _cams(inp)
    state = _state(inp)
    scale, min_grids = int(inp["grid_scale"]), int(inp["min_grids"])
    ids = torch.as_tensor(inp["ids"])
    out = {}
    grids = make_grids(cams, scale)
    acc, g = distributed.distributed_insert(
        mesh, grids, cams, state, ids,
        OrganizerConfig(grid_scale=scale, min_grids_to_accept=min_grids))
    out["dist_accepted"], out["dist_cells"] = acc.numpy(), g.cells.numpy()
    for K in (1, 2):
        grids = make_grids(cams, scale, K)
        gpad = distributed.pad_views(grids, mesh.world_size)
        out[f"pad_cols_K{K}"] = gpad.cols.numpy()
        out[f"pad_rows_K{K}"] = gpad.rows.numpy()
        cells = candidate_cells(grids, cams, state.position, state.vis,
                                scale)
        Vp = gpad.cells.shape[0]
        cells = torch.nn.functional.pad(cells, (0, Vp - cells.shape[1]),
                                        value=-1)
        local = distributed.shard_views(mesh, gpad)
        for r in (0, 1):
            acc, local = distributed.viewsharded_insert(
                mesh, local, cells, state.alive, ids + 1000 * r, min_grids)
            out[f"vs_accepted_K{K}_r{r}"] = acc.numpy()
            out[f"vs_cells_K{K}_r{r}"] = _gather_grid(mesh, local)
    return out


def task_refine(mesh, inp):
    """refine_step_impl and distributed_refine_step over the mesh."""
    cams, state = _cams(inp), _state(inp)
    images = torch.as_tensor(inp["images"])
    k = int(inp["texture_size"])
    cfg = OptimizeConfig(max_iterations=int(inp["max_iterations"]),
                         max_refine_batch=int(inp["max_refine_batch"]))
    a = distributed.refine_step_impl(images, cams, state, k, cfg, mesh=mesh)
    b = distributed.distributed_refine_step(images, cams, state, k, cfg,
                                            mesh=mesh)
    return {**_state_out(a, "impl_"), **_state_out(b, "step_")}


def task_nelder_mead(mesh, inp):
    """Nelder-Mead over this rank's rows of a batch of shifted quadratics
    whose lanes converge at different iterations; returns the mesh's
    collective calls inside the solve and the steps this rank ran."""
    from densepoints_tpu_torch.ops import simplex
    from densepoints_tpu_torch.ops.simplex import nelder_mead

    x0 = pmesh.shard_patches(mesh, torch.as_tensor(inp["x0"]))
    c = pmesh.shard_patches(mesh, torch.as_tensor(inp["centres"]))
    w = pmesh.shard_patches(mesh, torch.as_tensor(inp["weights"]))

    def f(x):
        return (w[:, None, :] * (x - c[:, None, :]) ** 2).sum(-1)

    calls, steps = mesh.traffic.calls, simplex.STEPS
    x, fb, iters = nelder_mead(f, x0, torch.full((x0.shape[1],), 0.3),
                               max_iterations=int(inp["max_iterations"]),
                               tolerance=1e-6, mesh=mesh)
    collectives = np.int64(mesh.traffic.calls - calls)
    steps = np.int64(simplex.STEPS - steps)
    return {"x": pmesh.all_gather(mesh, x).numpy(),
            "f": pmesh.all_gather(mesh, fb).numpy(),
            "iters": pmesh.all_gather(mesh, iters).numpy(),
            "collectives": collectives, "steps": steps}


def task_ba(mesh, inp):
    from densepoints_tpu_torch.ba import reprojection_rmse, run_ba_sharded

    problem = ba_problem_from_numpy(*(inp["ba_" + f] for f in BA_FIELDS))
    R, C, pts, cost = run_ba_sharded(
        problem, mesh, max_outer_iterations=int(inp["outer"]),
        cg_iterations=int(inp["cg"]))
    return {"R": R.numpy(), "C": C.numpy(), "points": pts.numpy(),
            "cost": cost.numpy(),
            "rmse": reprojection_rmse(problem, R, C, pts).numpy()}


def task_seed(mesh, inp):
    """The view-sharded front end and seed points, beside the unsharded
    ones of the same process."""
    from densepoints_tpu_torch.pmvs import seed

    cams = _cams(inp)
    images = torch.as_tensor(inp["images"])
    cfg = MatchingConfig(max_keypoints_per_view=int(inp["max_keypoints"]),
                         matcher=str(inp["matcher"]))
    xy, resp, valid, desc, shapes = seed._viewsharded_features(mesh, images,
                                                               cfg)
    points, _, _ = seed.generate_seed_points(images, cams, cfg, mesh=mesh)
    ref_xy, ref_resp, ref_valid = seed._detect(images, cfg)
    ref_points, _, _ = seed.generate_seed_points(images, cams, cfg)
    out = {"xy": xy.numpy(), "resp": resp.numpy(), "valid": valid.numpy(),
           "block_shape": np.asarray(shapes[0]), "points": points,
           "ref_xy": ref_xy.numpy(), "ref_resp": ref_resp.numpy(),
           "ref_valid": ref_valid.numpy(), "ref_points": ref_points}
    if desc is not None:
        out["desc"] = desc.numpy()
        out["ref_desc"] = seed._describe(images, ref_xy, cfg).numpy()
    return out


def plane_scene():
    """The JAX package's multi-host test scene: 5 views of 160 x 120 of
    the textured plane and 40 seed points on it (tests/parallel/
    multihost_worker.py), in the same order of draws."""
    from synthetic import TexturedPlaneScene

    rng = np.random.default_rng(0)
    sc = TexturedPlaneScene(rng, num_views=5, width=160, height=120)
    cams = Cameras.from_projection_matrices(sc.P, widths=sc.width,
                                            heights=sc.height)
    scene = Scene(cameras=cams, images=sc.render_all(), colors=None)
    xy = rng.uniform(-0.6, 0.6, (40, 2))
    pts = np.concatenate([xy, np.zeros((40, 1))], 1).astype(np.float32)
    return scene, pts


def _config(inp):
    cfg = PipelineConfig()
    return dataclasses.replace(
        cfg,
        optimize=dataclasses.replace(
            cfg.optimize, max_iterations=int(inp["max_iterations"])),
        expand=dataclasses.replace(cfg.expand,
                                   max_rounds=int(inp["max_rounds"])),
        multiscale=MultiscaleConfig(levels=int(inp.get("levels", 1))),
        runtime=RuntimeConfig(
            checkpoint_dir=str(inp.get("checkpoint_dir", "")),
            resume=bool(inp.get("resume", False))),
    )


def _cloud(res):
    return {"position": res.patches.position.cpu().numpy(),
            "normal": res.patches.normal.cpu().numpy(),
            "vis": res.patches.vis.cpu().numpy(),
            **{"counter_" + k: np.float64(v)
               for k, v in res.metrics.counters.items()}}


def task_multihost(mesh, inp):
    from densepoints_tpu_torch.parallel.multihost import densify_multihost

    scene, pts = plane_scene()
    return _cloud(densify_multihost(scene, _config(inp), mesh=mesh,
                                    seed_points=pts))


def task_multihost_traced(mesh, inp):
    """`task_multihost` under `torch.profiler` (host activity): the cloud,
    the counters and the program's spans as (names, starts, ends)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = task_multihost(mesh, inp)
    spans = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
             for ev in prof.profiler.kineto_results.events()
             if re.match(r"(stage|expand|nm)/", ev.name())]
    out["span_names"] = np.asarray([s[0] for s in spans])
    out["span_bounds"] = np.asarray([s[1:] for s in spans], np.int64)
    return out


def task_densify_distributed(mesh, inp):
    """`densify_distributed` on the plane scene, seeds from its own front
    end."""
    from densepoints_tpu_torch.parallel.pipeline import densify_distributed

    scene, _ = plane_scene()
    cfg = _config(inp)
    cfg = dataclasses.replace(cfg, matching=MatchingConfig(
        max_keypoints_per_view=int(inp["max_keypoints"])))
    return _cloud(densify_distributed(scene, cfg, mesh=mesh))


def sphere_scene():
    """The JAX package's clustered test scene: a sphere ringed by 8 views
    of 200 x 150 and 60 seed points on it (tests/parallel/
    clustered_worker.py)."""
    from synthetic import TexturedSphereScene

    rng = np.random.default_rng(0)
    sc = TexturedSphereScene(rng, num_views=8, width=200, height=150,
                             focal=170.0, radius=1.0, cam_radius=4.0)
    cams = Cameras.from_projection_matrices(sc.P, widths=sc.width,
                                            heights=sc.height)
    scene = Scene(cameras=cams, images=sc.render_all(), colors=None)
    g = np.random.default_rng(7)
    pts = g.standard_normal((60, 3)).astype(np.float32)
    pts *= 1.0 / np.linalg.norm(pts, axis=1, keepdims=True)
    return scene, pts


def task_clustered(mesh, inp):
    from densepoints_tpu_torch.parallel.clustered import densify_clustered

    scene, pts = sphere_scene()
    held = {}

    def loader(view_ids):
        held["views"] = np.asarray(view_ids)
        return scene.images[view_ids]

    res = densify_clustered(scene, _config(inp), seed_points=pts,
                            halo_threshold=float(inp["halo_threshold"]),
                            image_loader=loader, mesh=mesh)
    return {**_cloud(res), "views_held": held["views"]}


def task_plan(mesh, inp):
    """Each rank's `plan_clusters` of the job's world size."""
    from densepoints_tpu_torch.parallel.clustered import plan_clusters

    plan = plan_clusters(_cams(inp), mesh.world_size, mesh.rank,
                         float(inp["halo_threshold"]))
    return {"assign": plan.assign, "my_views": plan.my_views,
            "member_mask": plan.member_mask, "halo_mask": plan.halo_mask}


def task_mesh(mesh, inp):
    """`make_mesh` inside a job: the job's mesh for its world size, for 0
    and for none given; `ValueError` for any other count."""
    same = [pmesh.make_mesh(n, device="cpu") is mesh
            for n in (None, 0, mesh.world_size)]
    try:
        pmesh.make_mesh(mesh.world_size + 1, device="cpu")
        raised = ""
    except ValueError as exc:
        raised = str(exc)
    return {"same": np.asarray(same), "raised": np.asarray(raised)}


def task_cli(mesh, inp):
    """The CLI as one rank of the job (it joins the job itself)."""
    from densepoints_tpu_torch import cli

    rank = inp["argv"][inp["argv"].index("--process-id") + 1]
    rc = cli.main([str(a).replace("{rank}", rank) for a in inp["argv"]])
    return {"rc": np.int64(rc)}


TASKS = {"insert": task_insert, "refine": task_refine,
         "nelder_mead": task_nelder_mead, "ba": task_ba, "seed": task_seed,
         "multihost": task_multihost, "clustered": task_clustered,
         "densify_distributed": task_densify_distributed,
         "plan": task_plan, "mesh": task_mesh, "cli": task_cli,
         "multihost_traced": task_multihost_traced}


def main():
    task, rank, world, port, src, dst = sys.argv[1:7]
    rank, world = int(rank), int(world)
    with np.load(src, allow_pickle=False) as data:
        inp = {k: data[k] for k in data.files}
    if task == "cli":
        inp["argv"] = list(inp["argv"]) + [
            "--coordinator", f"127.0.0.1:{port}", "--num-processes",
            str(world), "--process-id", str(rank)]
        out = TASKS[task](None, inp)
    else:
        pmesh.initialize_multihost(f"127.0.0.1:{port}", world, rank,
                                   device=str(inp.get("device", "cpu")))
        mesh = pmesh.global_mesh()
        out = TASKS[task](mesh, inp)
        out["backend"] = np.asarray(mesh.backend)
        pmesh.shutdown_multihost()
    np.savez(f"{dst}.{rank}.npz", **out)
    print(f"rank {rank}/{world}: {task} done", flush=True)


if __name__ == "__main__":
    sys.exit(main())
