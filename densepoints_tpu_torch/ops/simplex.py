"""Batched Nelder-Mead (downhill simplex) minimization.

ONE Nelder-Mead drives the whole batch: the simplex state is (B, D+1, D)
and every step evaluates the objective for all B lanes at once; converged
lanes are frozen by masking. Per iteration there are exactly two batched
objective evaluations (reflection, then a per-lane select of expansion /
outside / inside contraction); the shrink step is replaced by accepting
the contraction point.

The loop is the JAX package's `lax.while_loop`: a pure step (`_step`, no
host read) run in blocks of `_BLOCK` steps, with the exit ("every lane
done, or the cap reached") read once per block. A lane is active while it
has not converged and the step count is below the cap, so a step past
either point changes no lane: a converged lane is frozen, `iters` counts
active lanes only, and a frozen lane's vertices are only re-sorted, stably,
which leaves `argmin`'s pick unchanged. Blocks of any size therefore give
the result of the per-iteration loop bitwise; a block of m steps may
evaluate the objective up to 2 (m - 1) more times, on frozen lanes.

A step of the photometric objective (an `ops.nm_step.StepObjective`) is
`ops.nm_step.KernelStep`: on a CUDA device five launches (three kernels of
`csrc/nm_step.cu` and the scoring kernel twice) that update the state in
place and write the exit flag on the device, the counterpart of XLA's
fusions of the JAX package's loop body; on the CPU the kernels' plain twins,
which give `_step` bitwise. Any other objective callable takes `_step`.

On the CPU the blocks run eagerly. On a CUDA device the first block runs
eagerly (real iterations, and the warm-up a capture needs), the next one
is captured as a CUDA graph in a memory pool of its own, and the host only
replays it until the device's exit flag says stop: the counterpart of the
JAX package's one XLA program per slice. A capture that fails raises; there
is no eager retry on the card, and no fallback from the kernel step to
`_step`.

A solve of a `StepObjective` on the card keeps its graph (`_Solve`): the
graph is captured on buffers at a bucket capacity (`bucket`: the next
power of two, at least 256), and a later solve with the same scene,
texture size, cap, tolerance and bucket copies its lanes into them, pads
the rest with dead lanes and replays the graph from its first step, with
no eager block and no capture. A lane's steps do not depend on the other
lanes (N1-N3 run a thread a lane, K1 a warp a row, and a dead lane never
clears the exit flag), so every lane ends bitwise as in a graph of its own
batch. The graphs of a scene share one memory pool and go with its images
tensor. Any other objective callable captures a graph per call.

With a `mesh`, each rank holds a row block of the batch and reads its own
exit flag: it stops once its own lanes have converged or the cap is
reached, with no collective inside the loop. The JAX loop's predicate runs
every rank until the whole (global) batch has converged; the steps one
rank runs past its own exit would change none of its lanes (see above), so
each row block, and the batch the caller gathers, is the same bitwise.

Profiler spans: `nm/solve` around each call, `nm/capture` around each
graph's capture; none inside the blocks or around a replay.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Callable

import torch
from torch.profiler import record_function

from densepoints_tpu_torch.ops import _build, allview_ncc, nm_step

__all__ = ["nelder_mead", "bucket", "counts", "count_since"]

_ALPHA, _GAMMA, _RHO = nm_step.ALPHA, nm_step.GAMMA, nm_step.RHO
# Steps per block: per captured graph on the card, per exit read anywhere.
# With the step kernels (five launches a step) 2 took the least host time
# per iteration of 1, 2, 4 and 8 on an H100 (`chip_smoke.py --nm-graph`,
# PERF.md): a replay of one step costs little more than its exit read, and
# a block's eager run and capture cost host time in proportion to its
# steps.
_BLOCK = 2

# One side stream per card for every call: a new stream would cost a new
# cuBLAS workspace (32 MiB on Hopper, kept for the process's life).
_STREAMS: dict = {}

# Solves of a `StepObjective` kept for the card's later solves, by scene:
# id(images) -> (weak reference to images, {key: `_Solve`}); an entry goes
# when its images tensor does.
_SOLVES: dict = {}

GRAPH_CAPTURES = 0  # CUDA graphs captured
GRAPH_REUSES = 0  # solves that replayed a graph an earlier solve captured
GRAPH_REPLAYS = 0  # replays of the graphs
STEPS = 0  # steps run on the device, eager or replayed, frozen lanes or not


def counts() -> dict:
    """The solver's counters, under the names `StageMetrics` reports;
    `nm_kernel_launches` counts the three step kernels' device launches
    together (under a graph, at each replay)."""
    return {"nm_graph_captures": GRAPH_CAPTURES,
            "nm_graph_reuses": GRAPH_REUSES,
            "nm_graph_replays": GRAPH_REPLAYS, "nm_steps": STEPS,
            "nm_kernel_launches": nm_step.REFLECT_LAUNCHES
            + nm_step.CONTRACT_LAUNCHES + nm_step.ACCEPT_LAUNCHES}


def count_since(metrics, before: dict):
    """Add the solver's counts since `before` (a `counts()`) to `metrics`'
    counters and log them on one `[nm-graph]` line."""
    from densepoints_tpu_torch.utils import log

    for name, value in counts().items():
        metrics.count(name, value - before[name])
    log.info("[nm-graph] captures=%d reuses=%d replays=%d steps=%d "
             "kernel_launches=%d",
             *(metrics.counters[name] for name in before))


def bucket(n: int, multiple: int = 1, minimum: int = 256) -> int:
    """Next power-of-two capacity >= max(n, minimum), padded to a
    multiple of `multiple` (a mesh's world size). A cached solve's graph
    serves every batch of its bucket; `densify_multihost`'s buckets fix its
    batches and the slices cut over them, so that both are the same for
    every world size."""
    target = minimum
    while target < n:
        target *= 2
    return -(-target // multiple) * multiple


def _step(f, verts, fvals, done, iters, step, max_iterations, tolerance):
    """One iteration on device tensors, no host read; returns the new
    (verts, fvals, done, iters, step)."""
    order = torch.argsort(fvals, dim=1, stable=True)
    verts = torch.take_along_dim(verts, order[:, :, None], dim=1)
    fvals = torch.take_along_dim(fvals, order, dim=1)
    best, second_worst, worst = fvals[:, 0], fvals[:, -2], fvals[:, -1]
    x_worst = verts[:, -1, :]
    centroid = verts[:, :-1, :].mean(dim=1)

    x_r = centroid + _ALPHA * (centroid - x_worst)
    f_r = f(x_r[:, None, :])[:, 0]

    expand = f_r < best
    outside = f_r < worst
    x_e = centroid + _GAMMA * (centroid - x_worst)
    x_oc = centroid + _RHO * (x_r - centroid)
    x_ic = centroid - _RHO * (centroid - x_worst)
    x_2 = torch.where(
        expand[:, None], x_e, torch.where(outside[:, None], x_oc, x_ic)
    )
    f_2 = f(x_2[:, None, :])[:, 0]

    # Accept rules (no shrink; contraction always replaces the worst).
    use_2 = torch.where(
        expand, f_2 < f_r, (f_r >= second_worst) & (f_2 < f_r)
    )
    x_new = torch.where(use_2[:, None], x_2, x_r)
    f_new = torch.where(use_2, f_2, f_r)
    improved = f_new < worst
    x_acc = torch.where(improved[:, None], x_new, x_worst)
    f_acc = torch.where(improved, f_new, worst)

    active = ~done & (step < max_iterations)
    verts[:, -1, :] = torch.where(active[:, None], x_acc, x_worst)
    fvals[:, -1] = torch.where(active, f_acc, worst)

    spread = fvals.max(dim=1).values - fvals.min(dim=1).values
    done = done | (spread < tolerance)
    iters = iters + active.to(torch.int32)
    return verts, fvals, done, iters, step + 1


class _TorchStep:
    """`_step` of any objective callable; the exit flag from the state."""

    def __init__(self, f):
        self.f = f

    def __call__(self, *state_and_limits):
        return _step(self.f, *state_and_limits)

    @staticmethod
    def exit_flag(state, max_iterations):
        _, _, done, _, step = state
        return done.all() | (step >= max_iterations)


def _block(advance, state, m, max_iterations, tolerance):
    """`m` steps of `advance` (a `_TorchStep` or an `nm_step.KernelStep`)
    from `state`; returns the new state and its exit flag."""
    for _ in range(m):
        state = advance(*state, max_iterations, tolerance)
    return state, advance.exit_flag(state, max_iterations)


def _advance(f, verts):
    """The step of objective `f`: `nm_step.KernelStep` for a
    `StepObjective`, else `_TorchStep`."""
    return (nm_step.KernelStep(f, verts)
            if isinstance(f, nm_step.StepObjective) else _TorchStep(f))


def _run_eager(f, state, m, max_iterations, tolerance):
    """Blocks of `m` steps run eagerly, the exit read after each."""
    global STEPS
    advance = _advance(f, state[0])
    while True:
        state, flag = _block(advance, state, m, max_iterations, tolerance)
        STEPS += m
        if bool(flag):
            return state


def _capture(advance, state, m, max_iterations, tolerance, pool=None):
    """One block captured as a CUDA graph that advances `state` in place,
    in `pool` (another graph's `pool()`) or a pool of its own; returns
    (graph, exit flag, kernel launches recorded per replay). Raises, naming
    the cause, if capture fails."""
    global GRAPH_CAPTURES
    graph = torch.cuda.CUDAGraph()
    _build.take_recorded()
    # thread_local: a collective library's watchdog thread may query events
    # while this thread captures.
    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
    try:
        out, flag = _block(advance, state, m, max_iterations, tolerance)
        for dst, src in zip(state, out):
            if dst is not src:  # the kernel step updates in place
                dst.copy_(src)
    except Exception as exc:
        with contextlib.suppress(Exception):
            graph.capture_end()
        _build.take_recorded()
        raise RuntimeError(
            "nelder_mead: capturing a block of Nelder-Mead steps as a CUDA "
            f"graph failed ({type(exc).__name__}: {exc}); the objective must "
            "not read a device value on the host (.item(), bool(), nonzero) "
            "or build a tensor on the host"
        ) from exc
    graph.capture_end()
    GRAPH_CAPTURES += 1
    return graph, flag, _build.take_recorded()


def _replay(graph, flag, recorded, m):
    """Replays of `graph` until the exit `flag` is set."""
    global GRAPH_REPLAYS, STEPS
    while True:
        graph.replay()
        GRAPH_REPLAYS += 1
        STEPS += m
        _build.count_replay(recorded)
        if bool(flag):
            return


def _on_side_stream(run, f, state, *limits):
    """`run(f, state, *limits)` on the card's side stream (a graph cannot
    be captured on the default stream), after the current stream's work so
    far and before its next; returns run's state."""
    device = state[0].device
    current = torch.cuda.current_stream(device)
    stream = _STREAMS.get(device.index)
    if stream is None:
        stream = _STREAMS[device.index] = torch.cuda.Stream(device=device)
    stream.wait_stream(current)
    for t in state:
        t.record_stream(stream)
    with torch.cuda.stream(stream):
        state = run(f, state, *limits)
    current.wait_stream(stream)
    for t in state:
        t.record_stream(current)
    return state


def _run_graph(f, state, m, max_iterations, tolerance):
    """The first block eagerly, then a captured block replayed until the
    exit flag is set (the eager block warms the stream's library state,
    e.g. its cuBLAS workspace, before the capture). The graph and its pool
    go with this frame."""
    global STEPS
    advance = _advance(f, state[0])
    state, flag = _block(advance, state, m, max_iterations, tolerance)
    STEPS += m
    if not bool(flag):
        with record_function("nm/capture"):
            graph, flag, recorded = _capture(advance, state, m,
                                             max_iterations, tolerance)
        _replay(graph, flag, recorded, m)
    return state


class _Solve:
    """The buffers of `StepObjective` solves at a bucket capacity `Bb`, and
    once captured, the CUDA graph of a block of steps on them: the
    objective's parts, the solver's state and a `KernelStep` (its scratch,
    flag and counters). `load` puts a solve's B <= Bb lanes in `[:B]` and
    dead lanes in `[B:]` (zeroed: nothing visible, no payload, `done`).
    `keep` holds what the graph reads of the scene (the images' storage and
    the cameras' tensors), so that no address it holds is reused while it
    lives. Its scorer is bound only while a block runs eagerly or is
    captured (`score`), so that it does not hold the images tensor."""

    def __init__(self, f, Bb, keep):
        V, dev = f.vis.shape[1], f.vis.device
        f32, i64, b8 = torch.float32, torch.int64, torch.bool

        def zeros(shape, dtype=f32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.objective = nm_step.StepObjective(
            zeros((Bb, 3)), zeros((Bb, 3)), zeros((Bb, 3)),
            zeros((Bb,), i64), zeros((Bb, V), b8), zeros((Bb, V), b8),
            zeros((Bb,), i64), score=None)
        self.state = (zeros((Bb, 4, 3)), zeros((Bb, 4)),
                      torch.ones(Bb, dtype=b8, device=dev),
                      zeros((Bb,), torch.int32), zeros((), i64))
        self.advance = nm_step.KernelStep(self.objective, self.state[0])
        self.keep = keep
        self.graph = self.recorded = None

    def load(self, f, state):
        """Lanes `[:B]` from `f`'s parts and `state`, dead lanes after."""
        B = state[0].shape[0]
        o = self.objective
        pairs = [(getattr(o, name), getattr(f, name)) for name in (
            "position0", "normal0", "C_ref", "ref", "vis", "payload",
            "n_payload")]
        for dst, src in pairs + list(zip(self.state[:4], state[:4])):
            dst[:B].copy_(src)
            dst[B:].zero_()
        self.state[2][B:] = True
        self.state[4].copy_(state[4])

    @contextlib.contextmanager
    def score(self, f):
        """`f`'s scorer bound for the block within, its work uncounted."""
        self.objective.score = f.score.launch
        try:
            yield
        finally:
            self.objective.score = None


def _cached(f, Bb, m, max_iterations, tolerance):
    """The `_Solve` of objective `f` at capacity `Bb`, made at first use,
    and the memory pool of its scene's graphs (None before the first).
    Its key is what its graph bakes in: the scene (`f`'s images tensor and
    its cameras' tensors, held), the texture size, the view count, `Bb`,
    the block's steps, the cap, the tolerance and the dtype."""
    score = f.score
    images, cameras = score.images, score.cameras
    camera_tensors = (cameras.K, cameras.E, cameras.C, cameras.x_axis,
                      cameras.width, cameras.height)
    key = (tuple(map(id, camera_tensors)), score.texture_size,
           f.vis.shape[1], Bb, m, int(max_iterations), float(tolerance),
           f.position0.dtype)
    scene = _SOLVES.get(id(images))
    if scene is None:
        ref = weakref.ref(images, lambda _, i=id(images), solves=_SOLVES:
                          solves.pop(i, None))
        scene = _SOLVES[id(images)] = (ref, {})
    solve = scene[1].get(key)
    if solve is None:
        keep = (images.untyped_storage(), camera_tensors, score.scene[1:])
        solve = scene[1][key] = _Solve(f, Bb, keep)
    pool = next((s.graph.pool() for s in scene[1].values()
                 if s.graph is not None), None)
    return solve, pool


def _run_cached(f, state, m, max_iterations, tolerance):
    """A solve of `StepObjective` `f` through the `_Solve` of its bucket:
    the first use runs a block eagerly and captures the next, as
    `_run_graph` does; a later one replays the graph from its first step.
    Returns the state of the solve's B lanes (copies). K1's work is counted
    for those lanes alone: every launch scored Bb rows, B of them real.
    A scene's graphs share one memory pool: what a block allocates lives
    only inside the block, and the graphs replay one at a time, in stream
    order, so none reads what another wrote there."""
    global GRAPH_REUSES, STEPS
    B = state[0].shape[0]
    solve, pool = _cached(f, bucket(B), m, max_iterations, tolerance)
    solve.load(f, state)
    launches = allview_ncc.KERNEL_LAUNCHES
    if solve.graph is not None:
        GRAPH_REUSES += 1
        _replay(solve.graph, solve.advance.flag, solve.recorded, m)
    else:
        with solve.score(f):
            _, flag = _block(solve.advance, solve.state, m, max_iterations,
                             tolerance)
            STEPS += m
            if not bool(flag):
                with record_function("nm/capture"):
                    solve.graph, _, solve.recorded = _capture(
                        solve.advance, solve.state, m, max_iterations,
                        tolerance, pool)
        if solve.graph is not None:
            _replay(solve.graph, solve.advance.flag, solve.recorded, m)
    allview_ncc.count_work(f.vis, f.score.texture_size,
                           allview_ncc.KERNEL_LAUNCHES - launches)
    return tuple(t[:B].clone() for t in solve.state[:4]) + (
        solve.state[4].clone(),)


def nelder_mead(
    f: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    init_step: torch.Tensor,
    max_iterations: int = 500,
    tolerance: float = 1e-4,
    mesh=None,
    *,
    _eager: bool = False,
    _block_steps: int = _BLOCK,
):
    """Minimize f over a batch.

    f: (B, K, D) -> (B, K) batched objective; lane b always refers to the
      same problem instance. On a CUDA device f is captured into a graph:
      it must not read a device value on the host. An
      `nm_step.StepObjective` (D = 3) steps through `nm_step.KernelStep`,
      any other callable through `_step`. x0: (B, D); init_step: (D,).
    mesh: a `parallel.mesh.Mesh` when x0 is this rank's row block of a
      batch split over ranks; the rank exits on its own block's flag.
    `_eager` runs the eager blocks on a CUDA device too (the witness the
    graph is held against) and `_block_steps` sets the block size; neither
    is for callers of the pipeline.
    Returns (x_best (B, D), f_best (B,), iterations_used (B,)).
    """
    if mesh is not None:
        from densepoints_tpu_torch.parallel.mesh import require_started

        require_started(mesh, "nelder_mead")
    # holds syncs: the exit flag is read once a block
    with record_function("nm/solve"):
        B, D = x0.shape
        dev = x0.device
        if B == 0:
            return (x0.clone(), x0.new_empty((0,)),
                    torch.zeros(0, dtype=torch.int32, device=dev))
        offsets = torch.cat(
            [x0.new_zeros((1, D)), torch.diag(init_step.to(x0))], dim=0
        )  # (D+1, D)
        verts = x0[:, None, :] + offsets[None, :, :]  # (B, D+1, D)
        fvals = f(verts)  # (B, D+1)
        state = (
            verts, fvals,
            torch.zeros(B, dtype=torch.bool, device=dev),  # done
            torch.zeros(B, dtype=torch.int32, device=dev),  # iters
            torch.zeros((), dtype=torch.int64, device=dev),  # step
        )
        limits = (_block_steps, max_iterations, tolerance)
        if max_iterations > 0 and (dev.type != "cuda" or _eager):
            state = _run_eager(f, state, *limits)
        elif max_iterations > 0:
            run = (_run_cached if isinstance(f, nm_step.StepObjective)
                   else _run_graph)
            state = _on_side_stream(run, f, state, *limits)
        verts, fvals, _, iters, _ = state
        ib = torch.argmin(fvals, dim=1)
        x_best = torch.take_along_dim(verts, ib[:, None, None],
                                      dim=1)[:, 0, :]
        f_best = torch.take_along_dim(fvals, ib[:, None], dim=1)[:, 0]
        return x_best, f_best, iters
