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
from typing import Callable

import torch
from torch.profiler import record_function

from densepoints_tpu_torch.ops import _build, nm_step

__all__ = ["nelder_mead", "counts", "count_since"]

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

GRAPH_CAPTURES = 0  # CUDA graphs captured (one per call that replays)
GRAPH_REPLAYS = 0  # replays of those graphs
STEPS = 0  # steps run on the device, eager or replayed, frozen lanes or not


def counts() -> dict:
    """The solver's counters, under the names `StageMetrics` reports;
    `nm_kernel_launches` counts the three step kernels' device launches
    together (under a graph, at each replay)."""
    return {"nm_graph_captures": GRAPH_CAPTURES,
            "nm_graph_replays": GRAPH_REPLAYS, "nm_steps": STEPS,
            "nm_kernel_launches": nm_step.REFLECT_LAUNCHES
            + nm_step.CONTRACT_LAUNCHES + nm_step.ACCEPT_LAUNCHES}


def count_since(metrics, before: dict):
    """Add the solver's counts since `before` (a `counts()`) to `metrics`'
    counters and log them on one `[nm-graph]` line."""
    from densepoints_tpu_torch.utils import log

    for name, value in counts().items():
        metrics.count(name, value - before[name])
    log.info("[nm-graph] captures=%d replays=%d steps=%d "
             "kernel_launches=%d",
             *(metrics.counters[name] for name in before))


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


def _run_eager(advance, state, m, max_iterations, tolerance):
    """Blocks of `m` steps run eagerly, the exit read after each."""
    global STEPS
    while True:
        state, flag = _block(advance, state, m, max_iterations, tolerance)
        STEPS += m
        if bool(flag):
            return state


def _capture(advance, state, m, max_iterations, tolerance):
    """One block captured as a CUDA graph (in a pool of its own) that
    advances `state` in place; returns (graph, exit flag, kernel launches
    recorded per replay). Raises, naming the cause, if capture fails."""
    global GRAPH_CAPTURES
    graph = torch.cuda.CUDAGraph()
    _build.take_recorded()
    # thread_local: a collective library's watchdog thread may query events
    # while this thread captures.
    graph.capture_begin(capture_error_mode="thread_local")
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


def _run_graph(advance, state, m, max_iterations, tolerance):
    """The first block eagerly, then a captured block replayed until the
    exit flag is set. Everything runs on a side stream (a graph cannot be
    captured on the default stream; the eager block warms that stream's
    library state, e.g. its cuBLAS workspace, before the capture)."""
    global GRAPH_REPLAYS, STEPS
    device = state[0].device
    current = torch.cuda.current_stream(device)
    stream = _STREAMS.get(device.index)
    if stream is None:
        stream = _STREAMS[device.index] = torch.cuda.Stream(device=device)
    stream.wait_stream(current)
    for t in state:
        t.record_stream(stream)
    with torch.cuda.stream(stream):
        state, flag = _block(advance, state, m, max_iterations, tolerance)
        STEPS += m
        if not bool(flag):
            with record_function("nm/capture"):
                graph, flag, recorded = _capture(advance, state, m,
                                                 max_iterations, tolerance)
            while True:
                graph.replay()
                GRAPH_REPLAYS += 1
                STEPS += m
                _build.count_replay(recorded)
                if bool(flag):
                    break
    # The graph and its pool go with this frame.
    current.wait_stream(stream)
    for t in state:
        t.record_stream(current)
    return state


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
        if max_iterations > 0:
            advance = (nm_step.KernelStep(f, verts)
                       if isinstance(f, nm_step.StepObjective)
                       else _TorchStep(f))
            run = (_run_graph if dev.type == "cuda" and not _eager
                   else _run_eager)
            state = run(advance, state, _block_steps, max_iterations,
                        tolerance)
        verts, fvals, _, iters, _ = state
        ib = torch.argmin(fvals, dim=1)
        x_best = torch.take_along_dim(verts, ib[:, None, None],
                                      dim=1)[:, 0, :]
        f_best = torch.take_along_dim(fvals, ib[:, None], dim=1)[:, 0]
        return x_best, f_best, iters
