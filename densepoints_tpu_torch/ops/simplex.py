"""Batched Nelder-Mead (downhill simplex) minimization.

ONE Nelder-Mead drives the whole batch: the simplex state is (B, D+1, D)
and every step evaluates the objective for all B lanes at once; converged
lanes are frozen by masking. Per iteration there are exactly two batched
objective evaluations (reflection, then a per-lane select of expansion /
outside / inside contraction); the shrink step is replaced by accepting
the contraction point. The loop stops when every lane has converged or
the iteration cap is reached, a host check each iteration. A converged
lane is frozen and its ties keep their order under the stable sort, so
when the loop stops changes no lane's result: what the batch composition
can move is the objective's rounding by batch shape. With a `mesh`, each
rank holds a row block of the batch and the check is one `all_reduce` of
a flag per iteration: every rank runs until the whole (global) batch has
converged, as the JAX loop's predicate over the global batch does.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["nelder_mead"]

_ALPHA = 1.0  # reflection
_GAMMA = 2.0  # expansion
_RHO = 0.5  # contraction


def nelder_mead(
    f: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    init_step: torch.Tensor,
    max_iterations: int = 500,
    tolerance: float = 1e-4,
    mesh=None,
):
    """Minimize f over a batch.

    f: (B, K, D) -> (B, K) batched objective; lane b always refers to the
      same problem instance. x0: (B, D); init_step: (D,).
    mesh: a `parallel.mesh.Mesh` when x0 is this rank's row block of a
      batch split over ranks; the early exit then waits for every rank.
    Returns (x_best (B, D), f_best (B,), iterations_used (B,)).
    """
    if mesh is not None:
        from densepoints_tpu_torch.parallel.mesh import (
            all_true,
            require_started,
        )

        require_started(mesh, "nelder_mead")
    B, D = x0.shape
    offsets = torch.cat(
        [x0.new_zeros((1, D)), torch.diag(init_step.to(x0))], dim=0
    )  # (D+1, D)
    verts = x0[:, None, :] + offsets[None, :, :]  # (B, D+1, D)
    fvals = f(verts)  # (B, D+1)
    done = torch.zeros(B, dtype=torch.bool, device=x0.device)
    iters = torch.zeros(B, dtype=torch.int32, device=x0.device)

    for _ in range(max_iterations):
        if mesh is None:
            if bool(done.all()):
                break
        elif all_true(mesh, done.all()):
            break
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

        active = ~done
        verts[:, -1, :] = torch.where(active[:, None], x_acc, x_worst)
        fvals[:, -1] = torch.where(active, f_acc, worst)

        spread = fvals.max(dim=1).values - fvals.min(dim=1).values
        done = done | (spread < tolerance)
        iters = iters + active.to(torch.int32)

    ib = torch.argmin(fvals, dim=1)
    x_best = torch.take_along_dim(verts, ib[:, None, None], dim=1)[:, 0, :]
    f_best = torch.take_along_dim(fvals, ib[:, None], dim=1)[:, 0]
    return x_best, f_best, iters
