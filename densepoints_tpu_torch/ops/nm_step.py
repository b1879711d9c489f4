"""One Nelder-Mead step of the photometric objective as three kernels
around two scoring passes.

The JAX package runs `nelder_mead`'s loop body with the photometric
objective inside one XLA program, fused around its two Pallas scoring
calls. Here a step of a `StepObjective` (the parts of
`pmvs.optimize.photometric_objective_paged`) is five launches on a CUDA
device, all on buffers made once per `KernelStep` (per solver call, or on
the card per cached solve graph, `ops.simplex._Solve`):

  nm_reflect   sort each lane's 4 vertices by f-value (stably), the
               centroid of the best three, the reflection x_r and its pose,
               written into the scorer's position / normal;
  K1           the all-views scoring pass (`ops.allview_ncc`) for x_r;
  nm_contract  f_r from K1's grid, the second candidate x_2 (expansion,
               outside or inside contraction) and its pose;
  K1           again, for x_2;
  nm_accept    f_2, the accept rules, the new worst vertex, the spread test,
               `done`, `iters`, the step count and the exit flag.

Each of the three wrappers launches its kernel in `csrc/nm_step.cu` on a
CUDA tensor (or raises) and runs its plain twin (`nm_*_plain`) on a CPU
tensor, writing the twin's results into the same buffers. The twins are the
torch ops of `ops.simplex._step` and of the objective's call, part by part
and in the same order, so on the CPU `KernelStep` gives `_step` bitwise; the
kernels agree with them within f32 rounding (the V-sum and the rotation run
in another order). `REFLECT_LAUNCHES`, `CONTRACT_LAUNCHES` and
`ACCEPT_LAUNCHES` count the kernels' launches where they launch (under a
CUDA graph, at each replay: `_build.count_launch`), `PLAIN_CALLS` the twins'
calls through the wrappers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from densepoints_tpu_torch.ops import _build

__all__ = [
    "ALPHA",
    "GAMMA",
    "RHO",
    "StepObjective",
    "KernelStep",
    "cost",
    "nm_reflect",
    "nm_contract",
    "nm_accept",
    "nm_reflect_plain",
    "nm_contract_plain",
    "nm_accept_plain",
    "REFLECT_LAUNCHES",
    "CONTRACT_LAUNCHES",
    "ACCEPT_LAUNCHES",
    "PLAIN_CALLS",
]

ALPHA = 1.0  # reflection
GAMMA = 2.0  # expansion
RHO = 0.5  # contraction

REFLECT_LAUNCHES = 0  # kernel launches, counted where each kernel launches
CONTRACT_LAUNCHES = 0
ACCEPT_LAUNCHES = 0
PLAIN_CALLS = 0  # wrapper calls answered by a plain twin (CPU tensors)

_VP, _I64 = _build.VOID_P, _build.INT64
_POSE = (_VP, _VP, _VP)  # position0, normal0, C_ref
_REFLECT_ARGTYPES = (*_POSE, _VP, _VP, _VP, _VP, _VP, _VP, _I64, _VP)
_CONTRACT_ARGTYPES = (
    *_POSE, _VP, _VP, _VP, _I64,  # scores, payload, n_payload, V
    _VP, _VP, _VP, _VP,  # verts, fvals, centroid, x_r
    _VP, _VP, _VP, _VP, _I64, _VP,  # f_r, x_2, position, normal, B, stream
)
_ACCEPT_ARGTYPES = (
    _VP, _VP, _VP, _I64,  # scores, payload, n_payload, V
    _VP, _VP, _VP, _VP, _VP,  # verts, fvals, done, iters, step
    _VP, _VP, _VP, _I64, _build.FLOAT,  # x_r, f_r, x_2, cap, tolerance
    _VP, _VP, _I64, _VP,  # flag, counters, B, stream
)


@dataclasses.dataclass(eq=False)
class StepObjective:
    """What the kernel step needs of the photometric objective, made once
    per solver call: the pose the parameters start from (`position0`,
    `normal0`, the reference camera's centre `C_ref`, each (B, 3) f32),
    `ref` (B,) int64 and `vis` (B, V) bool for the scorer, the payload
    views (`payload` (B, V) bool: visible, not the anchor) and their count
    `n_payload` (B,) int64, and `score(position, normal, ref, vis) ->
    (scores (B, V), anchor, anchor_ok)`, the bound all-views scorer
    (`ops.allview_ncc.allview_scorer`: on the card the solver keys its
    kept graphs by the scorer's images and cameras)."""

    position0: torch.Tensor
    normal0: torch.Tensor
    C_ref: torch.Tensor
    ref: torch.Tensor
    vis: torch.Tensor
    payload: torch.Tensor
    n_payload: torch.Tensor
    score: Callable


def _pose(params, position0, normal0, C_ref):
    """`unparametrize` of one (B, 3) point per lane, shaped as the
    objective's call of K = 1 shapes it, flattened to the scorer's (B, 3)."""
    from densepoints_tpu_torch.pmvs.optimize import unparametrize

    B = params.shape[0]
    pos, nrm = unparametrize(params[:, None, :], position0[:, None, :],
                             normal0[:, None, :], C_ref[:, None, :])
    return pos.reshape(B, 3), nrm.reshape(B, 3)


def cost(scores, payload, n_payload, K):
    """The photometric objective of K points per lane from the scorer's
    (B * K, V) grid, (B, K): the mean of 1 - score over the payload views,
    2 where there is none."""
    B, V = payload.shape
    err = torch.where(
        payload[:, None, :], 1.0 - scores.reshape(B, K, V), 0.0
    ).sum(dim=2)
    n = n_payload[:, None]
    return torch.where(n > 0, err / torch.clamp_min(n, 1), 2.0)


def _cost(scores, payload, n_payload):
    """`cost` of one point per lane, (B,)."""
    return cost(scores, payload, n_payload, 1)[:, 0]


def nm_reflect_plain(verts, fvals, position0, normal0, C_ref):
    """Plain twin of `nm_reflect`: returns (verts, fvals) sorted by
    f-value, the centroid of the best three, x_r, and x_r's (position,
    normal)."""
    order = torch.argsort(fvals, dim=1, stable=True)
    verts = torch.take_along_dim(verts, order[:, :, None], dim=1)
    fvals = torch.take_along_dim(fvals, order, dim=1)
    x_worst = verts[:, -1, :]
    centroid = verts[:, :-1, :].mean(dim=1)
    x_r = centroid + ALPHA * (centroid - x_worst)
    return (verts, fvals, centroid, x_r,
            *_pose(x_r, position0, normal0, C_ref))


def nm_contract_plain(scores, payload, n_payload, verts, fvals, centroid,
                      x_r, position0, normal0, C_ref):
    """Plain twin of `nm_contract` (sorted `verts`, `fvals`; `scores` the
    grid of x_r): returns (f_r, x_2, x_2's position, normal)."""
    f_r = _cost(scores, payload, n_payload)
    best, worst = fvals[:, 0], fvals[:, -1]
    x_worst = verts[:, -1, :]
    expand = f_r < best
    outside = f_r < worst
    x_e = centroid + GAMMA * (centroid - x_worst)
    x_oc = centroid + RHO * (x_r - centroid)
    x_ic = centroid - RHO * (centroid - x_worst)
    x_2 = torch.where(
        expand[:, None], x_e, torch.where(outside[:, None], x_oc, x_ic)
    )
    return (f_r, x_2, *_pose(x_2, position0, normal0, C_ref))


def nm_accept_plain(scores, payload, n_payload, verts, fvals, done, iters,
                    step, x_r, f_r, x_2, max_iterations, tolerance):
    """Plain twin of `nm_accept` (`scores` the grid of x_2): returns the
    new (verts, fvals, done, iters, step) and the exit flag, every lane
    done or the cap reached."""
    f_2 = _cost(scores, payload, n_payload)
    best, second_worst, worst = fvals[:, 0], fvals[:, -2], fvals[:, -1]
    x_worst = verts[:, -1, :]
    expand = f_r < best
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
    verts, fvals = verts.clone(), fvals.clone()
    verts[:, -1, :] = torch.where(active[:, None], x_acc, x_worst)
    fvals[:, -1] = torch.where(active, f_acc, worst)

    spread = fvals.max(dim=1).values - fvals.min(dim=1).values
    done = done | (spread < tolerance)
    iters = iters + active.to(torch.int32)
    step = step + 1
    return verts, fvals, done, iters, step, done.all() | (
        step >= max_iterations)


def _plain(buffers, values):
    """A twin's results into the wrapper's buffers."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    for buf, value in zip(buffers, values):
        buf.copy_(value)


def _check(dev, **tensors):
    """`name=(tensor, dtype, shape)`: each on `dev`, contiguous."""
    if dev.type != "cuda":
        raise ValueError(f"the Nelder-Mead step kernels need CUDA tensors, "
                         f"got {dev}")
    for name, (t, dtype, shape) in tensors.items():
        _build.check_tensor(name, t, dev, dtype, shape)


def _pose_args(B, position0, normal0, C_ref):
    f32 = torch.float32
    return dict(position0=(position0, f32, (B, 3)),
                normal0=(normal0, f32, (B, 3)), C_ref=(C_ref, f32, (B, 3)))


def nm_reflect(verts, fvals, position0, normal0, C_ref, centroid, x_r,
               position, normal):
    """In place: sort `verts` (B, 4, 3) and `fvals` (B, 4) by f-value,
    write the centroid of the best three and x_r (B, 3), and x_r's pose
    into `position` and `normal` (B, 3), the scorer's inputs."""
    if verts.device.type == "cpu":
        _plain((verts, fvals, centroid, x_r, position, normal),
               nm_reflect_plain(verts, fvals, position0, normal0, C_ref))
        return
    B, f32 = verts.shape[0], torch.float32
    _check(verts.device, verts=(verts, f32, (B, 4, 3)),
           fvals=(fvals, f32, (B, 4)),
           **_pose_args(B, position0, normal0, C_ref),
           centroid=(centroid, f32, (B, 3)), x_r=(x_r, f32, (B, 3)),
           position=(position, f32, (B, 3)), normal=(normal, f32, (B, 3)))
    if B == 0:
        return
    _build.count_launch(f"{__name__}:REFLECT_LAUNCHES")
    _build.launch(
        "nm_reflect_launch", _REFLECT_ARGTYPES, verts.device,
        position0.data_ptr(), normal0.data_ptr(), C_ref.data_ptr(),
        verts.data_ptr(), fvals.data_ptr(), centroid.data_ptr(),
        x_r.data_ptr(), position.data_ptr(), normal.data_ptr(), B,
    )


def nm_contract(scores, payload, n_payload, verts, fvals, centroid, x_r,
                position0, normal0, C_ref, f_r, x_2, position, normal):
    """In place: f_r (B,) from x_r's grid `scores` (B, V), the second
    candidate `x_2` (B, 3), and its pose into `position` and `normal`."""
    if verts.device.type == "cpu":
        _plain((f_r, x_2, position, normal), nm_contract_plain(
            scores, payload, n_payload, verts, fvals, centroid, x_r,
            position0, normal0, C_ref))
        return
    (B, V), f32 = scores.shape, torch.float32
    _check(verts.device, scores=(scores, f32, (B, V)),
           payload=(payload, torch.bool, (B, V)),
           n_payload=(n_payload, torch.int64, (B,)),
           verts=(verts, f32, (B, 4, 3)), fvals=(fvals, f32, (B, 4)),
           centroid=(centroid, f32, (B, 3)), x_r=(x_r, f32, (B, 3)),
           **_pose_args(B, position0, normal0, C_ref),
           f_r=(f_r, f32, (B,)), x_2=(x_2, f32, (B, 3)),
           position=(position, f32, (B, 3)), normal=(normal, f32, (B, 3)))
    if B == 0:
        return
    _build.count_launch(f"{__name__}:CONTRACT_LAUNCHES")
    _build.launch(
        "nm_contract_launch", _CONTRACT_ARGTYPES, verts.device,
        position0.data_ptr(), normal0.data_ptr(), C_ref.data_ptr(),
        scores.data_ptr(), payload.data_ptr(), n_payload.data_ptr(), V,
        verts.data_ptr(), fvals.data_ptr(), centroid.data_ptr(),
        x_r.data_ptr(), f_r.data_ptr(), x_2.data_ptr(), position.data_ptr(),
        normal.data_ptr(), B,
    )


def nm_accept(scores, payload, n_payload, verts, fvals, done, iters, step,
              x_r, f_r, x_2, max_iterations, tolerance, flag, counters):
    """In place: f_2 from x_2's grid `scores`, the accept rules on the
    worst vertex of every active lane, `done` (B,) bool, `iters` (B,)
    int32, `step` () int64 + 1, and `flag` () bool: every lane done or the
    cap reached. `counters` (2,) int32, zero at the first call, is the
    kernel's scratch for the flag (it leaves it zero)."""
    if verts.device.type == "cpu":
        _plain((verts, fvals, done, iters, step, flag), nm_accept_plain(
            scores, payload, n_payload, verts, fvals, done, iters, step, x_r,
            f_r, x_2, max_iterations, tolerance))
        return
    (B, V), f32 = scores.shape, torch.float32
    _check(verts.device, scores=(scores, f32, (B, V)),
           payload=(payload, torch.bool, (B, V)),
           n_payload=(n_payload, torch.int64, (B,)),
           verts=(verts, f32, (B, 4, 3)), fvals=(fvals, f32, (B, 4)),
           done=(done, torch.bool, (B,)), iters=(iters, torch.int32, (B,)),
           step=(step, torch.int64, ()), x_r=(x_r, f32, (B, 3)),
           f_r=(f_r, f32, (B,)), x_2=(x_2, f32, (B, 3)),
           flag=(flag, torch.bool, ()),
           counters=(counters, torch.int32, (2,)))
    if B == 0:
        return
    _build.count_launch(f"{__name__}:ACCEPT_LAUNCHES")
    _build.launch(
        "nm_accept_launch", _ACCEPT_ARGTYPES, verts.device,
        scores.data_ptr(), payload.data_ptr(), n_payload.data_ptr(), V,
        verts.data_ptr(), fvals.data_ptr(), done.data_ptr(),
        iters.data_ptr(), step.data_ptr(), x_r.data_ptr(), f_r.data_ptr(),
        x_2.data_ptr(), int(max_iterations), float(tolerance),
        flag.data_ptr(), counters.data_ptr(), B,
    )


class KernelStep:
    """One Nelder-Mead step of a `StepObjective`, in place on the solver's
    state (verts (B, 4, 3), fvals (B, 4), done, iters, step): `nm_reflect`,
    the scorer, `nm_contract`, the scorer, `nm_accept`. Its scratch buffers
    and exit flag are made here, once per step object, so a CUDA graph of
    its steps sees fixed addresses."""

    def __init__(self, objective: StepObjective, verts: torch.Tensor):
        o = objective
        self.objective = o
        self.pose = tuple(t.contiguous()
                          for t in (o.position0, o.normal0, o.C_ref))
        self.payload = o.payload.contiguous()
        self.n_payload = o.n_payload.contiguous()
        B = verts.shape[0]
        self.centroid, self.x_r, self.x_2, self.position, self.normal = (
            verts.new_empty((B, 3)) for _ in range(5))
        self.f_r = verts.new_empty((B,))
        self.flag = torch.zeros((), dtype=torch.bool, device=verts.device)
        self.counters = torch.zeros(2, dtype=torch.int32,
                                    device=verts.device)

    def __call__(self, verts, fvals, done, iters, step, max_iterations,
                 tolerance):
        o = self.objective
        nm_reflect(verts, fvals, *self.pose, self.centroid, self.x_r,
                   self.position, self.normal)
        scores = o.score(self.position, self.normal, o.ref, o.vis)[0]
        nm_contract(scores, self.payload, self.n_payload, verts, fvals,
                    self.centroid, self.x_r, *self.pose, self.f_r, self.x_2,
                    self.position, self.normal)
        scores = o.score(self.position, self.normal, o.ref, o.vis)[0]
        nm_accept(scores, self.payload, self.n_payload, verts, fvals, done,
                  iters, step, self.x_r, self.f_r, self.x_2, max_iterations,
                  tolerance, self.flag, self.counters)
        return verts, fvals, done, iters, step

    def exit_flag(self, state, max_iterations):
        """The flag the last `nm_accept` wrote."""
        return self.flag
