"""Bundle adjustment: batched Jacobians + matrix-free Schur-complement CG.

  * per-observation residuals r = project(K, R0 dR(w), C0 + dC; X) - obs
    with Huber robustification; Jacobians for all observations in one
    `torch.func.vmap` of `jacfwd` (fixed (2, 6) and (2, 3) blocks, no
    sparse assembly);
  * Levenberg-Marquardt normal equations reduced by the Schur complement
    over points; the reduced camera system S = U - W V^-1 W^T is never
    formed: CG applies S x through two segment sums per iteration
    (observations -> points -> observations);
  * the point update is the back-substitution dX_p = V_p^-1 (g_p - W^T dx_c).

Camera intrinsics stay fixed (MVS input cameras are pre-calibrated);
extrinsics are a local axis-angle rotation delta and a camera-centre delta.
Everything is f32 on the device of the problem's tensors. The CG has a
fixed length and the LM accept/reject is a `torch.where`, so the solve
queues its work without waiting on the device. The segment sums add in a
fixed order, so one problem gives one solution, run after run.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.func import jacfwd, vmap

__all__ = ["BAProblem", "run_ba", "reprojection_rmse", "rodrigues"]


@dataclasses.dataclass(frozen=True)
class BAProblem:
    """K/R0/C0: (V,3,3),(V,3,3),(V,3) f32; points0: (N,3) f32;
    obs_point/obs_view: (M,) int64; obs_xy: (M,2) f32; obs_mask: (M,) bool."""

    K: torch.Tensor
    R0: torch.Tensor
    C0: torch.Tensor
    points0: torch.Tensor
    obs_point: torch.Tensor
    obs_view: torch.Tensor
    obs_xy: torch.Tensor
    obs_mask: torch.Tensor


def rodrigues(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (...,3) -> rotation matrix (...,3,3).

    R = I + A [w]_x + B [w]_x^2 with A = sin(t)/t, B = (1-cos t)/t^2 and
    Taylor forms near t = 0, guarded by the double-where trick so forward
    derivatives are exact and finite at w = 0 (BA linearizes there every
    outer iteration).
    """
    # t2 keeps its last axis: under `jacfwd` a 0-dim tensor met with a
    # Python float is promoted to float64.
    t2 = (w * w).sum(-1, keepdim=True)
    small = t2 < 1e-8
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    t_safe = torch.sqrt(t2_safe)
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t_safe) / t_safe)
    B = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(t_safe)) / t2_safe)
    wx, wy, wz = w.unbind(-1)
    zero = torch.zeros_like(wx)
    Wx = torch.stack(
        [
            torch.stack([zero, -wz, wy], -1),
            torch.stack([wz, zero, -wx], -1),
            torch.stack([-wy, wx, zero], -1),
        ],
        -2,
    )
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(Wx.shape)
    return eye + A[..., None] * Wx + B[..., None] * (Wx @ Wx)


def _project_residual(cam6, X, K, R0, C0, obs_xy):
    """Residual(s) of observations; cam6 = (w(3), dC(3)). Leading batch
    dimensions broadcast."""
    R = R0 @ rodrigues(cam6[..., :3])
    C = C0 + cam6[..., 3:]
    cam = torch.einsum("...ij,...j->...i", R, X - C)
    pix_h = torch.einsum("...ij,...j->...i", K, cam)
    return pix_h[..., :2] / pix_h[..., 2:3] - obs_xy


def _gather(problem: BAProblem, cam_params, points):
    v = problem.obs_view
    return (cam_params[v], points[problem.obs_point], problem.K[v],
            problem.R0[v], problem.C0[v], problem.obs_xy)


def _residuals(problem: BAProblem, cam_params, points):
    """r (M, 2) of all observations."""
    return _project_residual(*_gather(problem, cam_params, points))


def _with_residual(*args):
    r = _project_residual(*args)
    return r, r


def _residuals_and_jacobians(problem: BAProblem, cam_params, points):
    """(r (M,2), Jc (M,2,6), Jp (M,2,3)) for all observations."""
    (Jc, Jp), r = vmap(jacfwd(_with_residual, argnums=(0, 1), has_aux=True))(
        *_gather(problem, cam_params, points)
    )
    return r, Jc, Jp


def _huber_weights(r: torch.Tensor, delta: float) -> torch.Tensor:
    """sqrt IRLS weights per observation: w = min(1, delta/|r|)."""
    norm = torch.linalg.vector_norm(r, dim=-1)
    return torch.sqrt(torch.clamp_max(delta / torch.clamp_min(norm, 1e-12),
                                      1.0))


def _segment_sum(values, ids, n):
    """Sum the rows of `values` into `n` segments by `ids`. `index_put_`
    with `accumulate` adds in one order on every run (on CUDA it sorts the
    ids first), where `index_add_` adds f32 atomics in no fixed order and
    the same problem could end in another solution."""
    out = values.new_zeros((n,) + tuple(values.shape[1:]))
    return out.index_put_((ids,), values, accumulate=True)


def _schur_matvec(x, U, W, Vinv, obs_view, obs_point, num_views):
    """Apply S = U - W V^-1 W^T to stacked camera deltas x (V,6)."""
    y1 = torch.einsum("vij,vj->vi", U, x)
    t = torch.einsum("mij,mi->mj", W, x[obs_view])  # (M, 3) = W^T x per obs
    u_p = torch.einsum("pij,pj->pi", Vinv,
                       _segment_sum(t, obs_point, Vinv.shape[0]))
    z = torch.einsum("mij,mj->mi", W, u_p[obs_point])  # (M, 6)
    return y1 - _segment_sum(z, obs_view, num_views)


def _cg(matvec, b, iterations: int):
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = torch.dot(r, r)
    for _ in range(iterations):
        Ap = matvec(p)
        alpha = rs / torch.clamp_min(torch.dot(p, Ap), 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / torch.clamp_min(rs, 1e-20)) * p
        rs = rs_new
    return x


def run_ba(
    problem: BAProblem,
    max_outer_iterations: int = 10,
    cg_iterations: int = 50,
    damping: float = 1e-4,
    robust_delta: float = 2.0,
):
    """Levenberg-Marquardt with a Schur-complement CG, on the device of the
    problem's tensors. Returns (R (V,3,3), C (V,3), points (N,3), final
    mean robustified reprojection cost)."""
    V = problem.K.shape[0]
    N = problem.points0.shape[0]
    mask = problem.obs_mask.to(problem.obs_xy.dtype)
    n_obs = torch.clamp_min(mask.sum(), 1.0)
    obs_view, obs_point = problem.obs_view, problem.obs_point

    def cost(cam_params, points):
        r = _residuals(problem, cam_params, points)
        w = _huber_weights(r, robust_delta)
        return (((w[:, None] * r) ** 2).sum(-1) * mask).sum() / n_obs

    def outer(m):
        return torch.einsum("mri,mrj->mij", m, m)

    cam_params = problem.points0.new_zeros((V, 6))
    points = problem.points0
    lam = torch.tensor(damping, dtype=points.dtype, device=points.device)
    eye6 = torch.eye(6, dtype=points.dtype, device=points.device)
    eye3 = torch.eye(3, dtype=points.dtype, device=points.device)
    for _ in range(max_outer_iterations):
        r, Jc, Jp = _residuals_and_jacobians(problem, cam_params, points)
        w = (_huber_weights(r, robust_delta) * mask)[:, None]
        r = r * w
        Jc = Jc * w[:, :, None]
        Jp = Jp * w[:, :, None]

        U = _segment_sum(outer(Jc), obs_view, V) + lam * eye6
        Vp = _segment_sum(outer(Jp), obs_point, N) + lam * eye3
        W = torch.einsum("mri,mrj->mij", Jc, Jp)  # (M, 6, 3)
        g_c = -_segment_sum(torch.einsum("mri,mr->mi", Jc, r), obs_view, V)
        g_p = -_segment_sum(torch.einsum("mri,mr->mi", Jp, r), obs_point, N)
        # inv_ex: no host check of the factorization (which would wait on
        # the device); a singular block gives inf/nan as in the JAX solver.
        Vinv = torch.linalg.inv_ex(Vp)[0]

        # Reduced RHS: b = g_c - W V^-1 g_p (gathered per observation).
        u_p = torch.einsum("pij,pj->pi", Vinv, g_p)
        b = g_c - _segment_sum(
            torch.einsum("mij,mj->mi", W, u_p[obs_point]), obs_view, V
        )

        def matvec(x):
            return _schur_matvec(x.reshape(V, 6), U, W, Vinv, obs_view,
                                 obs_point, V).reshape(-1)

        dx_c = _cg(matvec, b.reshape(-1), cg_iterations).reshape(V, 6)

        # Back-substitute points: dX = V^-1 (g_p - W^T dx_c).
        t = _segment_sum(torch.einsum("mij,mi->mj", W, dx_c[obs_view]),
                         obs_point, N)
        dx_p = torch.einsum("pij,pj->pi", Vinv, g_p - t)

        new_cam = cam_params + dx_c
        new_points = points + dx_p
        accept = cost(new_cam, new_points) < cost(cam_params, points)
        cam_params = torch.where(accept, new_cam, cam_params)
        points = torch.where(accept, new_points, points)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
    R = problem.R0 @ rodrigues(cam_params[:, :3])
    C = problem.C0 + cam_params[:, 3:]
    return R, C, points, cost(cam_params, points)


def reprojection_rmse(problem: BAProblem, R, C, points) -> torch.Tensor:
    """Unrobustified RMS reprojection error in pixels over valid obs."""
    v = problem.obs_view
    cam = torch.einsum("mij,mj->mi", R[v], points[problem.obs_point] - C[v])
    pix_h = torch.einsum("mij,mj->mi", problem.K[v], cam)
    pix = pix_h[:, :2] / pix_h[:, 2:3]
    err2 = ((pix - problem.obs_xy) ** 2).sum(-1)
    m = problem.obs_mask.to(err2.dtype)
    return torch.sqrt((err2 * m).sum() / torch.clamp_min(m.sum(), 1.0))
