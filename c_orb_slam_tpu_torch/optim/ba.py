"""Bundle adjustment: Levenberg-Marquardt on the Schur complement.

Counterpart of c_orb_slam_tpu/optim/ba.py (reference: Optimizer.cc:49
BundleAdjustment, :453-778 LocalBundleAdjustment and g2o's
block_solver.hpp Schur solve). The camera-point graph is a flat
observation list (obs_cam, obs_pt); one LM iteration is
residuals/Jacobians -> per-camera and per-point normal blocks (index_add)
-> the reduced camera system S = Hcc - W Hpp^-1 Wᵀ -> point
back-substitution. Two routes solve the reduced system, chosen by
``schur``: "dense" forms S and solves it by Cholesky (local BA, small
C); "pcg" never forms S or W and runs preconditioned conjugate gradients
on the implicit matvec S·x = Hcc·x − W·Hpp⁻¹·Wᵀ·x, two gathers and two
index_adds an application (global BA, where the dense W would not fit).
``schur`` defaults to "dense" here (the JAX package defaults to "pcg").
Fixed cameras get zero Jacobians; invalid slots are masked.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from c_orb_slam_tpu_torch.geometry import se3
from c_orb_slam_tpu_torch.optim import residuals as res


class BAProblem(NamedTuple):
    """Fixed-shape bundle-adjustment problem (SoA)."""

    cam_T: torch.Tensor  # (C, 3, 4) world->cam poses
    cam_fixed: torch.Tensor  # (C,) bool: pose held constant
    cam_valid: torch.Tensor  # (C,) bool: slot live
    points: torch.Tensor  # (P, 3)
    point_valid: torch.Tensor  # (P,) bool
    obs_cam: torch.Tensor  # (O,) int32
    obs_pt: torch.Tensor  # (O,) int32
    obs_uv: torch.Tensor  # (O, 3) (u, v, ur); ur ignored for mono rows
    obs_stereo: torch.Tensor  # (O,) bool
    obs_inv_sigma2: torch.Tensor  # (O,)
    obs_valid: torch.Tensor  # (O,) bool
    K: torch.Tensor  # (4,)
    bf: torch.Tensor  # () float


class BAResult(NamedTuple):
    cam_T: torch.Tensor
    points: torch.Tensor
    obs_inlier: torch.Tensor  # (O,) bool post-optimization gate
    final_chi2: torch.Tensor  # () mean inlier chi2


def _chi2_th(p: BAProblem, chi2_mono: float, chi2_stereo: float) -> torch.Tensor:
    dev = p.obs_uv.device
    return torch.where(
        p.obs_stereo, torch.tensor(chi2_stereo, device=dev), torch.tensor(chi2_mono, device=dev)
    )


def _obs_terms(p: BAProblem, cam_T, points, use_huber, chi2_mono, chi2_stereo):
    """Residuals, Jacobians, IRLS weights for every observation."""
    T = cam_T[p.obs_cam.long()]
    xw = points[p.obs_pt.long()]
    r, Jc, Jp = res.residual_and_jacobians(T, xw, p.obs_uv, p.K, p.bf, p.obs_stereo)
    c2 = res.chi2(r, p.obs_inv_sigma2)
    w = p.obs_inv_sigma2 * p.obs_valid.to(r.dtype)
    if use_huber:
        w = w * res.huber_weight(c2, _chi2_th(p, chi2_mono, chi2_stereo))
    # Behind-camera points poison the linearization: drop them this iter.
    w = w * (se3.apply(T, xw)[..., 2] > 1e-3).to(r.dtype)
    # Fixed cameras contribute no pose Jacobian.
    Jc = Jc * (1.0 - p.cam_fixed[p.obs_cam.long()].to(r.dtype))[:, None, None]
    return r, Jc, Jp, w, c2


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg.long(), x)


def _assemble(p: BAProblem, r, Jc, Jp, w, lm_lambda):
    """Normal-equation blocks: Hcc (C,6,6), Hpp^-1 (P,3,3), gc, gp."""
    C = p.cam_T.shape[0]
    P = p.points.shape[0]
    Jcw = Jc * w[:, None, None]
    Jpw = Jp * w[:, None, None]
    Hcc = _segment_sum(Jcw.transpose(1, 2) @ Jc, p.obs_cam, C)
    gc = _segment_sum((Jcw.transpose(1, 2) @ r[..., None])[..., 0], p.obs_cam, C)
    Hpp = _segment_sum(Jpw.transpose(1, 2) @ Jp, p.obs_pt, P)
    gp = _segment_sum((Jpw.transpose(1, 2) @ r[..., None])[..., 0], p.obs_pt, P)
    eye6 = torch.eye(6, dtype=r.dtype, device=r.device)
    eye3 = torch.eye(3, dtype=r.dtype, device=r.device)
    # LM damping; dead camera/point slots get identity so inverses exist.
    free_cam = (p.cam_valid & ~p.cam_fixed).to(r.dtype)[:, None, None]
    Hcc = Hcc + lm_lambda * eye6 + (1.0 - free_cam) * eye6
    live_pt = p.point_valid.to(r.dtype)[:, None, None]
    Hpp = Hpp + lm_lambda * eye3 + (1.0 - live_pt) * eye3
    return Hcc, _inv3x3(Hpp), gc, gp


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    inv_det = 1.0 / torch.where(det.abs() < 1e-20, torch.full_like(det, 1e-20), det)
    adj = torch.stack(
        [
            torch.stack([A00, A01, A02], dim=-1),
            torch.stack([A10, A11, A12], dim=-1),
            torch.stack([A20, A21, A22], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def _solve_cameras_dense(p: BAProblem, Jc, Jp, w, Hcc, Hpp_inv, gc, gp, free_cam):
    """Explicit dense Schur complement + Cholesky solve of the (6C, 6C)
    reduced camera system. Returns dc (C, 6)."""
    C = p.cam_T.shape[0]
    P = p.points.shape[0]
    # Dense W (6C x 3P): per-observation 6x3 blocks summed by the flat
    # (point, camera) key.
    B = (Jc * w[:, None, None]).transpose(1, 2) @ Jp  # (O, 6, 3)
    key = p.obs_pt.long() * C + p.obs_cam.long()
    Wpc = _segment_sum(B.reshape(-1, 18), key, P * C)
    W = Wpc.reshape(P, C, 6, 3).permute(1, 2, 0, 3).reshape(C * 6, P * 3)
    WH = torch.einsum("cpj,pjk->cpk", W.reshape(C * 6, P, 3), Hpp_inv)  # (6C, P, 3)
    S = -(WH.reshape(C * 6, P * 3) @ W.T)
    ar = torch.arange(C, device=S.device)
    S4 = S.view(C, 6, C, 6)
    S4[ar, :, ar, :] = S4[ar, :, ar, :] + Hcc  # block diagonal
    rhs = -(gc - torch.einsum("cpj,pj->c", WH, gp).reshape(C, 6))
    # Fixed/dead cameras: identity rows/cols, zero rhs.
    free6 = free_cam.repeat_interleave(6)
    S = S * free6[:, None] * free6[None, :] + torch.diag(1.0 - free6)
    rhs = rhs * free_cam[:, None]
    L = torch.linalg.cholesky_ex(S)[0]  # SPD after masking
    dc = torch.cholesky_solve(rhs.reshape(C * 6, 1), L).reshape(C, 6)
    return dc * free_cam[:, None]


def _w_times(p: BAProblem, Jc, Jp, w, y):
    """W @ y for per-point y (P, 3) -> (C, 6), without forming W."""
    s = (Jp @ y[p.obs_pt.long()][..., None])[..., 0] * w[:, None]  # (O, 3)
    return _segment_sum((Jc.transpose(1, 2) @ s[..., None])[..., 0], p.obs_cam, p.cam_T.shape[0])


def _wt_times(p: BAProblem, Jc, Jp, w, x):
    """Wᵀ @ x for per-camera x (C, 6) -> (P, 3), without forming W."""
    u = (Jc @ x[p.obs_cam.long()][..., None])[..., 0] * w[:, None]  # (O, 3)
    return _segment_sum((Jp.transpose(1, 2) @ u[..., None])[..., 0], p.obs_pt, p.points.shape[0])


def _schur_matvec(p: BAProblem, Jc, Jp, w, Hcc, Hpp_inv, x, free_cam):
    """S @ x without materializing S. x: (C, 6)."""
    x = x * free_cam[:, None]
    hx = (Hcc @ x[..., None])[..., 0]
    y = (Hpp_inv @ _wt_times(p, Jc, Jp, w, x)[..., None])[..., 0]
    return (hx - _w_times(p, Jc, Jp, w, y)) * free_cam[:, None]


def _pcg(matvec, precond, b, iters: int):
    """Fixed-iteration preconditioned conjugate gradients."""
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    d = z
    rz = (r * z).sum()
    for _ in range(iters):
        Ad = matvec(d)
        alpha = rz / torch.clamp((d * Ad).sum(), min=1e-20)
        x = x + alpha * d
        r = r - alpha * Ad
        z = precond(r)
        rz_new = (r * z).sum()
        beta = rz_new / torch.clamp(rz, min=1e-20)
        d = z + beta * d
        rz = rz_new
    return x


def _solve_cameras_pcg(p: BAProblem, Jc, Jp, w, Hcc, Hpp_inv, gc, gp, free_cam, pcg_iters):
    """PCG on the implicit Schur system, block-Jacobi (Hcc^-1)
    preconditioner. Returns dc (C, 6)."""
    # Schur RHS: -(gc - W Hpp^-1 gp)
    y = (Hpp_inv @ gp[..., None])[..., 0]
    rhs = -(gc - _w_times(p, Jc, Jp, w, y)) * free_cam[:, None]
    Hcc_inv = torch.linalg.inv(Hcc)

    def matvec(x):
        return _schur_matvec(p, Jc, Jp, w, Hcc, Hpp_inv, x, free_cam)

    def precond(x):
        return (Hcc_inv @ x[..., None])[..., 0] * free_cam[:, None]

    return _pcg(matvec, precond, rhs, pcg_iters)


def ba_iteration(
    p: BAProblem, lm_lambda, use_huber, chi2_mono, chi2_stereo,
    pcg_iters: int = 40, schur: str = "dense",
):
    """One damped GN step. Returns (new_cam_T, new_points, dc, dp)."""
    r, Jc, Jp, w, _ = _obs_terms(p, p.cam_T, p.points, use_huber, chi2_mono, chi2_stereo)
    Hcc, Hpp_inv, gc, gp = _assemble(p, r, Jc, Jp, w, lm_lambda)
    free_cam = (p.cam_valid & ~p.cam_fixed).to(r.dtype)
    if schur == "dense":
        dc = _solve_cameras_dense(p, Jc, Jp, w, Hcc, Hpp_inv, gc, gp, free_cam)
    else:
        dc = _solve_cameras_pcg(
            p, Jc, Jp, w, Hcc, Hpp_inv, gc, gp, free_cam, pcg_iters
        )
    # dp = Hpp^-1 (-gp - Wᵀ dc)
    u = (Jc @ dc[p.obs_cam.long()][..., None])[..., 0] * w[:, None]
    Wt_dc = _segment_sum((Jp.transpose(1, 2) @ u[..., None])[..., 0], p.obs_pt, p.points.shape[0])
    dp = (Hpp_inv @ (-gp - Wt_dc)[..., None])[..., 0]
    dp = dp * p.point_valid.to(dp.dtype)[:, None]
    new_T = se3.compose(se3.exp(dc), p.cam_T)
    new_T = torch.where(free_cam[:, None, None] > 0, new_T, p.cam_T)
    return new_T, p.points + dp, dc, dp


def _total_error(p, cam_T, points, use_huber, chi2_mono, chi2_stereo):
    r, _, _, w, c2 = _obs_terms(p, cam_T, points, use_huber, chi2_mono, chi2_stereo)
    chi2_th = _chi2_th(p, chi2_mono, chi2_stereo)
    mask = p.obs_valid.to(r.dtype)
    # Huber-robustified total (rho(chi2)), like g2o's activeRobustChi2.
    robust = torch.where(
        c2 <= chi2_th,
        c2,
        2.0 * torch.sqrt(chi2_th) * torch.sqrt(torch.clamp(c2, min=1e-12)) - chi2_th,
    )
    return ((robust if use_huber else c2) * mask).sum()


def sort_by_point(p: BAProblem) -> BAProblem:
    """Observations sorted by (point, camera), stable (as jnp.argsort)."""
    C = p.cam_T.shape[0]
    perm = torch.argsort(p.obs_pt.long() * C + p.obs_cam.long(), stable=True)
    return p._replace(
        obs_cam=p.obs_cam[perm],
        obs_pt=p.obs_pt[perm],
        obs_uv=p.obs_uv[perm],
        obs_stereo=p.obs_stereo[perm],
        obs_inv_sigma2=p.obs_inv_sigma2[perm],
        obs_valid=p.obs_valid[perm],
    )


def stage_error(p: BAProblem, use_huber=True, chi2_mono=5.991, chi2_stereo=7.815):
    """Initial total error for an LM stage (pairs with lm_step)."""
    return _total_error(p, p.cam_T, p.points, use_huber, chi2_mono, chi2_stereo)


def lm_step(
    p: BAProblem, lam, err, use_huber=True, chi2_mono=5.991, chi2_stereo=7.815,
    pcg_iters: int = 40, schur: str = "dense",
):
    """ONE damped LM iteration with accept/reject, on device (no
    readback): the incremental global BA dispatches one of these per
    tracked frame instead of a single monolithic solve, so tracking
    interleaves with the solve on the device — the functional analog of
    the reference's background GBA thread (LoopClosing.cc:645-749).
    Returns (cam_T, points, lam, err)."""
    new_T, new_pts, _, _ = ba_iteration(
        p, lam, use_huber, chi2_mono, chi2_stereo, pcg_iters, schur
    )
    new_err = _total_error(p, new_T, new_pts, use_huber, chi2_mono, chi2_stereo)
    accept = new_err < err
    return (
        torch.where(accept, new_T, p.cam_T),
        torch.where(accept, new_pts, p.points),
        torch.where(accept, lam * 0.5, lam * 4.0),
        torch.where(accept, new_err, err),
    )


def optimize(
    p: BAProblem,
    iters: int = 10,
    use_huber: bool = True,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    lm_lambda0: float = 1e-4,
    pcg_iters: int = 40,
    schur: str = "dense",
):
    """LM loop with accept/reject damping. Returns (cam_T, points)."""
    p = sort_by_point(p)
    err = _total_error(p, p.cam_T, p.points, use_huber, chi2_mono, chi2_stereo)
    lam = torch.tensor(lm_lambda0, dtype=torch.float32, device=p.points.device)
    for _ in range(iters):
        cam_T, points, lam, err = lm_step(
            p, lam, err, use_huber, chi2_mono, chi2_stereo, pcg_iters, schur
        )
        p = p._replace(cam_T=cam_T, points=points)
    return p.cam_T, p.points


def classify_inliers(p: BAProblem, chi2_mono: float = 5.991, chi2_stereo: float = 7.815):
    """Post-optimization gate: chi2 within threshold AND positive depth
    (reference: Optimizer.cc:676-705)."""
    T = p.cam_T[p.obs_cam.long()]
    xw = p.points[p.obs_pt.long()]
    r, _, _ = res.residual_and_jacobians(T, xw, p.obs_uv, p.K, p.bf, p.obs_stereo)
    c2 = res.chi2(r, p.obs_inv_sigma2)
    z = se3.apply(T, xw)[..., 2]
    return p.obs_valid & (c2 <= _chi2_th(p, chi2_mono, chi2_stereo)) & (z > 0)


def bundle_adjust(
    p: BAProblem,
    iters_first: int = 5,
    iters_second: int = 10,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    pcg_iters: int = 40,
    schur: str = "dense",
) -> BAResult:
    """Two-stage BA with outlier re-classification between stages
    (reference: Optimizer.cc:659-709 LocalBundleAdjustment flow)."""
    cam_T, points = optimize(
        p, iters=iters_first, use_huber=True, chi2_mono=chi2_mono, chi2_stereo=chi2_stereo,
        pcg_iters=pcg_iters, schur=schur,
    )
    p = p._replace(cam_T=cam_T, points=points)
    p = p._replace(obs_valid=classify_inliers(p, chi2_mono, chi2_stereo))
    cam_T, points = optimize(
        p, iters=iters_second, use_huber=False, chi2_mono=chi2_mono, chi2_stereo=chi2_stereo,
        pcg_iters=pcg_iters, schur=schur,
    )
    p = p._replace(cam_T=cam_T, points=points)
    inlier = classify_inliers(p, chi2_mono, chi2_stereo)
    r, _, _ = res.residual_and_jacobians(
        cam_T[p.obs_cam.long()], points[p.obs_pt.long()], p.obs_uv, p.K, p.bf, p.obs_stereo
    )
    c2 = res.chi2(r, p.obs_inv_sigma2)
    n = torch.clamp(inlier.to(torch.float32).sum(), min=1.0)
    mean_chi2 = torch.where(inlier, c2, torch.zeros_like(c2)).sum() / n
    return BAResult(cam_T=cam_T, points=points, obs_inlier=inlier, final_chi2=mean_chi2)
