"""Motion-only pose optimization (the per-frame hot solver).

Counterpart of c_orb_slam_tpu/optim/pose_opt.py (reference:
src/Optimizer.cc:239-451 PoseOptimization): 4 rounds x 10 Gauss-Newton
iterations on the 6x6 normal system, inlier reclassification at
chi2 = 5.991 / 7.815 between rounds, Huber kernel for rounds 0-1.
Everything stays on the device: no value is read back inside the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from c_orb_slam_tpu_torch.geometry import se3
from c_orb_slam_tpu_torch.optim import residuals as res


class PoseOptResult(NamedTuple):
    pose: torch.Tensor  # (..., 3, 4) optimized Tcw
    inliers: torch.Tensor  # (..., N) bool
    n_inliers: torch.Tensor  # (...) int32


def optimize_pose(
    T0: torch.Tensor,
    xw: torch.Tensor,
    obs: torch.Tensor,
    inv_sigma2: torch.Tensor,
    is_stereo: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    bf: float = 0.0,
    rounds: int = 4,
    iters: int = 10,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    damping: float = 1e-5,
) -> PoseOptResult:
    """Optimize a camera pose against fixed 3D points.

    xw: (N, 3) world points; obs: (N, 3) (u, v, ur) with ur ignored for
    mono rows; valid: initial match mask. A leading batch dimension on T0
    (..., 3, 4) and xw/obs (..., N, .) solves that many independent
    problems at once (the JAX package vmaps this function); the
    per-observation arrays broadcast against it."""
    chi2_th = torch.where(
        is_stereo, torch.tensor(chi2_stereo, device=xw.device),
        torch.tensor(chi2_mono, device=xw.device),
    )
    eye6 = damping * torch.eye(6, dtype=xw.dtype, device=xw.device)
    T = T0
    inlier_mask = valid
    for rnd in range(rounds):
        weight_mask = inlier_mask.to(torch.float32)
        for _ in range(iters):
            r, J, _ = res.residual_and_jacobians(T, xw, obs, K, bf, is_stereo)
            w = inv_sigma2 * weight_mask
            if rnd < 2:  # the reference drops the kernel from round 3
                w = w * res.huber_weight(res.chi2(r, inv_sigma2), chi2_th)
            Jw = J * w[..., None, None]
            H = torch.einsum("...nij,...nik->...jk", Jw, J) + eye6
            b = torch.einsum("...nij,...ni->...j", Jw, r)
            # r = obs - pred; J = d r / d xi  =>  normal eq H dx = -b.
            # solve_ex: no error check, so no device sync per iteration.
            dx = torch.linalg.solve_ex(H, -b)[0]
            T = se3.compose(se3.exp(dx), T)
        r, _, _ = res.residual_and_jacobians(T, xw, obs, K, bf, is_stereo)
        inlier_mask = valid & (res.chi2(r, inv_sigma2) <= chi2_th)
    return PoseOptResult(
        pose=T, inliers=inlier_mask, n_inliers=inlier_mask.sum(-1, dtype=torch.int32)
    )
