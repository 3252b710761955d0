"""Reprojection residuals + analytic Jacobians for the GN/LM engine.

Counterpart of c_orb_slam_tpu/optim/residuals.py (reference: g2o
EdgeSE3ProjectXYZ / EdgeStereoSE3ProjectXYZ,
types_six_dof_expmap.cpp:103-140). r = observation - projection; pose
updates are left-multiplied twists T <- exp(xi) * T, xi = [rho, phi].
Mono rows have the third component zeroed.
"""

from __future__ import annotations

import torch

from c_orb_slam_tpu_torch.geometry import camera, se3, so3


def transform_points(T: torch.Tensor, xw: torch.Tensor) -> torch.Tensor:
    """World points into the camera frame of T (3, 4)."""
    return se3.apply(T, xw)


def residual_and_jacobians(T, xw, obs, K, bf, is_stereo):
    """Per-observation residual (3,), pose Jacobian (3,6), point Jacobian
    (3,3) — batched over leading dims of xw/obs."""
    xc = se3.apply(T, xw)
    r = obs - camera.project_stereo(xc, K, bf)
    third = is_stereo.to(r.dtype)
    ones = torch.ones_like(third)
    row_mask = torch.stack([ones, ones, third], dim=-1)
    r = r * row_mask
    Jproj = camera.project_stereo_jacobian_point(xc, K, bf) * row_mask[..., :, None]
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(*Jproj.shape[:-2], 3, 3)
    Jxi = torch.cat([eye, -so3.hat(xc)], dim=-1)  # d(xc)/d(xi) = [I | -hat(xc)]
    J_pose = -(Jproj @ Jxi)
    R = se3.rotation(T)
    if xw.dim() > T.dim() - 1:  # (..., N, 3) points per transform
        R = R.unsqueeze(-3)
    J_point = -(Jproj @ R)
    return r, J_pose, J_point


def chi2(r: torch.Tensor, inv_sigma2: torch.Tensor) -> torch.Tensor:
    """Weighted squared error per observation."""
    return (r * r).sum(-1) * inv_sigma2


def huber_weight(chi2_val: torch.Tensor, delta2: torch.Tensor | float) -> torch.Tensor:
    """IRLS weight of the Huber kernel with threshold delta (chi2 space):
    1 inside, delta/sqrt(chi2) beyond (g2o RobustKernelHuber)."""
    e = torch.sqrt(torch.clamp(chi2_val, min=1e-12))
    delta = torch.sqrt(torch.as_tensor(delta2, dtype=chi2_val.dtype, device=chi2_val.device))
    return torch.where(chi2_val <= delta2, torch.ones_like(e), delta / e)
