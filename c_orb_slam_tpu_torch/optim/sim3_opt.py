"""Gauss-Newton refinement of a single Sim(3): the loop-alignment polish.

Counterpart of c_orb_slam_tpu/optim/sim3_opt.py (reference:
src/Optimizer.cc OptimizeSim3 (:1046-1241) — one VertexSim3Expmap plus
paired fixed points with bidirectional reprojection edges (:1140-1173),
Huber sqrt(10), two stages with chi2>10 inlier pruning between them
(:1180-1217); scale fixed for stereo/RGB-D).

All matches are one fixed-shape batch; the 7-dof Jacobians come from
``torch.func.jacrev`` under ``vmap`` of the residual wrt the
left-multiplied tangent update — a (M, 4, 7) tensor contracted into a 7x7
normal system.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacrev, vmap

from c_orb_slam_tpu_torch.geometry import sim3


class Sim3OptResult(NamedTuple):
    S12: torch.Tensor  # (8,) refined Sim3
    inliers: torch.Tensor  # (M,) bool
    n_inliers: torch.Tensor


def _project(K, x):
    z = torch.clamp(x[..., 2], min=1e-9)
    return torch.stack(
        [K[0] * x[..., 0] / z + K[2], K[1] * x[..., 1] / z + K[3]], dim=-1
    )


def _residual(xi, S12, x1, x2, uv1, uv2, K1, K2):
    """(4,) stacked bidirectional reprojection residual for one match,
    at the left-perturbed pose S = exp(xi) ∘ S12."""
    S = sim3.compose(sim3.exp(xi), S12)
    S21 = sim3.inverse(S)
    e1 = uv1 - _project(K1, sim3.apply(S, x2))
    e2 = uv2 - _project(K2, sim3.apply(S21, x1))
    return torch.cat([e1, e2])


def optimize_sim3(
    S12: torch.Tensor,
    x1: torch.Tensor,
    x2: torch.Tensor,
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    inv_sigma2_1: torch.Tensor,
    inv_sigma2_2: torch.Tensor,
    valid: torch.Tensor,
    K1: torch.Tensor,
    K2: torch.Tensor,
    fix_scale: bool = False,
    iters_per_stage: int = 5,
    chi2_gate: float = 10.0,
) -> Sim3OptResult:
    """Two-stage GN on S12 (maps camera-2 coords into camera-1).

    x1/x2: (M, 3) matched points in each camera frame; uv1/uv2 observed
    pixels; inv_sigma2_*: per-match information (by octave).
    """
    delta2 = chi2_gate  # Huber delta^2 = 10 (reference: :1134 sqrt(10))
    dev, dt = S12.device, S12.dtype
    xi0 = torch.zeros(7, dtype=dt, device=dev)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    # Fixed scale: the last tangent coordinate is taken out of the system.
    dof = torch.ones(7, dtype=dt, device=dev)
    if fix_scale:
        dof[6] = 0.0
    w_info = torch.cat(
        [inv_sigma2_1[:, None].expand(-1, 2), inv_sigma2_2[:, None].expand(-1, 2)],
        dim=1,
    )  # (M, 4)

    def chi2_parts(S):
        S21 = sim3.inverse(S)
        e1 = uv1 - _project(K1, sim3.apply(S, x2))
        e2 = uv2 - _project(K2, sim3.apply(S21, x1))
        return (e1 * e1).sum(-1) * inv_sigma2_1, (e2 * e2).sum(-1) * inv_sigma2_2

    def gn_stage(S, mask):
        for _ in range(iters_per_stage):
            def res_fn(xi, a, b, u, v, S=S):
                return _residual(xi, S, a, b, u, v, K1, K2)

            r = vmap(res_fn, in_dims=(None, 0, 0, 0, 0))(xi0, x1, x2, uv1, uv2)
            J = vmap(jacrev(res_fn), in_dims=(None, 0, 0, 0, 0))(
                xi0, x1, x2, uv1, uv2
            )  # (M, 4, 7)
            # Huber on the per-direction chi2.
            c1 = (r[:, :2] ** 2).sum(1) * inv_sigma2_1
            c2 = (r[:, 2:] ** 2).sum(1) * inv_sigma2_2
            hw1 = torch.where(c1 > delta2, torch.sqrt(delta2 / torch.clamp(c1, min=1e-12)), 1.0)
            hw2 = torch.where(c2 > delta2, torch.sqrt(delta2 / torch.clamp(c2, min=1e-12)), 1.0)
            hw = torch.cat([hw1[:, None].expand(-1, 2), hw2[:, None].expand(-1, 2)], 1)
            w = w_info * hw * mask[:, None]
            Jw = J * w[:, :, None]
            H = torch.einsum("mia,mib->ab", Jw, J)
            g = -torch.einsum("mia,mi->a", Jw, r)
            H = H * dof[:, None] * dof[None, :] + torch.diag(1.0 - dof)
            g = g * dof
            H = H + 1e-6 * eye7
            xi = torch.linalg.solve(H, g)
            S = sim3.compose(sim3.exp(xi), S)
        return S

    mask0 = valid.to(dt)
    S1 = gn_stage(S12, mask0)
    c1, c2 = chi2_parts(S1)
    keep = valid & (c1 < chi2_gate) & (c2 < chi2_gate)
    S2 = gn_stage(S1, keep.to(dt))
    c1, c2 = chi2_parts(S2)
    inl = keep & (c1 < chi2_gate) & (c2 < chi2_gate)
    return Sim3OptResult(S12=S2, inliers=inl, n_inliers=inl.sum(dtype=torch.int32))
