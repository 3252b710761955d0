"""Batched PnP RANSAC for relocalization.

Counterpart of c_orb_slam_tpu/ops/pnp.py (reference: src/PnPsolver.cc,
driven from Tracking::Relocalization, src/Tracking.cc:1398-1447). Every
hypothesis is solved at once along a leading batch dimension: a 6-point
DLT (batched 12x12 eigendecomposition, Procrustes projection of the
rotation) refined by motion-only Gauss-Newton on its own sample, ranked
by per-octave chi2 inlier count (PnPsolver.cc:308-339); the top 8 are
polished on their consensus sets, a second LO-RANSAC round draws from
the best consensus, and the winner gets a final polish.

Draws come from a torch.Generator on the tensors' device, so they cannot
reproduce the JAX package's jax.random stream: ``idx`` injects the first
round's sample sets (tests pass the JAX draw); the second round always
draws internally.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from c_orb_slam_tpu_torch.geometry import se3
from c_orb_slam_tpu_torch.ops.match import _top_k_stable
from c_orb_slam_tpu_torch.ops.ransac import draw
from c_orb_slam_tpu_torch.optim import pose_opt

CHI2_2DOF = 5.991


class PnPResult(NamedTuple):
    ok: torch.Tensor  # () bool
    pose: torch.Tensor  # (3, 4) Tcw
    inliers: torch.Tensor  # (M,) bool
    n_inliers: torch.Tensor  # () int32


def _dlt_pose(xw: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """6+ point DLT, batched: P (3x4) from world points xw (..., k, 3) and
    normalized image coords xn (..., k, 2), Hartley-normalized on both
    sides, then projected onto SE(3) (see the JAX package for why the
    normalization is needed in float32)."""
    dt, dev = xw.dtype, xw.device
    cw = xw.mean(-2)
    dw = xw - cw[..., None, :]
    sw = math.sqrt(3.0) / torch.clamp(torch.linalg.vector_norm(dw, dim=-1).mean(-1), min=1e-9)
    xw_n = dw * sw[..., None, None]
    ci = xn.mean(-2)
    di = xn - ci[..., None, :]
    si = math.sqrt(2.0) / torch.clamp(torch.linalg.vector_norm(di, dim=-1).mean(-1), min=1e-9)
    xn_n = di * si[..., None, None]

    Xh = torch.cat([xw_n, torch.ones_like(xw_n[..., :1])], dim=-1)  # (..., k, 4)
    zeros = torch.zeros_like(Xh)
    rows_a = torch.cat([Xh, zeros, -xn_n[..., 0:1] * Xh], dim=-1)  # (..., k, 12)
    rows_b = torch.cat([zeros, Xh, -xn_n[..., 1:2] * Xh], dim=-1)
    A = torch.cat([rows_a, rows_b], dim=-2)  # (..., 2k, 12)
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    pn = V[..., :, 0].reshape(*V.shape[:-2], 3, 4)
    # Denormalize: P = T_img^-1 @ P_n @ T_world.
    zero, one = torch.zeros_like(si), torch.ones_like(si)
    Timg_inv = torch.stack(
        [
            torch.stack([1.0 / si, zero, ci[..., 0]], dim=-1),
            torch.stack([zero, 1.0 / si, ci[..., 1]], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )
    eye3 = torch.eye(3, dtype=dt, device=dev)
    Tw_top = torch.cat([sw[..., None, None] * eye3, (-sw[..., None] * cw)[..., :, None]], dim=-1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=dt, device=dev).expand(*Tw_top.shape[:-2], 1, 4)
    Tw = torch.cat([Tw_top, bottom], dim=-2)
    p = Timg_inv @ pn @ Tw
    # Scale: |det| -> 1; sign: points in front (positive depth mean).
    scale = torch.linalg.det(p[..., :3]).abs() ** (1.0 / 3.0)
    p = p / torch.clamp(scale, min=1e-12)[..., None, None]
    z = (xw @ p[..., 2, :3, None])[..., 0] + p[..., 2, 3, None]
    sign = torch.where(torch.sign(z).sum(-1) < 0, -1.0, 1.0)
    p = p * sign[..., None, None]
    # Procrustes: nearest rotation to the 3x3 block.
    U, _, Vt = torch.linalg.svd(p[..., :3])
    d = torch.sign(torch.linalg.det(U @ Vt))
    flip = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = (U * flip[..., None, :]) @ Vt
    return se3.make(R, p[..., 3])


def solve_pnp_ransac(
    xw: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    inv_sigma2: torch.Tensor,
    K: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    n_hypotheses: int = 256,
    min_inliers: int = 15,
    idx: Optional[torch.Tensor] = None,
) -> PnPResult:
    """3D-2D RANSAC pose. xw: (M, 3) world points; uv: (M, 2) pixels;
    idx: optional (n_hypotheses, 6) first-round sample sets."""
    m = xw.shape[0]
    dt = xw.dtype
    xn = torch.stack([(uv[:, 0] - K[2]) / K[0], (uv[:, 1] - K[3]) / K[1]], dim=1)
    if idx is None:
        idx = draw(valid, n_hypotheses, 6, generator)
    idx = idx.long()
    B = idx.shape[0]

    def count_inliers(T):
        """Inlier count and mask of every pose in T (..., 3, 4)."""
        xc = xw @ se3.rotation(T).transpose(-1, -2) + se3.translation(T)[..., None, :]
        z = torch.clamp(xc[..., 2], min=1e-9)
        u = K[0] * xc[..., 0] / z + K[2]
        v = K[1] * xc[..., 1] / z + K[3]
        e2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
        inl = (e2 * inv_sigma2 <= CHI2_2DOF) & (xc[..., 2] > 0) & valid
        return inl.sum(-1, dtype=torch.int32), inl

    obs3 = torch.cat([uv, torch.zeros_like(uv[:, :1])], dim=1)
    no_stereo = torch.zeros(m, dtype=torch.bool, device=xw.device)

    def polish(T, inl, rounds, iters):
        """GN of each pose in T (n, 3, 4) on its consensus set inl (n, M)."""
        n = T.shape[0]
        r = pose_opt.optimize_pose(
            T, xw.expand(n, m, 3), obs3.expand(n, m, 3), inv_sigma2, no_stereo, inl, K, 0.0,
            rounds=rounds, iters=iters,
        )
        return r.pose

    # Each minimal hypothesis: 6-point DLT, then GN on its own sample in
    # normalized coordinates (K = identity).
    xs, ns = xw[idx], xn[idx]  # (B, 6, 3), (B, 6, 2)
    T0 = _dlt_pose(xs, ns)
    Kn = torch.tensor([1.0, 1.0, 0.0, 0.0], dtype=dt, device=xw.device)
    poses = pose_opt.optimize_pose(
        T0, xs, torch.cat([ns, torch.zeros_like(ns[..., :1])], dim=-1),
        torch.full((B, 6), 1e6, dtype=dt, device=xw.device),
        torch.zeros((B, 6), dtype=torch.bool, device=xw.device),
        torch.ones((B, 6), dtype=torch.bool, device=xw.device), Kn, 0.0, rounds=1, iters=8,
    ).pose
    counts, inls = count_inliers(poses)

    # Polish the top 8 on their consensus sets and re-score.
    top = _top_k_stable(counts, min(8, B))
    pT = polish(poses[top], inls[top], 1, 8)
    pc, pinl = count_inliers(pT)
    bestp = torch.argmax(pc)
    T_best, inliers0 = pT[bestp], pinl[bestp]

    # LO-RANSAC: a second round of minimal samples from the best
    # consensus set only (plain DLT, no per-sample GN).
    idx2 = draw(inliers0.to(torch.float32) + 1e-6, 64, 6, generator)
    poses2 = _dlt_pose(xw[idx2], xn[idx2])
    counts2, inls2 = count_inliers(poses2)
    top2 = _top_k_stable(counts2, 4)
    pT2 = polish(poses2[top2], inls2[top2], 1, 8)
    pc2, pinl2 = count_inliers(pT2)
    best2 = torch.argmax(pc2)
    use2 = pc2[best2] > pc[bestp]
    T_best = torch.where(use2, pT2[best2], T_best)
    inliers0 = torch.where(use2, pinl2[best2], inliers0)

    # Final polish with more rounds on the winner's consensus set.
    refined = pose_opt.optimize_pose(
        T_best, xw, obs3, inv_sigma2, no_stereo, inliers0, K, 0.0, rounds=2, iters=10,
    )
    return PnPResult(
        ok=refined.n_inliers >= min_inliers, pose=refined.pose,
        inliers=refined.inliers, n_inliers=refined.n_inliers,
    )
