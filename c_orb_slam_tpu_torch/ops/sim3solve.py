"""Batched Horn closed-form Sim(3) RANSAC for loop alignment.

Counterpart of c_orb_slam_tpu/ops/sim3solve.py (reference:
src/Sim3Solver.cc — sequential RANSAC over 3-point Horn 1987 quaternion
alignment (ComputeSim3 :226-337), inliers checked by two-way reprojection
(CheckInliers :340-364); scale fixed for stereo/RGB-D (:292-311)).

All hypotheses are solved in one batched pass. The 4x4 quaternion matrix
N is diagonalized in float64. In float32 the top eigenvectors of LAPACK
and of cuSOLVER (NVIDIA H100) agree to 1e-7 for most samples, but where
the quaternion's w is near 0 the sign rule below flips on one device and
not the other (a difference of 1.97 in 300 samples); in float64 they
agree to 1e-8 on every sample.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from c_orb_slam_tpu_torch.geometry import sim3, so3
from c_orb_slam_tpu_torch.ops.ransac import draw


class Sim3Result(NamedTuple):
    ok: torch.Tensor
    S12: torch.Tensor  # (8,) packed Sim3 mapping frame-2 coords to frame-1
    inliers: torch.Tensor  # (M,) bool
    n_inliers: torch.Tensor


def horn_matrix(M: torch.Tensor) -> torch.Tensor:
    """The 4x4 symmetric matrix N of Horn's eq. 25 from the (..., 3, 3)
    cross-covariance M; its top eigenvector is the rotation quaternion."""
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    rows = [
        [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
        [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
        [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
        [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def horn_sim3(p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool = False) -> torch.Tensor:
    """Closed-form Sim3 aligning point sets: x1 ≈ s R x2 + t.

    p1, p2: (..., k, 3) corresponding points (camera-frame coordinates in
    the reference's usage), batched over leading dims. Horn 1987
    quaternion method, as Sim3Solver.cc:226.
    """
    c1 = p1.mean(dim=-2)
    c2 = p2.mean(dim=-2)
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]
    N = horn_matrix(q2.transpose(-1, -2) @ q1)  # note order — maps 2 into 1
    _, vecs = torch.linalg.eigh(N.double())
    q = vecs[..., :, -1].to(p1.dtype)  # top eigenvector = quaternion (w,x,y,z)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)

    r2 = so3.rotate(q[..., None, :], q2)  # rotated centered set 2
    if fix_scale:
        s = torch.ones(q.shape[:-1], dtype=p1.dtype, device=p1.device)
    else:
        # s = dot(q1, R q2) / |q2|^2 (reference: Sim3Solver.cc:294-308).
        s = (q1 * r2).sum(dim=(-1, -2)) / torch.clamp(
            (q2 * q2).sum(dim=(-1, -2)), min=1e-12
        )
    t = c1 - s[..., None] * so3.rotate(q, c2)
    return sim3.make(q, t, torch.clamp(s, min=1e-8))


def _project(K, x):
    z = torch.clamp(x[..., 2], min=1e-9)
    return torch.stack(
        [K[0] * x[..., 0] / z + K[2], K[1] * x[..., 1] / z + K[3]], dim=-1
    )


def solve_sim3_ransac(
    x1: torch.Tensor,
    x2: torch.Tensor,
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    valid: torch.Tensor,
    max_err2_1: torch.Tensor,
    max_err2_2: torch.Tensor,
    K1: torch.Tensor,
    K2: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    fix_scale: bool = False,
    n_hypotheses: int = 256,
    min_inliers: int = 20,
    idx: Optional[torch.Tensor] = None,
) -> Sim3Result:
    """RANSAC Sim3 between two keyframes' matched points.

    x1/x2: (M, 3) matched map points in each camera frame; uv1/uv2 their
    observed pixels; max_err2_*: per-match squared-pixel gates
    (9.21 * sigma2, reference Sim3Solver.cc:106-112). idx: optional
    (n_hypotheses, 3) sample sets in place of the generator's draw.
    """
    if idx is None:
        idx = draw(valid, n_hypotheses, 3, generator)
    idx = idx.long()
    H = idx.shape[0]

    S12s = horn_sim3(x1[idx], x2[idx], fix_scale)  # (H, 8)
    S21s = sim3.inverse(S12s)
    uv2to1 = _project(K1, sim3.apply(S12s[:, None, :], x2[None]))
    uv1to2 = _project(K2, sim3.apply(S21s[:, None, :], x1[None]))
    e1 = ((uv2to1 - uv1) ** 2).sum(-1)
    e2 = ((uv1to2 - uv2) ** 2).sum(-1)
    inls = (e1 < max_err2_1) & (e2 < max_err2_2) & valid
    counts = inls.sum(dim=1, dtype=torch.int64)
    # Highest count, ties to the first hypothesis, in any reduction order.
    best = torch.argmax(counts * H + (H - 1 - torch.arange(H, device=counts.device)))
    n = counts[best].to(torch.int32)
    return Sim3Result(
        ok=n >= min_inliers, S12=S12s[best], inliers=inls[best], n_inliers=n
    )
