"""Two-view monocular initialization: batched H/F RANSAC + reconstruction.

Counterpart of c_orb_slam_tpu/ops/twoview.py (reference:
src/Initializer.cc — H and F RANSAC :104-118, ReconstructF :470-570 with
CheckRT :798-907, ReconstructH :572-732). All hypotheses of both models
are solved at once along a leading batch dimension, the best of each is
refit on its inliers, and the 12 candidate motions (4 from F, 8 from H)
are scored by one batched cheirality/parallax check.

Draws come from a torch.Generator on the tensors' device; ``idx`` injects
the hypothesis sample sets instead (tests pass the JAX draw, hazard e).
Null vectors come from eigh and singular vectors from svd, whose signs
are arbitrary: F and H are only ever used up to sign (squared scores, the
determinant fix-ups of the motions, homogeneous triangulation).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from c_orb_slam_tpu_torch.geometry import se3
from c_orb_slam_tpu_torch.ops.ransac import draw

CHI2_2DOF = 5.991
CHI2_1DOF = 3.841


class TwoViewResult(NamedTuple):
    ok: torch.Tensor  # () bool
    T21: torch.Tensor  # (3, 4) pose of view 2 w.r.t. view 1 (world = view 1)
    points: torch.Tensor  # (M, 3) triangulated points in view-1 frame
    good: torch.Tensor  # (M,) bool triangulation-accepted matches
    used_homography: torch.Tensor  # () bool
    score_h: torch.Tensor
    score_f: torch.Tensor


def _normalize(uv: torch.Tensor, valid: torch.Tensor):
    """Zero-mean / unit-mean-abs-dev normalization (reference:
    Initializer.cc:749-795). Returns (normalized (M, 2), T (3, 3))."""
    w = valid.to(uv.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    mean = (uv * w[:, None]).sum(0) / n
    d = (uv - mean) * w[:, None]
    s = 1.0 / torch.clamp(d.abs().sum(0) / n, min=1e-8)
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack(
        [
            torch.stack([s[0], zero, -mean[0] * s[0]]),
            torch.stack([zero, s[1], -mean[1] * s[1]]),
            torch.stack([zero, zero, one]),
        ]
    )
    return (uv - mean) * s, T


def _solve_nullvec(A: torch.Tensor) -> torch.Tensor:
    """min |A v|, |v| = 1 via the smallest eigenvector of AᵀA. A: (..., R, 9).

    Solved in float64: AᵀA squares A's condition number, and in float32
    the null vector of a near-degenerate 8-point sample is off by up to
    1e-2, differently on LAPACK and on cuSOLVER's batched Jacobi solver,
    which then pick different best hypotheses (the reference takes an SVD
    of A itself)."""
    A64 = A.to(torch.float64)
    _, V = torch.linalg.eigh(A64.transpose(-1, -2) @ A64)
    return V[..., :, 0].to(A.dtype)


def _f_rows(p1, p2):
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    return torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)], dim=-1
    )


def _h_rows(p1, p2):
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    z, o = torch.zeros_like(x1), torch.ones_like(x1)
    rows_a = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    rows_b = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    return rows_a, rows_b


def _rank2(f: torch.Tensor) -> torch.Tensor:
    """(..., 9) -> (..., 3, 3) F with its smallest singular value zeroed."""
    U, S, Vt = torch.linalg.svd(f.reshape(*f.shape[:-1], 3, 3))
    S = S * torch.tensor([1.0, 1.0, 0.0], dtype=S.dtype, device=S.device)
    return U @ (S[..., :, None] * Vt)


def _fundamental_from_sets(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """8-point F per hypothesis set (B, 8, 2) normalized -> (B, 3, 3)
    (reference: Initializer.cc:268-303 ComputeF21 + rank-2 projection)."""
    return _rank2(_solve_nullvec(_f_rows(p1, p2)))


def _homography_from_sets(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """DLT H (p2 ~ H p1) per hypothesis set (B, 8, 2) -> (B, 3, 3)
    (reference: Initializer.cc:226-266 ComputeH21)."""
    h = _solve_nullvec(torch.cat(_h_rows(p1, p2), dim=-2))
    return h.reshape(*h.shape[:-1], 3, 3)


def _refit_f(n1, n2, w):
    """Weighted all-inlier 8-point refit (one 9x9 eigh)."""
    return _rank2(_solve_nullvec(_f_rows(n1, n2) * torch.sqrt(w)[:, None]))


def _refit_h(n1, n2, w):
    sw = torch.sqrt(w)[:, None]
    rows_a, rows_b = _h_rows(n1, n2)
    return _solve_nullvec(torch.cat([rows_a * sw, rows_b * sw], dim=0)).reshape(3, 3)


def _homog(uv):
    return torch.cat([uv, torch.ones_like(uv[:, :1])], dim=1)


def _score_f(F, uv1, uv2, valid, sigma2):
    """Symmetric epipolar-distance score (reference: Initializer.cc:390-468
    CheckFundamental). F: (B, 3, 3) -> (score (B,), inlier (B, M))."""
    p1, p2 = _homog(uv1), _homog(uv2)
    l2 = torch.einsum("bij,mj->bmi", F, p1)  # line in image 2
    l1 = torch.einsum("bji,mj->bmi", F, p2)  # line in image 1
    num2 = torch.einsum("bmi,mi->bm", l2, p2)
    num1 = torch.einsum("bmi,mi->bm", l1, p1)
    chi2 = num2 * num2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12) / sigma2
    chi1 = num1 * num1 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12) / sigma2
    in1, in2 = chi1 <= CHI2_1DOF, chi2 <= CHI2_1DOF
    sc = torch.where(in1, CHI2_2DOF - chi1, 0.0) + torch.where(in2, CHI2_2DOF - chi2, 0.0)
    inlier = in1 & in2 & valid[None, :]
    return (sc * inlier.to(sc.dtype)).sum(1), inlier


def _transfer(M, src):
    """Map pixels src (N, 2) through each homography M (B, 3, 3)."""
    q = torch.einsum("bij,mj->bmi", M, _homog(src))
    w = q[..., 2:3]
    return q[..., :2] / torch.clamp(w.abs(), min=1e-12) * torch.sign(torch.where(w == 0, 1.0, w))


def _score_h(H, uv1, uv2, valid, sigma2):
    """Symmetric transfer score (reference: Initializer.cc:305-388)."""
    Hinv = torch.linalg.inv_ex(H)[0]
    chi12 = ((_transfer(H, uv1) - uv2[None]) ** 2).sum(-1) / sigma2
    chi21 = ((_transfer(Hinv, uv2) - uv1[None]) ** 2).sum(-1) / sigma2
    in12, in21 = chi12 <= CHI2_2DOF, chi21 <= CHI2_2DOF
    sc = torch.where(in12, CHI2_2DOF - chi12, 0.0) + torch.where(in21, CHI2_2DOF - chi21, 0.0)
    inlier = in12 & in21 & valid[None, :]
    return (sc * inlier.to(sc.dtype)).sum(1), inlier


def _kmat(K: torch.Tensor) -> torch.Tensor:
    zero, one = torch.zeros_like(K[0]), torch.ones_like(K[0])
    return torch.stack(
        [torch.stack([K[0], zero, K[2]]), torch.stack([zero, K[1], K[3]]),
         torch.stack([zero, zero, one])]
    )


def _check_rt(R, t, uv1, uv2, K, inlier, sigma2):
    """Cheirality/parallax/reprojection-valid points of each candidate
    motion (R (C, 3, 3), t (C, 3)) (reference: Initializer.cc:798-907
    CheckRT). Returns (n_good (C,), points (C, M, 3), good (C, M),
    parallax_cos (C,))."""
    Km = _kmat(K).to(uv1.dtype)
    P1 = torch.cat([Km, torch.zeros_like(Km[:, :1])], dim=1)  # Km @ [I | 0]
    P2 = Km @ torch.cat([R, t[..., None]], dim=-1)  # (C, 3, 4)
    # Linear triangulation per (candidate, point): the smallest
    # eigenvector of AᵀA, A (C, M, 4, 4).
    a1 = uv1[:, 0, None] * P1[2] - P1[0]
    a2 = uv1[:, 1, None] * P1[2] - P1[1]
    a3 = uv2[None, :, 0, None] * P2[:, None, 2] - P2[:, None, 0]
    a4 = uv2[None, :, 1, None] * P2[:, None, 2] - P2[:, None, 1]
    A = torch.stack([a1.expand_as(a3), a2.expand_as(a3), a3, a4], dim=-2)
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    X = V[..., :, 0]
    w = X[..., 3:4]
    x1 = X[..., :3] / torch.where(w.abs() < 1e-12, 1e-12, w)  # (C, M, 3) view-1 frame
    x2 = x1 @ R.transpose(-1, -2) + t[:, None, :]

    finite = torch.isfinite(x1).all(-1)
    # Parallax between the two viewing rays.
    c2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    r2 = x1 - c2[:, None, :]
    cos_par = (x1 * r2).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(x1, dim=-1) * torch.linalg.vector_norm(r2, dim=-1), min=1e-12
    )
    depth_ok = (x1[..., 2] > 0) & (x2[..., 2] > 0)

    def reproj_err(x, uv):
        u = K[0] * x[..., 0] / x[..., 2] + K[2]
        v = K[1] * x[..., 1] / x[..., 2] + K[3]
        return (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2

    reproj_ok = (reproj_err(x1, uv1) < 4.0 * sigma2) & (reproj_err(x2, uv2) < 4.0 * sigma2)
    good = finite & depth_ok & reproj_ok & (cos_par < 0.99998) & inlier
    n_good = good.sum(-1, dtype=torch.int32)
    # The min(50, n)-th smallest parallax cosine of the good points
    # (Initializer.cc:887-895).
    cos_sorted = torch.sort(torch.where(good, cos_par, 1.0), dim=-1).values
    k = torch.clamp(torch.clamp(n_good, min=1), max=50) - 1
    parallax_cos = cos_sorted.gather(-1, k[:, None].long())[:, 0]
    return n_good, x1, good, parallax_cos


def _motions_from_f(F, K):
    """4 (R, t) hypotheses from E = KᵀFK (reference: Initializer.cc:470-500,
    DecomposeE :909-929)."""
    Km = _kmat(K).to(F.dtype)
    U, _, Vt = torch.linalg.svd(Km.T @ F @ Km)
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=F.dtype,
                     device=F.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _motions_from_h(H, K):
    """8 (R, t) hypotheses by Faugeras' SVD decomposition of K⁻¹HK
    (reference: Initializer.cc:572-686 ReconstructH)."""
    dt, dev = H.dtype, H.device
    Km = _kmat(K).to(dt)
    U, S, Vt = torch.linalg.svd(torch.linalg.inv_ex(Km)[0] @ H @ Km)
    s_det = torch.linalg.det(U) * torch.linalg.det(Vt.T)
    d1, d2, d3 = S[0], S[1], S[2]
    den = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den, min=0.0))
    signs = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=dt, device=dev)
    x1s = aux1 * torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=dt, device=dev)
    x3s = aux3 * torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=dt, device=dev)
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    zero, one = torch.zeros(4, dtype=dt, device=dev), torch.ones(4, dtype=dt, device=dev)

    def rows(*r):
        return torch.stack([torch.stack(x, -1) for x in r], dim=-2)  # (4, 3, 3)

    # Case d' > 0: R' = rotation about y by theta.
    ct = ((d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)).expand(4)
    sts = signs * root / torch.clamp((d1 + d3) * d2, min=1e-12)
    Rp_pos = rows([ct, zero, -sts], [zero, one, zero], [sts, zero, ct])
    tp_pos = (d1 - d3) * torch.stack([x1s, zero, -x3s], -1)
    # Case d' < 0: rotation about y by phi with a reflection.
    cp = ((d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)).expand(4)
    sps = signs * root / torch.clamp((d1 - d3) * d2, min=1e-12)
    Rp_neg = rows([cp, zero, sps], [zero, -one, zero], [sps, zero, -cp])
    tp_neg = (d1 + d3) * torch.stack([x1s, zero, x3s], -1)

    Rp = torch.cat([Rp_pos, Rp_neg])  # (8, 3, 3)
    tp = torch.cat([tp_pos, tp_neg])
    Rs = s_det * (U @ Rp @ Vt)
    ts = tp @ U.T
    return Rs, ts / torch.clamp(torch.linalg.vector_norm(ts, dim=-1, keepdim=True), min=1e-12)


def initialize(
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    sigma: float = 1.0,
    n_hypotheses: int = 256,
    min_triangulated: int = 50,
    idx: Optional[torch.Tensor] = None,
) -> TwoViewResult:
    """Two-view bootstrap from matched (undistorted) pixels uv1/uv2 (M, 2)
    with mask valid (M,): pose of view 2 in the view-1 world frame and
    the triangulated points. idx: optional (n_hypotheses, 8) sample sets."""
    sigma2 = sigma * sigma
    n1, T1 = _normalize(uv1, valid)
    n2, T2 = _normalize(uv2, valid)
    if idx is None:
        idx = draw(valid, n_hypotheses, 8, generator)
    idx = idx.long()
    s1, s2 = n1[idx], n2[idx]  # (B, 8, 2)

    F = T2.T @ _fundamental_from_sets(s1, s2) @ T1  # p2ᵀ F p1 on raw pixels
    f_scores, f_inl = _score_f(F, uv1, uv2, valid, sigma2)
    # Refit on the best hypothesis's inliers, then rescore (2 rounds).
    f_w = f_inl[torch.argmax(f_scores)].to(torch.float32)
    for _ in range(2):
        F_best = T2.T @ _refit_f(n1, n2, f_w) @ T1
        f_score_r, f_inl_r = _score_f(F_best[None], uv1, uv2, valid, sigma2)
        f_w = f_inl_r[0].to(torch.float32)
    score_f, f_inliers = f_score_r[0], f_inl_r[0]

    T2_inv = torch.linalg.inv_ex(T2)[0]
    H = T2_inv @ _homography_from_sets(s1, s2) @ T1
    h_scores, h_inl = _score_h(H, uv1, uv2, valid, sigma2)
    h_w = h_inl[torch.argmax(h_scores)].to(torch.float32)
    for _ in range(2):
        H_best = T2_inv @ _refit_h(n1, n2, h_w) @ T1
        h_score_r, h_inl_r = _score_h(H_best[None], uv1, uv2, valid, sigma2)
        h_w = h_inl_r[0].to(torch.float32)
    score_h, h_inliers = h_score_r[0], h_inl_r[0]

    use_h = score_h / torch.clamp(score_h + score_f, min=1e-12) > 0.40  # Initializer.cc:115

    # All 12 candidate motions with the chosen model's inlier set, picked
    # by good-point count.
    Rf, tf = _motions_from_f(F_best, K)
    Rh, th = _motions_from_h(H_best, K)
    Rs, ts = torch.cat([Rf, Rh]), torch.cat([tf, th])
    from_h = torch.arange(12, device=uv1.device) >= 4
    chosen_inl = torch.where(use_h, h_inliers, f_inliers)
    n_good, pts, good, par_cos = _check_rt(Rs, ts, uv1, uv2, K, chosen_inl, sigma2)
    n_good = torch.where(torch.where(use_h, from_h, ~from_h), n_good, -1)
    best = torch.argmax(n_good)
    best_good = n_good[best]
    second = torch.sort(n_good).values[-2]
    n_inliers = chosen_inl.sum(dtype=torch.int32)
    # Acceptance (Initializer.cc:522-556): a clear winner, enough points,
    # enough parallax (cos < cos(1 deg)).
    ok = (
        (best_good >= torch.clamp((0.9 * n_inliers).to(torch.int32), min=min_triangulated))
        & (second < (0.75 * best_good).to(torch.int32))
        & (par_cos[best] < 0.9998476)
    )
    return TwoViewResult(
        ok=ok, T21=se3.make(Rs[best], ts[best]), points=pts[best], good=good[best],
        used_homography=use_h, score_h=score_h, score_f=score_f,
    )
