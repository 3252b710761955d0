"""Sim(3) similarity transforms as flat ``(..., 8)`` tensors.

Counterpart of c_orb_slam_tpu/geometry/sim3.py (reference: g2o::Sim3,
Thirdparty/g2o/g2o/types/sim3.h:41-70). Monocular SLAM drifts in scale, so
loop alignment and the essential pose graph optimize over Sim(3);
stereo/RGB-D fixes s = 1 (reference: LoopClosing.cc:38-41).

Layout: ``[q(4), t(3), log_s(1)]``. Action: ``x -> s * R @ x + t``. Every
function is free of in-place writes and of Python branches on tensor
values, so ``torch.func.jacrev`` under ``torch.func.vmap`` can trace it.
"""

from __future__ import annotations

import torch

from c_orb_slam_tpu_torch.geometry import se3, so3

_EPS = 1e-8


def make(q: torch.Tensor, t: torch.Tensor, s) -> torch.Tensor:
    """Pack (quat, translation, scale) -> (..., 8) with log-scale stored."""
    s = torch.as_tensor(s, dtype=t.dtype, device=t.device)
    if s.dim() < t.dim() or s.shape[-1] != 1:
        s = s[..., None]
    return torch.cat([so3.quat_normalize(q), t, torch.log(s)], dim=-1)


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([1, 0, 0, 0, 0, 0, 0, 0], dtype=dtype, device=device)


def quat(S: torch.Tensor) -> torch.Tensor:
    return S[..., 0:4]


def translation(S: torch.Tensor) -> torch.Tensor:
    return S[..., 4:7]


def scale(S: torch.Tensor) -> torch.Tensor:
    return torch.exp(S[..., 7])


def rotation(S: torch.Tensor) -> torch.Tensor:
    return so3.to_matrix(quat(S))


def apply(S: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x -> s * R @ x + t; x may be (N, 3) against a single S."""
    q, t, s = quat(S), translation(S), scale(S)
    if x.dim() > S.dim():  # points batch vs single transform
        return s * so3.rotate(q[None, :], x) + t
    return s[..., None] * so3.rotate(q, x) + t


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A * B: (x -> A(B(x))). s = sA sB; R = RA RB; t = sA RA tB + tA."""
    qa, ta, sa = quat(A), translation(A), scale(A)
    qb, tb, sb = quat(B), translation(B), scale(B)
    q = so3.quat_multiply(qa, qb)
    t = sa[..., None] * so3.rotate(qa, tb) + ta
    return make(q, t, sa * sb)


def inverse(S: torch.Tensor) -> torch.Tensor:
    q, t, s = quat(S), translation(S), scale(S)
    qinv = torch.cat([q[..., :1], -q[..., 1:]], dim=-1)
    sinv = 1.0 / torch.clamp(s, min=_EPS)
    tinv = -sinv[..., None] * so3.rotate(qinv, t)
    return make(qinv, tinv, sinv)


def from_se3(T: torch.Tensor, s=1.0) -> torch.Tensor:
    q, t = se3.to_quat_t(T)
    s = torch.as_tensor(s, dtype=T.dtype, device=T.device)
    return make(q, t, s.expand(q.shape[:-1]))


def to_se3(S: torch.Tensor) -> torch.Tensor:
    """Drop scale into translation the way the reference recovers SE3 after
    essential-graph optimization: R, t/s (reference: Optimizer.cc:991-1010)."""
    s = scale(S)
    return se3.make(rotation(S), translation(S) / torch.clamp(s[..., None], min=_EPS))


def _calc_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """W(phi, sigma) such that t = W @ rho in the Sim(3) exp map.

    W = C*I + A*Phi + B*Phi^2 with the standard four-regime coefficients
    (Strasdat's thesis eq. on sim(3); same decomposition Sophus uses).
    Both sides of every ``where`` are evaluated, so each denominator is
    replaced by 1 on the side where it could vanish.
    """
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS**2))
    s = torch.exp(sigma)
    sig2 = sigma * sigma
    small_sig = torch.abs(sigma) < 1e-4
    small_th = theta2 < 1e-8
    one = torch.ones_like(sigma)

    safe_sig = torch.where(small_sig, one, sigma)
    safe_th = torch.where(small_th, one, theta)
    safe_th2 = torch.where(small_th, one, theta2)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)

    # C: identity coefficient = (s-1)/sigma, limit 1 + sigma/2 at sigma->0.
    C = torch.where(small_sig, 1.0 + sigma / 2.0 + sig2 / 6.0, (s - 1.0) / safe_sig)

    # sigma != 0, theta != 0 general case. c_ is clamped even though the
    # branch is unselected near the origin: reverse-mode AD multiplies a
    # zero cotangent by this branch's infinite partial (0 * inf = NaN).
    a_ = s * sin_t
    b_ = s * cos_t
    c_ = torch.where(small_sig & small_th, one, theta2 + sig2)
    A_gen = (a_ * sigma + (1.0 - b_) * theta) / (safe_th * c_)
    B_gen = (C - ((b_ - 1.0) * sigma + a_ * theta) / c_) / safe_th2

    # sigma != 0, theta -> 0.
    safe_sig2 = torch.where(small_sig, one, sig2)
    A_th0 = ((sigma - 1.0) * s + 1.0) / safe_sig2
    B_th0 = ((0.5 * sig2 - sigma + 1.0) * s - 1.0 - 0.5 * sig2) / (
        safe_sig2 * safe_sig
    )

    # sigma -> 0 (any theta).
    A_sig0 = torch.where(small_th, 0.5 - theta2 / 24.0, (1.0 - cos_t) / safe_th2)
    B_sig0 = torch.where(
        small_th, 1.0 / 6.0 - theta2 / 120.0, (theta - sin_t) / (safe_th2 * safe_th)
    )

    A = torch.where(small_sig, A_sig0, torch.where(small_th, A_th0, A_gen))
    B = torch.where(small_sig, B_sig0, torch.where(small_th, B_th0, B_gen))

    Phi = so3.hat(phi)
    Phi2 = Phi @ Phi
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(Phi.shape)
    return (
        C[..., None, None] * eye
        + A[..., None, None] * Phi
        + B[..., None, None] * Phi2
    )


def exp(xi: torch.Tensor) -> torch.Tensor:
    """sim(3) -> Sim(3). xi = [rho(3), phi(3), sigma(1)]; t = W @ rho."""
    rho, phi, sigma = xi[..., 0:3], xi[..., 3:6], xi[..., 6]
    W = _calc_W(phi, sigma)
    t = (W @ rho[..., None])[..., 0]
    return make(so3.quat_exp(phi), t, torch.exp(sigma))


def log(S: torch.Tensor) -> torch.Tensor:
    """Sim(3) -> sim(3): rho solves W(phi, sigma) @ rho = t.

    W is 3x3 and well-conditioned for |phi| < pi, so a direct solve is exact
    and avoids a second (error-prone) closed form for W^{-1}.
    """
    phi = so3.quat_log(quat(S))
    sigma = S[..., 7]
    W = _calc_W(phi, sigma)
    rho = torch.linalg.solve(W, translation(S)[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
