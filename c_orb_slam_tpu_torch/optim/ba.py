"""Bundle adjustment: Levenberg-Marquardt on the Schur complement.

Counterpart of c_orb_slam_tpu/optim/ba.py (reference: Optimizer.cc:49
BundleAdjustment, :453-778 LocalBundleAdjustment and g2o's
block_solver.hpp Schur solve). The camera-point graph is a flat
observation list (obs_cam, obs_pt); one LM iteration is
residuals/Jacobians -> per-camera and per-point normal blocks (segment
sums in a fixed order, ops/segment.py) -> the reduced camera system
S = Hcc - W Hpp^-1 Wᵀ -> point back-substitution. Two routes solve the reduced system, chosen by
``schur``: "dense" forms S and solves it by Cholesky (local BA, small
C); "pcg" never forms S or W and runs preconditioned conjugate gradients
on the implicit matvec S·x = Hcc·x − W·Hpp⁻¹·Wᵀ·x, two gathers and two
segment sums an application (global BA, where the dense W would not fit).
``schur`` defaults to "dense" here (the JAX package defaults to "pcg").
Fixed cameras get zero Jacobians; invalid slots are masked. The iteration
and the two-stage schedule (``TwoStage``) are written once over the
shards of a mesh: the functions here run them on a one-shard mesh,
parallel/dba with the observations split over several shards, and
parallel/sharded_ba's map-sharded iteration reuses the schedule.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from c_orb_slam_tpu_torch.geometry import se3
from c_orb_slam_tpu_torch.ops import segment
from c_orb_slam_tpu_torch.optim import residuals as res
from c_orb_slam_tpu_torch.parallel.mesh import Mesh, pcg


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


class Segs(NamedTuple):
    """The summing order of a problem's three segment sums: by camera, by
    point and by the flat (point, camera) key of the W blocks. The
    observations' ids never change within a solve, so ``lm_solve`` builds
    it once."""

    cam: segment.Segments
    pt: segment.Segments
    key: Optional[segment.Segments]  # dense route only: None where W is never formed


def segs_of(p: BAProblem, w_blocks: bool = True) -> Segs:
    """`p`'s ``Segs``; the (point, camera) key, whose offsets span P*C
    (67M at the global BA's bucket), only with `w_blocks`."""
    C = p.cam_T.shape[0]
    P = p.points.shape[0]
    key = (segment.segments(p.obs_pt.long() * C + p.obs_cam.long(), P * C) if w_blocks
           else None)
    return Segs(segment.segments(p.obs_cam, C), segment.segments(p.obs_pt, P), key)


def _normal_sums(p: BAProblem, r, Jc, Jp, w, segs: Optional[Segs] = None):
    """Undamped normal-equation blocks, segment sums over the observations
    of `p`: Hcc (C,6,6), gc (C,6), Hpp (P,3,3), gp (P,3). Linear in the
    observations, so a sharded solve sums shards' partials
    (parallel/dba.py, parallel/sharded_ba.py). Each side is one sum of
    concatenated blocks, as in the JAX package's ``_assemble``."""
    segs = segs or segs_of(p, w_blocks=False)
    O = r.shape[0]
    Jcw = Jc * w[:, None, None]
    Jpw = Jp * w[:, None, None]
    cam = segment.segment_sum(torch.cat([
        (Jcw.transpose(1, 2) @ Jc).reshape(O, 36),
        (Jcw.transpose(1, 2) @ r[..., None])[..., 0]], 1), segs.cam)
    pt = segment.segment_sum(torch.cat([
        (Jpw.transpose(1, 2) @ Jp).reshape(O, 9),
        (Jpw.transpose(1, 2) @ r[..., None])[..., 0]], 1), segs.pt)
    return cam[:, :36].reshape(-1, 6, 6), cam[:, 36:], pt[:, :9].reshape(-1, 3, 3), pt[:, 9:]


def _damp(p: BAProblem, Hcc, Hpp, lm_lambda):
    """LM damping; dead camera/point slots get identity so inverses
    exist. Returns (Hcc, Hpp^-1)."""
    dt, dev = Hcc.dtype, Hcc.device
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    free_cam = (p.cam_valid & ~p.cam_fixed).to(dt)[:, None, None]
    Hcc = Hcc + lm_lambda * eye6 + (1.0 - free_cam) * eye6
    live_pt = p.point_valid.to(dt)[:, None, None]
    Hpp = Hpp + lm_lambda * eye3 + (1.0 - live_pt) * eye3
    return Hcc, _inv3x3(Hpp)


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


def _w_blocks(p: BAProblem, Jc, Jp, w, segs: Optional[Segs] = None):
    """Dense W (6C x 3P) as per-observation 6x3 blocks summed by the flat
    (point, camera) key: (P*C, 18). Linear in the observations."""
    segs = segs or segs_of(p)
    B = (Jc * w[:, None, None]).transpose(1, 2) @ Jp  # (O, 6, 3)
    return segment.segment_sum(B.reshape(-1, 18), segs.key)


def _dense_solve(Wpc, Hcc, Hpp_inv, gc, gp, free_cam):
    """Explicit dense Schur complement + Cholesky solve of the (6C, 6C)
    reduced camera system from the (P*C, 18) W blocks. Returns dc (C, 6)."""
    C = Hcc.shape[0]
    P = Hpp_inv.shape[0]
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
    # SPD after masking in exact arithmetic. In float32 the pivot of a
    # camera left alone with points it sees once (their Hpp rank 2 plus
    # the damping) can cancel to a non-positive value: then the step is
    # NaN, as JAX's cho_factor gives, so the LM test rejects it and raises
    # the damping. No readback.
    L, info = torch.linalg.cholesky_ex(S)
    _count_failed(info)
    dc = torch.cholesky_solve(rhs.reshape(C * 6, 1), L).reshape(C, 6)
    dc = torch.where(info == 0, dc, float("nan"))
    return dc * free_cam[:, None]


# Dense-Schur factorizations that failed since the last reset, one int64
# counter on each device that solved, added to on the device (a replicated
# solve counts once per device that computes it).
_failed: dict[torch.device, torch.Tensor] = {}


def _count_failed(info: torch.Tensor):
    n = _failed.get(info.device)
    if n is None:
        n = _failed[info.device] = torch.zeros((), dtype=torch.int64, device=info.device)
    n.add_((info != 0).to(torch.int64))


def reset_failed_factorizations():
    _failed.clear()


def failed_factorizations(device) -> int:
    """Dense-Schur LM iterations on `device` whose Cholesky failed since
    the last reset (one readback)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    n = _failed.get(d)
    return 0 if n is None else int(n)


def _w_times(p: BAProblem, Jc, Jp, w, y, segs: Optional[Segs] = None):
    """W @ y for per-point y (P, 3) -> (C, 6), without forming W."""
    s = (Jp @ y[p.obs_pt.long()][..., None])[..., 0] * w[:, None]  # (O, 3)
    segs = segs or segs_of(p, w_blocks=False)
    return segment.segment_sum((Jc.transpose(1, 2) @ s[..., None])[..., 0], segs.cam)


def _wt_times(p: BAProblem, Jc, Jp, w, x, segs: Optional[Segs] = None):
    """Wᵀ @ x for per-camera x (C, 6) -> (P, 3), without forming W."""
    u = (Jc @ x[p.obs_cam.long()][..., None])[..., 0] * w[:, None]  # (O, 3)
    segs = segs or segs_of(p, w_blocks=False)
    return segment.segment_sum((Jp.transpose(1, 2) @ u[..., None])[..., 0], segs.pt)


# ---------------------------------------------------------------------------
# One LM iteration, written once over the shards of a mesh
# (parallel/mesh.py): the observations split into slabs, one problem `ps[i]`
# a local shard, cameras and points replicated. The single-device solvers
# run it on a one-shard mesh, where a psum is its argument; parallel/dba
# runs it on several shards. Values are per-shard lists throughout.
# ---------------------------------------------------------------------------


class _Normal(NamedTuple):
    """The damped normal system of one LM iteration, replicated."""

    Hcc: torch.Tensor  # (C, 6, 6)
    Hpp_inv: torch.Tensor  # (P, 3, 3)
    gc: torch.Tensor  # (C, 6)
    gp: torch.Tensor  # (P, 3)
    free: torch.Tensor  # (C,) 1 for a camera that moves
    Wpc: Optional[torch.Tensor]  # (P*C, 18) W blocks (dense route only)


def _normal(mesh: Mesh, ps, terms, lam, dense: bool) -> list:
    """Each shard's partial Hcc, gc, Hpp and gp (and W blocks), joined by
    one psum, then damped."""

    def partial(p, t):  # t: (r, Jc, Jp, w[, Segs])
        sums = _normal_sums(p, *t)
        return (*sums, _w_blocks(p, *t[1:])) if dense else sums

    def damp(p, s, lam_):
        Hcc, Hpp_inv = _damp(p, s[0], s[2], lam_)
        free = (p.cam_valid & ~p.cam_fixed).to(Hcc.dtype)
        return _Normal(Hcc, Hpp_inv, s[1], s[3], free, s[4] if dense else None)

    return mesh.replicated(damp, ps, mesh.psum(mesh.per_shard(partial, ps, terms)), lam)


def _wt_x(mesh: Mesh, ps, terms, x):
    """Wᵀ x for replicated per-camera x (C, 6): (P, 3), a psum."""
    return mesh.psum(mesh.per_shard(
        lambda p, t, x_: _wt_times(p, *t[1:4], x_, *t[4:]), ps, terms, x))


def _w_y(mesh: Mesh, ps, terms, y):
    """W y for replicated per-point y (P, 3): (C, 6), a psum."""
    return mesh.psum(mesh.per_shard(
        lambda p, t, y_: _w_times(p, *t[1:4], y_, *t[4:]), ps, terms, y))


def _schur_matvec(mesh: Mesh, ps, terms, nrm, x):
    """S @ x = Hcc x − W Hpp⁻¹ Wᵀ x without materializing S or W; x (C, 6)."""
    x = mesh.replicated(lambda n, x_: x_ * n.free[:, None], nrm, x)
    y = mesh.replicated(lambda n, v: (n.Hpp_inv @ v[..., None])[..., 0], nrm,
                        _wt_x(mesh, ps, terms, x))
    return mesh.replicated(
        lambda n, x_, z: ((n.Hcc @ x_[..., None])[..., 0] - z) * n.free[:, None],
        nrm, x, _w_y(mesh, ps, terms, y))


def _solve_cameras(mesh: Mesh, ps, terms, nrm, dense: bool, pcg_iters: int):
    """dc (C, 6) of the reduced camera system: the dense Schur complement
    and Cholesky, or PCG on the implicit matvec with the block-Jacobi
    (Hcc⁻¹) preconditioner."""
    if dense:
        return mesh.replicated(
            lambda n: _dense_solve(n.Wpc, n.Hcc, n.Hpp_inv, n.gc, n.gp, n.free), nrm)
    # Schur RHS: -(gc - W Hpp^-1 gp)
    Wy = _w_y(mesh, ps, terms,
              mesh.replicated(lambda n: (n.Hpp_inv @ n.gp[..., None])[..., 0], nrm))
    rhs = mesh.replicated(lambda n, wy: -(n.gc - wy) * n.free[:, None], nrm, Wy)
    Hcc_inv = mesh.replicated(lambda n: torch.linalg.inv_ex(n.Hcc)[0], nrm)
    return pcg(
        lambda x: _schur_matvec(mesh, ps, terms, nrm, x),
        lambda v: mesh.replicated(
            lambda hi, n, v_: (hi @ v_[..., None])[..., 0] * n.free[:, None], Hcc_inv, nrm, v),
        lambda a, b: mesh.replicated(lambda a_, b_: (a_ * b_).sum(), a, b),
        mesh.replicated, rhs, pcg_iters)


def _iteration(mesh: Mesh, ps, cam_T, points, lam, use_huber, chi2_mono, chi2_stereo,
               pcg_iters: int = 40, schur: str = "dense", segs: Optional[list] = None,
               steps: bool = False):
    """One damped GN step over observation shards. Returns per-shard
    (cam_T, points), and with `steps` also dc (C, 6) and dp (P, 3).
    `segs` holds each shard's ``Segs`` (built here when None)."""
    segs = segs or mesh.per_shard(lambda p: segs_of(p, schur == "dense"), ps)
    terms = mesh.per_shard(
        lambda p, T, X, sg: (*_obs_terms(p, T, X, use_huber, chi2_mono, chi2_stereo)[:4], sg),
        ps, cam_T, points, segs)
    nrm = _normal(mesh, ps, terms, lam, schur == "dense")
    dc = _solve_cameras(mesh, ps, terms, nrm, schur == "dense", pcg_iters)
    Wt_dc = _wt_x(mesh, ps, terms, dc)

    def update(p, n, d, wt, T, X):
        dp = (n.Hpp_inv @ (-n.gp - wt)[..., None])[..., 0]  # Hpp^-1 (-gp - Wᵀ dc)
        dp = dp * p.point_valid.to(dp.dtype)[:, None]
        new_T = se3.compose(se3.exp(d), T)
        return torch.where(n.free[:, None, None] > 0, new_T, T), X + dp, dp

    new = mesh.replicated(update, ps, nrm, dc, Wt_dc, cam_T, points)
    out = [t[0] for t in new], [t[1] for t in new]
    return (*out, dc, [t[2] for t in new]) if steps else out


def _error(mesh: Mesh, ps, cam_T, points, use_huber, chi2_mono, chi2_stereo):
    """The robust total error, psummed over the shards."""
    return mesh.psum(mesh.per_shard(
        lambda p, T, X: _total_error(p, T, X, use_huber, chi2_mono, chi2_stereo),
        ps, cam_T, points))


def _lm_iteration(mesh: Mesh, ps, cam_T, points, lam, err, iteration: Callable,
                  points_each: Callable, use_huber, chi2_mono, chi2_stereo):
    """One damped iteration with LM accept/reject, on device (no readback).
    Returns per-shard (cam_T, points, lam, err)."""
    new_T, new_X = iteration(ps, cam_T, points, lam, use_huber)
    new_err = _error(mesh, ps, new_T, new_X, use_huber, chi2_mono, chi2_stereo)
    accept = mesh.replicated(lambda e, ne: ne < e, err, new_err)
    return (
        mesh.replicated(torch.where, accept, new_T, cam_T),
        points_each(torch.where, accept, new_X, points),
        mesh.replicated(lambda a, l: torch.where(a, l * 0.5, l * 4.0), accept, lam),
        mesh.replicated(torch.where, accept, new_err, err),
    )


class TwoStage:
    """bundle_adjust's schedule over the shards of a mesh, one damped LM
    iteration a ``step()`` (reference: Optimizer.cc:659-709): an LM stage
    with Huber weights, the inlier reclassification, a clean LM stage.
    The live global BA steps it once per tracked frame, so tracking
    interleaves with the solve on the device (the functional analog of the
    reference's background GBA thread, LoopClosing.cc:645-749); the
    solvers ``run()`` it to its end.

    ``iteration(ps, cam_T, points, lam, use_huber)`` is one damped GN step
    over the shards ``ps`` (``_iteration``, or parallel/sharded_ba's
    map-sharded body); ``points_each`` applies an update to the points
    (``Mesh.replicated`` where they are replicated, ``Mesh.per_shard``
    where sharded). ``cam_T``, ``points``, ``lam`` and ``err`` are
    per-shard lists."""

    def __init__(self, mesh: Mesh, ps, cam_T, points, iteration: Callable,
                 points_each: Callable, iters_first: int, iters_second: int,
                 chi2_mono: float, chi2_stereo: float, lm_lambda0: float = 1e-4):
        self.mesh, self.ps, self.cam_T, self.points = mesh, ps, cam_T, points
        self.iteration, self.points_each = iteration, points_each
        self.iters = (iters_first, iters_second)
        self.chi2 = (chi2_mono, chi2_stereo)
        self.lm_lambda0 = lm_lambda0
        self.stage, self.i = 0, 0  # stage 0 Huber LM, 1 clean LM, 2 done
        self.lam = self.err = None
        self._settle()

    @property
    def done(self) -> bool:
        return self.stage == 2

    def _classify(self, q, T, X):
        return classify_inliers(q._replace(cam_T=T, points=X), *self.chi2)

    def _settle(self):
        if self.stage == 0 and self.i >= self.iters[0]:
            inlier = self.mesh.per_shard(self._classify, self.ps, self.cam_T, self.points)
            self.ps = self.mesh.per_shard(lambda q, v: q._replace(obs_valid=v), self.ps, inlier)
            self.stage, self.i, self.err = 1, 0, None
        if self.stage == 1 and self.i >= self.iters[1]:
            self.stage = 2

    def step(self):
        if self.done:
            return
        mesh, use_huber = self.mesh, self.stage == 0
        if self.err is None:  # a stage starts: its initial error and damping
            self.err = _error(mesh, self.ps, self.cam_T, self.points, use_huber, *self.chi2)
            self.lam = mesh.replicated(lambda p: torch.tensor(
                self.lm_lambda0, dtype=torch.float32, device=p.points.device), self.ps)
        self.cam_T, self.points, self.lam, self.err = _lm_iteration(
            mesh, self.ps, self.cam_T, self.points, self.lam, self.err, self.iteration,
            self.points_each, use_huber, *self.chi2)
        self.i += 1
        self._settle()

    def run(self) -> "TwoStage":
        while not self.done:
            self.step()
        return self

    def result(self):
        """The final gate (chi2 and depth, Optimizer.cc:676-705): per-shard
        (cam_T, points, obs_inlier) and the mean inlier chi2."""

        def final(q, T, X):
            inlier = self._classify(q, T, X)
            r, _, _ = res.residual_and_jacobians(
                T[q.obs_cam.long()], X[q.obs_pt.long()], q.obs_uv, q.K, q.bf, q.obs_stereo)
            c2 = res.chi2(r, q.obs_inv_sigma2)
            return inlier, (torch.where(inlier, c2, torch.zeros_like(c2)).sum(),
                            inlier.to(torch.float32).sum())

        out = self.mesh.per_shard(final, self.ps, self.cam_T, self.points)
        s, n = self.mesh.psum([o[1] for o in out])[0]
        return self.cam_T, self.points, [o[0] for o in out], s / torch.clamp(n, min=1.0)


def lm_solve(mesh: Mesh, ps, iters_first: int, iters_second: int, chi2_mono: float,
             chi2_stereo: float, pcg_iters: int = 40, schur: str = "dense") -> TwoStage:
    """The two-stage solve over observation shards ``ps`` (cameras and
    points replicated), not yet stepped."""

    # The ids stay; obs_valid alone changes.
    segs = mesh.per_shard(lambda p: segs_of(p, schur == "dense"), ps)

    def iteration(ps_, T, X, lam, use_huber):
        return _iteration(mesh, ps_, T, X, lam, use_huber, chi2_mono, chi2_stereo, pcg_iters,
                          schur, segs)

    return TwoStage(mesh, ps, [q.cam_T for q in ps], [q.points for q in ps], iteration,
                    mesh.replicated, iters_first, iters_second, chi2_mono, chi2_stereo)


def _one_shard(p: BAProblem) -> Mesh:
    return Mesh([p.points.device])


def ba_iteration(p: BAProblem, lm_lambda, use_huber: bool, chi2_mono: float,
                 chi2_stereo: float, pcg_iters: int, schur: str = "pcg",
                 obs_pt_sorted: bool = False):
    """One damped GN step on one device, with the JAX package's signature
    (``_iteration`` on a one-shard mesh). Returns (new_cam_T, new_points,
    dc (C, 6), dp (P, 3)). `obs_pt_sorted` is accepted and not needed: the
    segment sums sort their ids themselves."""
    del obs_pt_sorted
    lam = torch.as_tensor(lm_lambda, dtype=torch.float32, device=p.points.device)
    T, X, dc, dp = _iteration(_one_shard(p), [p], [p.cam_T], [p.points], [lam], use_huber,
                              chi2_mono, chi2_stereo, pcg_iters, schur, steps=True)
    return T[0], X[0], dc[0], dp[0]


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


def _point_order(p: BAProblem) -> torch.Tensor:
    C = p.cam_T.shape[0]
    return torch.argsort(p.obs_pt.long() * C + p.obs_cam.long(), stable=True)


def sort_by_point(p: BAProblem, perm: Optional[torch.Tensor] = None) -> BAProblem:
    """Observations sorted by (point, camera), stable (as jnp.argsort)."""
    perm = _point_order(p) if perm is None else perm
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
    """ONE damped LM iteration with accept/reject on one device, no
    readback (pairs with stage_error). Returns (cam_T, points, lam, err)."""
    mesh = _one_shard(p)

    def iteration(ps, T, X, lam_, h):
        return _iteration(mesh, ps, T, X, lam_, h, chi2_mono, chi2_stereo, pcg_iters, schur)

    out = _lm_iteration(mesh, [p], [p.cam_T], [p.points], [lam], [err], iteration,
                        mesh.replicated, use_huber, chi2_mono, chi2_stereo)
    return tuple(o[0] for o in out)


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
    (reference: Optimizer.cc:659-709 LocalBundleAdjustment flow) on one
    device: ``lm_solve`` on a one-shard mesh. The observations are sorted
    by (point, camera) for the solve; the inlier flags come back in the
    input's order."""
    perm = _point_order(p)
    cam_T, points, inlier, mean_chi2 = lm_solve(
        _one_shard(p), [sort_by_point(p, perm)], iters_first, iters_second, chi2_mono,
        chi2_stereo, pcg_iters, schur).run().result()
    obs_inlier = torch.empty_like(inlier[0])
    obs_inlier[perm] = inlier[0]
    return BAResult(cam_T=cam_T[0], points=points[0], obs_inlier=obs_inlier,
                    final_chi2=mean_chi2)
