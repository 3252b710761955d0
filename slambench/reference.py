"""The plain reference that decides ``correct``: numpy only, nothing of
the program.

The right answers come from the inputs the benchmark made and handed to
the program: the ground-truth path of every frame. The program's outputs
are judged against it:

- every frame handed in has a pose (``unresolved``), tracked (``lost``);
- the resolved poses lie on the path, up to one rigid motion for a
  stereo rig or one similarity for a monocular camera (its scale is
  free): ``ate_m``, the RMSE of the camera centres after that alignment,
  the Umeyama arithmetic of the port's ``tools/bench.py``, copied. Frame
  build's keypoints and stereo depths, tracking's pose solves and
  mapping's local bundle adjustment all show in it;
- the same, each second of the sensor's frames aligned on its own by
  whole poses (``ate_seg_m``): a monocular camera's scale drifts over a
  window, and one alignment of the whole window mostly measures that
  drift; the error within a second still counts;
- the rotation between frames a second apart, against the path's
  (``rpe_rot_deg``): no alignment, no scale;
- the final map's reprojection error at level 0, each residual in
  ORB-SLAM2's sigma of its keypoint's level (``reproj_px``): the map's
  points and keyframe poses against the keypoints they were built from;
- no loop is closed on a path that never comes back (``loops_closed``);
- the program's local bundle adjustment of the newest keyframe's window
  (the harness runs it once more after the window), re-solved in float64
  from the program's answer (``local_ba``): how far that answer lies
  above the window's optimum, in chi2 a observation (``ba_gap``), and how
  far the optimum moves the free keyframes, over the window's median
  depth (``ba_move_rel``). Both are free of the map's scale, so a
  monocular camera owes nothing for it.

Every number is read in every run; a configuration's ``correct`` names
the ones compared, each with the limit set between the sound runs and the
control (``readings.py``), and the others stay readings.
"""

from __future__ import annotations

import math

import numpy as np

NUMBERS = ("unresolved", "lost", "loops_closed", "ate_m", "ate_seg_m", "rpe_rot_deg",
           "reproj_px", "ba_gap", "ba_move_rel")

# The local-BA window's caps, the port's configuration's values
# (c_orb_slam_tpu_torch/config.py:264-266: local_ba_max_kfs,
# local_ba_max_points, local_ba_max_obs); the cameras, local and fixed
# frontier together, stop at twice the keyframes (mapping.py:578).
BA_MAX_KFS = 32
BA_MAX_POINTS = 8192
BA_MAX_OBS = 16384
# ORB-SLAM2's 95% chi2 gates of a 2-D and a 3-D (stereo) residual
# (Optimizer.cc:570, :595), the Huber kernel's delta squared.
CHI2_MONO = 5.991
CHI2_STEREO = 7.815
# The float64 solve stops at a relative cost drop under this, or after
# this many iterations.
BA_REL_TOL = 1e-10
BA_MAX_ITERS = 50


def centers(poses_cw: np.ndarray) -> np.ndarray:
    """(F, 3, 4) world-to-camera poses -> (F, 3) camera centres."""
    poses_cw = np.asarray(poses_cw, np.float64)
    return -np.einsum("fij,fi->fj", poses_cw[:, :, :3], poses_cw[:, :, 3])


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool):
    """(s, R, t) with gt ~ s R est + t (Umeyama; Horn without scale)."""
    mu_e, mu_g = est.mean(axis=0), gt.mean(axis=0)
    e, g = est - mu_e, gt - mu_g
    U, D, Vt = np.linalg.svd(g.T @ e / len(est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = 1.0
    if with_scale:
        var_e = (e * e).sum() / len(est)
        s = float(np.trace(np.diag(D) @ S) / max(var_e, 1e-12))
    return s, R, mu_g - s * R @ mu_e


def align_poses(est_cw: np.ndarray, gt_cw: np.ndarray, with_scale: bool):
    """(s, R, t) with X_gt ~ s R X_est + t from whole poses: R the chordal
    mean of the frames' R_gt^T R_est, then s and t from the centres. A path
    that runs nearly straight leaves the rotation about its own line to
    the orientations: the centres alone do not fix it."""
    Re, Rg = est_cw[:, :, :3], gt_cw[:, :, :3]
    U, _, Vt = np.linalg.svd(np.einsum("fji,fjk->ik", Rg, Re))
    R = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
    ce, cg = centers(est_cw), centers(gt_cw)
    e, g = ce - ce.mean(axis=0), cg - cg.mean(axis=0)
    s = float(np.sum((e @ R.T) * g) / max(np.sum(e * e), 1e-12)) if with_scale else 1.0
    return s, R, cg.mean(axis=0) - s * R @ ce.mean(axis=0)


def rotation_angle(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) rotations -> their angles in radians, from the skew part
    and the trace together: exact near 0, where float32 poses put the
    trace's arccos at the edge of its precision."""
    skew = 0.5 * (R - np.swapaxes(R, -1, -2))
    sin = np.sqrt(skew[..., 0, 1] ** 2 + skew[..., 0, 2] ** 2 + skew[..., 1, 2] ** 2)
    cos = 0.5 * (np.trace(R, axis1=-2, axis2=-1) - 1.0)
    return np.arctan2(sin, cos)


def segments(n_frames: int, size: int) -> list:
    """[(start, stop)] cutting n_frames into consecutive runs of `size`; a
    tail shorter than half a run joins the run before it."""
    cuts = list(range(0, n_frames, size)) + [n_frames]
    if len(cuts) > 2 and cuts[-1] - cuts[-2] < size / 2:
        del cuts[-2]
    return list(zip(cuts[:-1], cuts[1:]))


def ate_seg(est_cw: np.ndarray, gt_cw: np.ndarray, size: int, rigid: bool) -> float:
    """RMS of every frame's centre error, each segment of `size` frames
    aligned on its own by whole poses (a similarity, or a rigid motion for
    a stereo rig); inf where no segment holds 3 frames."""
    ce, cg = centers(est_cw), centers(gt_cw)
    sq = []
    for a, b in segments(len(ce), size):
        if b - a < 3:
            continue
        s, R, t = align_poses(est_cw[a:b], gt_cw[a:b], not rigid)
        sq.append(np.sum((ce[a:b] @ (s * R).T + t - cg[a:b]) ** 2, axis=1))
    return rms(np.sqrt(np.concatenate(sq))) if sq else math.inf


def rpe_rot(poses: dict, gt_cw: np.ndarray, gap: int) -> float:
    """RMS, in degrees, over the tracked frame pairs (i, i + gap), of the
    angle of dR_gt^T dR_est, dR the rotation from camera i to camera
    i + gap; inf where no pair is tracked."""
    first = [i for i in sorted(poses) if i + gap in poses]
    if not first:
        return math.inf
    last = [i + gap for i in first]
    d_est = (np.stack([poses[j][:, :3] for j in last])
             @ np.swapaxes(np.stack([poses[i][:, :3] for i in first]), 1, 2))
    d_gt = gt_cw[last, :, :3] @ np.swapaxes(gt_cw[first, :, :3], 1, 2)
    return float(np.degrees(rms(rotation_angle(np.swapaxes(d_gt, 1, 2) @ d_est))))


def reprojection(final_map: dict, fx: float, fy: float, cx: float, cy: float,
                 scale_factor: float) -> np.ndarray:
    """Every observation that links a live keyframe's keypoint to a valid
    point of the final map: its pixel residual at level 0 over
    scale_factor**octave (ORB-SLAM2's sigma of the level), in float64.
    `final_map`: ``kf_pose`` (K, 3, 4) Tcw, ``kf_xy`` (K, P, 2),
    ``kf_octave`` (K, P), ``kf_mp`` (K, P) point index or -1, of the live
    keyframes; ``pt_xyz`` (N, 3), ``pt_valid`` (N,)."""
    mp = np.asarray(final_map["kf_mp"], np.int64)
    valid = np.asarray(final_map["pt_valid"], bool)
    obs = mp >= 0
    obs[obs] = valid[mp[obs]]
    k, f = np.nonzero(obs)
    T = np.asarray(final_map["kf_pose"], np.float64)[k]
    X = np.asarray(final_map["pt_xyz"], np.float64)[mp[k, f]]
    Xc = np.einsum("nij,nj->ni", T[:, :, :3], X) + T[:, :, 3]
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = np.c_[fx * Xc[:, 0] / Xc[:, 2] + cx, fy * Xc[:, 1] / Xc[:, 2] + cy]
    xy = np.asarray(final_map["kf_xy"], np.float64)[k, f]
    sigma = float(scale_factor) ** np.asarray(final_map["kf_octave"], np.float64)[k, f]
    return np.sqrt(np.sum((uv - xy) ** 2, axis=1)) / sigma


def rms(x: np.ndarray) -> float:
    """Root mean square; inf of nothing."""
    return float(np.sqrt(np.mean(np.square(x)))) if len(x) else math.inf


def camera(settings: dict) -> tuple:
    """(fx, fy, cx, cy, scale_factor) of a configuration's settings."""
    return tuple(float(settings[k]) for k in ("Camera.fx", "Camera.fy", "Camera.cx", "Camera.cy",
                                               "ORBextractor.scaleFactor"))


def ba_window(final_map: dict, monocular: bool):
    """The newest live keyframe's local-BA window, rebuilt from the final
    map by the rule of the port's ``LocalMapping._ba_dispatch``
    (mapping.py:548-635): the keyframe and its covisible keyframes, the
    heaviest first, up to BA_MAX_KFS, free; the valid points they see, by
    index, up to BA_MAX_POINTS; the keyframes that see those points and
    are not local, fixed (the frontier), after the local ones, up to
    2 * BA_MAX_KFS cameras; with no frontier the oldest local keyframe
    fixed, and for a monocular camera the second oldest too (the gauge);
    the observations of those points from those cameras, point by point
    (within a point by the observing keyframe's serial), up to BA_MAX_OBS.
    A covisibility weight is the count of valid points two keyframes
    share, counted here from ``kf_mp``.

    Departures, from ORB-SLAM2's ``Optimizer::LocalBundleAdjustment``
    (Optimizer.cc:453-778): ORB-SLAM2 takes every covisible keyframe and
    every point they see, the port (and so this rule) caps both; ORB-SLAM2
    fixes only the frontier and the map's first keyframe, the port fixes
    the oldest (and for a monocular camera the second oldest) local
    keyframe where there is no frontier. From the port: its weights are
    counted when a keyframe's connections were last updated, these on the
    final map, and its ties fall as an unstable sort leaves them, these by
    keyframe slot (which differ only where more than 31 keyframes are
    covisible); where BA_MAX_OBS cuts a point's observations short, the
    port keeps those added first, this rule leaves the point out.

    `final_map`: ``kf_pose`` (K, 3, 4), ``kf_xy`` (K, F, 2), ``kf_ur``
    (K, F) (right-image u, 0 or less for a monocular observation),
    ``kf_octave``, ``kf_mp`` (K, F) and ``kf_serial`` (K,) of the live
    keyframes in slot order; ``pt_xyz``, ``pt_valid``. None with fewer
    than 3 live keyframes (the port runs no local BA then)."""
    mp = np.asarray(final_map["kf_mp"], np.int64)
    valid = np.asarray(final_map["pt_valid"], bool)
    serial = np.asarray(final_map["kf_serial"], np.int64)
    n_kf = len(mp)
    if n_kf < 3:
        return None
    seen = mp >= 0
    seen[seen] = valid[mp[seen]]
    o_k, o_f = np.nonzero(seen)
    o_p = mp[o_k, o_f]
    newest = int(np.argmax(serial))
    weight = np.bincount(o_k[np.isin(o_p, mp[newest][seen[newest]])], minlength=n_kf)
    weight[newest] = 0
    by_weight = np.lexsort((np.arange(n_kf), -weight))
    local = [newest] + [int(k) for k in by_weight if weight[k] >= 1][:BA_MAX_KFS - 1]
    is_local = np.zeros(n_kf, bool)
    is_local[local] = True
    pts = np.unique(o_p[is_local[o_k]])[:BA_MAX_POINTS]
    in_pts = np.isin(o_p, pts)
    frontier = np.unique(o_k[in_pts & ~is_local[o_k]])
    cams = np.asarray((local + frontier.tolist())[:2 * BA_MAX_KFS], np.int64)
    fixed = ~is_local[cams]
    if len(frontier) == 0:
        by_age = np.argsort(serial[cams], kind="stable")
        fixed[by_age[:2 if monocular else 1]] = True
    slot = np.full(n_kf, -1)
    slot[cams] = np.arange(len(cams))
    keep = in_pts & (slot[o_k] >= 0)
    o_k, o_f, o_p = o_k[keep], o_f[keep], o_p[keep]
    order = np.lexsort((serial[o_k], o_p))
    if len(order) > BA_MAX_OBS:
        # The cap cuts one point's observations short; which of them the
        # port keeps follows the order they were added in, which the map
        # does not hold: that point is left out.
        cut = o_p[order[BA_MAX_OBS]]
        order = order[:BA_MAX_OBS]
        order = order[o_p[order] != cut]
    o_k, o_f, o_p = o_k[order], o_f[order], o_p[order]
    return dict(cams=cams, fixed=fixed, points=pts, obs_cam=slot[o_k],
                obs_pt=np.searchsorted(pts, o_p), obs_kf=o_k, obs_feat=o_f)


def _hat(w: np.ndarray) -> np.ndarray:
    """(..., 3) -> (..., 3, 3) skew-symmetric."""
    z = np.zeros(w.shape[:-1])
    return np.stack([np.stack([z, -w[..., 2], w[..., 1]], -1),
                     np.stack([w[..., 2], z, -w[..., 0]], -1),
                     np.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _se3_exp(xi: np.ndarray) -> tuple:
    """(n, 6) twists (translation, rotation) -> (R (n, 3, 3), t (n, 3)),
    Rodrigues and the left Jacobian in float64 (series near 0)."""
    rho, phi = xi[:, :3], xi[:, 3:]
    th2 = np.sum(phi * phi, axis=1)[:, None, None]
    th = np.sqrt(th2)
    small = th2 < 1e-12
    safe = np.where(small, 1.0, th)
    a = np.where(small, 1.0 - th2 / 6.0, np.sin(safe) / safe)
    b = np.where(small, 0.5 - th2 / 24.0, (1.0 - np.cos(safe)) / safe ** 2)
    c = np.where(small, 1.0 / 6.0 - th2 / 120.0, (safe - np.sin(safe)) / safe ** 3)
    W = _hat(phi)
    WW = W @ W
    eye = np.eye(3)
    return eye + a * W + b * WW, ((eye + b * W + c * WW) @ rho[:, :, None])[:, :, 0]


def _ba_terms(T, X, prob, jacobians: bool):
    """Per observation: residual (n, 3) (the third row 0 for a monocular
    one), chi2, depth, and with `jacobians` d r / d twist of its camera
    (n, 3, 6) (zero for a fixed camera) and d r / d point (n, 3, 3). The
    camera model is the pinhole with the stereo rig's right u = u - bf / z;
    a pose moves as T <- exp(xi) T."""
    fx, fy, cx, cy = prob["K"]
    R, t = T[prob["cam"], :, :3], T[prob["cam"], :, 3]
    Xc = np.einsum("nij,nj->ni", R, X[prob["pt"]]) + t
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        iz = 1.0 / z
        u = fx * x * iz + cx
        proj = np.stack([u, fy * y * iz + cy, u - prob["bf"] * iz], 1)
    r = (prob["uv"] - proj) * prob["rows"]
    chi2 = np.sum(r * r, axis=1) * prob["isig2"]
    if not jacobians:
        return r, chi2, z
    J = np.zeros((len(z), 3, 3))
    J[:, 0, 0], J[:, 0, 2] = fx * iz, -fx * x * iz * iz
    J[:, 1, 1], J[:, 1, 2] = fy * iz, -fy * y * iz * iz
    J[:, 2] = J[:, 0]
    J[:, 2, 2] += prob["bf"] * iz * iz
    J *= prob["rows"][:, :, None]
    Jc = -np.concatenate([J, -J @ _hat(Xc)], axis=2) * prob["free_obs"][:, None, None]
    return r, chi2, z, Jc, -J @ R


def _robust(chi2: np.ndarray, delta2: np.ndarray) -> tuple:
    """Huber's rho of chi2 at delta squared, and its IRLS weight."""
    over = chi2 > delta2
    root = np.sqrt(np.maximum(chi2, 1e-300))
    rho = np.where(over, 2.0 * np.sqrt(delta2) * root - delta2, chi2)
    return rho, np.where(over, np.sqrt(delta2) / root, 1.0)


def _ba_cost(T, X, prob) -> float:
    """E = sum of rho(chi2); inf where a point falls behind its camera."""
    _, chi2, z = _ba_terms(T, X, prob, False)
    if not np.all(z > 1e-6):
        return math.inf
    return float(np.sum(_robust(chi2, prob["delta2"])[0]))


def _segment_sum(idx: np.ndarray, values: np.ndarray, n: int) -> np.ndarray:
    """(n, ...) sums of `values` (N, ...) by their segment `idx` (N,)."""
    flat = values.reshape(len(idx), -1)
    out = np.stack([np.bincount(idx, weights=flat[:, k], minlength=n)
                    for k in range(flat.shape[1])], 1)
    return out.reshape((n,) + values.shape[1:])


def _normal(T, X, prob, lam: float) -> dict:
    """The damped normal equations at (T, X), the points eliminated by the
    dense Schur complement: the reduced camera matrix ``S`` of the free
    cameras (6 F, 6 F) and its right side ``rhs``, and what the point
    back-substitution needs."""
    r, chi2, _, Jc, Jp = _ba_terms(T, X, prob, True)
    w = (_robust(chi2, prob["delta2"])[1] * prob["isig2"])[:, None, None]
    n_cam, n_pt = len(T), len(X)
    cam, pt = prob["cam"], prob["pt"]
    Jcw, Jpw = Jc * w, Jp * w
    Hcc = _segment_sum(cam, np.swapaxes(Jcw, 1, 2) @ Jc, n_cam)
    gc = _segment_sum(cam, np.einsum("nki,nk->ni", Jcw, r), n_cam)
    Hpp = _segment_sum(pt, np.swapaxes(Jpw, 1, 2) @ Jp, n_pt)
    gp = _segment_sum(pt, np.einsum("nki,nk->ni", Jpw, r), n_pt)
    Hpp_inv = np.linalg.inv(Hpp + lam * np.eye(3))
    Wo = np.swapaxes(Jcw, 1, 2) @ Jp  # (n, 6, 3), one (camera, point) block each
    free = np.nonzero(prob["free_cam"])[0]
    fslot = np.full(n_cam, -1)
    fslot[free] = np.arange(len(free))
    nf = len(free)
    # W of the free cameras, dense (6 F, 3 P): one (camera, point) block
    # an observation; S = Hcc - W Hpp^-1 W^T.
    fo = np.nonzero(prob["free_obs"] > 0)[0]
    W = np.zeros((nf, n_pt, 6, 3))
    W[fslot[cam[fo]], pt[fo]] = Wo[fo]
    W = W.transpose(0, 2, 1, 3).reshape(6 * nf, 3 * n_pt)
    WH = np.matmul(W.reshape(6 * nf, n_pt, 3).transpose(1, 0, 2), Hpp_inv)
    WH = WH.transpose(1, 0, 2).reshape(6 * nf, -1)
    S = -(WH @ W.T)
    S4 = S.reshape(nf, 6, nf, 6)
    S4[np.arange(nf), :, np.arange(nf), :] += Hcc[free] + lam * np.eye(6)
    rhs = -(gc[free].reshape(-1) - WH @ gp.reshape(-1))
    return dict(S=S, rhs=rhs, free=free, Wo=Wo, Hpp_inv=Hpp_inv, gp=gp)


def _ba_step(T, X, prob, lam: float):
    """One damped Gauss-Newton step (``_normal``): (new T, new X), or None
    where the reduced system cannot be factored."""
    n = _normal(T, X, prob, lam)
    try:
        L = np.linalg.cholesky(n["S"])
    except np.linalg.LinAlgError:
        return None
    dc = np.zeros((len(T), 6))
    dc[n["free"]] = np.linalg.solve(L.T, np.linalg.solve(L, n["rhs"])).reshape(-1, 6)
    wt_dc = _segment_sum(prob["pt"], np.einsum("nij,ni->nj", n["Wo"], dc[prob["cam"]]), len(X))
    dp = np.einsum("pij,pj->pi", n["Hpp_inv"], -n["gp"] - wt_dc)
    dR, dt = _se3_exp(dc)
    new_T = np.concatenate([dR @ T[:, :, :3], dR @ T[:, :, 3:] + dt[:, :, None]], 2)
    return new_T, X + dp


def _points_only(T, X, prob, iters: int = 20) -> float:
    """The least cost over the points alone, the cameras held at T: each
    point's own damped Gauss-Newton, a step kept where it lowers that
    point's cost."""
    pt, n_pt = prob["pt"], len(X)
    lam = np.full(n_pt, 1e-6)

    def per_point(X_):
        _, chi2, z = _ba_terms(T, X_, prob, False)
        rho = _robust(chi2, prob["delta2"])[0]
        return np.where(np.bincount(pt, weights=(z <= 1e-6).astype(float), minlength=n_pt) > 0,
                        np.inf, np.bincount(pt, weights=rho, minlength=n_pt))

    cost = per_point(X)
    for _ in range(iters):
        r, chi2, _, _, Jp = _ba_terms(T, X, prob, True)
        w = (_robust(chi2, prob["delta2"])[1] * prob["isig2"])[:, None, None]
        H = _segment_sum(pt, np.swapaxes(Jp * w, 1, 2) @ Jp, n_pt)
        g = _segment_sum(pt, np.einsum("nki,nk->ni", Jp * w, r), n_pt)
        scale = np.trace(H, axis1=1, axis2=2)[:, None, None] / 3.0
        step = -np.einsum("pij,pj->pi", np.linalg.inv(H + lam[:, None, None] * scale * np.eye(3)), g)
        new = per_point(X + step)
        better = new < cost
        X = np.where(better[:, None], X + step, X)
        cost = np.where(better, new, cost)
        lam = np.where(better, lam / 3.0, lam * 4.0)
    return float(cost.sum())


def ba_solve(final_map: dict, settings: dict, monocular: bool):
    """The window (``ba_window``) at the program's final poses and points,
    its observations over their gate there left out, as the program's
    clean second stage leaves them (an observation behind its camera too),
    and so the points the rest see fewer than twice (a point seen once
    constrains no camera: its residual goes to 0 for free), solved in
    float64 (``local_ba``). None where there is no window; a dict of
    ``window`` alone (its sizes) where nothing in it moves; else also
    ``cams`` and ``points`` (the final map's keyframe positions and point
    indices solved), ``free`` (per camera), ``T0``, ``X0`` (the
    program's), ``T``, ``X`` (the optimum), the costs ``e_program``,
    ``e_reference``, ``depth`` (per observation, at the program's state),
    ``iterations``, and in ``window`` ``e_points``, the least cost over
    the points alone with the cameras held at the program's."""
    win = ba_window(final_map, monocular)
    if win is None:
        return None
    fx, fy, cx, cy, sf = camera(settings)
    cams, pts, kf, feat = win["cams"], win["points"], win["obs_kf"], win["obs_feat"]
    T0 = np.asarray(final_map["kf_pose"], np.float64)[cams]
    X0 = np.asarray(final_map["pt_xyz"], np.float64)[pts]
    ur = np.asarray(final_map["kf_ur"], np.float64)[kf, feat]
    stereo = ur > 0
    octave = np.asarray(final_map["kf_octave"], np.float64)[kf, feat]
    prob = dict(cam=win["obs_cam"], pt=win["obs_pt"],
                uv=np.c_[np.asarray(final_map["kf_xy"], np.float64)[kf, feat],
                         np.where(stereo, ur, 0.0)],
                rows=np.c_[np.ones((len(kf), 2)), stereo.astype(np.float64)],
                isig2=float(sf) ** (-2.0 * octave),
                delta2=np.where(stereo, CHI2_STEREO, CHI2_MONO))
    _, chi2, z = _ba_terms(T0, X0, dict(prob, K=(fx, fy, cx, cy),
                                        bf=float(settings.get("Camera.bf", 0.0))), False)
    gated = (chi2 <= prob["delta2"]) & (z > 0)
    keep = gated & (np.bincount(prob["pt"][gated], minlength=len(pts))[prob["pt"]] >= 2)
    prob = {k: v[keep] for k, v in prob.items()}
    used, prob["pt"] = np.unique(prob["pt"], return_inverse=True)
    free = ~win["fixed"]
    prob.update(K=(fx, fy, cx, cy), bf=float(settings.get("Camera.bf", 0.0)),
                free_cam=free, free_obs=free[prob["cam"]].astype(np.float64))
    window = dict(cameras=int(len(cams)), free=int(free.sum()), points=int(len(used)),
                  observations=int(keep.sum()), stereo=int(stereo[keep].sum()),
                  gated_out=int((~gated).sum()), seen_once=int((gated & ~keep).sum()))
    if not keep.any() or not free.any():
        return dict(window=window)
    X0 = X0[used]
    e_prog = _ba_cost(T0, X0, prob)
    _, _, _, Jc, _ = _ba_terms(T0, X0, prob, True)
    scale = float(np.mean(np.sum(Jc * Jc, axis=1)[prob["free_obs"] > 0]))
    T, X, e, lam, its = T0, X0, e_prog, 1e-6, 0
    while its < BA_MAX_ITERS and lam < 1e12:
        its += 1
        step = _ba_step(T, X, prob, lam * scale)
        e_new = _ba_cost(*step, prob) if step is not None else math.inf
        if e_new < e:
            drop = (e - e_new) / max(e, 1e-300)
            T, X, e, lam = step[0], step[1], e_new, max(lam / 3.0, 1e-12)
            if drop < BA_REL_TOL:
                break
        else:
            lam *= 4.0
    window["e_points"] = _points_only(T0, X0, prob)
    return dict(window=window, cams=cams, points=pts[used], free=free, T0=T0, X0=X0, T=T, X=X,
                e_program=e_prog, e_reference=e, depth=_ba_terms(T0, X0, prob, False)[2],
                iterations=its, observations=len(prob["cam"]))


def local_ba(final_map: dict, settings: dict, monocular: bool) -> dict:
    """The last local BA re-solved (module docstring): ``ba_solve``'s
    window, where E = sum of Huber's rho(chi2) over its observations,
    chi2 = |r|^2 / sigma^2, sigma = scale_factor ** octave, delta^2
    CHI2_MONO for a 2-D and CHI2_STEREO for a 3-D residual, minimised by
    Levenberg-Marquardt in float64 from the program's state, the points
    eliminated by the dense Schur complement, until the relative cost drop
    is under BA_REL_TOL or BA_MAX_ITERS iterations.

    Returns ``ba_gap`` = (E_program - E_reference) / observations and
    ``ba_move_rel`` = RMS over the free keyframes of the move of their
    centres over the median depth of the observations, both inf where
    there is no window to solve, and ``window``: its sizes, costs and
    iterations."""
    sol = ba_solve(final_map, settings, monocular)
    out = dict(ba_gap=math.inf, ba_move_rel=math.inf, window=sol and sol["window"])
    if sol is None or "T" not in sol:
        return out
    free, depth = sol["free"], float(np.median(sol["depth"]))
    move = np.linalg.norm(centers(sol["T"][free]) - centers(sol["T0"][free]), axis=1)
    out.update(ba_gap=(sol["e_program"] - sol["e_reference"]) / sol["observations"],
               ba_move_rel=rms(move) / depth)
    out["window"].update(e_program=sol["e_program"], e_reference=sol["e_reference"],
                         iterations=sol["iterations"], median_depth=depth)
    return out


def readings(answers: dict, handed: list, gt_poses: np.ndarray, loops_closed: int,
             rigid: bool, settings: dict, final_map: dict, ba_map: dict | None) -> dict:
    """The numbers. `answers` maps a frame index to (pose_cw, tracked);
    `handed` lists the judged frames' indices; `settings` is the
    configuration's (the sensor's rate, the camera, the pyramid's scale,
    a stereo rig's bf); `final_map` the map's arrays (``reprojection``);
    `ba_map` the same as the program's last local BA left them
    (``ba_window``), or None where it ran none. Beside the numbers,
    ``ba_window`` describes the re-solved window (``local_ba``)."""
    got = [i for i in handed if i in answers]
    ok = [i for i in got if answers[i][1]]
    rate = float(settings["Camera.fps"])
    second = max(1, round(rate))
    ba = (local_ba(ba_map, settings, monocular=not rigid) if ba_map is not None
          else dict(ba_gap=math.inf, ba_move_rel=math.inf, window=None))
    out = dict(unresolved=len(handed) - len(got), lost=len(got) - len(ok),
               loops_closed=int(loops_closed), ate_m=math.inf, ate_seg_m=math.inf,
               rpe_rot_deg=rpe_rot({i: np.asarray(answers[i][0], np.float64) for i in ok},
                                   np.asarray(gt_poses, np.float64), second),
               reproj_px=rms(reprojection(final_map, *camera(settings))),
               ba_gap=ba["ba_gap"], ba_move_rel=ba["ba_move_rel"], ba_window=ba["window"])
    if len(ok) < 3:
        return out
    est_cw = np.stack([np.asarray(answers[i][0], np.float64) for i in ok])
    gt_cw = np.asarray(gt_poses, np.float64)[ok]
    est, gt = centers(est_cw), centers(gt_cw)
    s, R, t = align_umeyama(est, gt, with_scale=not rigid)
    err = np.sqrt(np.sum((est @ (s * R).T + t - gt) ** 2, axis=1))
    out["ate_m"] = float(np.sqrt(np.mean(err ** 2)))
    out["ate_seg_m"] = ate_seg(est_cw, gt_cw, second, rigid)
    return out


def judge(values: dict, limits: dict) -> list:
    """[(name, value, limit, within)] for each number that has a limit."""
    return [(k, values[k], limits[k], bool(values[k] <= limits[k]))
            for k in NUMBERS if k in limits]
