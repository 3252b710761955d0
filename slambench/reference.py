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
- no loop is closed on a path that never comes back (``loops_closed``).

Every number is read in every run; a configuration's ``correct`` names
the ones compared, each with the limit set between the sound runs and the
control (``readings.py``), and the others stay readings.
"""

from __future__ import annotations

import math

import numpy as np

NUMBERS = ("unresolved", "lost", "loops_closed", "ate_m", "ate_seg_m", "rpe_rot_deg",
           "reproj_px")


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


def readings(answers: dict, handed: list, gt_poses: np.ndarray, loops_closed: int,
             rigid: bool, settings: dict, final_map: dict) -> dict:
    """The numbers. `answers` maps a frame index to (pose_cw, tracked);
    `handed` lists the judged frames' indices; `settings` is the
    configuration's (the sensor's rate, the camera, the pyramid's scale);
    `final_map` the map's arrays (``reprojection``)."""
    got = [i for i in handed if i in answers]
    ok = [i for i in got if answers[i][1]]
    rate = float(settings["Camera.fps"])
    second = max(1, round(rate))
    out = dict(unresolved=len(handed) - len(got), lost=len(got) - len(ok),
               loops_closed=int(loops_closed), ate_m=math.inf, ate_seg_m=math.inf,
               rpe_rot_deg=rpe_rot({i: np.asarray(answers[i][0], np.float64) for i in ok},
                                   np.asarray(gt_poses, np.float64), second),
               reproj_px=rms(reprojection(final_map, *camera(settings))))
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
