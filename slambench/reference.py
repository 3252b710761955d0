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
- no loop is closed on a path that never comes back (``loops_closed``).

These are the numbers that the control (``readings.py``) moves by three
times and more over the sound runs; the others that were read beside them
are ``readings.py``'s diagnostics.
"""

from __future__ import annotations

import math

import numpy as np

NUMBERS = ("unresolved", "lost", "loops_closed", "ate_m")


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


def readings(answers: dict, handed: list, gt_poses: np.ndarray, loops_closed: int,
             rigid: bool) -> dict:
    """The numbers compared. `answers` maps a frame index to (pose_cw,
    tracked); `handed` lists the judged frames' indices."""
    got = [i for i in handed if i in answers]
    ok = [i for i in got if answers[i][1]]
    out = dict(unresolved=len(handed) - len(got), lost=len(got) - len(ok),
               loops_closed=int(loops_closed), ate_m=math.inf)
    if len(ok) < 3:
        return out
    est = centers(np.stack([answers[i][0] for i in ok]))
    gt = centers(gt_poses[ok])
    s, R, t = align_umeyama(est, gt, with_scale=not rigid)
    err = np.sqrt(np.sum((est @ (s * R).T + t - gt) ** 2, axis=1))
    out["ate_m"] = float(np.sqrt(np.mean(err ** 2)))
    return out


def judge(values: dict, limits: dict) -> list:
    """[(name, value, limit, within)] for each number that has a limit."""
    return [(k, values[k], limits[k], bool(values[k] <= limits[k]))
            for k in NUMBERS if k in limits]
