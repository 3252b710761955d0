"""Trajectory export in TUM and KITTI formats + ATE evaluation.

Counterpart of c_orb_slam_tpu/io/trajectory.py (reference:
src/System.cc:322-472 SaveTrajectoryTUM / SaveKeyFrameTrajectoryTUM /
SaveTrajectoryKITTI), host-side numpy throughout.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from c_orb_slam_tpu_torch.geometry import so3


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of a rotation matrix."""
    return so3.from_matrix(torch.as_tensor(R, dtype=torch.float32)).numpy()


def save_tum(path: str, stamps, poses_cw):
    """TUM format: timestamp tx ty tz qx qy qz qw — camera-to-world."""
    with open(path, "w") as f:
        for t, Tcw in zip(stamps, poses_cw):
            R = Tcw[:, :3]
            tw = -R.T @ Tcw[:, 3]
            q = _rot_to_quat(R.T)
            f.write(
                f"{t:.6f} {tw[0]:.7f} {tw[1]:.7f} {tw[2]:.7f} "
                f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n"
            )


def save_kitti(path: str, poses_cw):
    """KITTI format: flattened 3x4 camera-to-world per line."""
    with open(path, "w") as f:
        for Tcw in poses_cw:
            R = Tcw[:, :3]
            tw = -R.T @ Tcw[:, 3]
            Twc = np.concatenate([R.T, tw[:, None]], axis=1)
            f.write(" ".join(f"{v:.6e}" for v in Twc.reshape(-1)) + "\n")


def sha256(poses_cw, stamps) -> str:
    """SHA-256 of a trajectory, its stamps and then its poses as float32
    bytes: equal only when two runs gave the same poses, bit for bit."""
    h = hashlib.sha256(np.asarray(stamps, np.float32).tobytes())
    h.update(np.asarray(poses_cw, np.float32).tobytes())
    return h.hexdigest()


def centers_from_cw(poses_cw: np.ndarray) -> np.ndarray:
    """(F, 3, 4) Tcw -> (F, 3) camera centers in world."""
    return -np.einsum("fij,fi->fj", poses_cw[:, :, :3], poses_cw[:, :, 3])


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = True):
    """Umeyama/Horn alignment (s, R, t) such that gt ≈ s R est + t."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    e = est - mu_e
    g = gt - mu_g
    U, D, Vt = np.linalg.svd(g.T @ e / len(est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (e * e).sum() / len(est)
        s = float(np.trace(np.diag(D) @ S) / max(var_e, 1e-12))
    else:
        s = 1.0
    return s, R, mu_g - s * R @ mu_e


def ate_rmse(est_cw: np.ndarray, gt_cw: np.ndarray, with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after (scaled) alignment."""
    est = centers_from_cw(est_cw)
    gt = centers_from_cw(gt_cw)
    s, R, t = align_umeyama(est, gt, with_scale)
    aligned = est @ (s * R).T + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))
