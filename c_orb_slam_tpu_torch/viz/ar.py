"""AR demo utilities: dominant-plane detection + virtual cube overlay.

Reference: Examples/ROS/ORB_SLAM2/src/AR/ViewerAR.cc — DetectPlane (:345)
RANSAC-fits a plane to the currently tracked map points (50 iterations of
3-point hypotheses, inliers by normalized point-plane distance), and the
viewer renders a cube anchored to the plane under the live camera pose
(:57-240).
"""

from __future__ import annotations

import numpy as np


def detect_plane(
    xyz: np.ndarray,
    n_iters: int = 50,
    inlier_frac_th: float = 0.2,
    seed: int = 0,
):
    """RANSAC plane fit over tracked 3D points (world frame).

    Returns (origin (3,), normal (3,), inlier_mask) or None. Mirrors
    ViewerAR::DetectPlane's relative-distance threshold (ViewerAR.cc:345):
    the inlier gate adapts to scene scale via the median point spread.
    """
    n = len(xyz)
    if n < 20:
        return None
    rng = np.random.default_rng(seed)
    center = np.median(xyz, axis=0)
    scale = np.median(np.linalg.norm(xyz - center, axis=1))
    th = 0.02 * max(scale, 1e-6)

    best = None
    for _ in range(n_iters):
        i, j, k = rng.choice(n, 3, replace=False)
        nrm = np.cross(xyz[j] - xyz[i], xyz[k] - xyz[i])
        norm = np.linalg.norm(nrm)
        if norm < 1e-9:
            continue
        nrm = nrm / norm
        d = np.abs((xyz - xyz[i]) @ nrm)
        inl = d < th
        if best is None or inl.sum() > best[0]:
            best = (int(inl.sum()), nrm, xyz[i], inl)
    if best is None or best[0] < inlier_frac_th * n:
        return None
    _, nrm, _, inl = best
    # Refine with least squares on inliers.
    pts = xyz[inl]
    origin = pts.mean(axis=0)
    _, _, vt = np.linalg.svd(pts - origin, full_matrices=False)
    normal = vt[2]
    if normal[1] > 0:  # keep normal pointing "up" in camera-y-down worlds
        normal = -normal
    inl = np.abs((xyz - origin) @ normal) < th
    return origin, normal, inl


def plane_basis(origin: np.ndarray, normal: np.ndarray) -> np.ndarray:
    """(4, 4) world-from-plane transform: z axis = plane normal."""
    z = normal / np.linalg.norm(normal)
    a = np.array([1.0, 0, 0]) if abs(z[0]) < 0.9 else np.array([0, 1.0, 0])
    x = np.cross(a, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4, dtype=np.float32)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, origin
    return T


_CUBE_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def cube_segments(T_wp: np.ndarray, size: float) -> list:
    """World-space line segments of a cube of side `size` sitting on the
    plane (reference draws the same cube glyph, ViewerAR.cc:238)."""
    s = size / 2.0
    corners_p = np.array(
        [
            [-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0],
            [-s, -s, size], [s, -s, size], [s, s, size], [-s, s, size],
        ],
        np.float32,
    )
    corners_w = corners_p @ T_wp[:3, :3].T + T_wp[:3, 3]
    return [(corners_w[i], corners_w[j]) for i, j in _CUBE_EDGES]


def draw_cube_overlay(
    image_rgb: np.ndarray,
    Tcw: np.ndarray,
    K4: np.ndarray,
    T_wp: np.ndarray,
    size: float,
    color=(255, 60, 60),
) -> np.ndarray:
    """Project the cube into the frame and rasterize its edges."""
    img = image_rgb.copy()
    h, w = img.shape[:2]
    fx, fy, cx, cy = np.asarray(K4, np.float64)
    R, t = np.asarray(Tcw)[:, :3], np.asarray(Tcw)[:, 3]
    col = np.asarray(color, np.uint8)
    for p, q in cube_segments(T_wp, size):
        pc, qc = R @ p + t, R @ q + t
        if pc[2] <= 1e-3 or qc[2] <= 1e-3:
            continue
        u0 = (fx * pc[0] / pc[2] + cx, fy * pc[1] / pc[2] + cy)
        u1 = (fx * qc[0] / qc[2] + cx, fy * qc[1] / qc[2] + cy)
        tt = np.linspace(0, 1, 64)
        xs = np.clip(np.round(u0[0] * (1 - tt) + u1[0] * tt), 0, w - 1).astype(int)
        ys = np.clip(np.round(u0[1] * (1 - tt) + u1[1] * tt), 0, h - 1).astype(int)
        img[ys, xs] = col
        if h > 2 and w > 2:  # 2px-thick lines read better
            img[np.minimum(ys + 1, h - 1), xs] = col
    return img
