"""Stereo rectification: undistort + rectify maps and a bilinear remap.

Counterpart of c_orb_slam_tpu/frontend/rectify.py (reference:
Examples/Stereo/stereo_euroc.cc:72-98 reads LEFT.*/RIGHT.* K, D, R, P
from the settings YAML, builds cv::initUndistortRectifyMap once and
cv::remap's every frame on the CPU).

The (H, W, 2) source-coordinate maps are computed once on the host
(numpy, the same construction as OpenCV's: unproject with the new
projection P, rotate by R^-1, apply radial-tangential distortion,
project with the original K); the per-frame remap is an indexing-based
bilinear sample on the caller's device, with the JAX package's border
clamp.
"""

from __future__ import annotations

import numpy as np
import torch


def init_undistort_rectify_map(
    K: np.ndarray,
    D: np.ndarray,
    R: np.ndarray,
    P: np.ndarray,
    size_wh: tuple[int, int],
) -> np.ndarray:
    """(H, W, 2) map of source (x, y) pixel coords for each rectified pixel.

    K: (3,3) original intrinsics; D: (k1,k2,p1,p2[,k3]) distortion;
    R: (3,3) rectification rotation; P: (3,4) or (3,3) new projection.
    Same construction as cv::initUndistortRectifyMap.
    """
    w, h = size_wh
    P = np.asarray(P, np.float64)
    fxp, fyp = P[0, 0], P[1, 1]
    cxp, cyp = P[0, 2], P[1, 2]
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    x = (u - cxp) / fxp
    y = (v - cyp) / fyp
    ones = np.ones_like(x)
    xyz = np.stack([x, y, ones], axis=-1) @ np.linalg.inv(np.asarray(R, np.float64)).T
    xn = xyz[..., 0] / xyz[..., 2]
    yn = xyz[..., 1] / xyz[..., 2]

    D = np.asarray(D, np.float64).ravel()
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    k3 = D[4] if len(D) > 4 else 0.0
    r2 = xn * xn + yn * yn
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn

    K = np.asarray(K, np.float64)
    map_x = K[0, 0] * xd + K[0, 2]
    map_y = K[1, 1] * yd + K[1, 2]
    return np.stack([map_x, map_y], axis=-1).astype(np.float32)


def remap_bilinear(image: torch.Tensor, src_map: torch.Tensor) -> torch.Tensor:
    """Sample `image` (H, W) at src_map (H', W', 2) (x, y) coords with
    bilinear interpolation, on the tensors' device. Coordinates clamp to
    [0, W - 1.001] x [0, H - 1.001], as in the JAX package (cv::remap's
    BORDER_CONSTANT differs only on a 1 px fringe that the ORB edge
    threshold already excludes)."""
    H, W = image.shape
    x = torch.clamp(src_map[..., 0], 0.0, W - 1.001)
    y = torch.clamp(src_map[..., 1], 0.0, H - 1.001)
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    i00 = image[y0, x0]
    i01 = image[y0, x0 + 1]
    i10 = image[y0 + 1, x0]
    i11 = image[y0 + 1, x0 + 1]
    return (
        i00 * (1 - fy) * (1 - fx)
        + i01 * (1 - fy) * fx
        + i10 * fy * (1 - fx)
        + i11 * fy * fx
    )


class StereoRectifier:
    """Precomputed left/right rectification maps, applied per frame on
    `device`."""

    def __init__(self, left: dict, right: dict, size_wh: tuple[int, int], device):
        """left/right: dicts with K (3,3), D (n,), R (3,3), P (3,4)."""
        self.device = torch.device(device)
        self.map_l, self.map_r = (
            torch.from_numpy(
                init_undistort_rectify_map(side["K"], side["D"], side["R"], side["P"], size_wh)
            ).to(self.device)
            for side in (left, right)
        )

    def __call__(self, left_img, right_img):
        def on_device(img):
            return torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(self.device)

        return (
            remap_bilinear(on_device(left_img), self.map_l),
            remap_bilinear(on_device(right_img), self.map_r),
        )
