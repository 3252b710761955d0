"""Frozen numpy copy of the test suite's ``render_scene`` (the loop over
blobs, far to near), taking the micro-texture tiles as an argument where
the original draws them from a fixed generator. The tests hold the torch
renderer (``render.py``) to it; the benchmark's runs do not use it."""

from __future__ import annotations

import numpy as np


def render_scene(xw, intensity, world_size, tiles, T, K4, h=480, w=640, bg=128.0):
    ss = 2
    fx, fy, cx, cy = K4
    xc = xw @ T[:, :3].T + T[:, 3]
    z = xc[:, 2]
    vis = z > 1.2
    u = ss * (fx * xc[:, 0] / np.maximum(z, 1e-6) + cx)
    v = ss * (fy * xc[:, 1] / np.maximum(z, 1e-6) + cy)
    r = np.clip(ss * world_size * fx / np.maximum(z, 1e-6), ss, ss * 80)
    H, W = h * ss, w * ss
    img = np.full((H, W), bg, dtype=np.float32)
    order = np.argsort(-z, kind="stable")
    P = tiles.shape[-1]
    for i in order:
        if not vis[i]:
            continue
        ri = int(round(r[i]))
        yc, xc_ = int(round(v[i])), int(round(u[i]))
        y0, y1 = yc - ri, yc + ri
        x0, x1 = xc_ - ri, xc_ + ri
        if y1 < 0 or x1 < 0 or y0 >= H or x0 >= W:
            continue
        cy0, cy1 = max(y0, 0), min(max(y1, 0), H)
        cx0, cx1 = max(x0, 0), min(max(x1, 0), W)
        if cy1 <= cy0 or cx1 <= cx0:
            continue
        side = 2 * ri
        ty = (np.arange(cy0, cy1) - y0) * P // side
        tx = (np.arange(cx0, cx1) - x0) * P // side
        patch = tiles[i][np.clip(ty, 0, P - 1)[:, None], np.clip(tx, 0, P - 1)[None, :]]
        img[cy0:cy1, cx0:cx1] = np.clip(intensity[i] * patch, 0, 255)
    return img.reshape(h, ss, w, ss).mean(axis=(1, 3))
