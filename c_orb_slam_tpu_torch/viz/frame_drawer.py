"""Annotated camera frame: the FrameDrawer equivalent.

Reference: src/FrameDrawer.cc — DrawFrame (:38) paints the current image
with tracked keypoints (green squares for map-point matches, blue for
visual-odometry points, FrameDrawer.cc:91-123), initialization match lines
(:77-88), and a status text bar (DrawTextInfo :129-165 shows mode, #KFs,
#MPs, #matches).

Counterpart of c_orb_slam_tpu/viz/frame_drawer.py: host-side numpy
rendering (PIL for the status text, where installed), no OpenCV or
Pangolin; the frame's keypoints are fetched from the device.
"""

from __future__ import annotations

import numpy as np

from c_orb_slam_tpu_torch.tracking import TrackState
from c_orb_slam_tpu_torch.utils.host import fetch

GREEN = (60, 220, 60)
BLUE = (80, 120, 255)
ORANGE = (255, 160, 40)


def _to_rgb_u8(image) -> np.ndarray:
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img.copy()


def _draw_squares(img: np.ndarray, xy: np.ndarray, color, r: int = 3):
    """Hollow squares at integer centers (vectorized numpy scatter)."""
    h, w = img.shape[:2]
    if len(xy) == 0:
        return
    cx = np.round(xy[:, 0]).astype(np.int64)
    cy = np.round(xy[:, 1]).astype(np.int64)
    keep = (cx >= r) & (cx < w - r) & (cy >= r) & (cy < h - r)
    cx, cy = cx[keep], cy[keep]
    col = np.asarray(color, np.uint8)
    span = np.arange(-r, r + 1)
    # Top/bottom edges.
    for dy in (-r, r):
        img[cy[:, None] + dy, cx[:, None] + span[None, :]] = col
    # Left/right edges.
    for dx in (-r, r):
        img[cy[:, None] + span[None, :], cx[:, None] + dx] = col


def _draw_lines(img: np.ndarray, xy0: np.ndarray, xy1: np.ndarray, color):
    """Polyline segments via dense sampling (init-match visualization)."""
    if len(xy0) == 0:
        return
    h, w = img.shape[:2]
    t = np.linspace(0.0, 1.0, 32)[None, :, None]
    pts = xy0[:, None, :] * (1 - t) + xy1[:, None, :] * t  # (N, 32, 2)
    px = np.clip(np.round(pts[..., 0]).astype(np.int64), 0, w - 1)
    py = np.clip(np.round(pts[..., 1]).astype(np.int64), 0, h - 1)
    img[py.ravel(), px.ravel()] = np.asarray(color, np.uint8)


class FrameDrawer:
    """Accumulates per-frame tracker state and renders annotated frames
    (reference: FrameDrawer::Update pulls from Tracking, FrameDrawer.cc:167)."""

    def __init__(self, system):
        self.system = system
        self._image = None
        self._xy = np.zeros((0, 2), np.float32)
        self._matched = np.zeros((0,), bool)
        self._vo = np.zeros((0,), bool)

    def update(self, image, frame_xy=None, cur_mp=None):
        """Record the latest frame. frame_xy: (N, 2) keypoints; cur_mp:
        (N,) map-point index per keypoint or -1."""
        self._image = _to_rgb_u8(image)
        tracker = self.system.tracker
        if frame_xy is None and tracker.last_frame is not None:
            frame_xy = fetch(tracker.last_frame.xy)
        if cur_mp is None and tracker.last_mp is not None:
            cur_mp = tracker.last_mp
        if frame_xy is not None and cur_mp is not None:
            n = min(len(frame_xy), len(cur_mp))
            self._xy = np.asarray(frame_xy)[:n]
            mp = np.asarray(cur_mp)[:n]
            matched = mp >= 0
            obs = np.zeros(n, np.int64)
            valid = matched & self.system.map.pt_valid[np.maximum(mp, 0)]
            obs[valid] = self.system.map.pt_n_obs[mp[valid]]
            self._matched = matched & (obs > 0)
            self._vo = matched & (obs == 0)  # VO/temporal points

    def draw_frame(self) -> np.ndarray:
        """(H, Wtext+H?, 3) uint8 annotated frame + status bar
        (reference: FrameDrawer::DrawFrame + DrawTextInfo)."""
        if self._image is None:
            return np.zeros((32, 32, 3), np.uint8)
        img = self._image.copy()
        _draw_squares(img, self._xy[self._matched], GREEN)
        _draw_squares(img, self._xy[self._vo], BLUE)
        bar = self._status_bar(img.shape[1])
        return np.concatenate([img, bar], axis=0)

    def _status_bar(self, width: int) -> np.ndarray:
        state = self.system.tracker.state
        n_kf = len(self.system.map.live_keyframes())
        n_mp = int(self.system.map.pt_valid.sum())
        n_m = int(self._matched.sum())
        mode = {
            TrackState.NOT_INITIALIZED: "NOT INITIALIZED",
            TrackState.OK: (
                "LOCALIZATION" if self.system.localization_only else "SLAM"
            ),
            TrackState.LOST: "LOST",
        }.get(state, "?")
        text = f"{mode} | KFs: {n_kf} | MPs: {n_mp} | matches: {n_m}"
        bar = np.zeros((22, width, 3), np.uint8)
        try:
            from PIL import Image, ImageDraw

            im = Image.fromarray(bar)
            ImageDraw.Draw(im).text((4, 4), text, fill=(255, 255, 255))
            bar = np.asarray(im)
        except ImportError:
            pass  # text is cosmetic; the bar stays blank without PIL
        return bar
