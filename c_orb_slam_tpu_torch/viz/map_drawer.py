"""3D map / graph / camera rendering: the MapDrawer equivalent.

Reference: src/MapDrawer.cc — DrawMapPoints (:44, black points + red
reference points), DrawKeyFrames (:83, blue frusta + green covisibility
graph + spanning tree + loop edges), DrawCurrentCamera (:179, green
frustum). Counterpart of c_orb_slam_tpu/viz/map_drawer.py: rendered with
matplotlib (Agg) instead of Pangolin GL, from the host map; figures go to
PNG/HTML reports.
"""

from __future__ import annotations

import numpy as np


def _camera_center(T: np.ndarray) -> np.ndarray:
    return -T[:, :3].T @ T[:, 3]


def _frustum_segments(T: np.ndarray, size: float):
    """Line segments of a camera frustum glyph for pose Tcw (world coords),
    mirroring the reference's KF glyph (MapDrawer.cc:92-131)."""
    w, h, z = size, size * 0.75, size * 0.6
    pts_c = np.array(
        [[0, 0, 0], [w, h, z], [w, -h, z], [-w, -h, z], [-w, h, z]],
        np.float32,
    )
    R = T[:, :3]
    pts_w = (pts_c - T[:, 3]) @ R  # R^T (p - t)
    o, a, b, c, d = pts_w
    return [
        (o, a), (o, b), (o, c), (o, d),
        (a, b), (b, c), (c, d), (d, a),
    ]


class MapDrawer:
    """Matplotlib renderer for the map state (top-down XZ by default —
    the informative projection for forward-moving cameras — or 3D)."""

    def __init__(self, system, kf_size: float = 0.05):
        self.system = system
        self.kf_size = kf_size
        self.show_points = True
        self.show_keyframes = True
        self.show_graph = True
        self.covis_min_weight = 100  # reference draws >=100 edges (MapDrawer.cc:140)

    def draw(self, ax=None, mode: str = "xz", current_pose=None):
        """Render onto a matplotlib axis (created if None). Returns the
        figure. mode: 'xz' top-down or '3d'."""
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        m = self.system.map
        if ax is None:
            if mode == "3d":
                fig = plt.figure(figsize=(7, 7))
                ax = fig.add_subplot(111, projection="3d")
            else:
                fig, ax = plt.subplots(figsize=(7, 7))
        else:
            fig = ax.figure

        def plot_pts(x, y, z, **kw):
            if mode == "3d":
                ax.scatter(x, z, y, **kw)
            else:
                ax.scatter(x, z, **kw)

        def plot_seg(p, q, **kw):
            if mode == "3d":
                ax.plot([p[0], q[0]], [p[2], q[2]], [p[1], q[1]], **kw)
            else:
                ax.plot([p[0], q[0]], [p[2], q[2]], **kw)

        if self.show_points:
            pts = m.pt_xyz[m.pt_valid]
            if len(pts):
                plot_pts(pts[:, 0], pts[:, 1], pts[:, 2], s=1, c="k", alpha=0.4)

        live = m.live_keyframes()
        if self.show_keyframes:
            for k in live:
                for p, q in _frustum_segments(m.kf_pose[k], self.kf_size):
                    plot_seg(p, q, c="tab:blue", lw=0.5)
        if self.show_graph and len(live) > 1:
            centers = {int(k): _camera_center(m.kf_pose[k]) for k in live}
            # Covisibility edges (weight >= threshold) + spanning tree.
            for k in live:
                for k2 in live:
                    if k2 > k and m.covis[k, k2] >= self.covis_min_weight:
                        plot_seg(centers[int(k)], centers[int(k2)],
                                 c="tab:green", lw=0.4, alpha=0.6)
                parent = m.spanning_parent[k]
                if parent >= 0 and int(parent) in centers:
                    plot_seg(centers[int(k)], centers[int(parent)],
                             c="tab:green", lw=0.6)
            for ki, kj in m.loop_edges:
                if int(ki) in centers and int(kj) in centers:
                    plot_seg(centers[int(ki)], centers[int(kj)],
                             c="tab:red", lw=1.2)

        if current_pose is not None:
            for p, q in _frustum_segments(
                np.asarray(current_pose), self.kf_size * 1.5
            ):
                plot_seg(p, q, c="tab:green", lw=1.5)

        ax.set_xlabel("x")
        ax.set_ylabel("z" if mode != "3d" else "z")
        if mode != "3d":
            ax.set_aspect("equal", adjustable="datalim")
        return fig

    def save(self, path: str, **kw):
        import matplotlib.pyplot as plt

        fig = self.draw(**kw)
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
