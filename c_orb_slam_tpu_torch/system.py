"""Public API facade — the equivalent of ORB_SLAM2::System.

Counterpart of c_orb_slam_tpu/system.py (reference: src/System.cc —
TrackRGBD :116-280, Reset :295, Shutdown :301, trajectory savers
:322-472). One host loop, no threads: LocalMapping runs as stages after
keyframe insertion. Every tensor lives on the ``device`` given to the
constructor.

Ported: monocular, stereo and RGB-D tracking (with relocalization) with
loop closing off. Loop closing (with its vocabulary), localization mode
and map checkpoints raise NotImplementedError naming their ROADMAP.md
item.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from c_orb_slam_tpu_torch.config import SlamConfig, Sensor
from c_orb_slam_tpu_torch.frontend import frame as frame_mod
from c_orb_slam_tpu_torch.io import trajectory as traj_io
from c_orb_slam_tpu_torch.mapping import LocalMapping
from c_orb_slam_tpu_torch.slam_map.mapstate import MapState
from c_orb_slam_tpu_torch.tracking import Tracking, TrackState
from c_orb_slam_tpu_torch.utils.metrics import Metrics


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} not ported yet (ROADMAP.md queue 1: {item})")


def _to_gray_f32(image, device: torch.device) -> torch.Tensor:
    img = torch.as_tensor(np.asarray(image)).to(device)
    if img.dim() == 3:  # (H, W, 3) -> grayscale (Rec.601 like cvtColor)
        img = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return img.to(torch.float32)


class System:
    def __init__(self, cfg: SlamConfig, device, enable_loop_closing: bool = True):
        if enable_loop_closing:
            _not_ported("loop closing", "loop path")
        self.cfg = cfg
        self.device = torch.device(device)
        self.metrics = Metrics()
        self._build_pipeline(MapState(cfg, compute_device=self.device))

    def _build_pipeline(self, map_state: MapState):
        """Construct tracker and mapper over `map_state` and wire them
        (shared by __init__ and reset())."""
        self.map = map_state
        self.tracker = Tracking(self.cfg, self.map, self.device)
        self.local_mapping = LocalMapping(self.cfg, self.map, self.device)
        self.tracker.mapper = self.local_mapping
        self.local_mapping.metrics = self.metrics

    # ------------------------------------------------------------------
    def _check_sensor(self, sensor: int, call: str):
        if self.cfg.sensor != sensor:
            raise ValueError(f"{call} needs cfg.sensor == {sensor}, not {self.cfg.sensor}")

    def track_monocular(self, image, timestamp: float) -> Optional[np.ndarray]:
        self._check_sensor(Sensor.MONOCULAR, "track_monocular")
        with self.metrics.stage("frame_build"):
            f = frame_mod.build_mono(_to_gray_f32(image, self.device), self.cfg)
        return self._track(f, timestamp)

    def track_stereo(self, left, right, timestamp: float) -> Optional[np.ndarray]:
        """Rectified stereo pair (reference: System::TrackStereo)."""
        self._check_sensor(Sensor.STEREO, "track_stereo")
        with self.metrics.stage("frame_build"):
            f = frame_mod.build_stereo(
                _to_gray_f32(left, self.device), _to_gray_f32(right, self.device), self.cfg
            )
        return self._track(f, timestamp)

    def track_rgbd(self, image, depth, timestamp: float) -> Optional[np.ndarray]:
        self._check_sensor(Sensor.RGBD, "track_rgbd")
        with self.metrics.stage("frame_build"):
            f = frame_mod.build_rgbd(
                _to_gray_f32(image, self.device),
                torch.as_tensor(np.asarray(depth, np.float32)).to(self.device),
                self.cfg,
            )
        return self._track(f, timestamp)

    def _track(self, f, timestamp: float) -> Optional[np.ndarray]:
        t0 = time.perf_counter()
        self.tracker.current_timestamp = timestamp
        with self.metrics.stage("tracking"):
            pose = self.tracker.track(f)
        if self.tracker.request_reset:
            # Lost with <=5 keyframes: restart from scratch
            # (reference: Tracking.cc:472-479).
            self.metrics.count("auto_resets")
            self.reset()
            return None
        new_kfs = self.map.added_kfs
        self.map.added_kfs = []
        made_kf = bool(new_kfs)
        if made_kf:
            self.metrics.count("keyframes_created", len(new_kfs))
            for k in new_kfs:
                # Initialization keyframes skip mapping (as the reference's
                # mapper does).
                if self.map.n_added_keyframes > 2:
                    self.local_mapping.insert_keyframe(k)
        # Thin tracking margin while the mapper is behind: drain it this
        # frame so new points land before the view moves on; otherwise one
        # budgeted mapping slice per tracked frame.
        thin = (
            self.tracker.state == TrackState.OK
            and self.tracker.current_inliers < 2 * self.cfg.tracking.min_inliers_local_map
            and self.local_mapping.queue_len() > 0
        )
        if thin:
            with self.metrics.stage("mapping_catchup"):
                self.local_mapping.drain()
        else:
            with self.metrics.stage("mapping_stage"):
                self.local_mapping.step()
        self.metrics.end_frame(
            frame_id=self.tracker.frame_id,
            timestamp=timestamp,
            state=self.tracker.state,
            n_inliers=self.tracker.current_inliers,
            n_keyframes=len(self.map.live_keyframes()),
            n_points=int(self.map.pt_valid.sum()),
            is_keyframe=made_kf,
            total_ms=(time.perf_counter() - t0) * 1000.0,
        )
        return pose

    # ------------------------------------------------------------------
    def activate_localization_mode(self):
        _not_ported("localization mode", "product surface")

    def reset(self):
        """Reference: System::Reset -> Tracking::Reset (Tracking.cc:1504)."""
        self._build_pipeline(MapState(self.cfg, compute_device=self.device))
        self.metrics.reset()

    def shutdown(self):
        """Drain the tracking and mapping pipelines (System.cc:301-320)."""
        self.tracker.flush_pending()
        self.local_mapping.drain()

    def warmup(self):
        """Run the local-BA solve once at both problem sizes, so their
        first-call costs land at start-up, not mid-sequence."""
        self.local_mapping.warm_programs()

    # ------------------------------------------------------------------
    def tracking_state(self) -> int:
        return self.tracker.state

    def frame_poses(self) -> tuple[np.ndarray, list]:
        """(F, 3, 4) per-frame Tcw for tracked frames, with timestamps,
        rebuilt as T_cr · T_rw from each frame's reference keyframe's
        current pose (reference: System.cc:345-380)."""
        self.tracker.flush_pending()
        poses, stamps = [], []
        for fid, T_cr, ref, state, t in self.tracker.trajectory:
            if state != TrackState.OK:
                continue
            if ref >= 0:
                T_rw = self.map.recover_pose(ref)
                if T_rw is None:
                    continue
                pose = (
                    np.vstack([T_cr, [0, 0, 0, 1.0]])[:3] @ np.vstack([T_rw, [0, 0, 0, 1.0]])
                ).astype(np.float32)
            else:
                pose = T_cr
            poses.append(pose)
            stamps.append(t)
        return np.asarray(poses), stamps

    def keyframe_poses(self) -> np.ndarray:
        return self.map.kf_pose[self.map.live_keyframes()]

    def save_map(self, path: str):
        _not_ported("map checkpoints", "product surface")

    def save_trajectory_tum(self, path: str):
        poses, stamps = self.frame_poses()
        traj_io.save_tum(path, stamps, poses)

    def save_trajectory_kitti(self, path: str):
        poses, _ = self.frame_poses()
        traj_io.save_kitti(path, poses)

    def save_keyframe_trajectory_tum(self, path: str):
        """Keyframes in temporal order with their dataset timestamps
        (reference: System::SaveKeyFrameTrajectoryTUM, System.cc:383-417)."""
        live = self.map.live_keyframes()
        live = live[np.argsort(self.map.kf_serial[live])]
        stamps = [float(self.map.kf_timestamp[k]) for k in live]
        traj_io.save_tum(path, stamps, self.map.kf_pose[live])
