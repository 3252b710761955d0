"""Public API facade — the equivalent of ORB_SLAM2::System.

Counterpart of c_orb_slam_tpu/system.py (reference: src/System.cc —
TrackRGBD :116-280, Reset :295, Shutdown :301, trajectory savers
:322-472). One host loop, no threads: LocalMapping runs as stages after
keyframe insertion. Every tensor lives on the ``device`` given to the
constructor.

Ported: monocular, stereo and RGB-D tracking with relocalization, and
loop closing (BoW place recognition, Sim3 alignment, staged correction,
essential graph, background global BA) on one device. Localization mode
and map checkpoints raise NotImplementedError naming their ROADMAP.md
item.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from c_orb_slam_tpu_torch.bow import vocab as vocab_mod
from c_orb_slam_tpu_torch.config import SlamConfig, Sensor
from c_orb_slam_tpu_torch.frontend import frame as frame_mod
from c_orb_slam_tpu_torch.geometry import np_se3
from c_orb_slam_tpu_torch.io import trajectory as traj_io
from c_orb_slam_tpu_torch.loop_closing import LoopClosing
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
        self.cfg = cfg
        self.device = torch.device(device)
        self._enable_loop_closing = enable_loop_closing
        self.metrics = Metrics()
        self._last_big_change = -1
        vocabulary = None
        if enable_loop_closing:
            # Default: the shipped pretrained artifact (the analog of the
            # reference's ORBvoc.txt load, System.cc:64). Set
            # vocabulary.path="online" to train from the run's first
            # keyframes instead.
            path = cfg.vocabulary.path or vocab_mod.builtin_vocabulary_path()
            if path and path != "online":
                if path.endswith(".txt"):
                    vocabulary = vocab_mod.load_dbow2_text(path, device=self.device)
                else:
                    vocabulary = vocab_mod.load(path, device=self.device)
        self._build_pipeline(MapState(cfg, compute_device=self.device), vocabulary)

    def _build_pipeline(self, map_state: MapState, vocabulary):
        """Construct tracker, mapper and loop closer over `map_state` and
        wire their cross-references (shared by __init__ and reset(), so
        no path can drop the wiring of System.cc:106-113)."""
        self.map = map_state
        self.tracker = Tracking(self.cfg, self.map, self.device)
        self.local_mapping = LocalMapping(self.cfg, self.map, self.device)
        self.loop_closing = (
            LoopClosing(self.cfg, self.map, self.device, vocabulary)
            if self._enable_loop_closing
            else None
        )
        if self.loop_closing is not None:
            self.loop_closing.on_pose_correction = self._on_loop_correction
            self.loop_closing.on_before_correction = self.tracker.flush_pending
            self.loop_closing.mapper = self.local_mapping
            self.tracker.reloc_provider = self.loop_closing
        self.tracker.mapper = self.local_mapping
        self.local_mapping.on_keyframe_done = self._on_mapping_done
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
                if self.map.n_added_keyframes > 2:
                    # Regular keyframe: enqueue for the mapping pipeline;
                    # LoopClosing is fed on completion.
                    self.local_mapping.insert_keyframe(k)
                elif self.loop_closing is not None:
                    # Initialization keyframes skip mapping (as the
                    # reference's mapper does): index them for place
                    # recognition directly.
                    self.loop_closing.process_keyframe(k)
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
        if self.loop_closing is not None:
            with self.metrics.stage("loop_stage"):
                self.loop_closing.step()
                # One chunk of background work (Sim3 stage, correction
                # chunk or global-BA step) per frame.
                self.loop_closing.advance_background()
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

    def _on_mapping_done(self, kf: int):
        if self.loop_closing is not None:
            self.loop_closing.process_keyframe(kf)

    def _on_loop_correction(self, kf: int, T_old: np.ndarray, T_new: np.ndarray):
        """Re-anchor the tracker after a loop correction moved the map
        (the reference's Tracking reads corrected poses through shared
        memory; here the host hands the correction over explicitly)."""
        # In-flight pipelined frames were already drained by the
        # on_before_correction hook (fired before any map mutation); any
        # frame dispatched since would be a bug, so drain defensively.
        self.tracker.flush_pending()
        # T_corr = T_new ∘ T_old^-1 (both world->cam).
        if self.tracker.last_pose is not None:
            T_corr = np_se3.compose(T_new, np_se3.inverse(T_old))
            self.tracker.last_pose = np_se3.compose(
                T_corr, self.tracker.last_pose
            ).astype(np.float32)
        # The device pose chain predates the correction: break it so the
        # next dispatch re-seeds from the corrected host pose.
        self.tracker._chain = None

    # ------------------------------------------------------------------
    def activate_localization_mode(self):
        _not_ported("localization mode", "product surface")

    def reset(self):
        """Reference: System::Reset -> Tracking::Reset (Tracking.cc:1504)."""
        voc = self.loop_closing.voc if self.loop_closing else None
        self._build_pipeline(MapState(self.cfg, compute_device=self.device), voc)
        self.metrics.reset()

    def shutdown(self):
        """Drain the tracking, mapping and loop pipelines (the reference
        joins its threads incl. the GBA wait, System.cc:301-320)."""
        self._drain_all()

    def _drain_all(self):
        """Settle every pipeline: the loop closer first (an in-flight
        staged correction holds the mapper paused), then mapping (whose
        finished keyframes may arm a NEW loop event), iterating to a
        fixed point."""
        self.tracker.flush_pending()
        for _ in range(8):
            if self.loop_closing is not None:
                self.loop_closing.drain()
            self.local_mapping.drain()
            if self.local_mapping.queue_len() == 0 and (
                self.loop_closing is None or self.loop_closing.idle()
            ):
                break

    def warmup(self):
        """Run the local-BA solve once at both problem sizes, so their
        first-call costs land at start-up, not mid-sequence."""
        self.local_mapping.warm_programs()

    def map_changed(self) -> bool:
        """Reference: System::MapChanged (System.cc:282-293)."""
        idx = self.map.big_change_idx
        changed = self._last_big_change < idx
        self._last_big_change = idx
        return changed

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
