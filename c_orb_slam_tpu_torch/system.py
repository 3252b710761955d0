"""Public API facade — the equivalent of ORB_SLAM2::System.

Counterpart of c_orb_slam_tpu/system.py (reference: src/System.cc —
TrackRGBD :116-280, Reset :295, Shutdown :301, trajectory savers
:322-472). One host loop, no threads: LocalMapping runs as stages after
keyframe insertion. Every tensor lives on the ``device`` given to the
constructor.

Ported: monocular, stereo and RGB-D tracking with relocalization, loop
closing (BoW place recognition, Sim3 alignment, staged correction,
essential graph, background global BA), localization mode
(System.cc:127-145), and map checkpoints (io/checkpoint.py) with
``System.from_saved_map``. ``mesh`` (parallel/mesh.py, in process; default:
every visible device of the device's type, one shard on a CPU) routes the
full-bucket local BA, the essential graph and the global BA to the
sharded solvers of parallel/ when it has more than one shard.
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
from c_orb_slam_tpu_torch.io import checkpoint, trajectory as traj_io
from c_orb_slam_tpu_torch.loop_closing import LoopClosing
from c_orb_slam_tpu_torch.mapping import LocalMapping
from c_orb_slam_tpu_torch.ops import window_top2
from c_orb_slam_tpu_torch.parallel.mesh import Mesh, make_mesh
from c_orb_slam_tpu_torch.slam_map.mapstate import MapState
from c_orb_slam_tpu_torch.tracking import Tracking, TrackState
from c_orb_slam_tpu_torch.utils.host import fetch
from c_orb_slam_tpu_torch.utils.metrics import Metrics


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    """A numpy array or a tensor on any device -> a tensor on `device`."""
    return (a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))).to(device)


def _to_gray_f32(image, device: torch.device) -> torch.Tensor:
    img = _as_tensor(image, device)
    if img.dim() == 3:  # (H, W, 3) -> grayscale (Rec.601 like cvtColor)
        img = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return img.to(torch.float32)


def warm_linalg(device: torch.device):
    """One small batched call of each dense solver kind, at each dtype and
    shape family the solvers use: eigh of 12x12 (PnP DLT, float32), 4x4
    (two-view triangulation, float32; Horn's Sim3, float64) and 9x9
    (two-view null vectors, float64); 3x3 svd, det and inverse; the 6x6 /
    7x7 solves and inverses of the pose, Sim3 and pose-graph steps; a
    Cholesky factor and solve (local BA)."""
    g = torch.Generator(device="cpu").manual_seed(0)
    for batch in (1, 64):
        def spd(n, dtype):
            a = torch.randn(batch, n, n, generator=g, dtype=dtype)
            return (a @ a.transpose(-1, -2) + n * torch.eye(n, dtype=dtype)).to(device)

        for n, dtype in ((12, torch.float32), (4, torch.float32), (9, torch.float64),
                         (4, torch.float64)):
            torch.linalg.eigh(spd(n, dtype))
        for dtype in (torch.float32, torch.float64):
            m3 = spd(3, dtype)
            torch.linalg.svd(m3)
            torch.linalg.det(m3)
            torch.linalg.inv_ex(m3)
        for n in (6, 7):
            m = spd(n, torch.float32)
            torch.linalg.solve_ex(m, m[..., :1])
            torch.linalg.solve(m, m[..., 0])
            torch.linalg.inv(m)
        m = spd(96, torch.float32)
        torch.cholesky_solve(m[..., :1], torch.linalg.cholesky_ex(m)[0])
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class System:
    def __init__(self, cfg: SlamConfig, device, enable_loop_closing: bool = True,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        # The mesh is decided here only. In process whatever the state of
        # torch.distributed: a process-group mesh would have each rank's
        # mapper and loop closer call collectives on its own schedule.
        self.mesh = (mesh if mesh is not None
                     else make_mesh(device_type=self.device.type, group=False))
        if self.mesh.group:
            raise ValueError(f"System runs on an in-process mesh, not {self.mesh}")
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
        self.localization_only = False

    def _build_pipeline(self, map_state: MapState, vocabulary):
        """Construct tracker, mapper and loop closer over `map_state` and
        wire their cross-references (shared by __init__, reset() and
        from_saved_map(), so no path can drop the wiring of
        System.cc:106-113)."""
        self.map = map_state
        self.tracker = Tracking(self.cfg, self.map, self.device)
        self.local_mapping = LocalMapping(self.cfg, self.map, self.device, self.mesh)
        self.loop_closing = (
            LoopClosing(self.cfg, self.map, self.device, self.mesh, vocabulary)
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
                _as_tensor(depth, self.device).to(torch.float32),
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
        if not self.localization_only:
            self._map_step(new_kfs)
        elif self.loop_closing is not None and (
            self.loop_closing.sim3_job is not None
            or self.loop_closing.correction_job is not None
            or self.loop_closing.gba_job is not None
        ):
            # Localization mode stops mapping and new loop detection, but
            # a Sim3, correction or global-BA job already in flight at the
            # switch still advances (the reference keeps its LoopClosing
            # thread running, System.cc:127-135): it mutates the map only.
            with self.metrics.stage("loop_stage"):
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

    def _map_step(self, new_kfs: list):
        """Route new keyframes and run one mapping and loop slice."""
        if new_kfs:
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
        """Reference: System::ActivateLocalizationMode (System.cc:127-135):
        mapping stops; tracking goes on against the frozen map."""
        self.localization_only = True
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        self.localization_only = False
        self.tracker.only_tracking = False

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
        """Pay the process's first-call costs at start-up, not
        mid-sequence (JAX system.py:279-286): the local-BA solve at both
        problem sizes, through the routing point the live path uses (so a
        mesh of more than one shard warms the sharded route), the dense
        solvers behind two-view initialization, PnP and Sim3 RANSAC and
        the GN steps (cuSOLVER's handles and kernels on a card), and on a
        card the window_top2 kernel's library (built with nvcc at first
        use)."""
        self.local_mapping.warm_programs()
        warm_linalg(self.device)
        if self.device.type == "cuda":
            window_top2.empty_launch(self.device)
            torch.cuda.synchronize(self.device)

    def map_changed(self) -> bool:
        """Reference: System::MapChanged (System.cc:282-293)."""
        idx = self.map.big_change_idx
        changed = self._last_big_change < idx
        self._last_big_change = idx
        return changed

    # ------------------------------------------------------------------
    def tracking_state(self) -> int:
        return self.tracker.state

    def tracked_map_points(self) -> np.ndarray:
        """(M, 3) world positions of the map points matched in the most
        recent frame (reference: System::GetTrackedMapPoints,
        System.cc:295; positions here, where the reference hands out
        pointers)."""
        self.tracker.flush_pending()
        mp = self.tracker.last_mp
        if mp is None:
            return np.zeros((0, 3), np.float32)
        ids = mp[mp >= 0]
        return self.map.pt_xyz[ids[self.map.pt_valid[ids]]].copy()

    def tracked_keypoints(self) -> np.ndarray:
        """(N, 2) undistorted keypoints of the most recent frame
        (reference: System::GetTrackedKeyPointsUn, System.cc:300)."""
        self.tracker.flush_pending()
        f = self.tracker.last_frame
        if f is None:
            return np.zeros((0, 2), np.float32)
        xy, valid = fetch(f.xy, f.valid)
        return xy[valid]

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
        """Write the map and the vocabulary to one npz (the reference's
        SaveMap TODO, System.h:115-117), after draining every pipeline so
        the snapshot is fully processed. The JAX package loads it too."""
        self._drain_all()
        checkpoint.save_map(path, self.map, self.loop_closing.voc if self.loop_closing else None)

    @classmethod
    def from_saved_map(cls, path: str, cfg: SlamConfig, device,
                       localization_only: bool = True,
                       enable_loop_closing: bool = True,
                       mesh: Optional[Mesh] = None) -> "System":
        """Start from a stored map (either package's npz): the first frame
        relocalizes into it, then tracking goes on, in localization mode
        unless asked otherwise. The file's vocabulary wins over the one
        the constructor loaded; its keyframes are indexed for BoW
        relocalization. With loop closing off the candidates are the 10
        newest keyframes."""
        sysm = cls(cfg, device, enable_loop_closing=enable_loop_closing, mesh=mesh)
        m, voc = checkpoint.load_map(path, cfg, sysm.device)
        if sysm.loop_closing is not None and voc is None:
            voc = sysm.loop_closing.voc
        sysm._build_pipeline(m, voc)
        live = m.live_keyframes()
        if sysm.loop_closing is not None and voc is not None:
            for k in live:
                sysm.loop_closing._index_keyframe(int(k))
        sysm.tracker.ref_kf = int(live[np.argmax(m.kf_serial[live])]) if len(live) else -1
        sysm.tracker.state = TrackState.LOST  # relocalize on the first frame
        if localization_only:
            sysm.activate_localization_mode()
        return sysm

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
