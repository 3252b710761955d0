"""Per-frame tracking: the SLAM front state machine.

Counterpart of c_orb_slam_tpu/tracking.py (reference: src/Tracking.cc —
Track() :267-506, motion model :867, reference keyframe :757, local map
:930, keyframe decision :977). A host state machine (numpy bookkeeping)
dispatching device steps written as plain tensor code: frustum culling,
projection matching on the window_top2 kernel, motion-only Gauss-Newton.

Ported: monocular (two-view RANSAC + initial BA) and depth-initialised
(stereo/RGB-D) tracking, the pipelined fused step, relocalization (PnP
RANSAC against BoW and recent keyframes), and localization mode with
visual-odometry points (reference: Tracking.cc:283-361, 801-865).
"""

from __future__ import annotations

import collections
import contextlib
from typing import Optional

import numpy as np
import torch

from c_orb_slam_tpu_torch.config import SlamConfig, Sensor
from c_orb_slam_tpu_torch.frontend import frame as frame_mod
from c_orb_slam_tpu_torch.geometry import camera, np_se3, se3, so3
from c_orb_slam_tpu_torch.ops import match, pnp, twoview
from c_orb_slam_tpu_torch.optim import ba as ba_mod, pose_opt
from c_orb_slam_tpu_torch.slam_map.mapstate import MapState
from c_orb_slam_tpu_torch.utils.host import fetch, fetch_async, to_device
from c_orb_slam_tpu_torch.utils.metrics import Metrics, no_span


class TrackState:
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


def frustum_check(T, xyz, normal, min_dist, max_dist, pt_valid, K,
                  img_w: int, img_h: int, log_scale: float, n_levels: int,
                  view_cos_limit: float = 0.5):
    """Batched Frame::isInFrustum (reference: src/Frame.cc:269-325);
    T (..., 3, 4) against points (..., N, .).
    Returns (in_view, uv, predicted_octave int32, view_cos)."""
    xc = se3.apply(T, xyz)
    z = xc[..., 2]
    uv = camera.project(xc, K)
    in_img = (uv[..., 0] >= 0) & (uv[..., 0] < img_w) & (uv[..., 1] >= 0) & (uv[..., 1] < img_h)
    center = se3.translation(se3.inverse(T)).unsqueeze(-2)
    po = xyz - center
    dist = torch.linalg.vector_norm(po, dim=-1)
    range_ok = (dist >= 0.8 * min_dist) & (dist <= 1.2 * max_dist)
    view_cos = (po * normal).sum(-1) / torch.clamp(dist, min=1e-12)
    # Predicted octave (reference: MapPoint::PredictScale, MapPoint.cc:385).
    ratio = torch.clamp(max_dist, min=1e-12) / torch.clamp(dist, min=1e-12)
    octave = torch.ceil(torch.log(ratio) / log_scale).to(torch.int32)
    octave = torch.clamp(octave, 0, n_levels - 1)
    in_view = pt_valid & (z > 0) & in_img & range_ok & (view_cos > view_cos_limit)
    return in_view, uv, octave, view_cos


def _frustum(cfg: SlamConfig, T, xyz, normal, mind, maxd, valid, K):
    return frustum_check(
        T, xyz, normal, mind, maxd, valid, K,
        img_w=cfg.camera.width, img_h=cfg.camera.height,
        log_scale=float(np.log(cfg.orb.scale_factor)), n_levels=cfg.orb.n_levels,
    )


def _optimize(cfg: SlamConfig, T0, xyz, obs, inv_s2, is_stereo, valid, K):
    return pose_opt.optimize_pose(
        T0, xyz, obs, inv_s2, is_stereo, valid, K, float(cfg.camera.bf),
        rounds=cfg.optimizer.pose_opt_rounds, iters=cfg.optimizer.pose_opt_its,
        chi2_mono=cfg.optimizer.chi2_mono, chi2_stereo=cfg.optimizer.chi2_stereo,
    )


def _pose_opt_over_queries(cfg: SlamConfig, T0, q_xyz, m, f, inv_sigma2_levels, K):
    """Motion-only GN where each row is a matched map point (query):
    observation = the frame keypoint the query matched."""
    mi = m.idx.long()
    ur = f.ur[mi]
    is_stereo = (ur > 0) & m.valid
    obs = torch.cat([f.xy[mi], torch.where(is_stereo, ur, 0.0)[:, None]], dim=1)
    inv_s2 = inv_sigma2_levels[f.octave[mi].long()]
    return _optimize(cfg, T0, q_xyz, obs, inv_s2, is_stereo, m.valid, K)


def _scatter_rows(m, n_feat: int) -> torch.Tensor:
    """Per-feature query index: row q of a unique-target match lands at
    its matched feature; -1 elsewhere (invalid rows drop)."""
    n_q = m.idx.shape[0]
    out = torch.full((n_feat + 1,), -1, dtype=torch.int32, device=m.idx.device)
    dst = torch.where(m.valid, m.idx.long(), n_feat)
    out[dst] = torch.arange(n_q, dtype=torch.int32, device=m.idx.device)
    return out[:n_feat]


def _ref_kf_step(cfg: SlamConfig, T0, k: int, kf_mp_k, KF_desc, KF_angle,
                 KF_kp_valid, PT_xyz, PT_valid, f, K, inv_sigma2_levels):
    """Fused reference-keyframe tracking step (reference:
    Tracking.cc:757-799; dense masked matching here)."""
    q_desc, q_angle = KF_desc[k], KF_angle[k]
    safe = torch.clamp(kf_mp_k, min=0).long()
    q_xyz = PT_xyz[safe]
    q_valid = (kf_mp_k >= 0) & KF_kp_valid[k] & PT_valid[safe]
    m = match.match(q_desc, f.desc, q_valid, f.valid, max_dist=cfg.matcher.th_low, nn_ratio=0.7)
    ok = match.rotation_consistency(q_angle, f.angle[m.idx.long()], m.valid)
    m = m._replace(valid=ok)
    result = _pose_opt_over_queries(cfg, T0, q_xyz, m, f, inv_sigma2_levels, K)
    return m.idx, m.valid, result.pose, result.inliers, result.n_inliers


def _local_map_step(cfg: SlamConfig, T0, local_idx, pt_fresh, seed_mp, PT_xyz,
                    PT_normal, PT_mind, PT_maxd, PT_desc, PT_valid, f, K,
                    inv_sigma2_levels, sf, radius_override: Optional[float] = None,
                    nn_ratio_override: Optional[float] = None):
    """Fused local-map tracking: frustum cull, projection search over the
    covisibility-local point set, pose GN over seed + new matches
    (reference: Tracking.cc:930-974, 1143-1230). Radius 4/6 px and octave
    gate [-3, +2], as in the JAX package; relocalization's widening rounds
    override the radius and the ratio."""
    safe_l = torch.clamp(local_idx, min=0).long()
    pt_xyz, pt_desc = PT_xyz[safe_l], PT_desc[safe_l]
    pt_valid = (local_idx >= 0) & PT_valid[safe_l]
    seed_valid = seed_mp >= 0
    seed_xyz = PT_xyz[torch.clamp(seed_mp, min=0).long()]
    in_view, uv, octave, view_cos = _frustum(
        cfg, T0, pt_xyz, PT_normal[safe_l], PT_mind[safe_l], PT_maxd[safe_l], pt_valid, K
    )
    if radius_override is None:
        r = torch.where(view_cos > 0.998, 4.0, 6.0)
    else:
        r = torch.full_like(view_cos, radius_override)
    m = match.search_by_projection(
        uv, r * sf[octave.long()], pt_desc, in_view & pt_fresh,
        f.xy, f.octave, f.desc, f.valid & ~seed_valid,
        torch.clamp(octave - 3, min=0), torch.clamp(octave + 2, max=cfg.orb.n_levels - 1),
        max_dist=cfg.matcher.th_high,
        nn_ratio=(
            cfg.matcher.nn_ratio_mapping + 0.2 if nn_ratio_override is None else nn_ratio_override
        ),
    )
    feat_q = _scatter_rows(m, f.xy.shape[0])
    feat_new = feat_q >= 0
    xyz_feat = torch.where(feat_new[:, None], pt_xyz[torch.clamp(feat_q, min=0).long()], seed_xyz)
    valid_feat = feat_new | seed_valid
    is_stereo = (f.ur > 0) & valid_feat
    obs = torch.cat([f.xy, torch.where(is_stereo, f.ur, 0.0)[:, None]], dim=1)
    result = _optimize(
        cfg, T0, xyz_feat, obs, inv_sigma2_levels[f.octave.long()], is_stereo, valid_feat, K
    )
    return in_view, m.idx, m.valid, result.pose, result.inliers, result.n_inliers


def _full_track_step(cfg: SlamConfig, T_pred, last_mp, last_octave, last_desc,
                     vo_xyz, vo_valid, local_idx, PT_xyz, PT_normal, PT_mind, PT_maxd,
                     PT_desc, PT_valid, f, K, inv_sigma2_levels, sf,
                     radius_mult: float = 1.0, span=no_span):
    """The whole per-frame tracking compute, queued on the device with no
    readback: motion-model projection matching -> pose GN -> frustum cull
    of the covisibility-local points -> projection matching -> pose GN
    (reference: Tracking.cc:313 + :930). Map data is read from the
    device-resident mirror by index (last_mp, local_idx). `span(name)`
    times the four parts: ``track.motion_search``, ``track.motion_pose``,
    ``track.local_search``, ``track.local_pose``.

    Visual-odometry rows (localization mode, reference Tracking.cc:801-865):
    a row with vo_valid takes the world position vo_xyz and the last
    frame's descriptor instead of map data; its last_mp is -1, so it
    constrains the pose but never binds to a map point."""
    n_levels = cfg.orb.n_levels
    # --- Stage 1: motion model (Tracking.cc:867) ---
    with span("track.motion_search"):
        safe_q = torch.clamp(last_mp, min=0).long()
        q_xyz = torch.where(vo_valid[:, None], vo_xyz, PT_xyz[safe_q])
        q_desc = torch.where(vo_valid[:, None], last_desc, PT_desc[safe_q])
        q_valid = ((last_mp >= 0) & PT_valid[safe_q]) | vo_valid
        xc = se3.apply(T_pred, q_xyz)
        uv = camera.project(xc, K)
        radii = 15.0 * radius_mult * sf[last_octave.long()]
        m1 = match.search_by_projection(
            uv, radii, q_desc, q_valid & (xc[:, 2] > 0),
            f.xy, f.octave, f.desc, f.valid,
            torch.clamp(last_octave - 1, min=0), torch.clamp(last_octave + 1, max=n_levels - 1),
            max_dist=cfg.matcher.th_high, nn_ratio=cfg.matcher.nn_ratio_tracking,
        )
    with span("track.motion_pose"):
        r1 = _pose_opt_over_queries(cfg, T_pred, q_xyz, m1, f, inv_sigma2_levels, K)
    mm_ok = (m1.valid.sum() >= 20) & (r1.n_inliers >= cfg.tracking.min_inliers_pose)
    pose1 = torch.where(mm_ok, r1.pose, T_pred)

    # --- Stage 2: local map (Tracking.cc:930, 1143) ---
    with span("track.local_search"):
        # Per-feature seed assignment from stage-1 inliers.
        n_feat = f.xy.shape[0]
        good_q = m1.valid & r1.inliers & mm_ok
        feat_q1 = _scatter_rows(m1._replace(valid=good_q), n_feat)
        seed_valid = feat_q1 >= 0
        seed_xyz = torch.where(
            seed_valid[:, None], q_xyz[torch.clamp(feat_q1, min=0).long()], 0.0
        )
        safe_l = torch.clamp(local_idx, min=0).long()
        pt_xyz, pt_desc = PT_xyz[safe_l], PT_desc[safe_l]
        pt_valid = (local_idx >= 0) & PT_valid[safe_l]
        in_view, uv2, octave2, view_cos = _frustum(
            cfg, pose1, pt_xyz, PT_normal[safe_l], PT_mind[safe_l], PT_maxd[safe_l], pt_valid, K
        )
        # Exclude local points already matched by stage 1 (sorted matched ids
        # + searchsorted membership test).
        matched_ids = torch.sort(torch.where(good_q, last_mp, 2**30)).values
        pos = torch.searchsorted(matched_ids, local_idx)
        already = matched_ids[torch.clamp(pos, max=last_mp.shape[0] - 1)] == local_idx
        fresh = pt_valid & ~already
        radii2 = torch.where(view_cos > 0.998, 4.0, 6.0) * sf[octave2.long()]
        m2 = match.search_by_projection(
            uv2, radii2, pt_desc, in_view & fresh,
            f.xy, f.octave, f.desc, f.valid & ~seed_valid,
            torch.clamp(octave2 - 3, min=0), torch.clamp(octave2 + 2, max=n_levels - 1),
            max_dist=cfg.matcher.th_high, nn_ratio=cfg.matcher.nn_ratio_mapping + 0.2,
        )
        feat_q2 = _scatter_rows(m2, n_feat)
        feat_new2 = feat_q2 >= 0
        xyz_feat = torch.where(
            feat_new2[:, None], pt_xyz[torch.clamp(feat_q2, min=0).long()], seed_xyz
        )
        valid_feat = feat_new2 | seed_valid
        is_stereo = (f.ur > 0) & valid_feat
        obs = torch.cat([f.xy, torch.where(is_stereo, f.ur, 0.0)[:, None]], dim=1)
    with span("track.local_pose"):
        r2 = _optimize(
            cfg, pose1, xyz_feat, obs, inv_sigma2_levels[f.octave.long()], is_stereo,
            valid_feat, K
        )
    # Device-chained pose for the next frame's prediction (no host round
    # trip); on a failed step it falls back to the propagated prediction.
    chain_ok = mm_ok & (r2.n_inliers >= cfg.tracking.min_inliers_pose)
    chain_pose = torch.where(chain_ok, r2.pose, pose1)
    return (
        mm_ok, m1.idx, good_q, in_view, m2.idx, m2.valid,
        r2.pose, r2.inliers, r2.n_inliers,
    ), chain_pose


def _chain_predict(T_prev, T_prev2, frac: float):
    """Constant-velocity prediction from the two most recent device poses
    of the chained tracking recursion; frac scales the rotation part
    (TrackingConfig.velocity_rotation_fraction)."""
    vel = se3.compose(T_prev, se3.inverse(T_prev2))
    if frac == 0.0:
        R = torch.eye(3, dtype=T_prev.dtype, device=T_prev.device)
    elif frac == 1.0:
        R = se3.rotation(vel)
    else:
        R = so3.exp(so3.log(se3.rotation(vel)) * frac)
    return se3.compose(torch.cat([R, se3.translation(vel)[:, None]], dim=1), T_prev)


class Tracking:
    """Host tracking loop. One instance per System."""

    def __init__(self, cfg: SlamConfig, mapstate: MapState, device: torch.device):
        self.cfg = cfg
        self.map = mapstate
        self.device = torch.device(device)
        self.state = TrackState.NOT_INITIALIZED
        # Localization only: track against a frozen map, never insert
        # keyframes (reference: Tracking.mbOnlyTracking, Tracking.cc:272).
        self.only_tracking = False
        # In localization mode: few map matches, the pose rests on the
        # visual-odometry rows (reference: mbVO, Tracking.cc:283-361).
        self._vo_mode = False
        self._vo_zeros = None  # cached device zeros for the VO rows
        self.K = camera.intrinsics_array(cfg.camera, self.device)
        self.K_host = self.K.cpu().numpy()
        self.sf = np.asarray(cfg.orb.scale_factors(), np.float32)
        self._sf_dev = to_device(self.device, self.sf)
        self.inv_sigma2_levels = to_device(
            self.device, 1.0 / np.asarray(cfg.orb.level_sigma2(), np.float32)
        )
        self.velocity: Optional[np.ndarray] = None  # T_{cur<-last}
        self.last_pose: Optional[np.ndarray] = None
        self.last_frame: Optional[frame_mod.FrameData] = None
        self.last_mp: Optional[np.ndarray] = None  # (N,) point idx / -1
        self.ref_kf: int = -1
        self.request_reset = False  # set on early loss; System consumes
        self.frames_since_kf = 0
        self.frame_id = -1
        self.last_kf_frame_id = -1
        self.last_reloc_frame_id = -1000000
        # Monocular initialization: the first view of the two-view pair.
        self._init_frame: Optional[frame_mod.FrameData] = None
        self._init_frame_id = -1
        self._init_timestamp = 0.0
        # RANSAC draws (mono init, relocalization) take this generator,
        # seeded like the JAX package's PRNGKey; it lives on the tensors'
        # device, as torch.multinomial requires.
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.vocabulary.seed)
        # Per-frame trajectory log: (frame_id, T_cr relative to ref_kf,
        # ref_kf, state, timestamp) — loop/BA corrections of the reference
        # keyframe fix the exported trajectory retroactively
        # (Tracking.cc:488-505, System.cc:345-380).
        self.trajectory: list = []
        self.current_inliers = 0
        # The spans' registry: System hands in its own, as it does the
        # mapper's.
        self.metrics = Metrics()
        # Host wall ms of the fused hot path's sub-stages, summed over
        # frames (the JAX package's names and boundaries): the ms of the
        # spans track.<name> (_substage), read by tools/profile_stages.py
        # from the real code path, so the profile cannot go stale against a
        # copy of it.
        self.stage_ms: dict = {}
        # In-flight frames (frame, dispatch record, timestamp), applied at
        # the next track() (see there).
        self._pending = collections.deque()
        # Device pose chain (chain_pose_t, pose_{t-1}) of the last dispatch.
        self._chain = None
        self.current_timestamp = 0.0
        mapstate.on_slot_reuse = self._on_kf_slot_reuse

    def _on_kf_slot_reuse(self, k: int, Tcp_k: np.ndarray, parent_k: int):
        """A culled keyframe slot is being recycled: fold its stored
        relative pose into every trajectory entry that references it and
        re-point them at its spanning parent (System.cc:361-366)."""
        Tcp_h = np.vstack([Tcp_k, [0, 0, 0, 1.0]])
        for i, (fid, T_cr, ref, state, stamp) in enumerate(self.trajectory):
            if ref == k:
                T_new = (np.vstack([T_cr, [0, 0, 0, 1.0]]) @ Tcp_h)[:3].astype(np.float32)
                self.trajectory[i] = (fid, T_new, parent_k, state, stamp)
        if self.ref_kf == k:
            self.ref_kf = parent_k

    @contextlib.contextmanager
    def _substage(self, name: str, key: Optional[str] = None):
        """The span ``track.<name>``, its ms added to stage_ms[key or name]."""
        with self.metrics.stage("track." + name):
            yield
        key = key or name
        self.stage_ms[key] = self.stage_ms.get(key, 0.0) + self.metrics.last_ms

    # ------------------------------------------------------------------
    def track(self, f: frame_mod.FrameData) -> Optional[np.ndarray]:
        """Process one frame; returns the most recent resolved Tcw (3,4)
        numpy pose, or None if lost. Steady-state frames are pipelined one
        frame deep: the fused device step of frame t is applied at the
        start of frame t+1, on every device."""
        # One readback schedule on every device, the CPU's (where done() is
        # always true): each in-flight frame is applied here, at the first
        # track() after its dispatch, waiting for its readback with
        # Fetch.result(). The JAX package polls done() and bounds the queue
        # by its pipeline depth, to hide a remote chip's latency; on the
        # card the device is done when the host ends its enqueue, so
        # waiting costs ~nothing, and a poll lets the lag of the host
        # bookkeeping follow the host's load (PERF.md §6). The queue never
        # holds more than the last track()'s frame, so the port has no
        # depth (cfg.tracking.pipeline_depth is read by no code here).
        self.flush_pending()
        self.frame_id += 1

        if self.state == TrackState.NOT_INITIALIZED:
            self.flush_pending()
            if self.cfg.sensor == Sensor.MONOCULAR:
                self._monocular_initialization(f)
            else:
                self._stereo_initialization(f)
            self._log_frame()
            return self.last_pose

        if (
            self.state == TrackState.OK
            and self.velocity is not None
            and not (self.only_tracking and self._vo_mode)
        ):
            self._check_replaced_last()
            disp = self._fused_dispatch(f)
            if disp is not None:
                self._pending.append((f, disp, self.current_timestamp))
                if self.only_tracking:
                    # Localization mode is lock-step: the caller takes the
                    # returned pose as this frame's (the reference's
                    # TrackMonocular contract), so wait out the readback.
                    self.flush_pending()
                    return self.last_pose if self.state == TrackState.OK else None
                return self.last_pose

        # Sync path: drain in-flight frames first.
        self.flush_pending()
        ok, pose, cur_mp = self._track_sync(f)
        self._finalize(f, ok, pose, cur_mp)
        return self.last_pose if ok else None

    def _apply_oldest(self):
        """Complete the oldest in-flight frame: fetch its results, run the
        host bookkeeping, decide its keyframe; recover on failure."""
        if not self._pending:
            return
        f, disp, stamp = self._pending.popleft()
        saved_stamp = self.current_timestamp
        self.current_timestamp = stamp
        ok, pose, cur_mp = self._fused_apply(f, disp)
        if not ok:
            self._chain = None
            ok, pose, cur_mp = self._track_reference_kf(f)
            if self.state == TrackState.LOST or not ok:
                ok, pose, cur_mp = self._relocalize(f)
                if ok:
                    self.last_reloc_frame_id = self.frame_id
            if ok:
                ok, pose, cur_mp = self._track_local_map(f, pose, cur_mp)
        self._finalize(f, ok, pose, cur_mp)
        self.current_timestamp = saved_stamp

    def apply_pending(self):
        """Apply the oldest in-flight frame, if any (the JAX package's
        Tracking.apply_pending)."""
        self._apply_oldest()

    def flush_pending(self):
        """Drain every in-flight frame."""
        while self._pending:
            self._apply_oldest()

    def _track_sync(self, f: frame_mod.FrameData):
        """Synchronous (same-frame) tracking: the non-pipelined paths."""
        self._chain = None
        ok = False
        fused_done = False
        pose = None
        cur_mp = np.full(f.xy.shape[0], -1, np.int64)
        if self.state == TrackState.OK:
            self._check_replaced_last()
            if self.velocity is not None:
                disp = self._fused_dispatch(f)
                if disp is not None:
                    ok, pose, cur_mp = self._fused_apply(f, disp)
                    fused_done = ok
            if not ok:
                ok, pose, cur_mp = self._track_reference_kf(f)
        if ok and self.only_tracking and self._vo_mode:
            # VO mode: tracking holds on temporal points; keep trying to
            # relocalize into the map (reference: Tracking.cc:296-330).
            ok_r, pose_r, mp_r = self._relocalize(f)
            if ok_r:
                pose, cur_mp = pose_r, mp_r
                self._vo_mode = False
                self.last_reloc_frame_id = self.frame_id
        if self.state == TrackState.LOST or not ok:
            ok, pose, cur_mp = self._relocalize(f)
            if ok:
                self.last_reloc_frame_id = self.frame_id
        if ok and not fused_done:
            ok, pose, cur_mp = self._track_local_map(f, pose, cur_mp)
        return ok, pose, cur_mp

    def _finalize(self, f, ok, pose, cur_mp):
        """Post-tracking bookkeeping for one frame (motion model update,
        keyframe decision, loss handling, trajectory log)."""
        if cur_mp is None:
            cur_mp = np.full(f.xy.shape[0], -1, np.int64)
        if ok:
            if self.last_pose is not None:
                vel = np_se3.compose(pose, np_se3.inverse(self.last_pose))
                frac = self.cfg.tracking.velocity_rotation_fraction
                if frac < 1.0:
                    vel = np_se3.scale_rotation(vel, frac)
                self.velocity = vel
            self.state = TrackState.OK
            self.last_pose = np.asarray(pose)
            if not self.only_tracking and self._need_new_keyframe(f, cur_mp):
                self._create_keyframe(f, cur_mp)
                self.frames_since_kf = 0
            else:
                self.frames_since_kf += 1
        else:
            self.state = TrackState.LOST
            self.velocity = None
            # Lost soon after initialization: request a full reset
            # (reference: Tracking.cc:472-479; System consumes the flag).
            if len(self.map.live_keyframes()) <= 5 and not self.only_tracking:
                self.request_reset = True
        self.last_frame = f
        self.last_mp = cur_mp
        self._log_frame()

    # ------------------------------------------------------------------
    def _log_frame(self):
        if self.last_pose is not None:
            T_cr = self.last_pose
            if self.ref_kf >= 0:
                T_cr = np_se3.compose(self.last_pose, np_se3.inverse(self.map.kf_pose[self.ref_kf]))
            self.trajectory.append(
                (self.frame_id, T_cr.copy(), self.ref_kf, self.state, self.current_timestamp)
            )

    def _check_replaced_last(self):
        """Follow point forwarding on last frame's matches (reference:
        Tracking::CheckReplacedInLastFrame, Tracking.cc:739-754)."""
        if self.last_mp is not None:
            self.last_mp = self.map.resolve(self.last_mp)
            dead = (self.last_mp >= 0) & ~self.map.pt_valid[np.maximum(self.last_mp, 0)]
            self.last_mp[dead] = -1

    # ------------------------------------------------------------------
    # Initialization
    # ------------------------------------------------------------------
    def _monocular_initialization(self, f: frame_mod.FrameData):
        """Two-view bootstrap (reference: Tracking.cc:563-737)."""
        n_valid = int(f.valid.sum())
        min_matches = self.cfg.tracking.min_init_matches
        if self._init_frame is None:
            if n_valid >= min_matches:
                self._init_frame = f
                self._init_frame_id = self.frame_id
                self._init_timestamp = self.current_timestamp
            return
        if n_valid < min_matches:
            self._init_frame = None
            return
        f0 = self._init_frame
        # All octaves take part (the tracker passes zero octaves): a
        # documented deviation of the JAX package from the reference's
        # level-0 restriction (ORBmatcher.cc:415), kept here.
        m = match.search_for_initialization(
            f0.xy, f0.desc, f0.valid, f0.angle,
            f.xy, f.desc, f.valid, f.angle, torch.zeros_like(f.octave),
            window=100.0, max_dist=self.cfg.matcher.th_low,
            nn_ratio=self.cfg.matcher.nn_ratio_tracking,
        )
        res = twoview.initialize(
            f0.xy, f.xy[m.idx.long()], m.valid, self.K, generator=self.generator,
            n_hypotheses=self.cfg.capacity.ransac_init_iters,
        )
        valid0, idx1, res_ok, good, pts, T21 = fetch(
            m.valid, m.idx, res.ok, res.good, res.points, res.T21
        )
        if valid0.sum() < min_matches:
            self._init_frame = None
            return
        if not bool(res_ok):
            return
        # Median-depth scale normalization (reference: Tracking.cc:689-713).
        med = float(np.median(pts[good, 2]))
        if med <= 0:
            self._init_frame = None
            return
        pts = pts / med
        T21[:, 3] /= med
        mp0 = self._create_initial_map(f0, f, idx1, good, pts, T21)
        self.state = TrackState.OK
        self.last_pose = T21
        self.velocity = None
        self.last_mp = mp0
        self._init_frame = None

    def _create_initial_map(self, f0, f1, idx1, good, pts, T21):
        """The two initial keyframes and their points, then the initial
        BA (reference: Tracking.cc:640-737)."""
        mp = self.map
        f0h = frame_mod.FrameData(*fetch(*f0))
        f1h = frame_mod.FrameData(*fetch(*f1))
        desc0 = f0h.desc.view(np.uint32)
        k0 = mp.add_keyframe(
            self._init_frame_id, np.eye(3, 4, dtype=np.float32),
            f0h.xy, f0h.octave, f0h.angle, desc0, f0h.valid, timestamp=self._init_timestamp,
        )
        k1 = mp.add_keyframe(
            self.frame_id, T21, f1h.xy, f1h.octave, f1h.angle, f1h.desc.view(np.uint32),
            f1h.valid, timestamp=self.current_timestamp,
        )
        cur_mp = np.full(f1h.xy.shape[0], -1, np.int64)
        gi = np.nonzero(good)[0]
        new_idx = mp.add_points_batch(pts[gi], desc0[gi], k0)
        mp.pt_obs_kf[new_idx, 0] = k0
        mp.pt_obs_feat[new_idx, 0] = gi
        mp.pt_obs_kf[new_idx, 1] = k1
        mp.pt_obs_feat[new_idx, 1] = idx1[gi]
        mp.pt_n_obs[new_idx] = 2
        mp.kf_mp[k0, gi] = new_idx
        mp.kf_mp[k1, idx1[gi]] = new_idx
        mp.update_points_batch(new_idx)
        cur_mp[idx1[gi]] = new_idx
        mp.update_connections(k0)
        mp.update_connections(k1)
        self.ref_kf = k1
        self.last_kf_frame_id = self.frame_id
        self.frames_since_kf = 0
        mp.big_change_idx += 1
        # Full BA of the two-view map (Tracking.cc:686,
        # GlobalBundleAdjustemnt(pMap, 20)).
        self._initial_bundle_adjustment(k0, k1)
        return cur_mp

    def _initial_bundle_adjustment(self, k0: int, k1: int):
        """Dense-Schur BA of the two initial keyframes (k0 fixed) and every
        live point, then re-normalization to median depth 1 (the BA can
        drift the free scale gauge of a two-view map)."""
        mp = self.map
        pts = mp.live_points()
        kf, feat = mp.pt_obs_kf[pts], mp.pt_obs_feat[pts]
        has = (np.arange(kf.shape[1]) < mp.pt_n_obs[pts][:, None]) & (kf >= 0)
        si, oi = np.nonzero(has)  # point-major, as the reference's edge loop
        okf, ofeat = kf[si, oi], feat[si, oi]
        inv_s2 = 1.0 / np.asarray(self.cfg.orb.level_sigma2(), np.float64)
        uv = mp.kf_xy[okf, ofeat]
        n_obs = len(si)
        dev = self.device
        problem = ba_mod.BAProblem(
            *to_device(
                dev, np.stack([mp.kf_pose[k0], mp.kf_pose[k1]]), np.array([True, False]),
                np.ones(2, bool), mp.pt_xyz[pts], np.ones(len(pts), bool),
                np.where(okf == k0, 0, 1).astype(np.int32), si.astype(np.int32),
                np.concatenate([uv, np.zeros((n_obs, 1), np.float32)], axis=1),
                np.zeros(n_obs, bool), inv_s2[mp.kf_octave[okf, ofeat]].astype(np.float32),
                np.ones(n_obs, bool),
            ),
            K=self.K, bf=torch.tensor(0.0, device=dev),
        )
        cam_T, points = fetch(
            *ba_mod.optimize(problem, iters=self.cfg.optimizer.init_ba_its, use_huber=True)
        )
        mp.kf_pose[k1] = cam_T[1]
        mp.pt_xyz[pts] = points
        T = mp.kf_pose[k0]
        med = float(np.median(mp.pt_xyz[pts] @ T[2, :3] + T[2, 3]))
        if med > 0:
            mp.pt_xyz[pts] /= med
            mp.kf_pose[k1][:, 3] /= med
        mp.mark_kf_pose_dirty([k1])
        mp.mark_points_dirty(pts)
        self.last_pose = mp.kf_pose[k1].copy()

    def _stereo_initialization(self, f: frame_mod.FrameData):
        """Bootstrap from depth (reference: Tracking.cc:509-561)."""
        fh = frame_mod.FrameData(*fetch(*f))
        if int(fh.valid.sum()) < self.cfg.tracking.min_stereo_init_points:
            return
        if int(((fh.depth > 0) & fh.valid).sum()) < 50:
            return  # degenerate: almost no depth to seed the map
        mp = self.map
        pose = np.eye(3, 4, dtype=np.float32)
        k0 = mp.add_keyframe(
            self.frame_id, pose, fh.xy, fh.octave, fh.angle, fh.desc.view(np.uint32),
            fh.valid, ur=fh.ur, depth=fh.depth, timestamp=self.current_timestamp,
        )
        xyz = self._backproject(fh.xy, fh.depth)
        cur_mp = np.full(fh.xy.shape[0], -1, np.int64)
        sel = np.nonzero(fh.valid & (fh.depth > 0))[0]
        new_idx = mp.add_points_batch(xyz[sel], fh.desc.view(np.uint32)[sel], k0)
        mp.add_observations_batch(new_idx, k0, sel)
        mp.update_points_batch(new_idx)
        cur_mp[sel] = new_idx
        mp.update_connections(k0)
        self.ref_kf = k0
        self.last_kf_frame_id = self.frame_id
        self.state = TrackState.OK
        self.last_pose = pose
        self.last_mp = cur_mp
        self.frames_since_kf = 0
        mp.big_change_idx += 1

    def _backproject(self, xy: np.ndarray, depth: np.ndarray) -> np.ndarray:
        """(N, 3) camera-frame points of host keypoints xy at `depth`."""
        Kc = self.K_host
        return np.stack(
            [(xy[:, 0] - Kc[2]) * depth / Kc[0], (xy[:, 1] - Kc[3]) * depth / Kc[1], depth],
            axis=1,
        ).astype(np.float32)

    # ------------------------------------------------------------------
    # Per-frame pose tracking
    # ------------------------------------------------------------------
    def _fused_dispatch(self, f: frame_mod.FrameData):
        """Steady-state hot path, dispatch half: queue the whole frame's
        tracking compute on the device and start its readback. Returns
        the dispatch record for _fused_apply, or None if the frame can't
        take the fused path. The local point set comes from the previous
        frame's covisibility (one frame stale)."""
        # _vo_arrays runs first, since the gate counts its rows: its time
        # goes under "prep", where the JAX package calls it.
        with self._substage("vo", "prep"):
            vo_xyz_d, vo_valid_d = self._vo_arrays(f.xy.shape[0])
        vo_host = isinstance(vo_valid_d, np.ndarray)
        with self._substage("select"):
            n_queries = int((self.last_mp >= 0).sum())
            if vo_host:
                # VO rows are queries too: counting them keeps VO mode alive
                # past the frame that entered it (the JAX package counts map
                # rows only, so its VO mode ends in LOST one frame later).
                n_queries += int(vo_valid_d.sum())
            local_pts = (self._local_points(self._local_keyframes(self.last_mp))
                         if n_queries >= 10 else [])
        if len(local_pts) == 0:
            return None
        with self._substage("prep"):
            cap = self.cfg.capacity.local_map_max_points
            pts_pad = np.full(cap, -1, np.int32)
            pts_pad[: min(len(local_pts), cap)] = local_pts[:cap]
            safe = np.maximum(pts_pad, 0)
            if self._chain is None:
                # Extrapolate across the actual lag; prev at 1-frame spacing so
                # the next on-chain prediction is a 1-frame velocity.
                T_pred = np.vstack([self.last_pose, [0, 0, 0, 1]])
                vel_h = np.vstack([self.velocity, [0, 0, 0, 1]])
                T_prev = T_pred
                for _ in range(len(self._pending) + 1):
                    T_prev = T_pred
                    T_pred = vel_h @ T_pred
                lag = len(self._pending) + 1
                radius_mult = (1.0, 1.5, 2.0)[min(lag - 1, 2)]
            else:
                radius_mult = 1.0
        dev = self.map.device
        with self._substage("flush"):
            dev.flush()
        with self._substage("upload"):
            last_mp_d, local_idx_d = to_device(
                self.device, self.last_mp.astype(np.int32), pts_pad
            )
            if vo_host:
                vo_xyz_d, vo_valid_d = to_device(self.device, vo_xyz_d, vo_valid_d)
            frac = self.cfg.tracking.velocity_rotation_fraction
            if self._chain is not None:
                # Device pose chain: 1-frame prediction lag at any depth.
                T_pred_d = _chain_predict(self._chain[0], self._chain[1], frac)
                prev_pose_d = self._chain[0]
            else:
                T_pred_d, prev_pose_d = to_device(
                    self.device, T_pred[:3].astype(np.float32), T_prev[:3].astype(np.float32)
                )
        head_args = (self.cfg, T_pred_d, last_mp_d, self.last_frame.octave,
                     self.last_frame.desc, vo_xyz_d, vo_valid_d, local_idx_d)
        tail_args = (f, self.K, self.inv_sigma2_levels, self._sf_dev)
        with self._substage("dispatch"):
            out, chain_pose = _full_track_step(
                *head_args,
                dev.pt_xyz, dev.pt_normal, dev.pt_min_dist, dev.pt_max_dist,
                dev.pt_desc, dev.pt_valid,
                *tail_args, radius_mult=radius_mult, span=self.metrics.stage,
            )
        self._chain = (chain_pose, prev_pose_d)
        # The frame descriptors ride the same readback (per-frame point
        # descriptor refresh in _fused_postprocess).
        with self._substage("prefetch"):
            fut = fetch_async(*out, f.desc)
        return (fut, pts_pad, safe, self.last_mp, (head_args, tail_args))

    def _vo_arrays(self, n_feat: int):
        """Visual-odometry rows (reference: UpdateLastFrame,
        Tracking.cc:801-865): in localization mode, stereo and RGB-D input
        add the last frame's close-depth keypoints that have no map point,
        in world coordinates, to the motion model's queries, so tracking
        survives outside the mapped region. Their last_mp is -1: they
        constrain the pose and never create a map association.

        Returns (vo_xyz, vo_valid): host arrays while the rows are active,
        else cached zero tensors on the device (nothing to upload)."""
        if (
            self.only_tracking
            and self.cfg.sensor != Sensor.MONOCULAR
            and self.last_pose is not None
        ):
            depth, lf_valid, xy = fetch(
                self.last_frame.depth, self.last_frame.valid, self.last_frame.xy
            )
            close = (depth > 0) & (depth < self.cfg.tracking.th_depth * self.cfg.camera.baseline)
            vo = close & (self.last_mp < 0) & lf_valid
            if vo.any():
                xc = self._backproject(xy, depth)
                Tinv = np_se3.inverse(self.last_pose)
                return (xc @ Tinv[:, :3].T + Tinv[:, 3]).astype(np.float32), vo
        if self._vo_zeros is None or self._vo_zeros[0].shape[0] != n_feat:
            self._vo_zeros = (
                torch.zeros((n_feat, 3), dtype=torch.float32, device=self.device),
                torch.zeros(n_feat, dtype=torch.bool, device=self.device),
            )
        return self._vo_zeros

    def _fused_apply(self, f: frame_mod.FrameData, disp):
        """Steady-state hot path, apply half: one readback + host
        bookkeeping. On failure ONE synchronous retry re-runs the step
        with a 3x stage-1 window (Tracking.cc:888-892)."""
        fut, pts_pad, safe, last_mp, (head_args, tail_args) = disp
        with self._substage("fetch"):
            *fetched, f_desc = fut.result()
        ok, pose, mp = self._fused_postprocess(f, fetched, pts_pad, safe, last_mp, f_desc)
        if ok:
            return ok, pose, mp
        # The device pose chain was advanced with the failed step's
        # prediction; the retry's pose reaches the next dispatch through
        # the host instead (the JAX package keeps extrapolating the failed
        # prediction, doubling its error on the next frame).
        self._chain = None
        with self.metrics.stage("track.retry"):
            dev = self.map.device
            dev.flush()
            wide, _ = _full_track_step(
                *head_args,
                dev.pt_xyz, dev.pt_normal, dev.pt_min_dist, dev.pt_max_dist,
                dev.pt_desc, dev.pt_valid,
                *tail_args, radius_mult=3.0,
            )
            return self._fused_postprocess(f, fetch(*wide), pts_pad, safe, last_mp, f_desc)

    def _fused_postprocess(self, f, fetched, pts_pad, safe, last_mp, f_desc):
        (mm_ok, m1_idx, good_q, in_view, m2_idx, m2_valid, pose2, inl_feat, n2) = fetched
        if not bool(mm_ok):
            return False, None, None
        new_mp = np.full(f.xy.shape[0], -1, np.int64)
        new_mp[m1_idx[good_q]] = last_mp[good_q]
        new_mp[m2_idx[m2_valid]] = pts_pad[m2_valid]
        # Mapping stages ran between dispatch and apply: follow point
        # forwarding and drop tombstones before recording associations.
        new_mp = self.map.resolve(new_mp)
        dead = (new_mp >= 0) & ~self.map.pt_valid[np.maximum(new_mp, 0)]
        new_mp[dead] = -1
        found = new_mp.copy()
        found[~inl_feat] = -1
        new_mp[~inl_feat] = -1
        n = int(n2)
        vo_mode = self.only_tracking and int((new_mp >= 0).sum()) < 10
        recent_reloc = self.frame_id - self.last_reloc_frame_id < int(self.cfg.camera.fps)
        need = (
            self.cfg.tracking.min_inliers_local_map_strict
            if recent_reloc
            else self.cfg.tracking.min_inliers_local_map
        )
        # In VO mode (few map matches: off the mapped region) the pose
        # rests on the VO rows, so the pose-GN inliers, VO rows included,
        # decide; the map gate would drop to LOST outside the map
        # (reference: mbVO, Tracking.cc:283-361).
        if n < (self.cfg.tracking.min_inliers_pose if vo_mode else need):
            # No map side effects on a rejected pass (the wide retry runs
            # this again); the tracker-local inlier count is updated.
            self.current_inliers = n
            return False, pose2, new_mp
        self.map.pt_visible[safe[in_view]] += 1
        self.map.pt_found[found[found >= 0]] += 1
        # Per-frame descriptor refresh: an inlier-matched point takes the
        # current frame's descriptor (see the JAX package). Not in
        # localization mode, where the map stays as it was loaded.
        feat_sel = np.nonzero(new_mp >= 0)[0]
        if len(feat_sel) and not self.only_tracking:
            pt_sel = new_mp[feat_sel]
            self.map.pt_desc[pt_sel] = np.asarray(f_desc).view(np.uint32)[feat_sel]
            self.map.mark_points_dirty(pt_sel)
        self.current_inliers = n
        if self.only_tracking:
            self._vo_mode = vo_mode
        return True, pose2, new_mp

    def _track_reference_kf(self, f: frame_mod.FrameData):
        """Match against the reference keyframe's map points (reference:
        Tracking.cc:757-799): one device step and one readback."""
        k = self.ref_kf
        if k < 0:
            return False, None, None
        kf_mp = self.map.kf_mp[k]
        T0 = self.last_pose if self.last_pose is not None else np.eye(3, 4, dtype=np.float32)
        dev = self.map.device
        dev.flush()
        T0_d, kf_mp_d = to_device(self.device, T0.astype(np.float32), kf_mp.astype(np.int32))
        m_idx, m_valid, pose, inl, n = fetch(
            *_ref_kf_step(
                self.cfg, T0_d, k, kf_mp_d, dev.kf_desc, dev.kf_angle, dev.kf_kp_valid,
                dev.pt_xyz, dev.pt_valid, f, self.K, self.inv_sigma2_levels,
            )
        )
        if m_valid.sum() < 15:
            return False, None, None
        cur_mp = np.full(f.xy.shape[0], -1, np.int64)
        good_q = m_valid & inl
        cur_mp[m_idx[good_q]] = kf_mp[good_q]
        if n < self.cfg.tracking.min_inliers_pose:
            return False, None, None
        return True, pose, cur_mp

    def _optimize_frame_pose(self, f, T0, mp_idx: np.ndarray):
        """Motion-only GN against the frame's current matches mp_idx
        (feature -> point, -1 none); returns (pose, inlier mask, n)."""
        has = mp_idx >= 0
        dev = self.device
        xyz, has_d, T0_d = to_device(
            dev, self.map.pt_xyz[np.maximum(mp_idx, 0)], has, np.asarray(T0, np.float32)
        )
        is_stereo = (f.ur > 0) & has_d
        obs = torch.cat([f.xy, torch.where(is_stereo, f.ur, 0.0)[:, None]], dim=1)
        result = _optimize(
            self.cfg, T0_d, xyz, obs, self.inv_sigma2_levels[f.octave.long()], is_stereo,
            has_d, self.K,
        )
        pose, inl, n = fetch(result.pose, result.inliers, result.n_inliers)
        return pose, inl, int(n)

    def _relocalize(self, f: frame_mod.FrameData):
        """Global relocalization (reference: Tracking.cc:1341-1502):
        candidate keyframes -> descriptor match -> PnP RANSAC -> pose GN,
        then guided-reprojection widening. Candidates are the place
        recognizer's (reloc_provider, set by the loop path) plus the 10
        most recent keyframes by insertion serial; with loop closing off
        there is no provider and no vocabulary is needed."""
        live = self.map.live_keyframes()
        if len(live) == 0:
            return False, None, None
        candidates = []
        provider = getattr(self, "reloc_provider", None)
        if provider is not None:
            f_desc, f_kp_valid = fetch(f.desc, f.valid)
            candidates = list(provider.reloc_candidates(f_desc, f_kp_valid))
        order = np.argsort(self.map.kf_serial[live])
        recent = [int(k) for k in live[order[-10:]]]
        candidates = list(dict.fromkeys([int(c) for c in candidates] + recent))
        q_valid = (self.map.kf_mp[candidates] >= 0) & self.map.kf_kp_valid[candidates]
        keep = (self.map.kf_mp[candidates] >= 0).sum(1) >= 15
        candidates = [k for k, ok in zip(candidates, keep) if ok]
        if not candidates:
            return False, None, None
        # Every candidate's match in one batched call over a leading
        # candidate dimension, read back in one fetch.
        q_desc_d, q_valid_d = to_device(
            self.device, self.map.kf_desc[candidates], q_valid[keep]
        )
        m = match.match(
            q_desc_d, f.desc, q_valid_d, f.valid,
            max_dist=self.cfg.matcher.th_low, nn_ratio=0.75,
        )
        m_idx_all, m_valid_all = fetch(m.idx, m.valid)
        counts = m_valid_all.sum(1)
        c = int(np.argmax(counts))  # first best, as the candidate loop
        if counts[c] < 15:
            return False, None, None
        k, m_idx, ok_np = candidates[c], m_idx_all[c], m_valid_all[c]
        kf_mp = self.map.kf_mp[k]
        sel = np.full(f.xy.shape[0], -1, np.int64)  # padded to keypoint capacity
        nz = np.nonzero(ok_np)[0]
        sel[: len(nz)] = nz
        safe = np.maximum(sel, 0)
        pt_idx = np.where(sel >= 0, kf_mp[safe], 0)
        xw_d, feat_d, sel_ok_d = to_device(
            self.device, self.map.pt_xyz[pt_idx], m_idx[safe].astype(np.int64), sel >= 0
        )
        res = pnp.solve_pnp_ransac(
            xw_d, f.xy[feat_d], sel_ok_d, self.inv_sigma2_levels[f.octave[feat_d].long()],
            self.K, generator=self.generator, n_hypotheses=self.cfg.capacity.ransac_pnp_iters,
        )
        res_ok, res_inliers, res_pose = fetch(res.ok, res.inliers, res.pose)
        if not bool(res_ok):
            return False, None, None
        cur_mp = np.full(f.xy.shape[0], -1, np.int64)
        inl = res_inliers & (sel >= 0)
        cur_mp[m_idx[safe[inl]]] = pt_idx[inl]
        pose, pin, n = self._optimize_frame_pose(f, res_pose, cur_mp)
        cur_mp[~pin] = -1
        if n < self.cfg.tracking.min_inliers_pose:
            return False, None, None
        # Guided-reprojection widening (Tracking.cc:1441-1480): a coarse
        # 10 px round, then a 3 px round if close; accept at >= 50
        # inliers (Tracking.cc:1483).
        need = self.cfg.tracking.min_inliers_reloc
        if n < need:
            pose, cur_mp, n = self._reloc_widen(f, pose, cur_mp, k, 10.0)
            if self.cfg.tracking.min_inliers_local_map <= n < need:
                pose, cur_mp, n = self._reloc_widen(f, pose, cur_mp, k, 3.0)
        if n < need:
            return False, None, None
        return True, pose, cur_mp

    def _reloc_widen(self, f, pose, cur_mp, k: int, radius: float):
        """One guided-reprojection round against keyframe k's map points
        (reference: ORBmatcher.cc:1472-1599) + pose re-optimization."""
        kf_mp = self.map.kf_mp[k]
        pts = np.unique(kf_mp[kf_mp >= 0])
        pts = pts[self.map.pt_valid[pts]]
        cap = self.cfg.capacity.local_map_max_points
        pts_pad = np.full(cap, -1, np.int32)
        pts_pad[: min(len(pts), cap)] = pts[:cap]
        fresh = (pts_pad >= 0) & ~np.isin(pts_pad, cur_mp[cur_mp >= 0])
        dev = self.map.device
        dev.flush()
        pose_d, local_idx_d, fresh_d, seed_mp_d = to_device(
            self.device, np.asarray(pose, np.float32), pts_pad, fresh, cur_mp.astype(np.int32)
        )
        _, m_idx, m_valid, pose2, inl, n = fetch(
            *_local_map_step(
                self.cfg, pose_d, local_idx_d, fresh_d, seed_mp_d,
                dev.pt_xyz, dev.pt_normal, dev.pt_min_dist, dev.pt_max_dist,
                dev.pt_desc, dev.pt_valid, f, self.K, self.inv_sigma2_levels,
                self._sf_dev, radius_override=radius, nn_ratio_override=1.0,
            )
        )
        new_mp = cur_mp.copy()
        new_mp[m_idx[m_valid]] = pts_pad[m_valid]
        new_mp[~inl] = -1
        return pose2, new_mp, int(n)

    def _track_local_map(self, f, pose, cur_mp):
        """Widen matches to the covisibility-local map and re-optimize
        (reference: Tracking.cc:930-974, 1143-1230)."""
        local_pts = self._local_points(self._local_keyframes(cur_mp))
        if len(local_pts) == 0:
            n = (cur_mp >= 0).sum()
            self.current_inliers = int(n)
            return n >= self.cfg.tracking.min_inliers_pose, pose, cur_mp

        cap = self.cfg.capacity.local_map_max_points
        local_pts = local_pts[:cap]
        pts_pad = np.full(cap, -1, np.int32)
        pts_pad[: len(local_pts)] = local_pts
        safe = np.maximum(pts_pad, 0)
        # Exclude points already matched in this frame.
        fresh = (pts_pad >= 0) & ~np.isin(pts_pad, cur_mp[cur_mp >= 0])
        dev = self.map.device
        dev.flush()
        pose_d, local_idx_d, fresh_d, seed_mp_d = to_device(
            self.device, np.asarray(pose, np.float32), pts_pad, fresh, cur_mp.astype(np.int32)
        )
        in_view, m_idx, m_valid, pose2, inl, n = fetch(
            *_local_map_step(
                self.cfg, pose_d, local_idx_d, fresh_d, seed_mp_d,
                dev.pt_xyz, dev.pt_normal, dev.pt_min_dist, dev.pt_max_dist,
                dev.pt_desc, dev.pt_valid, f, self.K, self.inv_sigma2_levels,
                self._sf_dev,
            )
        )
        self.map.pt_visible[safe[in_view]] += 1
        new_mp = cur_mp.copy()
        new_mp[m_idx[m_valid]] = pts_pad[m_valid]
        found = new_mp.copy()
        found[~inl] = -1
        self.map.pt_found[found[found >= 0]] += 1
        new_mp[~inl] = -1
        self.current_inliers = n = int(n)
        recent_reloc = self.frame_id - self.last_reloc_frame_id < int(self.cfg.camera.fps)
        need = (
            self.cfg.tracking.min_inliers_local_map_strict
            if recent_reloc
            else self.cfg.tracking.min_inliers_local_map
        )
        return n >= need, pose2, new_mp

    def _local_keyframes(self, cur_mp) -> list[int]:
        """Covisibility vote (reference: Tracking.cc:1231-1300): one
        bincount over the observation table of the matched points."""
        pts = cur_mp[cur_mp >= 0]
        Nk = self.map.kf_pose.shape[0]
        if len(pts):
            obs = self.map.pt_obs_kf[pts]
            votes = np.bincount(obs[obs >= 0], minlength=Nk)
        else:
            votes = np.zeros(Nk, np.int64)
        if not votes.any():
            return [self.ref_kf] if self.ref_kf >= 0 else []
        order = np.argsort(-votes, kind="stable")
        n_vote = int((votes > 0).sum())
        local = [int(k) for k in order[: min(n_vote, self.cfg.tracking.max_local_keyframes)]]
        self.ref_kf = local[0]  # reference KF = most-voting keyframe
        # Add one covisibility ring (K2 set, capped).
        ring = []
        for k in local[:10]:
            ring.extend(self.map.covisible_keyframes(k, n=5, min_weight=15))
        seen = set(local)
        for k in ring:
            if k not in seen and len(local) < self.cfg.tracking.max_local_keyframes:
                local.append(k)
                seen.add(k)
        return local

    def _local_points(self, local_kfs) -> np.ndarray:
        if len(local_kfs) == 0:
            return np.zeros(0, np.int64)
        cols = self.map.kf_mp[np.asarray(local_kfs)].ravel()
        pts = np.unique(cols[cols >= 0])
        if len(pts):
            pts = pts[self.map.pt_valid[pts]]
        return pts

    # ------------------------------------------------------------------
    # Keyframe policy
    # ------------------------------------------------------------------
    def _need_new_keyframe(self, f, cur_mp) -> bool:
        """Reference: Tracking.cc:977-1061 (conditions c1a/c1b/c2 plus the
        mapper-idle gating); see the JAX package for the deviations."""
        if len(self.map.live_keyframes()) == 0:
            return False
        mapper = getattr(self, "mapper", None)
        if mapper is not None and mapper.paused:
            # A loop correction's staged window froze the map topology
            # (reference: NeedNewKeyFrame bails while LocalMapping is
            # stopped by a loop closure, Tracking.cc:992-996).
            return False
        idle = mapper.queue_len() == 0 if mapper is not None else True
        frames = self.frame_id - self.last_kf_frame_id
        ref_matches = (self.map.kf_mp[self.ref_kf] >= 0).sum() if self.ref_kf >= 0 else 0
        inliers = self.current_inliers
        theta = 0.9 if self.cfg.sensor == Sensor.MONOCULAR else 0.75
        c1a = frames >= self.cfg.tracking.max_frames_between_kf
        c1b = frames >= self.cfg.tracking.min_frames_between_kf and idle
        c2 = inliers < ref_matches * theta and inliers > 15
        urgent = c2 and inliers < 2 * self.cfg.tracking.min_inliers_local_map
        if not (c1a or ((c1b or urgent) and c2)):
            return False
        if idle:
            return True
        limit = 2 if self.cfg.sensor == Sensor.MONOCULAR else 3
        if c1a or urgent:
            limit += 2
        return mapper.queue_len() < limit

    def _create_keyframe(self, f, cur_mp):
        """Promote the frame (reference: Tracking.cc:1063-1141); RGB-D also
        seeds new close points from depth (:1077-1131)."""
        mp = self.map
        fh = frame_mod.FrameData(*fetch(*f))
        desc = fh.desc.view(np.uint32)
        k = mp.add_keyframe(
            self.frame_id, self.last_pose, fh.xy, fh.octave, fh.angle, desc, fh.valid,
            ur=fh.ur, depth=fh.depth, timestamp=self.current_timestamp,
        )
        has = np.nonzero(cur_mp >= 0)[0]
        # Dedupe (first feature wins if a point matched twice).
        _, first = np.unique(cur_mp[has], return_index=True)
        sel = has[np.sort(first)]
        mp.add_observations_batch(cur_mp[sel], k, sel)
        if self.cfg.sensor != Sensor.MONOCULAR:
            depth = fh.depth
            close = (
                (depth > 0)
                & (depth < self.cfg.tracking.th_depth * self.cfg.camera.baseline)
                & (cur_mp < 0)
                & fh.valid
            )
            order = np.argsort(np.where(close, depth, np.inf))
            n_new = min(int(close.sum()), self.cfg.tracking.max_new_stereo_points)
            Tinv = np_se3.inverse(self.last_pose)
            xyz_w = self._backproject(fh.xy, fh.depth) @ Tinv[:, :3].T + Tinv[:, 3]
            sel_new = order[:n_new]
            new_idx = mp.add_points_batch(xyz_w[sel_new], desc[sel_new], k)
            mp.add_observations_batch(new_idx, k, sel_new)
            cur_mp[sel_new] = new_idx
        mp.update_points_batch(np.unique(cur_mp[cur_mp >= 0]))
        mp.update_connections(k)
        self.ref_kf = k
        self.last_kf_frame_id = self.frame_id
        return k
