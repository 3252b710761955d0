"""Local mapping: point culling, triangulation, fusion, local BA, KF culling.

Counterpart of c_orb_slam_tpu/mapping.py (reference: src/LocalMapping.cc
— ProcessNewKeyFrame :128, MapPointCulling :170, CreateNewMapPoints :207,
SearchInNeighbors :454, LocalBundleAdjustment :81, KeyFrameCulling :632).
A stage pipeline the host loop advances once per tracked frame; each
batched stage has a dispatch half (queue device work, start the
readback) and an apply half (host bookkeeping) run on a later frame.
On a mesh of more than one shard, full-bucket local-BA windows go through
parallel/dba (observations sharded), as the JAX package routes them at
more than one device; ``process_keyframe`` runs the same stages as one
synchronous pass.
"""

from __future__ import annotations


import numpy as np
import torch

from c_orb_slam_tpu_torch.config import SlamConfig, Sensor
from c_orb_slam_tpu_torch.geometry import camera, se3, triangulate
from c_orb_slam_tpu_torch.ops import match
from c_orb_slam_tpu_torch.optim import ba
from c_orb_slam_tpu_torch.parallel import dba
from c_orb_slam_tpu_torch.parallel.mesh import Mesh
from c_orb_slam_tpu_torch.slam_map.mapstate import MapState
from c_orb_slam_tpu_torch.tracking import frustum_check
from c_orb_slam_tpu_torch.utils.host import fetch_async, to_device

# Sentinel: a pipelined apply stage whose device result has not landed yet
# asks the scheduler to retry next frame instead of blocking the frame loop.
NOT_READY = object()

# Mapping stages run per tracked frame (times 1 + the queue's length).
_STAGE_BUDGET = 4

# Max new-point candidates kept per neighbour pair (readback compaction).
TRI_COMPACT_K = 384
# Max fuse matches kept per (src, dst) pair (readback compaction).
FUSE_COMPACT_K = 384


def _fundamental_from_poses(T1, T2, K):
    """F12 such that x2ᵀ F12 x1 = 0 (reference: LocalMapping.cc:536-553),
    for one T1 against a batch of T2 (..., 3, 4)."""
    T12 = se3.compose(T2, se3.inverse(T1))
    R, t = se3.rotation(T12), se3.translation(T12)
    zero = torch.zeros_like(t[..., 0])
    tx = torch.stack(
        [
            torch.stack([zero, -t[..., 2], t[..., 1]], -1),
            torch.stack([t[..., 2], zero, -t[..., 0]], -1),
            torch.stack([-t[..., 1], t[..., 0], zero], -1),
        ],
        -2,
    )
    Km = torch.eye(3, dtype=T1.dtype, device=T1.device)
    Km[0, 0], Km[1, 1], Km[0, 2], Km[1, 2] = K[0], K[1], K[2], K[3]
    Kinv = torch.linalg.inv_ex(Km)[0]
    return Kinv.T @ tx @ R @ Kinv


def _compact(keep: torch.Tensor, k: int) -> torch.Tensor:
    """Row indices with `keep` first (stable, as jnp.argsort(~keep)),
    cut to k per row."""
    return torch.argsort((~keep).to(torch.uint8), dim=-1, stable=True)[..., :k]


def _triangulate_pairs_batch(cfg: SlamConfig, k1: int, ks, free1, free2s, pair_valid,
                             KF_pose, KF_xy, KF_octave, KF_desc, K, sigma2):
    """Epipolar match + ray triangulation + acceptance gates for ALL
    covisible neighbour pairs at once (reference: LocalMapping.cc:207-452
    loops neighbours; here the pair axis is a batch dimension).

    Gates: reprojection at 5.991 sigma2 (:363-393), scale consistency
    within 1.5 scaleFactor (:395-431), parallax cos < 0.99939 (~2 deg)."""
    sf = cfg.orb.scale_factor
    rf = 1.5 * sf
    T1, xy1, oct1, desc1 = KF_pose[k1], KF_xy[k1], KF_octave[k1], KF_desc[k1]
    c1 = se3.translation(se3.inverse(T1))
    s1 = sigma2[oct1.long()]
    ksl = ks.long()
    T2, xy2, oct2, desc2 = KF_pose[ksl], KF_xy[ksl], KF_octave[ksl], KF_desc[ksl]
    F12 = _fundamental_from_poses(T1, T2, K)  # (P, 3, 3)
    emask = match.epipolar_mask(F12, xy1, xy2, sigma2, oct2)
    # Octave agreement +-2 (see the JAX package).
    oct_ok = (oct1[:, None] - oct2[:, None, :]).abs() <= 2
    m = match.match(
        desc1, desc2, free1 & pair_valid[:, None], free2s,
        pair_mask=emask & oct_ok, max_dist=cfg.matcher.th_low,
        nn_ratio=cfg.matcher.nn_ratio_mapping,
    )
    mi = m.idx.long()
    uv2 = xy2.gather(1, mi[..., None].expand(-1, -1, 2))
    o2 = oct2.gather(1, mi)
    xw, cos_par = triangulate.triangulate_rays(xy1, uv2, T1, T2, K, K)
    z1 = triangulate.depth_in(T1, xw)
    z2 = triangulate.depth_in(T2, xw)
    e1 = ((camera.project(se3.apply(T1, xw), K) - xy1) ** 2).sum(-1)
    e2 = ((camera.project(se3.apply(T2, xw), K) - uv2) ** 2).sum(-1)
    s2 = sigma2[o2.long()]
    c2 = se3.translation(se3.inverse(T2)).unsqueeze(-2)
    d1 = torch.linalg.vector_norm(xw - c1, dim=-1)
    d2 = torch.linalg.vector_norm(xw - c2, dim=-1)
    ratio_dist = d2 / torch.clamp(d1, min=1e-9)
    ratio_oct = sf ** oct1.to(torch.float32) / sf ** o2.to(torch.float32)
    good = (
        m.valid
        & (cos_par < 0.99939)
        & (z1 > 0) & (z2 > 0)
        & (e1 < 5.991 * s1) & (e2 < 5.991 * s2)
        & (ratio_dist * rf > ratio_oct) & (ratio_dist < ratio_oct * rf)
    )
    # Compact: surviving candidates first, so the readback is K rows per
    # pair; n_good rides along to count survivors the cap drops.
    order = _compact(good, TRI_COMPACT_K)
    return (
        order.to(torch.int32),
        m.idx.gather(1, order),
        good.gather(1, order),
        xw.gather(1, order[..., None].expand(-1, -1, 3)),
        good.sum(-1, dtype=torch.int32),
    )


def _fuse_pairs_batch(cfg: SlamConfig, dsts, pts_idx, KF_pose, KF_xy, KF_octave,
                      KF_desc, KF_kp_valid, PT_xyz, PT_normal, PT_mind, PT_maxd,
                      PT_desc, PT_valid, K, sf):
    """Frustum + projection-guided fuse matching for ALL (src->dst) pairs
    in one batch (reference: ORBmatcher.cc:825-975 Fuse, per neighbour
    from LocalMapping::SearchInNeighbors :454-534): one window_top2
    launch searches every pair."""
    d = dsts.long()
    T, xy, octv, desc, kp_valid = KF_pose[d], KF_xy[d], KF_octave[d], KF_desc[d], KF_kp_valid[d]
    safe = torch.clamp(pts_idx, min=0).long()
    pmask = (pts_idx >= 0) & PT_valid[safe]
    in_view, uv, octave, _ = frustum_check(
        T, PT_xyz[safe], PT_normal[safe], PT_mind[safe], PT_maxd[safe], pmask, K,
        img_w=cfg.camera.width, img_h=cfg.camera.height,
        log_scale=float(np.log(cfg.orb.scale_factor)), n_levels=cfg.orb.n_levels,
    )
    # Radius 4 (reference 3) and octave gate [-3, +2] (reference [-1, +1]):
    # see the JAX package's _local_map_step.
    m = match.search_by_projection(
        uv, 4.0 * sf[octave.long()], PT_desc[safe], in_view,
        xy, octv, desc, kp_valid,
        torch.clamp(octave - 3, min=0), torch.clamp(octave + 2, max=cfg.orb.n_levels - 1),
        max_dist=cfg.matcher.th_low, nn_ratio=1.0,
    )
    order = _compact(m.valid, FUSE_COMPACT_K)
    return (
        order.to(torch.int32), m.idx.gather(1, order), m.valid.gather(1, order),
        m.valid.sum(-1, dtype=torch.int32),
    )


def local_ba_options(cfg: SlamConfig) -> dict:
    """The solver options of a local BA: LM iterations of its two stages,
    robust thresholds, dense Schur."""
    opt = cfg.optimizer
    return dict(iters_first=opt.local_ba_its_first, iters_second=opt.local_ba_its_second,
                chi2_mono=opt.chi2_mono, chi2_stereo=opt.chi2_stereo,
                pcg_iters=opt.pcg_iters, schur="dense")


class LocalMapping:
    def __init__(self, cfg: SlamConfig, mapstate: MapState, device: torch.device, mesh: Mesh):
        self.cfg = cfg
        self.map = mapstate
        self.device = torch.device(device)
        self.mesh = mesh  # more than one shard: full-bucket local BAs through parallel/dba
        self.recent_points: list[tuple[int, int]] = []  # (pt, born_serial)
        self.K = camera.intrinsics_array(cfg.camera, self.device)
        self.sigma2 = np.asarray(cfg.orb.level_sigma2(), np.float32)
        self.sf = np.asarray(cfg.orb.scale_factors(), np.float32)
        self._sigma2_dev = to_device(self.device, self.sigma2)
        self._sf_dev = to_device(self.device, self.sf)
        # Apply halves run on a fixed schedule, so that mapping progress
        # never depends on when a readback lands. On the CPU each defers
        # exactly one frame (NOT_READY), the JAX package's CPU rule
        # (mapping.py:275-282 there), which the CPU tests hold the port
        # to; on a card each waits for its readback in the frame of its
        # dispatch. The JAX package's accelerators poll the readback
        # instead: polled on the H100, whether a thin frame found the
        # mapper behind followed the host's load, and 2 of 28 monocular
        # benchmark records failed their ATE gate; the CPU's one-frame
        # defer on the card mapped too slowly for the stereo orbit
        # (chip_smoke phase 7 at 0.96 m against 0.4) (PERF.md §6).
        self._defer = self.device.type == "cpu"
        self.queue: list[int] = []
        self._stages: list = []
        self.on_keyframe_done = None  # callback(kf) -> feeds LoopClosing
        self.metrics = None  # optional Metrics registry (set by System)
        # Set by LoopClosing for the staged-correction window: keyframes
        # queue but no stage runs, so the map topology is frozen while
        # the essential graph solves (reference: RequestStop/Release,
        # LoopClosing.cc:408,582).
        self.paused = False
        self._pending_tri = self._pending_fuse = self._pending_ba = None
        self._waits = {"tri": 0, "fuse": 0, "ba": 0}
        self.n_local_ba = 0  # local BA solves applied
        self.ba_routes = {"ba.bundle_adjust": 0, "dba": 0}  # solves dispatched, by route

    # ------------------------------------------------------------------
    def warm_programs(self):
        """Run local BA once at both problem sizes _ba_dispatch uses, so
        their first-call costs (allocator growth, library handles) land at
        start-up instead of on a mid-sequence frame."""
        cap = self.cfg.capacity
        dev = self.device
        for small, (C, P, O) in (
            (True, (16, 2048, 4096)),
            (False, (cap.local_ba_max_kfs * 2, cap.local_ba_max_points, cap.local_ba_max_obs)),
        ):
            cam_fixed = torch.zeros(C, dtype=torch.bool, device=dev)
            cam_fixed[0] = True
            cam_valid = torch.zeros(C, dtype=torch.bool, device=dev)
            cam_valid[:2] = True
            point_valid = torch.zeros(P, dtype=torch.bool, device=dev)
            point_valid[:4] = True
            obs_valid = torch.zeros(O, dtype=torch.bool, device=dev)
            obs_valid[:8] = True
            prob = ba.BAProblem(
                cam_T=torch.eye(3, 4, device=dev).repeat(C, 1, 1),
                cam_fixed=cam_fixed, cam_valid=cam_valid,
                points=torch.tensor([0.0, 0.0, 5.0], device=dev).repeat(P, 1),
                point_valid=point_valid,
                obs_cam=torch.zeros(O, dtype=torch.int32, device=dev),
                obs_pt=torch.zeros(O, dtype=torch.int32, device=dev),
                obs_uv=torch.zeros(O, 3, device=dev),
                obs_stereo=torch.zeros(O, dtype=torch.bool, device=dev),
                obs_inv_sigma2=torch.ones(O, device=dev),
                obs_valid=obs_valid, K=self.K,
                bf=torch.tensor(float(self.cfg.camera.bf), device=dev),
            )
            self._solve_local_ba(prob, small, O)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def insert_keyframe(self, kf: int):
        """Enqueue a keyframe for mapping (LocalMapping.cc:114-119)."""
        self.queue.append(kf)

    def idle(self) -> bool:
        return not self.queue and not self._stages

    def queue_len(self) -> int:
        return len(self.queue) + (1 if self._stages else 0)

    def step(self):
        """Run mapping stages under a per-frame budget of _STAGE_BUDGET
        stages, scaled with queue depth. The JAX package counts stages on
        the CPU only and gives an accelerator 6 ms of wall clock a frame.
        The port's frame is bound by the host on the GPU as well, and 6
        ms of its 300 ms frame admits one stage: on the H100 the mapper
        then fell behind by a share that followed the host's load, and
        the 240-frame stereo orbit ended between 0.05 m ATE and a lost
        track from one run to the next; counted in stages it mapped twice
        the keyframes in the same ms/frame and ended at 0.01-0.04 m
        (PERF.md §6)."""
        if self.paused:
            return
        stage_budget = _STAGE_BUDGET * (1 + len(self.queue))
        n_stages = 0
        while True:
            if not self._stages:
                if not self.queue:
                    return
                self._stages = self._stages_of(self.queue.pop(0))
            name, fn = self._stages[0]
            if self.metrics is not None:
                with self.metrics.stage("map." + name):
                    r = fn()
            else:
                r = fn()
            if r is NOT_READY:
                return
            self._stages.pop(0)
            n_stages += 1
            if n_stages >= stage_budget:
                return

    def _stages_of(self, kf: int) -> list:
        """The mapping pass of one keyframe as (name, stage) pairs, in the
        reference's Run order (LocalMapping.cc:62-87); each batched stage
        is a dispatch half and an apply half."""
        return [
            ("cull_pts", lambda: self._cull_recent_points(kf)),
            ("tri_dispatch", lambda: self._triangulate_dispatch(kf)),
            ("tri_apply", self._triangulate_apply),
            ("fuse_dispatch", lambda: self._fuse_dispatch(kf)),
            ("fuse_apply", self._fuse_apply),
            ("ba_dispatch", lambda: self._ba_dispatch_if_ready(kf)),
            ("ba_apply", self._ba_apply),
            ("finish_kf", lambda: self._finish_keyframe(kf)),
        ]

    def process_keyframe(self, kf: int):
        """Full synchronous mapping pass for one keyframe (JAX
        mapping.py:447-468): cull recent points, create new points, fuse
        neighbours, local BA when more than 2 keyframes are live, finish
        the keyframe. The same stages as the pipelined step(), each apply
        half run to completion at once (an apply that reports NOT_READY is
        retried until its readback lands). For tests, drains and offline
        use."""
        for _, stage in self._stages_of(kf):
            while stage() is NOT_READY:
                pass

    def drain(self):
        """Run the pipeline to empty (shutdown/reset/loop-closing barrier).
        A no-op while paused: the correction window owns the map."""
        while not self.paused and (self.queue or self._stages):
            self.step()

    def _ba_dispatch_if_ready(self, kf: int):
        if len(self.map.live_keyframes()) > 2:
            self._ba_dispatch(kf)

    def _finish_keyframe(self, kf: int):
        self._cull_keyframes(kf)
        self.map.big_change_idx += 1
        if self.on_keyframe_done is not None and self.map.kf_valid[kf]:
            self.on_keyframe_done(kf)

    def _not_ready(self, stage: str) -> bool:
        """Whether an apply half defers to the next frame: on the CPU
        once, the frame of its dispatch; on a card never (its readback
        is waited for)."""
        if self._defer and self._waits[stage] < 1:
            self._waits[stage] += 1
            return True
        self._waits[stage] = 0
        return False

    # ------------------------------------------------------------------
    def _cull_recent_points(self, kf: int):
        """Found-ratio and observation-count gates (LocalMapping.cc:170-205)."""
        keep = []
        serial_now = int(self.map.kf_serial[kf])
        min_obs = 2 if self.cfg.sensor == Sensor.MONOCULAR else 3
        for pt, born in self.recent_points:
            if not self.map.pt_valid[pt]:
                continue
            age = serial_now - born
            found_ratio = self.map.pt_found[pt] / max(self.map.pt_visible[pt], 1)
            if found_ratio < self.cfg.mapping.min_found_ratio:
                self.map.erase_point(pt)
            elif age >= 2 and self.map.pt_n_obs[pt] <= min_obs:
                self.map.erase_point(pt)
            elif age < 3:
                keep.append((pt, born))
        self.recent_points = keep

    # ------------------------------------------------------------------
    def _triangulate_dispatch(self, kf: int):
        self._pending_tri = None
        n_neigh = (
            self.cfg.mapping.triangulation_neighbors_mono
            if self.cfg.sensor == Sensor.MONOCULAR
            else self.cfg.mapping.triangulation_neighbors_stereo
        )
        mp = self.map
        neighbors = mp.covisible_keyframes(kf, n=n_neigh, min_weight=1)
        c1 = mp.keyframe_center(kf)
        med_depth = self._median_depth(kf)
        k2s = []
        for k2 in neighbors:
            baseline = float(np.linalg.norm(mp.keyframe_center(k2) - c1))
            if self.cfg.sensor == Sensor.MONOCULAR:
                # Baseline/scene-depth ratio (LocalMapping.cc:246-254).
                if med_depth > 0 and baseline / med_depth < 0.01:
                    continue
            elif baseline < self.cfg.camera.baseline:
                continue
            k2s.append(k2)
        if not k2s:
            return
        free1 = mp.kf_kp_valid[kf] & (mp.kf_mp[kf] < 0)
        if free1.sum() < 5:
            return
        # One batch row per neighbour (the JAX package pads the batch to
        # n_neigh rows, a static-shape padding whose rows are masked).
        ks = k2s
        free2 = mp.kf_kp_valid[ks] & (mp.kf_mp[ks] < 0)
        pair_valid = free2.sum(axis=1) >= 5
        if not pair_valid.any():
            return
        dev = mp.device
        dev.flush()
        ks_d, free1_d, free2_d, pv_d = to_device(
            self.device, np.asarray(ks, np.int32), free1, free2, pair_valid
        )
        result = _triangulate_pairs_batch(
            self.cfg, kf, ks_d, free1_d, free2_d, pv_d,
            dev.kf_pose, dev.kf_xy, dev.kf_octave, dev.kf_desc, self.K, self._sigma2_dev,
        )
        self._pending_tri = (kf, ks, k2s, pair_valid, fetch_async(*result))

    def _triangulate_apply(self):
        if self._pending_tri is None:
            return
        if self._not_ready("tri"):
            return NOT_READY
        k1, ks, k2s, pair_valid, fut = self._pending_tri
        self._pending_tri = None
        mp = self.map
        src1, idx2, good, xw, n_good = fut.result()  # (P,K) x4 + (P,)
        dropped = int(np.maximum(n_good[pair_valid] - good.shape[1], 0).sum())
        if dropped and self.metrics is not None:
            self.metrics.count("tri_compact_dropped", dropped)
        k2_arr = np.asarray(ks, np.int64)
        ok = good & pair_valid[:, None]
        # Conflict gates against current map state.
        ok &= mp.kf_mp[k1, src1] < 0
        ok &= mp.kf_mp[k2_arr[:, None], idx2] < 0
        pi_f, j_f = np.nonzero(ok)
        i_f = src1[pi_f, j_f]
        # First winner per k1-feature across pairs (covisibility order).
        _, first = np.unique(i_f, return_index=True)
        first = np.sort(first)
        pi_f, j_f, i_f = pi_f[first], j_f[first], i_f[first]
        k2_f = k2_arr[pi_f]
        if len(i_f):
            new_idx = mp.add_points_batch(xw[pi_f, j_f], mp.kf_desc[k1][i_f], k1)
            j2 = idx2[pi_f, j_f]
            mp.pt_obs_kf[new_idx, 0] = k1
            mp.pt_obs_feat[new_idx, 0] = i_f
            mp.pt_obs_kf[new_idx, 1] = k2_f
            mp.pt_obs_feat[new_idx, 1] = j2
            mp.pt_n_obs[new_idx] = 2
            mp.kf_mp[k1, i_f] = new_idx
            mp.kf_mp[k2_f, j2] = new_idx
            mp.update_points_batch(new_idx)
            born = int(mp.kf_serial[k1])
            self.recent_points.extend((int(p), born) for p in new_idx)
            mp.update_connections(k1)
            for k2 in set(k2s):
                mp.update_connections(k2)

    def _median_depth(self, kf: int) -> float:
        mp = self.map.kf_mp[kf]
        pts = mp[mp >= 0]
        if len(pts) == 0:
            return -1.0
        T = self.map.kf_pose[kf]
        return float(np.median(self.map.pt_xyz[pts] @ T[2, :3] + T[2, 3]))

    # ------------------------------------------------------------------
    def _fuse_dispatch(self, kf: int):
        self._pending_fuse = None
        mp = self.map
        neighbors = mp.covisible_keyframes(kf, n=10, min_weight=15)
        ring = set(neighbors)
        for k in list(neighbors)[:5]:
            for k2 in mp.covisible_keyframes(k, n=5, min_weight=15):
                if k2 != kf:
                    ring.add(k2)
        if not ring:
            return
        pairs = []
        for k2 in sorted(ring):
            pairs.append((kf, k2))  # kf's points into k2
            pairs.append((k2, kf))  # k2's points into kf
        cap = mp.kf_mp.shape[1]
        live_pairs, pts_per_pair = [], []
        for src, dst in pairs:
            src_pts = mp.kf_mp[src]
            has = src_pts >= 0
            if not has.any():
                continue
            pts_live = np.unique(src_pts[has])
            pts_live = pts_live[mp.pt_valid[pts_live]]
            if len(pts_live) == 0:
                continue
            pts = np.full(cap, -1, np.int64)
            pts[: len(pts_live)] = pts_live[:cap]
            live_pairs.append((src, dst))
            pts_per_pair.append(pts)
        if not live_pairs:
            return
        # At most fuse_max_pairs pairs; pairs beyond it are dropped (the
        # strongest, in covisibility order, survive). The batch holds the
        # live pairs only: the JAX package pads it to the cap, a
        # static-shape padding whose rows are all masked.
        P = self.cfg.capacity.fuse_max_pairs
        if len(live_pairs) > P:
            if self.metrics is not None:
                self.metrics.count("fuse_pairs_dropped", len(live_pairs) - P)
            live_pairs, pts_per_pair = live_pairs[:P], pts_per_pair[:P]
        pts_arr = np.stack(pts_per_pair)  # (len(live_pairs), cap)
        dev = mp.device
        dev.flush()
        dsts_d, pts_idx_d = to_device(
            self.device, np.asarray([d for _, d in live_pairs], np.int32), pts_arr.astype(np.int32)
        )
        result = _fuse_pairs_batch(
            self.cfg, dsts_d, pts_idx_d,
            dev.kf_pose, dev.kf_xy, dev.kf_octave, dev.kf_desc, dev.kf_kp_valid,
            dev.pt_xyz, dev.pt_normal, dev.pt_min_dist, dev.pt_max_dist,
            dev.pt_desc, dev.pt_valid, self.K, self._sf_dev,
        )
        self._pending_fuse = (kf, live_pairs, pts_arr, fetch_async(*result))

    def _fuse_apply(self):
        if self._pending_fuse is None:
            return
        if self._not_ready("fuse"):
            return NOT_READY
        kf, live_pairs, pts_arr, fut = self._pending_fuse
        self._pending_fuse = None
        mp = self.map
        src_rows, m_idx, m_valid, n_valid = fut.result()
        dropped = int(np.maximum(n_valid - m_valid.shape[1], 0).sum())
        if dropped and self.metrics is not None:
            self.metrics.count("fuse_compact_dropped", dropped)
        for pi, (_, dst) in enumerate(live_pairs):
            pts = pts_arr[pi]
            rows = src_rows[pi]
            sel = np.nonzero(m_valid[pi] & (pts[rows] >= 0))[0]
            if len(sel) == 0:
                continue
            p_sel = pts[rows[sel]]
            f_sel = m_idx[pi][sel].astype(np.int64)
            alive = mp.pt_valid[p_sel]  # not merged away by an earlier pair
            p_sel, f_sel = p_sel[alive], f_sel[alive]
            existing = mp.kf_mp[dst, f_sel]
            ex_live = (existing >= 0) & mp.pt_valid[np.maximum(existing, 0)]
            # Plain additions, deduped within the batch (first wins, like
            # the sequential reference loop ORBmatcher.cc:952-971).
            add_p, add_f = p_sel[~ex_live], f_sel[~ex_live]
            _, first = np.unique(add_p, return_index=True)
            first = np.sort(first)
            mp.add_observations_batch(add_p[first], dst, add_f[first])
            # Conflicts: merge keeping the better-observed point.
            for p, ex in zip(p_sel[ex_live], existing[ex_live]):
                p, ex = int(p), int(ex)
                if p == ex or not mp.pt_valid[p] or not mp.pt_valid[ex]:
                    continue
                if mp.pt_n_obs[ex] >= mp.pt_n_obs[p]:
                    mp.replace_point(p, ex)
                else:
                    mp.replace_point(ex, p)
        mp.update_connections(kf)

    # ------------------------------------------------------------------
    def _ba_dispatch(self, kf: int):
        """Windowed BA on the covisibility neighbourhood (reference:
        Optimizer.cc:453-778 LocalBundleAdjustment)."""
        self._pending_ba = None
        mp = self.map
        cap = self.cfg.capacity
        local = [kf] + mp.covisible_keyframes(kf, n=cap.local_ba_max_kfs - 1, min_weight=1)
        local = local[: cap.local_ba_max_kfs]
        local_set = set(local)
        pts = set()
        for k in local:
            col = mp.kf_mp[k]
            pts.update(col[col >= 0].tolist())
        pts = np.asarray(sorted(pts), np.int64)
        if len(pts):
            pts = pts[mp.pt_valid[pts]]
        pts = pts[: cap.local_ba_max_points]
        # Fixed frontier: keyframes observing local points but not local.
        if len(pts):
            okf = mp.pt_obs_kf[pts]
            is_local = np.zeros(mp.kf_pose.shape[0] + 1, bool)
            is_local[list(local_set)] = True
            frontier = np.unique(okf[(okf >= 0) & ~is_local[okf]]).tolist()
        else:
            frontier = []
        cams = (local + sorted(frontier))[: cap.local_ba_max_kfs * 2]
        cam_slot = {k: i for i, k in enumerate(cams)}
        # Two problem sizes (small / full), as the JAX package's buckets.
        n_obs_est = int(np.count_nonzero(mp.pt_obs_kf[pts] >= 0)) if len(pts) else 0
        small = len(cams) <= 16 and len(pts) <= 2048 and n_obs_est <= 4096
        if small:
            C, P, O = 16, 2048, 4096
        else:
            C, P, O = cap.local_ba_max_kfs * 2, cap.local_ba_max_points, cap.local_ba_max_obs

        cam_T = np.tile(np.eye(3, 4, dtype=np.float32), (C, 1, 1))
        cam_fixed = np.ones(C, bool)
        cam_valid = np.zeros(C, bool)
        for k, i in cam_slot.items():
            cam_T[i] = mp.kf_pose[k]
            cam_valid[i] = True
            cam_fixed[i] = k not in local_set
        # Gauge: with no frontier, fix the oldest local keyframe (by serial).
        if len(frontier) == 0 and len(local) > 0:
            by_age = sorted(local, key=lambda k: mp.kf_serial[k])
            cam_fixed[cam_slot[by_age[0]]] = True
            if self.cfg.sensor == Sensor.MONOCULAR and len(local) > 1:
                cam_fixed[cam_slot[by_age[1]]] = True

        points = np.zeros((P, 3), np.float32)
        point_valid = np.zeros(P, bool)
        points[: len(pts)] = mp.pt_xyz[pts]
        point_valid[: len(pts)] = True

        inv_sigma2 = 1.0 / self.sigma2
        obs_kf_all = mp.pt_obs_kf[pts]
        obs_feat_all = mp.pt_obs_feat[pts]
        slot_of_kf = np.full(mp.kf_pose.shape[0], -1, np.int32)
        for k, i in cam_slot.items():
            slot_of_kf[k] = i
        ci_all = np.where(obs_kf_all >= 0, slot_of_kf[obs_kf_all], -1)
        keep = ci_all >= 0
        si_all = np.broadcast_to(np.arange(len(pts), dtype=np.int32)[:, None], keep.shape)
        sel_p, sel_o = np.nonzero(keep)
        sel_p, sel_o = sel_p[:O], sel_o[:O]
        n_obs = len(sel_p)
        kfs_sel = obs_kf_all[sel_p, sel_o]
        feats_sel = obs_feat_all[sel_p, sel_o]

        obs_cam = np.zeros(O, np.int32)
        obs_pt = np.zeros(O, np.int32)
        obs_uv = np.zeros((O, 3), np.float32)
        obs_stereo = np.zeros(O, bool)
        obs_isig = np.ones(O, np.float32)
        obs_valid = np.zeros(O, bool)
        obs_cam[:n_obs] = ci_all[sel_p, sel_o]
        obs_pt[:n_obs] = si_all[sel_p, sel_o]
        ur_sel = mp.kf_ur[kfs_sel, feats_sel]
        stereo_sel = ur_sel > 0
        obs_uv[:n_obs, :2] = mp.kf_xy[kfs_sel, feats_sel]
        obs_uv[:n_obs, 2] = np.where(stereo_sel, ur_sel, 0.0)
        obs_stereo[:n_obs] = stereo_sel
        obs_isig[:n_obs] = inv_sigma2[mp.kf_octave[kfs_sel, feats_sel]]
        obs_valid[:n_obs] = True

        up = to_device(
            self.device, cam_T, cam_fixed, cam_valid, points, point_valid, obs_cam,
            obs_pt, obs_uv, obs_stereo, obs_isig, obs_valid, np.float32(self.cfg.camera.bf),
        )
        problem = ba.BAProblem(*up[:11], K=self.K, bf=up[11])
        result = self._solve_local_ba(problem, small, O)
        fut = fetch_async(result.cam_T, result.points, result.obs_inlier)
        self._pending_ba = (cam_slot, cam_fixed, pts, n_obs, obs_pt, obs_valid, kfs_sel, fut)

    def _solve_local_ba(self, problem: ba.BAProblem, small: bool, O: int) -> ba.BAResult:
        """Dispatch the local BA solve, dense Schur: the one routing point
        of _ba_dispatch and warm_programs (JAX mapping.py:899-934). A
        full-bucket window on a mesh of more than one shard goes through
        parallel/dba with its observations sharded; small buckets stay on
        one device (sharding a tiny problem costs more in collectives than
        it saves). A failure on the sharded route raises."""
        kw = local_ba_options(self.cfg)
        if not small and self.mesh.size > 1:
            self.ba_routes["dba"] += 1
            result = dba.distributed_bundle_adjust(
                dba.pad_observations(problem, self.mesh.size), self.mesh, **kw)
            # The padding is appended: slice it off, so the apply side
            # indexes observations as before.
            return result._replace(obs_inlier=result.obs_inlier[:O])
        self.ba_routes["ba.bundle_adjust"] += 1
        return ba.bundle_adjust(problem, **kw)

    def _ba_apply(self):
        if self._pending_ba is None:
            return
        if self._not_ready("ba"):
            return NOT_READY
        cam_slot, cam_fixed, pts, n_obs, obs_pt, obs_valid, kfs_sel, fut = self._pending_ba
        self._pending_ba = None
        mp = self.map
        new_T, new_pts, inlier = fut.result()
        self.n_local_ba += 1
        moved = [k for k, i in cam_slot.items() if not cam_fixed[i]]
        for k in moved:
            mp.kf_pose[k] = new_T[cam_slot[k]]
        mp.pt_xyz[pts] = new_pts[: len(pts)]
        mp.mark_kf_pose_dirty(moved)
        mp.mark_points_dirty(pts)
        # Erase outlier observations (reference: Optimizer.cc:745-757).
        for oi in np.nonzero(~inlier[:n_obs] & obs_valid[:n_obs])[0]:
            p = int(pts[obs_pt[oi]])
            if not mp.pt_valid[p]:
                continue
            mp.erase_observation(p, int(kfs_sel[oi]))
            if mp.pt_n_obs[p] <= 1:
                mp.erase_point(p)

    # ------------------------------------------------------------------
    def _cull_keyframes(self, kf: int):
        """Cull local keyframes whose points are >=90% seen by at least 3
        other keyframes at the same or finer scale (LocalMapping.cc:
        632-696); never the origin, the newest window or more than 2 per
        pass."""
        mp = self.map
        culled = 0
        for k in mp.covisible_keyframes(kf, n=20, min_weight=1):
            if mp.kf_serial[k] == 0 or k == kf or not mp.kf_valid[k] or culled >= 2:
                continue
            if mp.kf_serial[kf] - mp.kf_serial[k] < 3:
                continue
            col = mp.kf_mp[k]
            feats = np.nonzero(col >= 0)[0]
            p = col[feats]
            alive = mp.pt_valid[p]
            p, feats = p[alive], feats[alive]
            total = len(p)
            redundant = 0
            if total:
                scale_k = mp.kf_octave[k, feats]
                obs_kf = mp.pt_obs_kf[p]
                obs_oct = mp.kf_octave[np.maximum(obs_kf, 0), np.maximum(mp.pt_obs_feat[p], 0)]
                seen = (obs_kf >= 0) & (obs_kf != k) & (obs_oct <= scale_k[:, None] + 1)
                redundant = int((seen.sum(axis=1) >= self.cfg.mapping.kf_cull_min_obs).sum())
            if total > 0 and redundant > self.cfg.mapping.kf_cull_redundancy * total:
                mp.erase_keyframe(k)
                culled += 1
