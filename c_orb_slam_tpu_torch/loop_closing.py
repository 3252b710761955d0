"""Loop closing: detection, Sim(3) computation, correction, pose graph, GBA.

Counterpart of c_orb_slam_tpu/loop_closing.py (reference:
src/LoopClosing.cc — a persistent thread consuming keyframes (Run :57-88):
DetectLoop (:103-229, BoW candidates with min-score from covisible KFs
:121-138, consecutive-consistency groups th=3 :152-211, 10-KF dead time
:114), ComputeSim3 (:231-400: SearchByBoW >=20 -> Sim3Solver RANSAC ->
SearchBySim3 -> OptimizeSim3 >=20 -> projection widening, accept >=40),
CorrectLoop (:402-585: stop mapping, propagate corrected Sim3 to the
covisibility group :447-516, fuse duplicates :518-542,
OptimizeEssentialGraph :567, spawn GlobalBundleAdjustment thread :579)).

A stage invoked by the host loop after local mapping: stages instead of
threads, and GBA's abort flag becomes a bounded iteration budget.
Candidate scoring is one batched BoW gather over all keyframes
(bow/database.py); Sim3 RANSAC evaluates every hypothesis in one batched
pass (ops/sim3solve.py); the essential graph is a Sim3 pose-graph GN with
implicit PCG (optim/pose_graph.py). One chunk of device work is queued
per tracked frame and read back through utils/host.fetch_async.

On a mesh of more than one shard (parallel/mesh.py), as the JAX package
at more than one device: the essential graph's edges are sharded
(parallel/dpose_graph) and the global BA's map (parallel/sharded_ba,
``_ShardedGbaJob``). Both stay chunked one iteration per tracked frame,
as on one device (the JAX package dispatches each sharded solve at once).
Match and point lists are not padded to power-of-two sizes: every padded
row was masked out, so no result depended on the padded shape.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from c_orb_slam_tpu_torch.bow import vocab as vocab_mod
from c_orb_slam_tpu_torch.bow.database import (
    KeyFrameDatabase, aggregate_bow, aggregate_bow_dev,
)
from c_orb_slam_tpu_torch.config import SlamConfig, Sensor
from c_orb_slam_tpu_torch.geometry import camera, np_se3, se3, sim3
from c_orb_slam_tpu_torch.ops import match, sim3solve
from c_orb_slam_tpu_torch.optim import ba as ba_mod
from c_orb_slam_tpu_torch.optim import pose_graph, sim3_opt
from c_orb_slam_tpu_torch.parallel import dpose_graph, sharded_ba
from c_orb_slam_tpu_torch.parallel.mesh import Mesh
from c_orb_slam_tpu_torch.slam_map.mapstate import MapState
from c_orb_slam_tpu_torch.utils.host import fetch, fetch_async, to_device

_DEBUG = bool(os.environ.get("SLAM_DEBUG"))


def _dbg(*args):
    if _DEBUG:
        print("[loop]", *args)


def _propagate_program(kf_pose_all, pt_xyz_all, S_cl, loop_kf, kf, g_idx,
                       owner_idx, sel_idx):
    """The whole Sim3 propagation block as one run of device work
    (reference: the mMutexMapUpdate-held block of CorrectLoop,
    LoopClosing.cc:443-516). kf_pose_all / pt_xyz_all are the
    device-resident map mirror (slam_map/devicemap.py): the host uploads
    only index arrays.

    Returns (S_all, S_g_corr, T_g_new, x_new, S_cw_corr): the full
    pre-correction Sim3 snapshot, corrected group Sim3 poses, their SE3
    forms, moved owned-point positions, and the corrected current pose.
    """
    sel_xyz = pt_xyz_all[sel_idx]
    S_all = sim3.from_se3(kf_pose_all)  # (Nk, 8) pre-correction snapshot
    S_lw = S_all[loop_kf]
    # Corrected Sim3 pose of the current KF: S_cw = S_cl ∘ S_lw
    # (reference: mg2oScw = gScm * gSmw, LoopClosing.cc:234-239).
    S_cw_corr = sim3.compose(S_cl, S_lw)
    S_g_old = S_all[g_idx]  # (G, 8)
    S_cur_old = S_all[kf]
    S_gc = sim3.compose(S_g_old, sim3.inverse(S_cur_old)[None])
    S_g_corr = sim3.compose(S_gc, S_cw_corr[None])
    # Owned points move with their owner keyframe's correction:
    # x' = S_corr^-1 (S_old x).
    x_old = sim3.apply(S_g_old[owner_idx], sel_xyz)
    x_new = sim3.apply(sim3.inverse(S_g_corr)[owner_idx], x_old)
    T_g_new = sim3.to_se3(S_g_corr)
    return S_all, S_g_corr, T_g_new, x_new, S_cw_corr


_FUSE_BLOCK = 4  # keyframes matched per fused-projection block


def _fuse_block_program(kf_pose_all, kf_desc_all, kf_valid_all, kf_xy_all,
                        pt_xyz_all, pt_desc_all, pt_valid_all,
                        gb, pts_idx, pts_mask, K, max_dist):
    """Guided projection match of the loop-neighborhood points into a
    BLOCK of corrected keyframes (reference: the SearchAndFuse projection
    per corrected KF, LoopClosing.cc:587-613 / ORBmatcher.cc:977-1100),
    batched over the block, over the device-resident map mirror."""
    xyz = pt_xyz_all[pts_idx]
    desc = pt_desc_all[pts_idx]
    pmask = pt_valid_all[pts_idx] & pts_mask
    T = kf_pose_all[gb]  # (B, 3, 4)
    xc = se3.apply(T, xyz.expand(T.shape[0], *xyz.shape))  # (B, P, 3)
    uv = camera.project(xc, K)
    radii = torch.full(xc.shape[:2], 8.0, dtype=torch.float32, device=xyz.device)
    m = match.match(
        desc.expand(T.shape[0], *desc.shape), kf_desc_all[gb],
        (xc[..., 2] > 0) & pmask, kf_valid_all[gb],
        pair_mask=match.window_mask(uv, radii, kf_xy_all[gb]),
        max_dist=max_dist, nn_ratio=1.0,
    )
    return m.idx, m.valid


def _sim3_widen_program(kf_pose_all, kf_desc_all, kf_valid_all, kf_xy_all,
                        pt_xyz_all, pt_desc_all,
                        S12, kf1, kf2, p1, v1, p2, v2, K, max_dist):
    """Bidirectional Sim3-guided projection match between the two loop
    keyframes' map points (reference: ORBmatcher::SearchBySim3,
    ORBmatcher.cc:1102-1326, called between the Sim3 RANSAC and
    OptimizeSim3 at LoopClosing.cc:323-326). p1/p2 are indexed by
    FEATURE slot: row f holds the map point attached to feature f; the
    big arrays are the device-resident map mirror.

    Forward: kf2's points through S12 into kf1's image, matched against
    kf1's feature descriptors in a projection window; backward through
    S12^-1 likewise. The host keeps only pairs that agree both ways
    (reference :1307-1323)."""
    T1 = kf_pose_all[kf1]
    T2 = kf_pose_all[kf2]
    xyz1, d1 = pt_xyz_all[p1], pt_desc_all[p1]
    xyz2, d2 = pt_xyz_all[p2], pt_desc_all[p2]
    desc_f1, vf1, xy_f1 = kf_desc_all[kf1], kf_valid_all[kf1], kf_xy_all[kf1]
    desc_f2, vf2, xy_f2 = kf_desc_all[kf2], kf_valid_all[kf2], kf_xy_all[kf2]
    x1c = se3.apply(T1, xyz1)
    x2c = se3.apply(T2, xyz2)
    x2in1 = sim3.apply(S12, x2c)
    r2 = torch.full((xyz2.shape[0],), 10.0, dtype=torch.float32, device=xyz2.device)
    m21 = match.match(
        d2, desc_f1, v2 & (x2in1[:, 2] > 0), vf1,
        pair_mask=match.window_mask(camera.project(x2in1, K), r2, xy_f1),
        max_dist=max_dist, nn_ratio=1.0,
    )
    S21 = sim3.inverse(S12)
    x1in2 = sim3.apply(S21, x1c)
    r1 = torch.full((xyz1.shape[0],), 10.0, dtype=torch.float32, device=xyz1.device)
    m12 = match.match(
        d1, desc_f2, v1 & (x1in2[:, 2] > 0), vf2,
        pair_mask=match.window_mask(camera.project(x1in2, K), r1, xy_f2),
        max_dist=max_dist, nn_ratio=1.0,
    )
    return m21.idx, m21.valid, m12.idx, m12.valid


def _pg_finalize_refs(ref_kf, moved_by, kf_valid, fallback):
    """The vertex each point is remapped through after the essential
    graph: the group keyframe that moved it in the Sim3 propagation where
    one did, else its reference keyframe (reference: Optimizer.cc:1021-1027,
    mnCorrectedReference); a dead reference falls back to `fallback`.
    The JAX package takes the reference keyframe for every point, so a
    propagated point referenced outside the group is corrected twice there
    (its loop_closing.py:1376)."""
    ref = np.where(moved_by >= 0, moved_by, ref_kf)
    return np.where((ref >= 0) & kf_valid[np.maximum(ref, 0)], ref, fallback)


def _pg_finalize_program(verts_old, verts_new, ref_idx, xyz_sel):
    """Post-essential-graph point remap + SE3 recovery:
    x' = S_new^-1 (S_old x) via each point's vertex (_pg_finalize_refs;
    reference: Optimizer.cc:1013-1043), poses t/s (:991-1010)."""
    S_old = verts_old[ref_idx]
    S_new = verts_new[ref_idx]
    x_new = sim3.apply(sim3.inverse(S_new), sim3.apply(S_old, xyz_sel))
    T_all = sim3.to_se3(verts_new)
    return x_new, T_all


class _CorrectionJob:
    """In-flight staged loop correction — everything AFTER the inline
    Sim3 propagation block. The reference blocks Tracking only while
    CorrectLoop holds mMutexMapUpdate for the propagation
    (LoopClosing.cc:443-516); SearchAndFuse and OptimizeEssentialGraph
    run on the loop thread while Tracking continues (:567, :587). Here
    the equivalent: the correction frame pays only the fused propagate
    program; fusion blocks and essential-graph GN chunks advance one per
    tracked frame (LocalMapping is paused meanwhile, like the reference's
    RequestStop at :408..Release :582 — keyframe creation is suppressed
    the same way the reference's NeedNewKeyFrame bails while the mapper
    is stopped, Tracking.cc:992-996)."""

    def __init__(self, kf, loop_kf, group, loop_pts, S_before_arr,
                 corrected, S_cw_corr, moved):
        self.stage = "fuse"
        self.kf = kf
        self.loop_kf = loop_kf
        self.group = group
        self.loop_pts = loop_pts
        self.S_before_arr = S_before_arr  # host (Nk, 8) pre-correction
        self.corrected = corrected  # {kf_slot: (8,) corrected Sim3}
        self.S_cw_corr = S_cw_corr  # host (8,)
        # The points the propagation moved: (ids, the group keyframe that
        # moved each, their serials), for the post-essential-graph remap.
        self.moved = moved
        self.fuse_specs = []  # pending blocks: lists of keyframe slots
        self.fuse_blocks = []  # dispatched: [(real_gs, pts_p, future)]
        self.fuse_next = 0  # next dispatched block to apply
        self.n_fused = 0
        self.fuse_pts_p = None  # loop-point ids (host)
        self.fuse_pts_idx = None  # same, device
        self.fuse_pts_mask = None
        # Essential-graph state.
        self.pg_problem = None
        self.pg_solve = None  # pose_graph.GraphSolve, stepped once a frame
        self.verts = None
        self.pg_iter = 0
        self.live_arr = None
        self.live_serials = None
        self.pts_p = None
        self.pt_serials = None
        self.fetch_fut = None


class _Sim3Job:
    """In-flight staged ComputeSim3 (reference: LoopClosing::ComputeSim3,
    LoopClosing.cc:231-400, which runs on the loop THREAD — tracking
    never waits for it). The chain (BoW match -> Sim3 RANSAC ->
    SearchBySim3 widening -> GN polish -> projection acceptance) is
    staged: each stage queues its device work and applies its readback on
    a later frame."""

    STAGES = ("bow", "ransac_widen", "gn_count")

    def __init__(self, kf, candidates, kf_serial, cand_serials):
        self.kf = kf
        self.cands = list(candidates)
        self.kf_serial = kf_serial
        self.cand_serials = list(cand_serials)
        self.ci = 0  # current candidate
        self.stage = "bow"
        self.fut = None  # in-flight readback for the current stage
        self.ctx = {}  # per-candidate intermediates

    def next_candidate(self):
        self.ci += 1
        self.stage = "bow"
        self.fut = None
        self.ctx = {}


class _GbaJob:
    """In-flight snapshot-epoch global BA (see LoopClosing._start_gba).

    Owns a device-resident BAProblem, solved on one device with the
    implicit-Schur PCG: advance() queues ONE LM iteration (no readback),
    walking the two-stage schedule of bundle_adjust (huber stage -> inlier
    reclassification -> clean stage, ``ba.TwoStage``) one chunk per call.
    ready() goes true once the final readback is dispatched; the apply
    then waits for it."""

    def __init__(self, problem, kfs, kf_serials, pts, pt_serials,
                 iters_first, iters_second, pcg_iters,
                 chi2_mono, chi2_stereo, mesh: Mesh):
        self.kfs = kfs
        self.kf_serials = kf_serials
        self.pts = pts
        self.pt_serials = pt_serials
        self.solve = self._solve(problem, mesh, iters_first, iters_second, pcg_iters,
                                 chi2_mono, chi2_stereo)
        self._fut = None

    def _solve(self, problem, mesh, iters_first, iters_second, pcg_iters, chi2_mono,
               chi2_stereo) -> ba_mod.TwoStage:
        return ba_mod.lm_solve(Mesh([problem.points.device]), [problem], iters_first,
                               iters_second, chi2_mono, chi2_stereo, pcg_iters, schur="pcg")

    def _solution(self):
        """(cam_T, points) of the snapshot's keyframes and points."""
        return self.solve.cam_T[0], self.solve.points[0]

    @property
    def err(self):
        return self.solve.err[0] if self.solve.err is not None else None

    @property
    def lam(self):
        return self.solve.lam[0] if self.solve.lam is not None else None

    def advance(self):
        if self._fut is not None:
            return
        self.solve.step()
        if self.solve.done:
            self._fut = fetch_async(*self._solution())

    def ready(self) -> bool:
        return self._fut is not None

    def result(self):
        return self._fut.result()


class _ShardedGbaJob(_GbaJob):
    """Multi-shard variant of _GbaJob (JAX loop_closing.py:323-360): the
    snapshot problem is partitioned through parallel/sharded_ba (map
    sharded over the mesh, camera Schur system reduce-scattered) and
    solved on the same schedule, ONE LM iteration per advance(), where
    the JAX package dispatches the whole solve at once: in eager PyTorch
    one dispatch is one host loop that launches every kernel before the
    frame returns, so the per-frame chunking of the single-device job is
    kept."""

    def _solve(self, problem, mesh, iters_first, iters_second, pcg_iters, chi2_mono,
               chi2_stereo) -> ba_mod.TwoStage:
        solve, _ = sharded_ba.map_sharded_solve(
            problem, mesh, iters_first=iters_first, iters_second=iters_second,
            pcg_iters=pcg_iters, chi2_mono=chi2_mono, chi2_stereo=chi2_stereo)
        self._mesh = mesh
        return solve

    def _solution(self):
        # Padding is appended, ids preserved: slice back to the snapshot.
        points = self._mesh.gather_local(self.solve.points)
        return self.solve.cam_T[0][: len(self.kfs)], points[: len(self.pts)]


class LoopClosing:
    def __init__(self, cfg: SlamConfig, mapstate: MapState, device: torch.device, mesh: Mesh,
                 vocabulary: Optional[vocab_mod.Vocabulary] = None):
        self.cfg = cfg
        self.map = mapstate
        self.device = torch.device(device)
        # More than one shard: the essential graph and the global BA take
        # the sharded solvers (JAX: len(jax.devices()) > 1).
        self.mesh = mesh
        self.K = camera.intrinsics_array(cfg.camera, self.device)
        self.sigma2 = np.asarray(cfg.orb.level_sigma2(), np.float32)
        self.fix_scale = cfg.sensor != Sensor.MONOCULAR
        self.voc = vocabulary.to(self.device) if vocabulary is not None else None
        self.db: Optional[KeyFrameDatabase] = None
        Nk = mapstate.kf_desc.shape[0]
        self.kp_cap = mapstate.kf_desc.shape[1]
        # Per-keyframe vocabulary-node ids, device-resident (the BoW
        # matching gate).
        self.kf_node_dev = torch.full(
            (Nk, self.kp_cap), -1, dtype=torch.int32, device=self.device
        )
        self._pending: list[int] = []  # keyframes awaiting vocabulary
        # Detection pipeline: (kf, connected, node, bow_w, bow_wt,
        # score_dev, n_shared_dev) dispatched this frame, applied next
        # frame when the prefetched score readback has landed.
        self._pending_detect = None
        self.last_loop_kf: int = -1000000
        self.last_loop_serial: int = -(1 << 40)
        self.consistent_groups: list[tuple[set, int]] = []
        self.loop_edges: list[tuple[int, int]] = []  # prior loop edges
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(cfg.vocabulary.seed + 1)
        self.n_loops_closed = 0
        # In-flight snapshot-epoch global BA (None when idle) + counter of
        # applied background solves.
        self.gba_job: Optional[_GbaJob | _ShardedGbaJob] = None
        self.n_gba_applied = 0
        # Essential-graph solves by route.
        self.pg_routes = {"gn_step": 0, "dpose_graph": 0}
        self.n_gba_replay_unresolved = 0
        # In-flight staged loop correction (fuse -> essential graph ->
        # GBA arming), advanced one chunk per tracked frame.
        self.correction_job: Optional[_CorrectionJob] = None
        # In-flight staged Sim3 computation (bow -> ransac -> widen ->
        # gn -> count), one stage readback per tracked frame.
        self.sim3_job: Optional[_Sim3Job] = None
        # Wired by System: the LocalMapping stage, paused for the
        # correction window (reference: RequestStop/Release,
        # LoopClosing.cc:408,582).
        self.mapper = None
        # Set by System so a loop correction also fixes the tracker state.
        self.on_pose_correction = None
        # Fired at the top of _correct_loop, BEFORE any map mutation: the
        # tracker drains its in-flight pipelined frames here, because they
        # were dispatched in the pre-correction world frame (the
        # reference's Tracking reads poses under mMutexMapUpdate instead,
        # LoopClosing.cc:445).
        self.on_before_correction = None
        # Evict culled keyframes from the place-recognition database
        # (reference: KeyFrame::SetBadFlag erases from KeyFrameDatabase,
        # KeyFrame.cc:543).
        mapstate.on_kf_erased = self._on_kf_erased

    def _on_kf_erased(self, k: int):
        if self.db is not None:
            self.db.erase(k)

    # ------------------------------------------------------------------
    def _set_node_row(self, kf: int, node: torch.Tensor):
        row = torch.tensor([kf], device=self.device)
        self.kf_node_dev.index_copy_(0, row, node[None])

    def _ensure_vocabulary(self, kf: int) -> bool:
        """Train the vocabulary from the first keyframes when none was
        provided (the reference instead loads the pretrained 140MB
        ORBvoc.txt, System.cc:64; absent from the snapshot — SURVEY.md §0)."""
        if self.voc is not None:
            return True
        self._pending.append(kf)
        if len(self._pending) < max(self.cfg.vocabulary.train_keyframes, 1):
            return False
        descs = []
        for k in self._pending:
            v = self.map.kf_kp_valid[k]
            descs.append(self.map.kf_desc[k][v])
        self.voc = vocab_mod.train_vocabulary(
            descs,
            k=self.cfg.vocabulary.branching,
            L=self.cfg.vocabulary.depth,
            levels_up=self.cfg.vocabulary.levels_up,
            seed=self.cfg.vocabulary.seed,
            device=self.device,
        )
        for k in self._pending[:-1]:
            self._index_keyframe(k)
        self._pending.clear()
        return True

    def _ensure_db(self):
        if self.db is None:
            self.db = KeyFrameDatabase(
                self.voc,
                self.cfg.capacity.max_keyframes,
                self.kp_cap,
            )

    def _transform_kf(self, kf: int):
        """Descriptor tree descent + device BoW aggregation for one KF —
        everything stays on device (reference: Frame::ComputeBoW)."""
        fb = vocab_mod.transform(
            self.voc, *to_device(self.device, self.map.kf_desc[kf], self.map.kf_kp_valid[kf])
        )
        w, wt = aggregate_bow_dev(fb.word, fb.weight, self.kp_cap)
        return fb, w, wt

    def _index_keyframe(self, kf: int):
        """Transform descriptors -> (word, node); add BoW vector to the DB
        (reference: ComputeBoW + KeyFrameDatabase::add). No readback: node
        table and database rows are device-resident."""
        self._ensure_db()
        fb, w, wt = self._transform_kf(kf)
        self._set_node_row(kf, fb.node)
        self.db.add_dev(kf, w, wt)

    # ------------------------------------------------------------------
    def reloc_candidates(self, desc: np.ndarray, d_valid: np.ndarray) -> list[int]:
        """BoW relocalization candidates for a (lost) frame (reference:
        KeyFrameDatabase::DetectRelocalizationCandidates via
        Tracking::Relocalization, Tracking.cc:1355)."""
        if self.voc is None or self.db is None:
            return []
        fb = vocab_mod.transform(self.voc, *to_device(self.device, desc, d_valid))
        bow = aggregate_bow(fb, self.kp_cap)
        return self.db.detect_reloc_candidates(bow, self.map)

    # ------------------------------------------------------------------
    def process_keyframe(self, kf: int) -> bool:
        """Feed one new keyframe to the loop pipeline: apply any pending
        detection first, then dispatch this keyframe's BoW scoring
        (prefetched; the detection logic runs on a later step()). Returns
        True when the pending apply closed a loop. The reference does the
        same work on its LoopClosing thread (LoopClosing.cc:57-88); here
        the stage is split so its device readback crosses a frame
        boundary."""
        if not self._ensure_vocabulary(kf):
            return False
        if kf in self._pending:
            self._pending.remove(kf)
        if self.sim3_job is not None or self.correction_job is not None:
            # The loop pipeline is busy on an earlier event (the
            # reference's loop thread would likewise still be inside
            # ComputeSim3/CorrectLoop and this keyframe would wait in its
            # queue): index the keyframe for future place recognition and
            # skip its detection.
            self._index_keyframe(kf)
            return False
        # Force-apply any previous detection first: _dispatch overwrites
        # the pending slot.
        closed = self.step(force=True)
        self._dispatch(kf)
        return closed

    def step(self, force: bool = False) -> bool:
        """Apply the pending detection, if any (called once per frame by
        System inside the tracking readback window), waiting for its
        scoring readback. Every stage of the loop closer takes its
        readback at the first call after its dispatch, on every device:
        the CPU's schedule. The JAX package polls the readback on an
        accelerator, to hide a remote chip's latency; on the card the
        device is done when the host ends its enqueue, and a polled
        schedule lets the result follow the host's load (PERF.md §6).
        `force` (the JAX package's signature) changes nothing here."""
        del force
        pd = self._pending_detect
        if pd is None:
            return False
        if self.sim3_job is not None or self.correction_job is not None:
            # An earlier loop event is mid-flight: hold the pending
            # detection (the dead-time gate re-checks at apply).
            return False
        self._pending_detect = None
        kf, kf_serial, connected, node, w, wt, fut = pd
        if not self.map.kf_valid[kf] or self.map.kf_serial[kf] != kf_serial:
            # The staged Sim3/correction jobs can hold a pending
            # detection for many frames; the keyframe may have been
            # culled and its slot recycled meanwhile — indexing the
            # stale BoW row would overwrite the new occupant's.
            return False
        # Index AFTER scoring (the query must not match itself; the
        # reference adds to the inverted file after DetectLoop,
        # LoopClosing.cc:85,228).
        self._set_node_row(kf, node)
        self.db.add_dev(kf, w, wt)
        score, n_shared = fut.result()
        candidates = self._detect_from(kf, connected, score, n_shared)
        if not candidates:
            return False
        # Stage the Sim3 computation: the reference runs ComputeSim3 on
        # its loop thread (tracking never waits); here the chain advances
        # one readback per tracked frame via advance_background. The
        # first stage is dispatched now; accept (frames later) runs
        # _correct_loop.
        self.sim3_job = _Sim3Job(
            kf, candidates, int(self.map.kf_serial[kf]),
            [int(self.map.kf_serial[c]) for c in candidates],
        )
        return self._advance_sim3(force=False)

    def advance_background(self):
        """Advance the in-flight background work by exactly ONE chunk:
        the staged loop correction if one is mid-flight, else the
        snapshot-epoch global BA. Called once per tracked frame by the
        System — NOT from step(), which keyframe events may invoke
        several times per frame (a catch-up drain would otherwise run a
        whole solve inside one frame)."""
        if self.correction_job is not None:
            return self._advance_correction()
        closed = False
        if self.sim3_job is not None:
            closed = self._advance_sim3()
        # A GBA from a previous loop may still be in flight while a new
        # detection computes its Sim3 — both advance one chunk.
        self._advance_gba()
        return closed

    def idle(self) -> bool:
        """No in-flight background work (System's shutdown drain loop)."""
        return (
            self.sim3_job is None
            and self.correction_job is None
            and self.gba_job is None
            and self._pending_detect is None
        )

    def drain(self):
        # Finish the staged Sim3 compute (it may arm a correction), then
        # the correction (it arms the GBA), then any pending detection
        # (which may arm a NEW Sim3 job), then the global BA — save_map,
        # shutdown and trajectory export need the settled map.
        closed = False
        for _ in range(4):
            while self.sim3_job is not None:
                closed = self._advance_sim3(force=True) or closed
            while self.correction_job is not None:
                self._advance_correction(force=True)
            closed = self.step(force=True) or closed
            if self.sim3_job is None and self.correction_job is None:
                break
        while self.gba_job is not None:
            self._advance_gba()
        return closed

    def _dispatch(self, kf: int):
        self._ensure_db()
        connected = self.map.covisible_keyframes(kf, n=1000, min_weight=1)
        fb, w, wt = self._transform_kf(kf)
        # Score ALL keyframes (the covisible scores define minScore); the
        # covisible set is excluded from candidacy at apply time.
        score, n_shared = self.db.scores_dev(w, wt)
        fut = fetch_async(score, n_shared)
        self._pending_detect = (
            kf, int(self.map.kf_serial[kf]), connected, fb.node, w, wt, fut
        )

    # ------------------------------------------------------------------
    def _detect_from(
        self, kf: int, connected, score: np.ndarray, n_shared: np.ndarray
    ) -> list[int]:
        """Reference: LoopClosing::DetectLoop (:103-229)."""
        # Dead time compares insertion serials, not slot ids (slots are
        # recycled at capacity).
        if self.map.kf_serial[kf] < self.last_loop_serial + self.cfg.loop.min_kf_gap or (
            len(self.map.live_keyframes()) < self.cfg.loop.min_kf_gap
        ):
            self.consistent_groups = []
            return []
        # minScore: lowest BoW similarity among covisible KFs (:121-138).
        cov_scores = [score[c] for c in connected if self.db.valid[c] and score[c] >= 0]
        min_score = min(cov_scores) if cov_scores else 0.015

        # Candidacy excludes the covisible neighborhood + self (the
        # reference's inverted file skips connected KFs, :93-96) and any
        # keyframe within the temporal dead-band (see
        # LoopConfig.candidate_kf_gap).
        score_f = score.copy()
        n_f = n_shared.copy()
        for c in set(connected) | {kf}:
            if 0 <= c < len(score_f):
                score_f[c] = -1.0
                n_f[c] = 0
        recent = (
            self.map.kf_serial
            > self.map.kf_serial[kf] - self.cfg.loop.candidate_kf_gap
        )
        score_f[recent] = -1.0
        n_f[recent] = 0
        cands = self.db.detect_loop_candidates_from(
            score_f, n_f, float(min_score), self.map
        )
        _dbg(
            f"detect kf={kf} serial={self.map.kf_serial[kf]}"
            f" connected={len(connected)} min_score={min_score:.4f}"
            f" cands={cands}"
        )
        if not cands:
            self.consistent_groups = []
            return []

        # Consecutive-consistency accumulation (:152-211).
        enough: list[int] = []
        new_groups: list[tuple[set, int]] = []
        for c in cands:
            group = set([c]) | set(self.map.covisible_keyframes(c, n=1000, min_weight=1))
            best_count = 0
            for prev_set, prev_count in self.consistent_groups:
                if group & prev_set:
                    best_count = max(best_count, prev_count + 1)
            new_groups.append((group, best_count))
            if best_count >= self.cfg.loop.covisibility_consistency_th:
                enough.append(c)
        _dbg(
            "consistency:",
            [(c, n) for (c, (_, n)) in zip(cands, new_groups)],
        )
        self.consistent_groups = new_groups
        return enough

    # ------------------------------------------------------------------
    # Staged ComputeSim3 (reference: LoopClosing::ComputeSim3 :231-400,
    # on the loop thread). Each advance applies ONE landed readback and
    # dispatches the next stage's device program:
    #   bow -> ransac -> widen -> gn -> count -> accept(_correct_loop).

    def _advance_sim3(self, force: bool = False) -> bool:
        """Advance the in-flight Sim3 computation by one stage readback
        (force completes it inline — drain only). Returns True when a
        loop was accepted and the correction armed this call."""
        job = self.sim3_job
        if job is None:
            return False
        mp = self.map
        while True:
            if job.ci >= len(job.cands):
                self.sim3_job = None
                return False
            cand = job.cands[job.ci]
            # Stale guard: keyframes may be culled/recycled while the
            # staged compute runs — mapping continues during detection
            # (the reference instead pins candidates with SetNotErase,
            # LoopClosing.cc:257).
            if not (
                mp.kf_valid[job.kf]
                and mp.kf_serial[job.kf] == job.kf_serial
                and mp.kf_valid[cand]
                and mp.kf_serial[cand] == job.cand_serials[job.ci]
            ):
                job.next_candidate()
                continue
            if job.fut is None:
                self._sim3_dispatch_bow(job)
                if not force:
                    return False
                continue
            accepted = self._sim3_apply_stage(job)
            if accepted:
                return True
            if not force:
                return False
            if self.sim3_job is None:
                return False

    def _sim3_dispatch_bow(self, job: "_Sim3Job"):
        """Descriptor match between the two keyframes' map-point
        features, gated by vocabulary-node agreement (reference:
        SearchByBoW(KF,KF) ORBmatcher.cc:522-655)."""
        kf, cand = job.kf, job.cands[job.ci]
        mp = self.map
        ok1 = (mp.kf_mp[kf] >= 0) & mp.kf_kp_valid[kf]
        ok2 = (mp.kf_mp[cand] >= 0) & mp.kf_kp_valid[cand]
        node_gate = (
            self.kf_node_dev[kf][:, None] == self.kf_node_dev[cand][None, :]
        )
        d1, d2, ok1_d, ok2_d, a1, a2 = to_device(
            self.device, mp.kf_desc[kf], mp.kf_desc[cand], ok1, ok2,
            mp.kf_angle[kf], mp.kf_angle[cand],
        )
        m = match.match(
            d1, d2, ok1_d, ok2_d,
            pair_mask=node_gate,
            max_dist=self.cfg.matcher.th_low,
            nn_ratio=0.75,
        )
        keep = match.rotation_consistency(a1, a2[m.idx.long()], m.valid)
        job.fut = fetch_async(m.idx, keep)
        job.stage = "bow"

    def _sim3_apply_stage(self, job: "_Sim3Job") -> bool:
        """Apply the landed readback of the current stage and dispatch
        the next one. Returns True on final acceptance."""
        kf, cand = job.kf, job.cands[job.ci]
        mp = self.map
        res = job.fut.result()
        job.fut = None

        if job.stage == "bow":
            idx2, keep = res
            n = int(keep.sum())
            if n < self.cfg.loop.min_bow_matches:
                _dbg(f"cand {cand}: bow={n} < "
                     f"{self.cfg.loop.min_bow_matches}, reject")
                job.next_candidate()
                return False
            # Paired 3D points in each camera frame.
            f1_p = np.nonzero(keep)[0]
            f2_p = idx2[f1_p].astype(np.int64)
            # Mapping ran between the bow dispatch and this apply: a
            # matched point may have been culled since (kf_mp -1 / dead
            # slot); the clamp below would silently feed point 0 to the
            # solvers, so mask those pairs out instead.
            raw1 = mp.kf_mp[kf, f1_p]
            raw2 = mp.kf_mp[cand, f2_p]
            p1_ids = np.maximum(raw1, 0)
            p2_ids = np.maximum(raw2, 0)
            mask = (
                (raw1 >= 0) & (raw2 >= 0)
                & mp.pt_valid[p1_ids] & mp.pt_valid[p2_ids]
            )
            # Per-match chi2 gates 9.21*sigma2(octave) (Sim3Solver.cc:106).
            s1 = 9.21 * self.sigma2[mp.kf_octave[kf, f1_p]]
            s2 = 9.21 * self.sigma2[mp.kf_octave[cand, f2_p]]
            T1, T2, xw1, xw2, uv1, uv2, mask_d, s1_d, s2_d = to_device(
                self.device, mp.kf_pose[kf], mp.kf_pose[cand],
                mp.pt_xyz[p1_ids], mp.pt_xyz[p2_ids],
                mp.kf_xy[kf, f1_p], mp.kf_xy[cand, f2_p], mask, s1, s2,
            )
            rr = sim3solve.solve_sim3_ransac(
                se3.apply(T1, xw1), se3.apply(T2, xw2),
                uv1, uv2, mask_d, s1_d, s2_d,
                self.K, self.K, self._rng,
                fix_scale=self.fix_scale,
                n_hypotheses=self.cfg.loop.sim3_ransac_iters,
                min_inliers=self.cfg.loop.min_sim3_inliers,
            )
            # SearchBySim3 widening (reference: LoopClosing.cc:323-326)
            # queued in the SAME round trip: the widen program takes
            # rr.S12 device-side (garbage if RANSAC failed — discarded at
            # apply). Each avoided readback is one frame of loop-closure
            # latency.
            widen_out = self._dispatch_widen(kf, cand, rr.S12)
            job.ctx.update(n_bow=n, f1_p=f1_p, f2_p=f2_p, mask=mask)
            job.fut = fetch_async(
                rr.ok, rr.n_inliers, rr.S12, rr.inliers, *widen_out
            )
            job.stage = "ransac_widen"
            return False

        if job.stage == "ransac_widen":
            ok, n_in, S12, inliers = res[:4]
            if not bool(ok):
                _dbg(f"cand {cand}: ransac failed, reject")
                job.next_candidate()
                return False
            # Widen: grow the RANSAC-inlier match set with bidirectional
            # Sim3-guided projection agreements BEFORE the GN polish —
            # BoW matches alone are biased toward shared-word features
            # and starve the polish on weak-overlap real imagery.
            inl = inliers & job.ctx["mask"]
            u1, u2 = self._widen_union(
                kf, cand,
                job.ctx["f1_p"][inl], job.ctx["f2_p"][inl],
                *res[4:],
            )
            xu1, xu2, uvu1, uvu2, wu1, wu2, umask = self._sim3_pair_arrays(
                kf, cand, u1, u2
            )
            opt = sim3_opt.optimize_sim3(
                to_device(self.device, S12),
                xu1, xu2, uvu1, uvu2, wu1, wu2, umask,
                self.K, self.K,
                fix_scale=self.fix_scale,
            )
            # Projection acceptance rides the same round trip, consuming
            # the polished opt.S12 device-side (reference :335-391,
            # accept at >= min_total_matches).
            loop_pts = self._loop_neighborhood_points(cand)
            if len(loop_pts) == 0:
                job.next_candidate()
                return False
            m, _pts_p = self._project_match(kf, loop_pts, opt.S12, cand)
            job.ctx.update(n_ransac=int(n_in), loop_pts=loop_pts)
            job.fut = fetch_async(opt.S12, opt.n_inliers, m.valid)
            job.stage = "gn_count"
            return False

        # stage == "gn_count"
        S12_opt, n_inl, valid = res
        total = int(valid.sum())
        _dbg(
            f"cand {cand}: bow={job.ctx['n_bow']} "
            f"ransac={job.ctx['n_ransac']} opt={int(n_inl)} "
            f"total={total}"
        )
        if int(n_inl) < self.cfg.loop.min_sim3_inliers:
            _dbg(f"cand {cand}: gn inliers {int(n_inl)}, reject")
            job.next_candidate()
            return False
        if total < self.cfg.loop.min_total_matches:
            job.next_candidate()
            return False
        job.ctx["S_cl"] = S12_opt
        _dbg(f"loop accepted: kf {kf} <-> {cand}")
        self.sim3_job = None
        self._correct_loop(kf, cand, S12_opt, job.ctx["loop_pts"])
        self.last_loop_kf = kf
        self.last_loop_serial = int(mp.kf_serial[kf])
        self.n_loops_closed += 1
        mp.big_change_idx += 1
        return True

    def _dispatch_widen(self, kf: int, cand: int, S12):
        """Dispatch the SearchBySim3 bidirectional projection programs
        over the device mirror (no readback here — the staged Sim3 job
        fetches asynchronously)."""
        mp = self.map
        mp1 = mp.kf_mp[kf]
        mp2 = mp.kf_mp[cand]
        v1 = (mp1 >= 0) & mp.kf_kp_valid[kf] & mp.pt_valid[np.maximum(mp1, 0)]
        v2 = (mp2 >= 0) & mp.kf_kp_valid[cand] & mp.pt_valid[np.maximum(mp2, 0)]
        dev = mp.device
        dev.flush()
        if not isinstance(S12, torch.Tensor):
            S12 = to_device(self.device, S12)
        p1, v1_d, p2, v2_d = to_device(
            self.device, np.maximum(mp1, 0).astype(np.int64), v1,
            np.maximum(mp2, 0).astype(np.int64), v2,
        )
        return _sim3_widen_program(
            dev.kf_pose, dev.kf_desc, dev.kf_kp_valid, dev.kf_xy,
            dev.pt_xyz, dev.pt_desc,
            S12, kf, cand, p1, v1_d, p2, v2_d,
            self.K, max_dist=self.cfg.matcher.th_high,
        )

    def _widen_sim3_matches(self, kf: int, cand: int, S12,
                            base_f1: np.ndarray, base_f2: np.ndarray):
        """Blocking convenience wrapper (unit tests): dispatch + union."""
        out = fetch(*self._dispatch_widen(kf, cand, S12))
        return self._widen_union(kf, cand, base_f1, base_f2, *out)

    def _widen_union(self, kf: int, cand: int, base_f1, base_f2,
                     m21_idx, m21_ok, m12_idx, m12_ok):
        """SearchBySim3 host half: two-way agreement check + union with
        the base (BoW-RANSAC) pairs, first-wins per feature on either
        side (reference: ORBmatcher.cc:1102-1326, agreement :1307-1323,
        used at LoopClosing.cc:323-326)."""
        mp1 = self.map.kf_mp[kf]
        mp2 = self.map.kf_mp[cand]
        # Two-way agreement (reference :1307-1323).
        f2_all = np.nonzero(m21_ok)[0]
        f1_of = m21_idx[f2_all]
        agree = m12_ok[f1_of] & (m12_idx[f1_of] == f2_all)
        wf1, wf2 = f1_of[agree], f2_all[agree]
        used1 = np.zeros(mp1.shape[0], bool)
        used2 = np.zeros(mp2.shape[0], bool)
        used1[base_f1] = True
        used2[base_f2] = True
        fresh = ~used1[wf1] & ~used2[wf2]
        _dbg(
            f"sim3 widen: {len(base_f1)} base + {int(fresh.sum())} fresh"
            f" (of {len(wf1)} agreements)"
        )
        return (
            np.concatenate([base_f1, wf1[fresh]]),
            np.concatenate([base_f2, wf2[fresh]]),
        )

    def _sim3_pair_arrays(self, kf: int, cand: int,
                          f1: np.ndarray, f2: np.ndarray):
        """Paired per-camera 3D points / pixels / octave weights for a
        feature-pair list, as device tensors."""
        mp = self.map
        f1_p = np.asarray(f1, np.int64)
        f2_p = np.asarray(f2, np.int64)
        raw1 = mp.kf_mp[kf, f1_p]
        raw2 = mp.kf_mp[cand, f2_p]
        p1 = np.maximum(raw1, 0)
        p2 = np.maximum(raw2, 0)
        # Pairs whose point was culled since the matching stage ran are
        # masked, not clamped onto point 0.
        mask = (raw1 >= 0) & (raw2 >= 0) & mp.pt_valid[p1] & mp.pt_valid[p2]
        T1, T2, xw1, xw2, uv1, uv2, w1, w2, mask_d = to_device(
            self.device, mp.kf_pose[kf], mp.kf_pose[cand], mp.pt_xyz[p1], mp.pt_xyz[p2],
            mp.kf_xy[kf, f1_p], mp.kf_xy[cand, f2_p],
            1.0 / self.sigma2[mp.kf_octave[kf, f1_p]],
            1.0 / self.sigma2[mp.kf_octave[cand, f2_p]], mask,
        )
        return se3.apply(T1, xw1), se3.apply(T2, xw2), uv1, uv2, w1, w2, mask_d

    def _loop_neighborhood_points(self, cand: int) -> np.ndarray:
        pts = set()
        for k in [cand] + self.map.covisible_keyframes(cand, n=10):
            mp = self.map.kf_mp[k]
            pts.update(mp[mp >= 0].tolist())
        pts = np.asarray(sorted(pts), np.int64)
        return pts[self.map.pt_valid[pts]] if len(pts) else pts

    def _project_match(self, kf: int, pts: np.ndarray, S_cl, cand: int):
        """Match loop points (world coords) into keyframe kf through the
        corrected camera pose S_cl ∘ T_cand."""
        pts_p = np.asarray(pts, np.int64)
        T_cand, xyz, p_desc, k_desc, k_valid, k_xy = to_device(
            self.device, self.map.kf_pose[cand], self.map.pt_xyz[pts_p],
            self.map.pt_desc[pts_p], self.map.kf_desc[kf],
            self.map.kf_kp_valid[kf], self.map.kf_xy[kf],
        )
        if not isinstance(S_cl, torch.Tensor):
            S_cl = to_device(self.device, S_cl)
        S_cw = sim3.compose(S_cl, sim3.from_se3(T_cand))  # world -> current cam
        xc = sim3.apply(S_cw, xyz)
        uv = camera.project(xc, self.K)
        radii = torch.full((len(pts_p),), 10.0, dtype=torch.float32, device=self.device)
        m = match.match(
            p_desc, k_desc, xc[:, 2] > 0, k_valid,
            pair_mask=match.window_mask(uv, radii, k_xy),
            max_dist=self.cfg.matcher.th_low,
            nn_ratio=1.0,
        )
        return m, pts_p

    # ------------------------------------------------------------------
    def _correct_loop(self, kf: int, loop_kf: int, S_cl, loop_pts: np.ndarray):
        """Reference: LoopClosing::CorrectLoop (:402-585). Inline here is
        ONLY the Sim3 propagation block the reference runs under
        mMutexMapUpdate (:443-516) — one run of device work. Everything
        after (fuse, essential graph, GBA arming) is staged into a
        _CorrectionJob advanced one chunk per tracked frame."""
        # Defensive: a correction is never armed while one is in flight
        # (detection is paused), but direct callers (dryrun) may re-enter.
        while self.correction_job is not None:
            self._advance_correction(force=True)
        # A global BA of an earlier loop still in flight is aborted now,
        # before the map moves (reference: LoopClosing.cc:411-423); the
        # JAX package keeps it frozen until this correction arms its own.
        self.gba_job = None
        if self.on_before_correction is not None:
            self.on_before_correction()
        _t0 = time.perf_counter()

        def _lap(name):
            nonlocal _t0
            t = time.perf_counter()
            _dbg(f"correct_loop {name}: {(t - _t0) * 1000:.0f} ms")
            _t0 = t
        mp = self.map
        T_cur_old = mp.kf_pose[kf].copy()

        # Group = current KF + its covisibles (:447); each live point is
        # owned by its FIRST group keyframe (group order = covisibility
        # order, like the reference's sequential first-writer-wins loop).
        group = [kf] + mp.covisible_keyframes(kf, n=100, min_weight=1)
        garr = np.asarray(group, np.int64)
        Np = mp.pt_xyz.shape[0]
        owner = np.full(Np, -1, np.int32)
        for i in range(len(group) - 1, -1, -1):
            pg = mp.kf_mp[group[i]]
            owner[pg[pg >= 0]] = i
        sel = np.nonzero(owner >= 0)[0]
        sel = sel[mp.pt_valid[sel]]
        # ONE readback for the whole propagation (snapshot, group
        # correction, owned-point move, SE3 recovery), reading the
        # device-resident mirror — the upload is index-sized.
        dev = mp.device
        dev.flush()
        S_cl_d, g_idx, oi, sel_d = to_device(
            self.device, np.asarray(fetch(S_cl), np.float32), garr,
            owner[sel].astype(np.int64), sel.astype(np.int64),
        )
        S_all, S_g_corr, T_g_new, x_new, S_cw_corr = fetch(
            *_propagate_program(
                dev.kf_pose, dev.pt_xyz, S_cl_d, loop_kf, kf, g_idx, oi, sel_d
            )
        )
        corrected: dict[int, np.ndarray] = {
            int(g): S_g_corr[i] for i, g in enumerate(group)
        }
        if len(sel):
            mp.pt_xyz[sel] = x_new
            mp.mark_points_dirty(sel)
        mp.kf_pose[garr] = T_g_new
        mp.mark_kf_pose_dirty(garr)
        _lap("propagate")

        # Pause the mapping stage + keyframe creation for the staged
        # remainder (reference: RequestStop :408 .. Release :582).
        if self.mapper is not None:
            self.mapper.paused = True
        job = _CorrectionJob(
            kf, loop_kf, group, loop_pts, S_all, corrected, S_cw_corr,
            (sel, garr[owner[sel]], mp.pt_serial[sel].copy()),
        )
        self._dispatch_fuse_blocks(job)
        self.correction_job = job
        _lap("arm_fuse")

        # Let the tracker re-anchor its last pose / velocity off the
        # propagated correction now; the essential-graph refinement
        # re-anchors again when it applies.
        if self.on_pose_correction is not None:
            T_cur_new = mp.kf_pose[kf].copy()
            self.on_pose_correction(kf, T_cur_old, T_cur_new)

    # -- staged correction: fuse ---------------------------------------
    def _dispatch_fuse_blocks(self, job: "_CorrectionJob"):
        """Stage the guided SearchAndFuse projections for the group
        keyframes as _FUSE_BLOCK-sized batches. Only the FIRST
        block is dispatched here — the correction frame pays one dispatch;
        each following frame dispatches the next block while applying a
        landed one (double-buffered)."""
        pts_p = np.asarray(job.loop_pts, np.int64)
        job.fuse_pts_p = pts_p
        job.fuse_pts_idx = to_device(self.device, pts_p)
        job.fuse_pts_mask = torch.ones(len(pts_p), dtype=torch.bool, device=self.device)
        job.fuse_specs = [
            job.group[s: s + _FUSE_BLOCK]
            for s in range(0, len(job.group), _FUSE_BLOCK)
        ]
        self._dispatch_next_fuse(job)

    def _dispatch_next_fuse(self, job: "_CorrectionJob"):
        if not job.fuse_specs:
            return
        real_gs = job.fuse_specs.pop(0)
        gb = np.full(_FUSE_BLOCK, real_gs[0], np.int64)
        gb[: len(real_gs)] = real_gs
        dev = self.map.device
        dev.flush()
        idx, valid = _fuse_block_program(
            dev.kf_pose, dev.kf_desc, dev.kf_kp_valid, dev.kf_xy,
            dev.pt_xyz, dev.pt_desc, dev.pt_valid,
            to_device(self.device, gb), job.fuse_pts_idx, job.fuse_pts_mask,
            self.K, max_dist=self.cfg.matcher.th_low,
        )
        job.fuse_blocks.append((real_gs, job.fuse_pts_p, fetch_async(idx, valid)))

    def _apply_fuse_block(self, real_gs, pts_p, fut):
        """Host mutations for one fused block: replace duplicates / add
        missing observations (reference: LoopClosing.cc:518-542 +
        SearchAndFuse :587-613)."""
        mp = self.map
        idx, valid = fut.result()
        n_fused = 0
        for bi, g in enumerate(real_gs):
            ok = valid[bi]
            tgt_feat = idx[bi]
            for i in np.nonzero(ok)[0]:
                loop_p = int(pts_p[i])
                if not mp.pt_valid[loop_p]:
                    continue  # culled/replaced since dispatch
                feat = int(tgt_feat[i])
                cur_p = mp.kf_mp[g, feat]
                if cur_p >= 0 and cur_p != loop_p and mp.pt_valid[cur_p]:
                    mp.replace_point(int(cur_p), loop_p)
                    n_fused += 1
                elif cur_p < 0:
                    mp.add_observation(loop_p, g, feat)
            # Refresh covisibility as each block lands (new loop
            # connections, :546-564) instead of one bulk pass.
            mp.update_connections(g)
        return n_fused

    # -- staged correction: essential graph ----------------------------
    def _advance_correction(self, force: bool = False) -> bool:
        """Advance the in-flight correction by one chunk (called once per
        tracked frame; force drains to completion). Returns True when the
        correction fully applied this call."""
        job = self.correction_job
        if job is None:
            return False
        if job.stage == "fuse":
            # Double-buffer: dispatch the next block, then apply the
            # previous one, waiting for its readback — per frame cost =
            # one dispatch + one apply.
            self._dispatch_next_fuse(job)
            while job.fuse_next < len(job.fuse_blocks):
                real_gs, pts_p, fut = job.fuse_blocks[job.fuse_next]
                job.n_fused += self._apply_fuse_block(real_gs, pts_p, fut)
                job.fuse_next += 1
                if not force:
                    break  # one block per frame
            if force:
                while job.fuse_specs:
                    self._dispatch_next_fuse(job)
                    real_gs, pts_p, fut = job.fuse_blocks[job.fuse_next]
                    job.n_fused += self._apply_fuse_block(real_gs, pts_p, fut)
                    job.fuse_next += 1
            if not job.fuse_specs and job.fuse_next >= len(job.fuse_blocks):
                _dbg(f"fused {job.n_fused} duplicate points")
                job.stage = "pg_build"
            if not force:
                return False
        if job.stage == "pg_build":
            self._build_pose_graph(job)
            if not force:
                return False
        if job.stage == "pg":
            while job.pg_iter < self.cfg.optimizer.essential_graph_its:
                job.pg_solve.step(self.cfg.optimizer.pcg_iters)
                job.pg_iter += 1
                if not force:
                    break  # one GN chunk per frame
            if job.pg_iter >= self.cfg.optimizer.essential_graph_its:
                job.verts = job.pg_solve.vertices.to(self.device)
                self._dispatch_pg_finalize(job)
                job.stage = "pg_fetch"
            if not force:
                return False
        if job.stage == "pg_fetch":
            self._apply_pose_graph_result(job)
            job.stage = "arm_gba"
            if not force:
                return False
        if job.stage == "arm_gba":
            self.loop_edges.append((job.loop_kf, job.kf))
            # Arm the background snapshot-epoch global BA (:579 spawns
            # the GBA thread; an earlier job was aborted when this
            # correction started, :411-423).
            self._start_gba()
            # Release the mapper (reference: :582).
            if self.mapper is not None:
                self.mapper.paused = False
            self.correction_job = None
            return True
        return False

    def _build_pose_graph(self, job: "_CorrectionJob"):
        """Assemble the fixed-shape Sim3 pose graph on the host
        (reference: Optimizer::OptimizeEssentialGraph :781-1044 edge
        sets). Runs after fuse so the refreshed covisibility contributes
        the new loop connections."""
        mp = self.map
        live = mp.live_keyframes()
        Nk = mp.kf_pose.shape[0]
        live_arr = np.asarray(live, np.int64)
        kf, loop_kf = job.kf, job.loop_kf
        S_before_arr = job.S_before_arr  # (Nk, 8) pre-correction snapshot

        # --- edge pair assembly (vectorized) ---
        # Spanning tree (:898-923).
        par = mp.spanning_parent[live_arr]
        ok = (par >= 0) & mp.kf_valid[np.maximum(par, 0)]
        span_i, span_j = par[ok].astype(np.int64), live_arr[ok]
        # Prior loop edges (:925-949).
        if self.loop_edges:
            le = np.asarray(self.loop_edges, np.int64)
            ok = mp.kf_valid[le[:, 0]] & mp.kf_valid[le[:, 1]]
            loop_i, loop_j = le[ok, 0], le[ok, 1]
        else:
            loop_i = loop_j = np.zeros(0, np.int64)
        # Strong covisibility edges (:951-982), upper triangle only.
        thr = self.cfg.optimizer.essential_graph_min_weight
        live_mask = np.zeros(Nk, bool)
        live_mask[live_arr] = True
        cov = (mp.covis >= thr) & live_mask[:, None] & live_mask[None, :]
        cov_i, cov_j = np.nonzero(np.triu(cov, 1))

        ei = np.concatenate([[loop_kf], span_i, loop_i, cov_i]).astype(np.int64)
        ej = np.concatenate([[kf], span_j, loop_j, cov_j]).astype(np.int64)
        # Dedup by unordered pair, keeping the FIRST occurrence (the loop
        # edge at index 0 carries a special measurement and must win).
        lo, hi = np.minimum(ei, ej), np.maximum(ei, ej)
        keykeep = np.zeros(len(ei), bool)
        _, first = np.unique(lo * Nk + hi, return_index=True)
        keykeep[first] = True
        keykeep &= ei != ej
        keykeep[0] = True  # the loop edge always survives
        ei, ej = ei[keykeep], ej[keykeep]

        # Measurements: S_ji = S_before[j] ∘ S_before[i]^-1; the loop
        # edge (row 0) instead measures the corrected relative.
        E = len(ei)
        S_before_d, S_cw_corr_d, ei_d, ej_d = to_device(
            self.device, S_before_arr.astype(np.float32),
            np.asarray(job.S_cw_corr, np.float32), ei, ej,
        )
        meas = sim3.compose(S_before_d[ej_d], sim3.inverse(S_before_d[ei_d]))
        meas0 = sim3.compose(S_cw_corr_d, sim3.inverse(S_before_d[loop_kf]))
        meas = torch.cat([meas0[None], meas[1:]], dim=0)

        verts = np.tile(sim3.identity().numpy(), (Nk, 1))
        v_valid = np.zeros(Nk, bool)
        verts[live_arr] = S_before_arr[live_arr]
        v_valid[live_arr] = True
        for k, S in job.corrected.items():
            verts[k] = np.asarray(S)
        v_fixed = np.zeros(Nk, bool)
        v_fixed[loop_kf] = True

        verts_d, v_fixed_d, v_valid_d = to_device(
            self.device, verts.astype(np.float32), v_fixed, v_valid
        )
        job.pg_problem = pose_graph.PoseGraphProblem(
            vertices=verts_d, v_fixed=v_fixed_d, v_valid=v_valid_d,
            edge_i=ei_d, edge_j=ej_d, edge_Sji=meas,
            edge_weight=torch.ones(E, dtype=torch.float32, device=self.device),
            edge_valid=torch.ones(E, dtype=torch.bool, device=self.device),
        )
        job.live_arr = live_arr
        job.live_serials = mp.kf_serial[live_arr].copy()
        # Chunked GN: one iteration per tracked frame, over the mesh: its
        # edges sharded when it has more than one shard (parallel/
        # dpose_graph, JAX: len(jax.devices()) > 1). The JAX package solves
        # the sharded graph in one dispatch; in eager PyTorch that is one
        # host loop over every kernel inside the frame, so the port keeps
        # the chunking on both routes.
        job.pg_solve = dpose_graph.graph_solve(job.pg_problem, self.mesh, self.fix_scale)
        self.pg_routes["dpose_graph" if self.mesh.size > 1 else "gn_step"] += 1
        job.stage = "pg"

    def _dispatch_pg_finalize(self, job: "_CorrectionJob"):
        """Queue the point remap + SE3 recovery and its async readback
        (the last device work of the correction)."""
        mp = self.map
        pts_p = np.asarray(mp.live_points(), np.int64)
        live = job.live_arr
        moved, movers, serials = job.moved
        same = mp.pt_serial[moved] == serials
        moved_by = np.full(mp.pt_xyz.shape[0], -1, np.int64)
        moved_by[moved[same]] = movers[same]
        ref = _pg_finalize_refs(mp.pt_ref_kf[pts_p], moved_by[pts_p], mp.kf_valid,
                                live[0] if len(live) else 0)
        x_new, T_all = _pg_finalize_program(
            job.pg_problem.vertices, job.verts,
            *to_device(self.device, ref.astype(np.int64), mp.pt_xyz[pts_p]),
        )
        job.pts_p = pts_p
        job.pt_serials = mp.pt_serial[pts_p].copy()
        job.fetch_fut = fetch_async(x_new, T_all)

    def _apply_pose_graph_result(self, job: "_CorrectionJob"):
        """Write the essential-graph solve back into the map. LocalMapping
        was paused for the whole window so the topology is frozen, but
        every write is still serial-guarded (defense in depth against a
        future scheduling change)."""
        mp = self.map
        if self.on_before_correction is not None:
            self.on_before_correction()
        x_new, T_all = job.fetch_fut.result()

        live = job.live_arr
        ok = mp.kf_valid[live] & (mp.kf_serial[live] == job.live_serials)
        lv = live[ok]
        T_kf_before = mp.kf_pose[job.kf].copy()
        mp.kf_pose[lv] = T_all[lv]
        mp.mark_kf_pose_dirty(lv)

        pts = job.pts_p
        okp = mp.pt_valid[pts] & (mp.pt_serial[pts] == job.pt_serials)
        mp.pt_xyz[pts[okp]] = x_new[okp]
        mp.mark_points_dirty(pts[okp])
        mp.update_points_batch(pts[okp])
        mp.big_change_idx += 1
        _dbg(
            f"essential graph applied: {len(lv)} KFs, {int(okp.sum())} pts"
        )
        # Re-anchor the tracker off the current KF's refinement delta.
        if self.on_pose_correction is not None and bool(
            mp.kf_valid[job.kf]
        ):
            self.on_pose_correction(job.kf, T_kf_before, T_all[job.kf])

    # ------------------------------------------------------------------
    # Global BA — snapshot-epoch background solve (SURVEY.md §7.3).
    #
    # The reference runs GBA in a spawned abortable 4th thread while
    # tracking/mapping continue, then patches keyframes/points born
    # during the solve through the spanning tree
    # (LoopClosing::RunGlobalBundleAdjustment, LoopClosing.cc:645-749).
    # The equivalent here: the problem is SNAPSHOTTED at loop time
    # (identities pinned by kf_serial/pt_serial — slots recycle), the LM
    # solve is chunked into ONE lm_step per tracked frame (its device
    # work interleaves with tracking's, so no frame ever waits out the
    # whole solve), and on completion the result is applied with
    # serial-guarded writes + spanning-tree replay of keyframes born
    # mid-solve.

    def _start_gba(self):
        """Assemble the snapshot problem and arm the background job."""
        mp = self.map
        live = mp.live_keyframes()
        pts = mp.live_points()
        if len(live) < 2 or len(pts) == 0:
            return
        live = np.asarray(live, np.int64)
        pts = np.asarray(pts, np.int64)

        # Vectorized observation assembly (the mapping.py local-BA
        # assembly pattern, applied globally).
        obs_kf_all = mp.pt_obs_kf[pts]  # (P, Mo)
        obs_feat_all = mp.pt_obs_feat[pts]
        kf_slot_of = np.full(mp.kf_pose.shape[0], -1, np.int32)
        kf_slot_of[live] = np.arange(len(live), dtype=np.int32)
        ci = np.where(obs_kf_all >= 0, kf_slot_of[np.maximum(obs_kf_all, 0)], -1)
        keep = ci >= 0
        sel_p, sel_o = np.nonzero(keep)
        O = len(sel_p)
        if O < 10:
            return
        kfs_sel = obs_kf_all[sel_p, sel_o]
        feats_sel = obs_feat_all[sel_p, sel_o]
        uv_sel = mp.kf_xy[kfs_sel, feats_sel]
        ur_sel = mp.kf_ur[kfs_sel, feats_sel]
        stereo_sel = ur_sel > 0
        obs_uv = np.concatenate(
            [uv_sel, np.where(stereo_sel, ur_sel, 0.0)[:, None]], axis=1
        ).astype(np.float32)
        obs_isig = (1.0 / self.sigma2[mp.kf_octave[kfs_sel, feats_sel]]).astype(np.float32)

        # Gauge: fix the OLDEST keyframe by serial (the reference fixes
        # KF id 0, Optimizer.cc:79; slot 0 may have been recycled).
        C, P = len(live), len(pts)
        cam_fixed = np.zeros(C, bool)
        cam_fixed[int(np.argmin(mp.kf_serial[live]))] = True

        up = to_device(
            self.device, mp.kf_pose[live], cam_fixed, np.ones(C, bool),
            mp.pt_xyz[pts], np.ones(P, bool),
            ci[sel_p, sel_o].astype(np.int32), sel_p.astype(np.int32), obs_uv,
            stereo_sel, obs_isig, np.ones(O, bool),
        )
        problem = ba_mod.BAProblem(
            cam_T=up[0], cam_fixed=up[1],
            cam_valid=up[2],
            points=up[3], point_valid=up[4],
            obs_cam=up[5], obs_pt=up[6], obs_uv=up[7],
            obs_stereo=up[8], obs_inv_sigma2=up[9], obs_valid=up[10],
            K=self.K, bf=torch.tensor(float(self.cfg.camera.bf), device=self.device),
        )
        problem = ba_mod.sort_by_point(problem)
        job = dict(
            problem=problem,
            kfs=live,
            kf_serials=mp.kf_serial[live].copy(),
            pts=pts,
            pt_serials=mp.pt_serial[pts].copy(),
            iters_first=self.cfg.optimizer.global_ba_its,
            iters_second=self.cfg.optimizer.global_ba_its,
            pcg_iters=self.cfg.optimizer.pcg_iters,
            chi2_mono=self.cfg.optimizer.chi2_mono,
            chi2_stereo=self.cfg.optimizer.chi2_stereo,
        )
        # The LM schedule is chunked one iteration per frame, so tracking
        # interleaves with the solve; more than one shard: the map-sharded
        # solve (parallel/sharded_ba).
        self.gba_job = (_ShardedGbaJob if self.mesh.size > 1 else _GbaJob)(mesh=self.mesh, **job)
        self.gba_job.advance()  # dispatch the first chunk now

    def _advance_gba(self):
        """Called once per tracked frame: push the background solve one
        chunk forward; apply when finished, waiting for the final
        readback."""
        job = self.gba_job
        if job is None:
            return False
        job.advance()
        if not job.ready():
            return False
        self.gba_job = None
        self._apply_gba(job)
        return True

    def _apply_gba(self, job: "_GbaJob"):
        """Write the snapshot solve back into the (evolved) map:
        serial-guarded pose/point writes + spanning-tree replay for
        keyframes and points born during the solve (reference:
        LoopClosing.cc:665-737)."""
        mp = self.map
        if self.on_before_correction is not None:
            self.on_before_correction()
        cam_T, points = job.result()

        # 1. Snapshot keyframes still live under the same identity.
        T_bef: dict[int, np.ndarray] = {}
        T_new: dict[int, np.ndarray] = {}
        for i, k in enumerate(job.kfs):
            k = int(k)
            if mp.kf_valid[k] and mp.kf_serial[k] == job.kf_serials[i]:
                T_bef[k] = mp.kf_pose[k].copy()
                T_new[k] = cam_T[i]

        if not T_new:
            return

        # 2. Replay keyframes born during the solve via the spanning tree
        # (reference :677-715): T_new[child] = T_cur[child] ∘
        # T_bef[parent]^-1 ∘ T_new[parent]. Children are newer than their
        # parents in serial order, so one serial-sorted pass converges;
        # re-parenting edge cases get two extra passes.
        live_now = mp.live_keyframes()
        rest = sorted(
            (k for k in live_now if k not in T_new),
            key=lambda k: mp.kf_serial[k],
        )
        for _ in range(3):
            progressed = False
            for k in rest:
                if k in T_new:
                    continue
                p = int(mp.spanning_parent[k])
                if p in T_new:
                    T_cur = mp.kf_pose[k]
                    rel = np_se3.compose(T_cur, np_se3.inverse(T_bef[p]))
                    T_bef[k] = T_cur.copy()
                    T_new[k] = np_se3.compose(rel, T_new[p])
                    progressed = True
            if not progressed:
                break
        # A keyframe whose parent chain never resolves (e.g. a spanning
        # parent culled into a dead slot) keeps its pre-GBA pose while the
        # rest of the map shifts — make that visible instead of silent.
        unresolved = [k for k in rest if k not in T_new]
        self.n_gba_replay_unresolved = len(unresolved)
        if unresolved:
            _dbg(
                f"GBA replay: {len(unresolved)} keyframes kept pre-GBA "
                f"poses (unresolved parent chains): {unresolved[:8]}"
            )

        # 3. Points: snapshot points (same identity) take the solved
        # position; points born during the solve move with their
        # reference keyframe's correction: x' = T_new[ref]^-1 T_bef[ref] x
        # (reference :716-736).
        snap_ok = mp.pt_valid[job.pts] & (mp.pt_serial[job.pts] == job.pt_serials)
        snap_pts = job.pts[snap_ok]
        mp.pt_xyz[snap_pts] = points[snap_ok]

        snap_set = np.zeros(mp.pt_xyz.shape[0], bool)
        snap_set[snap_pts] = True
        other = mp.live_points()
        other = other[~snap_set[other]]
        moved = [int(p) for p in other]
        if moved:
            T_bef_arr = np.zeros((mp.kf_pose.shape[0], 3, 4), np.float32)
            T_new_arr = np.zeros_like(T_bef_arr)
            has = np.zeros(mp.kf_pose.shape[0], bool)
            for k in T_new:
                T_bef_arr[k] = T_bef[k]
                T_new_arr[k] = T_new[k]
                has[k] = True
            refs = mp.pt_ref_kf[moved]
            ok = (refs >= 0) & has[np.maximum(refs, 0)]
            sel = np.asarray(moved)[ok]
            if len(sel):
                r = refs[ok]
                x = mp.pt_xyz[sel]
                Rb = T_bef_arr[r, :, :3]
                tb = T_bef_arr[r, :, 3]
                x_cam = np.einsum("nij,nj->ni", Rb, x) + tb
                Rn = T_new_arr[r, :, :3]
                tn = T_new_arr[r, :, 3]
                x_new = np.einsum("nji,nj->ni", Rn, x_cam - tn)
                mp.pt_xyz[sel] = x_new.astype(np.float32)

        # 4. Publish + re-anchor the tracker off the newest corrected KF.
        all_k = np.asarray(sorted(T_new), np.int64)
        for k in all_k:
            mp.kf_pose[k] = T_new[int(k)]
        mp.mark_kf_pose_dirty(all_k)
        mp.mark_points_dirty(mp.live_points())
        mp.big_change_idx += 1
        self.n_gba_applied += 1
        _dbg(
            f"GBA applied: {len(job.kfs)} snap KFs, "
            f"{len(T_new) - len([k for k in job.kfs if int(k) in T_new])} replayed"
        )
        if self.on_pose_correction is not None:
            anchor = int(all_k[np.argmax(mp.kf_serial[all_k])])
            self.on_pose_correction(anchor, T_bef[anchor], T_new[anchor])
