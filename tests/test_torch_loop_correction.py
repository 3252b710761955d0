"""The port's staged loop correction against the JAX package's, on the
CPU. Each test drives BOTH packages on the same inputs and compares what
they do: the twins of tests/test_loop_correction.py (shutdown
mid-correction drains to a fixed point; the correction advances one chunk
a frame), the SearchBySim3 widening of tests/test_loop_optim.py, a stale
detection after slot reuse, and the small-capacity run of
tests/test_kf_capacity.py with loop closing ON, so that recycled keyframe
slots meet the loop closer's serial guards and its database eviction.

The tiny stereo sequence uses no RANSAC, so the two packages build the
same map (keyframe poses within 5e-3) and the correction can be held
stage by stage; the monocular capacity run starts from a RANSAC
initialization whose streams differ, and is held on outcomes.
"""

import itertools
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_orb_slam_tpu import config as jcfg
from c_orb_slam_tpu.geometry import np_se3 as j_np_se3, sim3 as jsim3
from c_orb_slam_tpu.loop_closing import LoopClosing as JaxLoopClosing
from c_orb_slam_tpu.slam_map.mapstate import MapState as JaxMapState
from c_orb_slam_tpu.system import System as JaxSystem
from c_orb_slam_tpu_torch import config as tcfg
from c_orb_slam_tpu_torch.geometry import np_se3 as t_np_se3, sim3 as tsim3
from c_orb_slam_tpu_torch.loop_closing import LoopClosing as TorchLoopClosing
from c_orb_slam_tpu_torch.parallel.mesh import Mesh
from c_orb_slam_tpu_torch.slam_map.mapstate import MapState as TorchMapState
from c_orb_slam_tpu_torch.system import System as TorchSystem

from synthetic import blob_world, render_scene, render_stereo_pair, smooth_trajectory

torch.set_num_threads(1)
CPU = torch.device("cpu")

# What differs between the packages' call signatures, and nothing else.
JAX = types.SimpleNamespace(
    name="jax", cfg=jcfg, np_se3=j_np_se3, sim3=jsim3,
    tensor=jnp.asarray,
    system=lambda cfg, **kw: JaxSystem(cfg, **kw),
    mapstate=lambda cfg: JaxMapState(cfg),
    loop_closing=lambda cfg, mp: JaxLoopClosing(cfg, mp, vocabulary=None),
)
TORCH = types.SimpleNamespace(
    name="torch", cfg=tcfg, np_se3=t_np_se3, sim3=tsim3,
    tensor=lambda a: torch.from_numpy(np.ascontiguousarray(a)),
    system=lambda cfg, **kw: TorchSystem(cfg, CPU, **kw),
    mapstate=lambda cfg: TorchMapState(cfg, compute_device=CPU),
    loop_closing=lambda cfg, mp: TorchLoopClosing(cfg, mp, CPU, Mesh([CPU]), vocabulary=None),
)
BOTH = (JAX, TORCH)


@pytest.fixture(autouse=True)
def one_jax_device(monkeypatch):
    """The port runs on one device. Where the test session gives JAX a
    mesh of CPU devices, the JAX package would solve the essential graph
    and the global BA in one sharded dispatch each; held to one device it
    takes the chunked gn_step and _GbaJob, the port's counterparts."""
    first = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *args: first)

# Keyframe poses of the two packages on the tiny sequence: 2.4e-3 apart
# before the correction (float32 tracking and local BA), 9.1e-3 after the
# global BA it arms; twice that is allowed.
POSE_TOL_BEFORE = 5e-3
POSE_TOL_AFTER = 2e-2


def _tiny_system(pkg, n_frames=6):
    c = pkg.cfg
    cam = c.CameraConfig(
        fx=125, fy=125, cx=80, cy=60, width=160, height=120, fps=10, bf=125.0 * 0.2,
    )
    cfg = c.SlamConfig(
        sensor=c.Sensor.STEREO, camera=cam,
        orb=c.OrbConfig(n_features=150, n_levels=2),
        tracking=c.TrackingConfig(
            min_stereo_init_points=10, min_inliers_local_map=8,
            min_inliers_pose=6, max_frames_between_kf=2,
        ),
    )
    xw, inten, size = blob_world(200, seed=5)
    traj = smooth_trajectory(n_frames, speed=0.3)
    K4 = (cam.fx, cam.fy, cam.cx, cam.cy)
    sysm = pkg.system(cfg)
    for i in range(n_frames):
        l, r = render_stereo_pair(xw, inten, size, traj[i], K4, 0.2, h=120, w=160)
        sysm.track_stereo(l, r, i * 0.1)
    return sysm


def _arm_correction(pkg, sysm, shift=0.0):
    """Start a correction that closes the newest keyframe onto the oldest,
    `shift` metres along x off their present relative pose."""
    lc = sysm.loop_closing
    live = sysm.map.live_keyframes()
    assert len(live) >= 2
    kf, loop_kf = int(live[-1]), int(live[0])
    T_rel = pkg.np_se3.compose(
        sysm.map.kf_pose[kf], pkg.np_se3.inverse(sysm.map.kf_pose[loop_kf])
    ).copy()
    T_rel[0, 3] += shift
    S_cl = pkg.sim3.from_se3(pkg.tensor(T_rel))
    mp_ids = sysm.map.kf_mp[loop_kf]
    lc._correct_loop(kf, loop_kf, S_cl, np.unique(mp_ids[mp_ids >= 0]))
    return lc


def _kf_poses(sysm):
    live = sysm.map.live_keyframes()
    return [int(k) for k in live], sysm.map.kf_pose[live].copy()


def _same_keyframes(j_sys, t_sys, tol):
    (j_live, j_pose), (t_live, t_pose) = _kf_poses(j_sys), _kf_poses(t_sys)
    assert j_live == t_live
    assert np.isfinite(t_pose).all()
    np.testing.assert_allclose(t_pose, j_pose, atol=tol)


@pytest.mark.parametrize("shift", [0.0, 0.05])
def test_shutdown_mid_correction_drains_to_fixed_point(shift):
    systems = []
    for pkg in BOTH:
        sysm = _tiny_system(pkg)
        systems.append(sysm)
        flushed = []
        flush = sysm.tracker.flush_pending
        sysm.loop_closing.on_before_correction = lambda: (flushed.append(1), flush())
        before = _kf_poses(sysm)[1]
        lc = _arm_correction(pkg, sysm, shift)
        assert flushed, f"{pkg.name}: the tracker was not flushed before the map moved"
        assert lc.correction_job is not None
        assert sysm.local_mapping.paused  # frozen topology window
        if shift:  # the propagation moved the newest keyframe, at once
            assert np.abs(_kf_poses(sysm)[1][-1] - before[-1]).max() > 0.5 * shift, pkg.name
        if pkg is TORCH:
            assert sysm.tracker._chain is None  # dropped by _on_loop_correction

        sysm.shutdown()
        assert lc.correction_job is None, pkg.name
        assert lc.gba_job is None, pkg.name
        assert lc.n_gba_applied >= 1, f"{pkg.name}: GBA armed by the correction never ran"
        assert not sysm.local_mapping.paused, f"{pkg.name}: mapper left paused"
        assert len(flushed) >= 3, pkg.name  # propagate, essential graph, GBA
        assert sysm.map_changed() and not sysm.map_changed()
    _same_keyframes(*systems, POSE_TOL_AFTER)


def test_correction_advances_one_chunk_per_frame():
    """Both packages pass through the same stages, one chunk a call, and
    leave the same keyframe poses after the essential graph and after the
    global BA."""
    systems = [_tiny_system(pkg) for pkg in BOTH]
    _same_keyframes(*systems, POSE_TOL_BEFORE)
    walks, gba_calls = [], []
    for pkg, sysm in zip(BOTH, systems):
        lc = _arm_correction(pkg, sysm, 0.05)
        assert not sysm.tracker._need_new_keyframe(None, None)  # window open
        stages = [lc.correction_job.stage]
        for _ in range(200):
            lc.advance_background()
            if lc.correction_job is None:
                break
            stages.append(lc.correction_job.stage)
            time.sleep(0.002)  # lets the readback workers run
        assert lc.correction_job is None, f"{pkg.name}: stuck at {stages[-1]}"
        assert lc.gba_job is not None, f"{pkg.name}: GBA not armed at completion"
        walks.append(stages)
    j_walk, t_walk = walks
    # Staged, not jumped; a wait for a readback repeats a stage, so runs
    # of one stage are compared by name and the GN chunks by count.
    assert [s for s, _ in itertools.groupby(t_walk)] == [
        "fuse", "pg_build", "pg", "pg_fetch", "arm_gba"]
    assert [s for s, _ in itertools.groupby(t_walk)] == [s for s, _ in itertools.groupby(j_walk)]
    its = systems[1].cfg.optimizer.essential_graph_its
    assert t_walk.count("pg") == j_walk.count("pg") == its
    _same_keyframes(*systems, POSE_TOL_BEFORE)  # after the essential graph

    for sysm in systems:
        lc, n = sysm.loop_closing, 0
        while lc.gba_job is not None:
            lc.advance_background()
            n += 1
        assert lc.n_gba_applied == 1
        gba_calls.append(n)
    assert gba_calls[0] == gba_calls[1]  # one LM step a call, on the CPU
    assert gba_calls[1] >= 2 * systems[1].cfg.optimizer.global_ba_its - 1
    _same_keyframes(*systems, POSE_TOL_AFTER)


def test_search_by_sim3_widening_grows_matches():
    """From 12 base matches the widening recovers the rest, and the same
    pairs in both packages."""
    unions = []
    for pkg in BOTH:
        rng = np.random.default_rng(3)
        c = pkg.cfg
        cfg = c.SlamConfig(
            camera=c.CameraConfig(fx=500, fy=500, cx=320, cy=240, width=640, height=480, fps=10),
            orb=c.OrbConfig(n_features=128, n_levels=2),
        )
        mp = pkg.mapstate(cfg)
        N = 60
        xyz = np.c_[rng.uniform(-2, 2, (N, 2)), rng.uniform(5, 9, N)].astype(np.float32)
        desc = rng.integers(0, 2**32, (N, 8), dtype=np.uint64).astype(np.uint32)

        def proj(T, x):
            xc = x @ T[:, :3].T + T[:, 3]
            return np.stack(
                [500 * xc[:, 0] / xc[:, 2] + 320, 500 * xc[:, 1] / xc[:, 2] + 240], axis=1
            ).astype(np.float32)

        T1 = np.eye(3, 4, dtype=np.float32)
        T2 = np.eye(3, 4, dtype=np.float32)
        T2[:, 3] = [0.3, 0.0, 0.1]
        k1 = mp.add_keyframe(0, T1, proj(T1, xyz), np.zeros(N, np.int32),
                             np.zeros(N, np.float32), desc, np.ones(N, bool))
        perm = rng.permutation(N)  # cand's features in a different order
        k2 = mp.add_keyframe(1, T2, proj(T2, xyz)[perm], np.zeros(N, np.int32),
                             np.zeros(N, np.float32), desc[perm], np.ones(N, bool))
        for i in range(N):
            p = mp.add_point(xyz[i], desc[i], k1)
            mp.add_observation(p, k1, i)
            mp.add_observation(p, k2, int(np.nonzero(perm == i)[0][0]))

        lc = pkg.loop_closing(cfg, mp)
        S12 = pkg.sim3.from_se3(pkg.tensor(pkg.np_se3.compose(T1, pkg.np_se3.inverse(T2))))
        base_f1 = np.arange(12)
        base_f2 = np.asarray([int(np.nonzero(perm == i)[0][0]) for i in base_f1])
        u1, u2 = lc._widen_sim3_matches(k1, k2, S12, base_f1, base_f2)
        assert len(u1) > len(base_f1) + 20, pkg.name
        assert (mp.kf_mp[k1][u1] == mp.kf_mp[k2][u2]).mean() > 0.95, pkg.name
        unions.append(sorted(zip(map(int, u1), map(int, u2))))
    assert unions[0] == unions[1]


def test_long_run_beyond_capacity_with_loop_closing_on():
    """More cumulative keyframes than slots, with the loop closer fed by
    every finished keyframe, in both packages: erased keyframes leave the
    place-recognition database, recycled slots are re-indexed under their
    new identity, and a correction armed on the recycled map drains
    cleanly. The port tracks as many frames as the JAX run, within 4."""
    n = 40
    xw, inten, size = blob_world(300, seed=7)
    traj = smooth_trajectory(n)
    frames = [render_scene(xw, inten, size, T, (500, 500, 320, 240)) for T in traj]
    tracked = []
    for pkg in BOTH:
        c = pkg.cfg
        cam = c.CameraConfig(fx=500, fy=500, cx=320, cy=240, width=640, height=480, fps=10)
        cfg = c.SlamConfig(
            sensor=c.Sensor.MONOCULAR, camera=cam,
            orb=c.OrbConfig(n_features=600, n_levels=4),
            capacity=c.CapacityConfig(max_keyframes=10),
        )
        sysm = pkg.system(cfg, enable_loop_closing=True)
        lc = sysm.loop_closing
        erased = []
        on_erased = sysm.map.on_kf_erased
        assert on_erased is not None  # the loop closer's eviction hook
        sysm.map.on_kf_erased = lambda k: (erased.append(k), on_erased(k))
        for i, im in enumerate(frames):
            sysm.track_monocular(im, i * 0.1)
            # The database never holds a dead slot.
            assert not (lc.db is not None and (lc.db.valid & ~sysm.map.kf_valid).any())
        sysm.shutdown()
        assert sysm.map.n_added_keyframes >= 8, pkg.name
        assert int(sysm.map.kf_valid.sum()) <= 10
        assert sysm.map.n_added_keyframes > 10 or erased, f"{pkg.name}: no slot pressure"
        poses, _ = sysm.frame_poses()
        assert len(poses) >= n * 0.5, pkg.name
        tracked.append(len(poses))
        assert lc.idle()
        # Every finished live keyframe is indexed.
        assert lc.db.valid.sum() >= int(sysm.map.kf_valid.sum()) - 2

        # A correction on the recycled map: serial guards see live identities.
        _arm_correction(pkg, sysm)
        sysm.shutdown()
        assert lc.correction_job is None and lc.n_gba_applied >= 1
        assert np.isfinite(sysm.map.kf_pose[sysm.map.live_keyframes()]).all()
        assert np.isfinite(sysm.map.pt_xyz[sysm.map.live_points()]).all()
    assert abs(tracked[1] - tracked[0]) <= 4, tracked


def test_stale_pending_detection_is_dropped_after_slot_reuse():
    """A detection held while its keyframe was erased (or its slot
    recycled) must not index the stale BoW row, in either package."""
    for pkg in BOTH:
        sysm = _tiny_system(pkg)
        lc = sysm.loop_closing
        kf = int(sysm.map.live_keyframes()[-1])
        lc.step(force=True)
        lc._dispatch(kf)
        assert lc._pending_detect is not None
        lc.db.valid[kf] = False
        sysm.map.kf_serial[kf] += 100  # the slot now holds another keyframe
        assert lc.step(force=True) is False, pkg.name
        assert lc._pending_detect is None and not lc.db.valid[kf], pkg.name
