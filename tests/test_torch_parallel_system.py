"""The port's sharded routes inside the live objects, against the JAX
package, on the CPU.

tests/conftest.py gives JAX 8 virtual CPU devices, so the JAX package
takes its multi-device routes: parallel/dba for a full-bucket local BA,
parallel/dpose_graph for the essential graph and _ShardedGbaJob for the
global BA. The port takes the same routes on an 8-shard in-process CPU
mesh, with the essential graph and the global BA chunked one iteration a
frame (JAX solves each in one dispatch). Held here: the routes
themselves, the keyframe poses of the tiny loop system of
tests/test_torch_loop_correction.py after its correction and after its
global BA, a full-bucket ``LocalMapping._solve_local_ba``, that a failure
on the sharded route raises instead of falling back to one device, that
System takes an in-process mesh only, and
``LocalMapping.process_keyframe`` (the synchronous pass) from one saved
map in both packages.
"""

import itertools
import time

import torch.distributed as tdist

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_loop_correction as tlc
from c_orb_slam_tpu import config as jcfg
from c_orb_slam_tpu.io import checkpoint as jckpt
from c_orb_slam_tpu.mapping import LocalMapping as JaxLocalMapping
from c_orb_slam_tpu.optim import ba as jba
from c_orb_slam_tpu.slam_map.mapstate import MapState as JaxMapState
from c_orb_slam_tpu_torch import config as tcfg
from c_orb_slam_tpu_torch.io import checkpoint as tckpt
from c_orb_slam_tpu_torch.mapping import LocalMapping as TorchLocalMapping
from c_orb_slam_tpu_torch.optim import ba as tba
from c_orb_slam_tpu_torch.parallel import dba, dpose_graph, sharded_ba
from c_orb_slam_tpu_torch.parallel.mesh import Mesh, make_mesh
from c_orb_slam_tpu_torch.slam_map.mapstate import MapState as TorchMapState
from c_orb_slam_tpu_torch.system import System as TorchSystem

from synthetic import blob_world, render_depth, render_scene, smooth_trajectory

torch.set_num_threads(1)
CPU = torch.device("cpu")

# Full-bucket local BA, port (8 shards) against JAX (8 devices): cam_T
# measured 1.2e-6; twice that, rounded up.
LOCAL_BA_TOL_JAX = 3e-6
# process_keyframe from one saved map: keyframe poses measured 3.3e-5 and
# map points 2.6e-3 apart (the farthest are seen from two keyframes);
# twice that, rounded up.
PK_POSE_TOL, PK_POINT_TOL = 7e-5, 6e-3


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def _torch_pkg(mesh):
    """test_torch_loop_correction's TORCH namespace, its System on `mesh`."""
    return tlc.types.SimpleNamespace(
        **{**vars(tlc.TORCH), "system": lambda cfg, **kw: TorchSystem(cfg, CPU, mesh=mesh, **kw)})


def test_sharded_loop_route_matches_jax(eight_devices):
    """The tiny loop system's correction on the sharded route, in both
    packages: the edge-sharded essential graph (one dispatch in JAX, one
    GN iteration a call in the port), then a _ShardedGbaJob (the port's
    one LM iteration a call); keyframe poses at
    test_torch_loop_correction's tolerances after each."""
    mesh = Mesh(["cpu"] * 8)
    pkgs = (tlc.JAX, _torch_pkg(mesh))
    systems = [tlc._tiny_system(pkg) for pkg in pkgs]
    tlc._same_keyframes(*systems, tlc.POSE_TOL_BEFORE)
    walks = []
    for pkg, sysm in zip(pkgs, systems):
        lc = tlc._arm_correction(pkg, sysm, 0.05)
        stages = [lc.correction_job.stage]
        for _ in range(200):
            lc.advance_background()
            if lc.correction_job is None:
                break
            stages.append(lc.correction_job.stage)
            time.sleep(0.002)  # lets the JAX readback workers run
        assert lc.correction_job is None, f"{pkg.name}: stuck at {stages[-1]}"
        assert type(lc.gba_job).__name__ == "_ShardedGbaJob", pkg.name
        walks.append([s for s, _ in itertools.groupby(stages)])
    assert walks[0] == ["fuse", "pg_build", "pg_fetch", "arm_gba"]
    assert walks[1] == ["fuse", "pg_build", "pg", "pg_fetch", "arm_gba"]
    opt = systems[1].cfg.optimizer
    assert stages.count("pg") == opt.essential_graph_its  # one GN iteration a call
    assert systems[1].loop_closing.pg_routes == {"gn_step": 0, "dpose_graph": 1}
    tlc._same_keyframes(*systems, tlc.POSE_TOL_BEFORE)  # after the essential graph
    n_before = dict(mesh.counts)
    assert n_before["psum"][0] > 0  # the essential graph's psums

    polls = []
    for sysm in systems:
        lc = sysm.loop_closing
        for i in range(200):
            if lc.gba_job is None:
                break
            lc.advance_background()
            time.sleep(0.002)
        assert lc.gba_job is None and lc.n_gba_applied == 1
        polls.append(i)
    # The port's sharded job steps one LM iteration a call (the first on
    # arming) and applies on the CPU as soon as its readback is queued.
    assert polls[1] == 2 * opt.global_ba_its - 1
    assert mesh.counts["psum_scatter"][0] > 0 and mesh.counts["all_gather"][0] > 0
    tlc._same_keyframes(*systems, tlc.POSE_TOL_AFTER)


def _local_ba_problem(C, P, O, seed=0):
    """A well-posed window (two cameras fixed) padded into a (C, P, O)
    bucket: numpy arrays in BAProblem field order."""
    rng = np.random.default_rng(seed)
    Cr, Pr, Or = C - 4, P // 2, O - 48  # about 8 observations a point
    cam_T = np.tile(np.eye(3, 4, dtype=np.float32), (C, 1, 1))
    cam_T[:Cr, 0, 3] = -0.15 * np.arange(Cr)
    cam_T[:Cr, 1, 3] = 0.05 * (np.arange(Cr) % 3)
    pts = np.zeros((P, 3), np.float32)
    pts[:Pr] = np.c_[rng.uniform(-2, 2, (Pr, 2)), rng.uniform(4, 8, Pr)]
    obs_cam = np.zeros(O, np.int32)
    obs_pt = np.zeros(O, np.int32)
    obs_cam[:Or] = rng.integers(0, Cr, Or)
    obs_pt[:Or] = rng.integers(0, Pr, Or)
    xc = pts[obs_pt] + cam_T[obs_cam][:, :, 3]
    uv = np.zeros((O, 3), np.float32)
    uv[:Or, 0] = 500 * xc[:Or, 0] / xc[:Or, 2] + 320
    uv[:Or, 1] = 500 * xc[:Or, 1] / xc[:Or, 2] + 240
    noisy = pts + rng.normal(0, 0.01, pts.shape).astype(np.float32) * (np.arange(P) < Pr)[:, None]
    return (cam_T, np.arange(C) < 2, np.arange(C) < Cr, noisy.astype(np.float32),
            np.arange(P) < Pr, obs_cam, obs_pt, uv, np.zeros(O, bool),
            np.ones(O, np.float32), np.arange(O) < Or,
            np.array([500.0, 500.0, 320.0, 240.0], np.float32), np.array(0.0, np.float32))


def _small_cap(c):
    return c.SlamConfig(capacity=c.CapacityConfig(
        local_ba_max_kfs=8, local_ba_max_points=512, local_ba_max_obs=2048))


def test_full_bucket_local_ba_routes_to_dba(eight_devices):
    """_solve_local_ba(small=False) on the same full-bucket problem: JAX
    at 8 devices and the port on an 8-shard mesh both take dba (dense
    Schur); the inlier flags come back at the bucket's O."""
    C, P, O = 16, 512, 2048  # the full bucket of _small_cap
    arrays = _local_ba_problem(C, P, O)
    jprob = jba.BAProblem(*(jnp.asarray(a) for a in arrays))
    tprob = tba.BAProblem(*(torch.from_numpy(np.array(a)) for a in arrays))
    jres = JaxLocalMapping(_small_cap(jcfg), JaxMapState(_small_cap(jcfg)))._solve_local_ba(
        jprob, False, O)

    tcf = _small_cap(tcfg)
    sharded = TorchLocalMapping(tcf, TorchMapState(tcf, compute_device=CPU), CPU,
                                mesh=Mesh(["cpu"] * 8))
    single = TorchLocalMapping(tcf, TorchMapState(tcf, compute_device=CPU), CPU, Mesh([CPU]))
    tres = sharded._solve_local_ba(tprob, False, O)
    sres = single._solve_local_ba(tprob, False, O)
    assert sharded.ba_routes == {"ba.bundle_adjust": 0, "dba": 1}
    assert single.ba_routes == {"ba.bundle_adjust": 1, "dba": 0}
    assert sharded.mesh.counts["psum"][0] > 0
    assert tres.obs_inlier.shape == (O,) and np.asarray(jres.obs_inlier).shape == (O,)
    np.testing.assert_array_equal(tres.obs_inlier.numpy(), np.asarray(jres.obs_inlier))
    np.testing.assert_array_equal(tres.obs_inlier.numpy(), sres.obs_inlier.numpy())
    np.testing.assert_allclose(tres.cam_T.numpy(), sres.cam_T.numpy(), atol=5e-4)
    np.testing.assert_allclose(tres.cam_T.numpy(), np.asarray(jres.cam_T), atol=LOCAL_BA_TOL_JAX)
    # A small bucket stays on one device, whatever the mesh.
    sharded._solve_local_ba(tprob, True, O)
    assert sharded.ba_routes == {"ba.bundle_adjust": 1, "dba": 1}


def test_sharded_route_failure_raises(monkeypatch):
    """A mesh of more than one shard never falls back to a single-device
    solve: a failure of a sharded solver reaches the caller, in the local
    BA, the essential graph and the global BA."""
    def boom(*args, **kwargs):
        raise RuntimeError("sharded solver failed")

    mesh = Mesh(["cpu"] * 2)
    tcf = _small_cap(tcfg)
    mapper = TorchLocalMapping(tcf, TorchMapState(tcf, compute_device=CPU), CPU, mesh=mesh)
    prob = tba.BAProblem(*(torch.from_numpy(np.array(a)) for a in _local_ba_problem(16, 512, 2048)))
    monkeypatch.setattr(dba, "distributed_bundle_adjust", boom)
    with pytest.raises(RuntimeError, match="sharded solver failed"):
        mapper._solve_local_ba(prob, False, 2048)
    assert mapper.ba_routes["ba.bundle_adjust"] == 0

    pkg = _torch_pkg(mesh)
    for solver, module, name in ((dpose_graph, "pg", "graph_solve"),
                                 (sharded_ba, "gba", "map_sharded_solve")):
        sysm = tlc._tiny_system(pkg)
        lc = tlc._arm_correction(pkg, sysm, 0.05)
        with monkeypatch.context() as m:
            m.setattr(solver, name, boom)
            with pytest.raises(RuntimeError, match="sharded solver failed"):
                for _ in range(100):
                    lc.advance_background()
        assert lc.pg_routes["gn_step"] == 0, module
        assert lc.gba_job is None, module  # no single-device _GbaJob instead


def test_system_mesh_is_in_process(tmp_path):
    """System decides the mesh, in process whatever the state of
    torch.distributed (a one-rank gloo group here), and refuses a
    process-group mesh: each rank's mapper and loop closer would call
    collectives on their own schedules."""
    cfg = _small_cap(tcfg)
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                             world_size=1)
    try:
        sysm = TorchSystem(cfg, CPU, enable_loop_closing=False)
        assert not sysm.mesh.group and sysm.mesh.size == 1
        assert sysm.local_mapping.mesh is sysm.mesh
        grouped = make_mesh(device_type="cpu")  # the default mirrors jax.devices()
        assert grouped.group
        with pytest.raises(ValueError, match="in-process mesh"):
            TorchSystem(cfg, CPU, enable_loop_closing=False, mesh=grouped)
    finally:
        tdist.destroy_process_group()


def _rgbd_cfg(c):
    cam = c.CameraConfig(fx=125, fy=125, cx=80, cy=60, width=160, height=120, fps=10,
                         bf=125.0 * 0.2)
    return c.SlamConfig(
        sensor=c.Sensor.RGBD, camera=cam, orb=c.OrbConfig(n_features=150, n_levels=2),
        tracking=c.TrackingConfig(min_stereo_init_points=10, min_inliers_local_map=8,
                                  min_inliers_pose=6, max_frames_between_kf=2),
    )


def test_process_keyframe_matches_jax(tmp_path):
    """The synchronous mapping pass from one saved map: the port maps a
    short RGB-D sequence keyframe by keyframe with process_keyframe, holds
    the next keyframe back, and saves the map; each package loads it and
    runs process_keyframe on the held keyframe. Same keyframes, same live
    points and keyframe-point links, poses and points within the gap
    measured between the packages' float32 solves."""
    n = 12
    xw, inten, size = blob_world(200, seed=5)
    K4 = (125.0, 125.0, 80.0, 60.0)
    sysm = TorchSystem(_rgbd_cfg(tcfg), CPU, enable_loop_closing=False)
    mapper = sysm.local_mapping
    mapper.insert_keyframe = mapper.process_keyframe  # synchronous mapping
    held = []
    for i, T in enumerate(smooth_trajectory(n, speed=0.3)):
        if i == n - 3:
            mapper.insert_keyframe = held.append
        sysm.track_rgbd(render_scene(xw, inten, size, T, K4, h=120, w=160),
                        render_depth(xw, size, T, K4, h=120, w=160), i * 0.1)
        if held:
            break
    assert held and mapper.n_local_ba >= 2, "no keyframe held back, or no local BA before it"
    assert mapper.idle()
    path = str(tmp_path / "map.npz")
    tckpt.save_map(path, sysm.map)

    out = []
    for mapper in (
        JaxLocalMapping(_rgbd_cfg(jcfg), jckpt.load_map(path, _rgbd_cfg(jcfg))[0]),
        TorchLocalMapping(_rgbd_cfg(tcfg), tckpt.load_map(path, _rgbd_cfg(tcfg), CPU)[0], CPU,
                          Mesh([CPU])),
    ):
        m = mapper.map
        n_before = int(m.pt_valid.sum())
        mapper.process_keyframe(held[0])
        live, pts = m.live_keyframes(), m.live_points()
        assert len(live) > 2 and len(pts) != n_before  # local BA ran; points culled and made
        out.append((list(live), m.kf_pose[live].copy(), list(pts), m.pt_xyz[pts].copy(),
                    m.kf_mp.copy()))
    (j_kf, j_pose, j_pts, j_xyz, j_mp), (t_kf, t_pose, t_pts, t_xyz, t_mp) = out
    assert t_kf == j_kf and t_pts == j_pts
    np.testing.assert_array_equal(t_mp, j_mp)
    np.testing.assert_allclose(t_pose, j_pose, atol=PK_POSE_TOL)
    np.testing.assert_allclose(t_xyz, j_xyz, atol=PK_POINT_TOL)
