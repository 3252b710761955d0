"""Localization mode's device step and its visual-odometry rows: the port's
tracking._full_track_step and Tracking._vo_arrays against the JAX
package's (XLA branch), on the same numpy inputs, on the CPU.

Inputs: two consecutive 320x240 RGB-D frames of tests/synthetic.py's blob
world, built once by the JAX frontend and handed to both packages as the
same arrays; a map of the first frame's depth keypoints; the first frame's
features split into map rows (last_mp >= 0), VO rows (vo_valid, no map
point) and empty rows.

Tolerances: every match output (stage-1 and stage-2 indices and flags,
the frustum cull) is equal; the two pose Gauss-Newton solves sum their
normal equations in another order, so poses agree within 1e-4 and the
inlier flags on at least 99% of the features, the inlier counts within 2.
_vo_arrays is host numpy on both sides: equal flags, world points within
1e-5 m.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_orb_slam_tpu import config as jcfg
from c_orb_slam_tpu import tracking as jtrack
from c_orb_slam_tpu.frontend import frame as jframe
from c_orb_slam_tpu.slam_map.mapstate import MapState as JaxMapState
from c_orb_slam_tpu_torch import config as tcfg
from c_orb_slam_tpu_torch import tracking as ttrack
from c_orb_slam_tpu_torch.frontend import frame as tframe
from c_orb_slam_tpu_torch.slam_map.mapstate import MapState as TorchMapState
from c_orb_slam_tpu_torch.utils.host import fetch

from synthetic import blob_world, render_depth, render_scene, smooth_trajectory

torch.set_num_threads(1)

W, H, F = 320, 240, 250.0
K4 = (F, F, W / 2, H / 2)


def small_cfg(mod, sensor=None):
    """320x240 RGB-D at half the TUM focal length, 400 features, 4 levels."""
    cam = mod.CameraConfig(fx=F, fy=F, cx=W / 2, cy=H / 2, width=W, height=H, fps=10,
                           bf=F * 0.2)
    return mod.SlamConfig(
        sensor=mod.Sensor.RGBD if sensor is None else sensor, camera=cam,
        orb=mod.OrbConfig(n_features=400, n_levels=4),
        tracking=mod.TrackingConfig(min_stereo_init_points=60, velocity_rotation_fraction=0.5,
                                    max_frames_between_kf=10),
    )


@pytest.fixture(scope="module")
def scene():
    jc = small_cfg(jcfg)
    xw, inten, size = blob_world(400, seed=5)
    traj = smooth_trajectory(8)
    frames = []
    for T in traj[5:7]:
        img, depth = render_scene(xw, inten, size, T, K4, h=H, w=W), render_depth(xw, size, T, K4, h=H, w=W)
        f = jframe.build_rgbd(jnp.asarray(img), jnp.asarray(depth), jc)
        frames.append(jframe.FrameData(*(np.asarray(a) for a in f)))
    return traj[5:7], frames


def _t(a):
    """numpy -> a CPU tensor (uint32 descriptor words as int32, same bits)."""
    return torch.from_numpy(np.array(a.view(np.int32) if a.dtype == np.uint32 else a))


def _torch_frame(fh):
    return tframe.FrameData(*(_t(a) for a in fh))


def _world_points(fh, T):
    """World positions of a frame's keypoints at their depth."""
    xc = np.stack([(fh.xy[:, 0] - K4[2]) * fh.depth / K4[0],
                   (fh.xy[:, 1] - K4[3]) * fh.depth / K4[1], fh.depth], axis=1)
    R, t = T[:, :3], T[:, 3]
    return ((xc - t) @ R).astype(np.float32)


def test_full_track_step_with_vo_rows_matches_jax(scene):
    traj, (f0, f1) = scene
    rng = np.random.default_rng(0)
    n = f0.xy.shape[0]
    has_depth = f0.valid & (f0.depth > 0)
    xw = _world_points(f0, traj[0])
    # Map: every depth keypoint of frame 0 is a point; rows alternate
    # between map rows and VO rows.
    ids = np.nonzero(has_depth)[0]
    Np = 512
    PT_xyz = np.zeros((Np, 3), np.float32)
    PT_desc = np.zeros((Np, 8), np.uint32)
    PT_normal = np.zeros((Np, 3), np.float32)
    PT_mind, PT_maxd = np.zeros(Np, np.float32), np.zeros(Np, np.float32)
    PT_valid = np.zeros(Np, bool)
    m = len(ids)
    assert 100 < m <= Np, m
    PT_xyz[:m] = xw[ids]
    PT_desc[:m] = f0.desc[ids]
    center = -traj[0][:, :3].T @ traj[0][:, 3]
    po = xw[ids] - center
    dist = np.linalg.norm(po, axis=1)
    PT_normal[:m] = po / dist[:, None]
    PT_mind[:m], PT_maxd[:m] = 0.5 * dist, 2.0 * dist
    PT_valid[:m] = rng.random(m) > 0.05
    last_mp = np.full(n, -1, np.int32)
    vo_valid = np.zeros(n, bool)
    vo_xyz = np.zeros((n, 3), np.float32)
    map_rows = ids[0::2]
    vo_rows = ids[1::2]
    last_mp[map_rows] = np.nonzero(np.isin(ids, map_rows))[0]
    vo_valid[vo_rows] = True
    vo_xyz[vo_rows] = xw[vo_rows]
    local_idx = np.full(Np, -1, np.int32)
    local_idx[:m] = np.arange(m)
    T_pred = traj[1].copy()
    T_pred[:, 3] += np.array([0.01, -0.005, 0.01], np.float32)
    jc, tc = small_cfg(jcfg), small_cfg(tcfg)
    sf = np.asarray(jc.orb.scale_factors(), np.float32)
    inv_s2 = (1.0 / np.asarray(jc.orb.level_sigma2(), np.float32)).astype(np.float32)
    K = np.asarray(K4, np.float32)
    head = (T_pred, last_mp, f0.octave, f0.desc, vo_xyz, vo_valid, local_idx,
            PT_xyz, PT_normal, PT_mind, PT_maxd, PT_desc, PT_valid)
    j_out, j_chain = jtrack._full_track_step(
        jc, *(jnp.asarray(a) for a in head), jframe.FrameData(*(jnp.asarray(a) for a in f1)),
        jnp.asarray(K), jnp.asarray(inv_s2), jnp.asarray(sf))
    t_out, t_chain = ttrack._full_track_step(
        tc, *(_t(a) for a in head), _torch_frame(f1), _t(K), _t(inv_s2), _t(sf))
    j_out = [np.asarray(a) for a in j_out]
    t_out = [a.numpy() for a in t_out]
    names = ("mm_ok", "m1_idx", "good_q", "in_view", "m2_idx", "m2_valid", "pose", "inliers",
             "n_inliers")
    j, t = dict(zip(names, j_out)), dict(zip(names, t_out))
    assert bool(j["mm_ok"]) and bool(t["mm_ok"])
    # The VO rows take part: some of the stage-1 inliers are VO rows.
    assert j["good_q"][vo_rows].sum() > 20 and j["good_q"][map_rows].sum() > 20
    for name in ("m1_idx", "good_q", "in_view", "m2_idx", "m2_valid"):
        np.testing.assert_array_equal(t[name], j[name], err_msg=name)
    np.testing.assert_allclose(t["pose"], j["pose"], atol=1e-4)
    np.testing.assert_allclose(t_chain.numpy(), np.asarray(j_chain), atol=1e-4)
    assert (t["inliers"] == j["inliers"]).mean() >= 0.99
    assert abs(int(t["n_inliers"]) - int(j["n_inliers"])) <= 2
    assert int(j["n_inliers"]) > 100


@pytest.mark.parametrize("sensor, only_tracking", [
    ("RGBD", True), ("RGBD", False), ("MONOCULAR", True),
])
def test_vo_arrays_match_jax(scene, sensor, only_tracking):
    """VO rows exist only in localization mode with depth: the close-depth
    keypoints of the last frame that have no map point, in world
    coordinates; otherwise both return zeros (the port's on the device)."""
    traj, (f0, _) = scene
    rng = np.random.default_rng(1)
    n = f0.xy.shape[0]
    last_mp = np.where(rng.random(n) < 0.4, rng.integers(0, 100, n), -1).astype(np.int64)
    jc = small_cfg(jcfg, getattr(jcfg.Sensor, sensor))
    tc = small_cfg(tcfg, getattr(tcfg.Sensor, sensor))
    cpu = torch.device("cpu")
    trackers = (jtrack.Tracking(jc, JaxMapState(jc)),
                ttrack.Tracking(tc, TorchMapState(tc, compute_device=cpu), cpu))
    trackers[0].last_frame = jframe.FrameData(*(jnp.asarray(a) for a in f0))
    trackers[1].last_frame = _torch_frame(f0)
    for tr in trackers:
        tr.only_tracking = only_tracking
        tr.last_pose = traj[0].copy()
        tr.last_mp = last_mp.copy()
    (j_xyz, j_valid), (t_xyz, t_valid) = (tr._vo_arrays(n) for tr in trackers)
    active = only_tracking and sensor == "RGBD"
    # Active rows are host arrays to upload; inactive ones cached device zeros.
    assert isinstance(t_valid, np.ndarray) == active
    t_xyz, t_valid = fetch(t_xyz, t_valid)
    np.testing.assert_array_equal(t_valid, np.asarray(j_valid))
    np.testing.assert_allclose(t_xyz, np.asarray(j_xyz), atol=1e-5)
    want = (f0.depth > 0) & (f0.depth < 35.0 * 0.2) & (last_mp < 0) & f0.valid
    np.testing.assert_array_equal(t_valid, want & active)
    assert want.sum() > 50
