"""The port's RGB-D slice end to end against the JAX package: both
Systems (loop closing off) track the 24-frame synthetic RGB-D run of
tests/e2e_stereo_debug.py (640x480, 800 features, 4 levels) on the CPU,
from the same rendered frames.

Gates: each tracks more than 80% of the frames with ATE < 0.05 m at
absolute scale (the gate of tests/test_e2e_stereo.py), and the first 5
tracked poses of the two agree within 5 mm and 1e-3 rad: both run the same
control flow (lock-step pipeline, stage-counted mapping on the CPU), and
their per-frame float32 solves differ only in summation order.
"""

import numpy as np
import pytest
import torch

import e2e_stereo_debug
from c_orb_slam_tpu import config as jcfg
from c_orb_slam_tpu.io import trajectory as jtraj
from c_orb_slam_tpu.system import System as JaxSystem
from c_orb_slam_tpu_torch import config as tcfg
from c_orb_slam_tpu_torch.io import trajectory as ttraj
from c_orb_slam_tpu_torch.system import System as TorchSystem

from synthetic import blob_world, render_depth, render_scene, smooth_trajectory

N_FRAMES = 24

# One intra-op thread: the test processes run side by side, and torch's
# spinning OpenMP workers across processes slow each small op many-fold.
torch.set_num_threads(1)


def _cfg(mod):
    """tests/e2e_stereo_debug.py's RGB-D configuration."""
    cam = mod.CameraConfig(
        fx=500, fy=500, cx=320, cy=240, width=640, height=480, fps=10,
        bf=500.0 * e2e_stereo_debug.BASELINE,
    )
    return mod.SlamConfig(
        sensor=mod.Sensor.RGBD, camera=cam, orb=mod.OrbConfig(n_features=800, n_levels=4),
        tracking=mod.TrackingConfig(
            min_stereo_init_points=60, velocity_rotation_fraction=0.5, max_frames_between_kf=10,
        ),
    )


@pytest.fixture(scope="module")
def sequence():
    xw, inten, size = blob_world(400, seed=5)
    traj = smooth_trajectory(N_FRAMES)
    K4 = (500.0, 500.0, 320.0, 240.0)
    frames = [(render_scene(xw, inten, size, T, K4), render_depth(xw, size, T, K4)) for T in traj]
    return traj, frames


def _run(sysm, frames, traj, traj_io):
    for i, (img, depth) in enumerate(frames):
        sysm.track_rgbd(img, depth, i * 0.1)
    sysm.shutdown()
    poses, stamps = sysm.frame_poses()
    ids = [int(round(t * 10)) for t in stamps]
    return poses, ids, traj_io.ate_rmse(poses, traj[ids], with_scale=False)


def test_rgbd_slice_matches_jax(sequence):
    traj, frames = sequence
    j_poses, j_ids, j_ate = _run(
        JaxSystem(_cfg(jcfg), enable_loop_closing=False), frames, traj, jtraj
    )
    t_sys = TorchSystem(_cfg(tcfg), torch.device("cpu"), enable_loop_closing=False)
    t_poses, t_ids, t_ate = _run(t_sys, frames, traj, ttraj)

    for n_ok, ate in ((len(j_poses), j_ate), (len(t_poses), t_ate)):
        assert n_ok > 0.8 * N_FRAMES, f"tracked only {n_ok}/{N_FRAMES} frames"
        assert ate < 0.05, f"ATE {ate:.4f} m"
    assert t_ids[:5] == j_ids[:5]
    for Tt, Tj in zip(t_poses[:5], j_poses[:5]):
        np.testing.assert_allclose(Tt[:, 3], Tj[:, 3], atol=5e-3)
        np.testing.assert_allclose(Tt[:, :3], Tj[:, :3], atol=1e-3)
    assert t_sys.local_mapping.n_local_ba >= 1
    assert np.isfinite(t_poses).all()


def test_unported_entry_points_raise(tmp_path):
    """Every entry point of the JAX System is ported now: none raises
    NotImplementedError."""
    cfg = _cfg(tcfg)
    # Loop closing defaults on, as in the JAX API, and is ported: the
    # constructor loads the port's own vocabulary.
    with_loop = TorchSystem(cfg, "cpu")
    assert with_loop.loop_closing.voc.n_words == 10**5
    assert with_loop.tracker.reloc_provider is with_loop.loop_closing
    sysm = TorchSystem(cfg, "cpu", enable_loop_closing=False)
    assert sysm.loop_closing is None
    sysm.activate_localization_mode()
    assert sysm.localization_only and sysm.tracker.only_tracking
    path = str(tmp_path / "empty_map.npz")
    sysm.save_map(path)
    loaded = TorchSystem.from_saved_map(path, cfg, "cpu", enable_loop_closing=False)
    assert loaded.map.n_keyframes == 0 and loaded.localization_only
