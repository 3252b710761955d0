"""The port's monocular path end to end against the JAX package: both
Systems (loop closing off) track tests/e2e_debug.py's 30-frame synthetic
monocular run (640x480, 800 features, 4 levels) on the CPU, from the same
rendered frames: two-view initialization with its initial BA, then
tracking, mapping and local BA.

Gate, on outcomes only: each tracks more than 80% of the frames with ATE
< 0.12 m after scale alignment (the gate of tests/test_e2e_mono.py). The
two-view RANSAC draws come from jax.random on one side and a
torch.Generator on the other (hazard e), so the initial maps differ by
the RANSAC outcome and the trajectories are not compared pose by pose.
"""

import torch

from c_orb_slam_tpu import config as jcfg
from c_orb_slam_tpu.io import trajectory as jtraj
from c_orb_slam_tpu.system import System as JaxSystem
from c_orb_slam_tpu_torch import config as tcfg
from c_orb_slam_tpu_torch.io import trajectory as ttraj
from c_orb_slam_tpu_torch.system import System as TorchSystem

from synthetic import blob_world, render_scene, smooth_trajectory

N_FRAMES = 30

# One intra-op thread: the test processes run side by side, and torch's
# spinning OpenMP workers across processes slow each small op many-fold.
torch.set_num_threads(1)


def _cfg(mod):
    """tests/e2e_debug.py's monocular configuration."""
    cam = mod.CameraConfig(fx=500, fy=500, cx=320, cy=240, width=640, height=480, fps=10)
    return mod.SlamConfig(sensor=mod.Sensor.MONOCULAR, camera=cam,
                          orb=mod.OrbConfig(n_features=800, n_levels=4))


def _run(sysm, frames, traj, traj_io):
    for i, img in enumerate(frames):
        sysm.track_monocular(img, i * 0.1)
    sysm.shutdown()
    poses, stamps = sysm.frame_poses()
    ids = [int(round(t * 10)) for t in stamps]
    return poses, traj_io.ate_rmse(poses, traj[ids], with_scale=True)


def test_mono_slice_matches_jax():
    xw, inten, size = blob_world(400, seed=5)
    traj = smooth_trajectory(N_FRAMES)
    frames = [render_scene(xw, inten, size, T, (500.0, 500.0, 320.0, 240.0)) for T in traj]
    j_poses, j_ate = _run(JaxSystem(_cfg(jcfg), enable_loop_closing=False), frames, traj, jtraj)
    t_sys = TorchSystem(_cfg(tcfg), torch.device("cpu"), enable_loop_closing=False)
    t_poses, t_ate = _run(t_sys, frames, traj, ttraj)
    for name, n_ok, ate in (("jax", len(j_poses), j_ate), ("torch", len(t_poses), t_ate)):
        assert n_ok > 0.8 * N_FRAMES, f"{name}: tracked only {n_ok}/{N_FRAMES} frames"
        assert ate < 0.12, f"{name}: ATE {ate:.4f} m (scaled)"
    assert t_sys.map.n_added_keyframes > 2  # initialised, then mapped on
