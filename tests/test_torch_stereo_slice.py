"""The port's stereo path end to end against the JAX package: both Systems
(loop closing off) track tests/e2e_stereo_debug.py's 24-frame synthetic
stereo run (rectified 640x480 pairs, baseline 0.2 m, 800 features, 4
levels) on the CPU, from the same rendered pairs.

Gates: each tracks more than 80% of the frames with ATE < 0.03 m at
absolute scale (the gate of tests/test_e2e_stereo.py), and the first 5
tracked poses agree within 5 mm and 1e-3 (rotation entries), as in the
RGB-D slice test: stereo initialization is deterministic, and the two
sides' float32 solves differ only in summation order.
"""

import dataclasses

import numpy as np
import torch

import e2e_stereo_debug
from c_orb_slam_tpu import config as jcfg
from c_orb_slam_tpu.io import trajectory as jtraj
from c_orb_slam_tpu.system import System as JaxSystem
from c_orb_slam_tpu_torch import config as tcfg
from c_orb_slam_tpu_torch.io import trajectory as ttraj
from c_orb_slam_tpu_torch.system import System as TorchSystem

from synthetic import blob_world, render_stereo_pair, smooth_trajectory
from test_torch_slice import _cfg as _rgbd_cfg

N_FRAMES = 24

# One intra-op thread: the test processes run side by side, and torch's
# spinning OpenMP workers across processes slow each small op many-fold.
torch.set_num_threads(1)


def _cfg(mod):
    """tests/e2e_stereo_debug.py's stereo configuration."""
    return dataclasses.replace(_rgbd_cfg(mod), sensor=mod.Sensor.STEREO)


def _run(sysm, pairs, traj, traj_io):
    for i, (left, right) in enumerate(pairs):
        sysm.track_stereo(left, right, i * 0.1)
    sysm.shutdown()
    poses, stamps = sysm.frame_poses()
    ids = [int(round(t * 10)) for t in stamps]
    return poses, ids, traj_io.ate_rmse(poses, traj[ids], with_scale=False)


def test_stereo_slice_matches_jax():
    xw, inten, size = blob_world(400, seed=5)
    traj = smooth_trajectory(N_FRAMES)
    K4 = (500.0, 500.0, 320.0, 240.0)
    pairs = [render_stereo_pair(xw, inten, size, T, K4, e2e_stereo_debug.BASELINE) for T in traj]
    j_poses, j_ids, j_ate = _run(JaxSystem(_cfg(jcfg), enable_loop_closing=False), pairs, traj, jtraj)
    t_sys = TorchSystem(_cfg(tcfg), torch.device("cpu"), enable_loop_closing=False)
    t_poses, t_ids, t_ate = _run(t_sys, pairs, traj, ttraj)
    for name, n_ok, ate in (("jax", len(j_poses), j_ate), ("torch", len(t_poses), t_ate)):
        assert n_ok > 0.8 * N_FRAMES, f"{name}: tracked only {n_ok}/{N_FRAMES} frames"
        assert ate < 0.03, f"{name}: ATE {ate:.4f} m (absolute scale)"
    assert t_ids[:5] == j_ids[:5]
    for Tt, Tj in zip(t_poses[:5], j_poses[:5]):
        np.testing.assert_allclose(Tt[:, 3], Tj[:, 3], atol=5e-3)
        np.testing.assert_allclose(Tt[:, :3], Tj[:, :3], atol=1e-3)
    assert t_sys.local_mapping.n_local_ba >= 1
