"""Relocalization and the early-loss reset of the port against the JAX
package: both Systems (loop closing off, so no vocabulary: relocalization
candidates are the 10 most recent keyframes) track tests/test_torch_slice.py's
RGB-D configuration with two blank frames (all-zero image and depth, a
dropped or black sensor frame) in the sequence, on the CPU.

- 40 frames, frames 28-29 blank, 9 keyframes by then: both lose the view
  and relocalize on the first frame after it, 30 or 31 (the recovery
  frame's PnP RANSAC draws differ between jax.random and torch, hazard e,
  so the gate is on outcomes), and end OK; the port tracks >= 36 frames
  with ATE < 0.05 m at absolute scale.
- 24 frames, frames 14-15 blank, at most 5 keyframes: the loss asks for a
  reset. Frame 15 returns None in both, both re-initialise from frame 16
  and end OK on the rebuilt map: every live keyframe is stamped >= 1.6 s.
"""

import numpy as np
import torch

from c_orb_slam_tpu import config as jcfg
from c_orb_slam_tpu.io import trajectory as jtraj
from c_orb_slam_tpu.system import System as JaxSystem
from c_orb_slam_tpu.tracking import TrackState as JaxState
from c_orb_slam_tpu_torch import config as tcfg
from c_orb_slam_tpu_torch.io import trajectory as ttraj
from c_orb_slam_tpu_torch.system import System as TorchSystem
from c_orb_slam_tpu_torch.tracking import TrackState as TorchState

from synthetic import blob_world, render_depth, render_scene, smooth_trajectory
from test_torch_slice import _cfg

# One intra-op thread: the test processes run side by side, and torch's
# spinning OpenMP workers across processes slow each small op many-fold.
torch.set_num_threads(1)


def _frames(n, blank):
    xw, inten, size = blob_world(400, seed=5)
    traj = smooth_trajectory(n)
    K4 = (500.0, 500.0, 320.0, 240.0)
    frames = []
    for i, T in enumerate(traj):
        if i in blank:
            frames.append((np.zeros((480, 640), np.float32), np.zeros((480, 640), np.float32)))
        else:
            frames.append((render_scene(xw, inten, size, T, K4), render_depth(xw, size, T, K4)))
    return traj, frames


def _run(sysm, frames):
    returned = [sysm.track_rgbd(img, depth, i * 0.1) for i, (img, depth) in enumerate(frames)]
    sysm.shutdown()
    return returned


def _both(n, blank):
    traj, frames = _frames(n, blank)
    j_sys = JaxSystem(_cfg(jcfg), enable_loop_closing=False)
    t_sys = TorchSystem(_cfg(tcfg), torch.device("cpu"), enable_loop_closing=False)
    return traj, (j_sys, _run(j_sys, frames)), (t_sys, _run(t_sys, frames))


def test_relocalizes_after_blank_frames():
    traj, (j_sys, _), (t_sys, _) = _both(40, blank=(28, 29))
    for sysm, ok_state in ((j_sys, JaxState.OK), (t_sys, TorchState.OK)):
        assert sysm.tracking_state() == ok_state
        assert 30 <= sysm.tracker.last_reloc_frame_id <= 31, sysm.tracker.last_reloc_frame_id
    poses, stamps = t_sys.frame_poses()
    ids = [int(round(t * 10)) for t in stamps]
    assert len(poses) >= 36, f"tracked only {len(poses)}/40 frames"
    assert not {28, 29} & set(ids)
    ate = ttraj.ate_rmse(poses, traj[ids], with_scale=False)
    assert ate < 0.05, f"ATE {ate:.4f} m"
    j_poses, j_stamps = j_sys.frame_poses()
    j_ids = [int(round(t * 10)) for t in j_stamps]
    assert jtraj.ate_rmse(j_poses, traj[j_ids], with_scale=False) < 0.05


def test_early_loss_resets_and_reinitializes():
    _, (j_sys, j_ret), (t_sys, t_ret) = _both(24, blank=(14, 15))
    for sysm, ret, ok_state in ((j_sys, j_ret, JaxState.OK), (t_sys, t_ret, TorchState.OK)):
        assert ret[15] is None
        assert sysm.tracking_state() == ok_state
        live = sysm.map.live_keyframes()
        assert len(live) >= 1
        assert (sysm.map.kf_timestamp[live] >= 1.6 - 1e-9).all(), sysm.map.kf_timestamp[live]
    assert t_ret[-1] is not None and np.isfinite(t_ret[-1]).all()
