"""The trajectory writers against the JAX package's (ROADMAP.md queue 3 item
s): one short monocular run through both Systems, tests/test_trajectory_export.py's
18 frames with dataset-like stamps, then save_trajectory_tum,
save_trajectory_kitti and save_keyframe_trajectory_tum from each.

Compared: the stamps, equal as written (the dataset's, never frame ids;
keyframes in temporal order); the camera centres within 2e-3 (the map's
units: both initialize the same two-view map and its scale, then their
solvers sum in other orders); the rotations, as the quaternions written in
the TUM files and the 3x3 blocks of the KITTI rows, within 2e-3 (a
quaternion and its negation are one rotation); and, within the port's
files, each TUM centre and quaternion against the KITTI row of its frame,
the quaternion as so3.from_matrix of the row's rotation, within 5e-6 (7
decimals written in the TUM file, 7 significant digits in the KITTI one).
"""

import threading

import numpy as np
import torch

from c_orb_slam_tpu import config as jcfg
from c_orb_slam_tpu.system import System as JaxSystem
from c_orb_slam_tpu_torch import config as tcfg
from c_orb_slam_tpu_torch.geometry import so3
from c_orb_slam_tpu_torch.system import System as TorchSystem

from synthetic import blob_world, render_scene, smooth_trajectory

torch.set_num_threads(1)
N = 18
STAMPS = [1234.5 + 0.1 * i for i in range(N)]


def _cfg(mod):
    cam = mod.CameraConfig(fx=500, fy=500, cx=320, cy=240, width=640, height=480, fps=10)
    return mod.SlamConfig(sensor=mod.Sensor.MONOCULAR, camera=cam,
                          orb=mod.OrbConfig(n_features=600, n_levels=4))


def _write(sysm, d, side):
    paths = {k: str(d / f"{side}_{k}.txt") for k in ("tum", "kitti", "kf")}
    sysm.save_trajectory_tum(paths["tum"])
    sysm.save_trajectory_kitti(paths["kitti"])
    sysm.save_keyframe_trajectory_tum(paths["kf"])
    return {k: np.loadtxt(p, ndmin=2) for k, p in paths.items()}


def _same_rotation(q, r, atol):
    """(F, 4) quaternions, each equal to the other's or to its negation."""
    sign = np.where((q * r).sum(1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose(q, r * sign, atol=atol)


def test_trajectory_writers_match_jax(tmp_path):
    xw, inten, size = blob_world(300, seed=3)
    traj = smooth_trajectory(N)
    K4 = (500.0, 500.0, 320.0, 240.0)
    frames = [render_scene(xw, inten, size, T, K4) for T in traj]
    systems = {"jax": JaxSystem(_cfg(jcfg), enable_loop_closing=False),
               "port": TorchSystem(_cfg(tcfg), torch.device("cpu"), enable_loop_closing=False)}
    out, errors = {}, []

    def run(side):
        try:
            sysm = systems[side]
            for i in range(N):
                sysm.track_monocular(frames[i], STAMPS[i])
            sysm.shutdown()
            out[side] = _write(sysm, tmp_path, side)
        except BaseException as e:  # re-raised in the main thread
            errors.append(e)

    jax_run = threading.Thread(target=run, args=("jax",))
    jax_run.start()
    run("port")
    jax_run.join(timeout=600)
    assert not jax_run.is_alive() and not errors, errors
    j, t = out["jax"], out["port"]
    for k in ("tum", "kf"):
        assert len(t[k]) >= 2 and t[k].shape == j[k].shape, k
        np.testing.assert_array_equal(t[k][:, 0], j[k][:, 0])  # stamps as written
        assert all(any(abs(s - x) < 1e-6 for x in STAMPS) for s in t[k][:, 0])
        assert (np.diff(t[k][:, 0]) > 0).all()
        np.testing.assert_allclose(t[k][:, 1:4], j[k][:, 1:4], atol=2e-3)  # centres
        _same_rotation(t[k][:, [7, 4, 5, 6]], j[k][:, [7, 4, 5, 6]], 2e-3)  # (w, x, y, z)
    assert t["kitti"].shape == (len(t["tum"]), 12) == j["kitti"].shape
    Twc_t, Twc_j = t["kitti"].reshape(-1, 3, 4), j["kitti"].reshape(-1, 3, 4)
    np.testing.assert_allclose(Twc_t[:, :, 3], Twc_j[:, :, 3], atol=2e-3)
    np.testing.assert_allclose(Twc_t[:, :, :3], Twc_j[:, :, :3], atol=2e-3)
    np.testing.assert_allclose(Twc_t[:, :, 3], t["tum"][:, 1:4], atol=5e-6)
    q = so3.from_matrix(torch.from_numpy(Twc_t[:, :, :3]).to(torch.float32)).numpy()
    _same_rotation(t["tum"][:, [7, 4, 5, 6]], q, 5e-6)
