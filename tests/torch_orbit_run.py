"""One run of the loop orbit through one package, for comparing the port
with the JAX package outside the test suite (several minutes a run on
the CPU).

    python tests/torch_orbit_run.py {torch,jax} {mono,stereo} FRAMES \
        [--threads N] [--repo PATH]

The orbit and the configuration are tests/test_torch_loop_slice.py's:
half resolution (320x240), 800 features on 4 levels, a 16-keyframe local
BA window, loop closing on; FRAMES poses of e2e_loop_debug.orbit_trajectory
(1.18 laps whatever the count). Prints one JSON line: frames tracked, ATE
(scale-aligned for mono), the loop and global-BA frames, and for the port
the dense-Schur Cholesky calls and those that failed. The count wraps
torch.linalg.cholesky_ex (matrices wider than 12: the reduced camera
systems) so that it reads a port without a failure counter too: --repo
points the imports at another checkout, e.g. a parent commit's.
"""

import argparse
import json
import os
import sys
import time

ap = argparse.ArgumentParser()
ap.add_argument("package", choices=("torch", "jax"))
ap.add_argument("sensor", choices=("mono", "stereo"))
ap.add_argument("frames", type=int)
ap.add_argument("--threads", type=int, default=1)
ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
args = ap.parse_args()
sys.path[:0] = [args.repo, os.path.join(args.repo, "tests")]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import torch  # noqa: E402

import e2e_loop_debug  # noqa: E402
from synthetic import render_scene, render_stereo_pair  # noqa: E402

torch.set_num_threads(args.threads)
mono = args.sensor == "mono"
solves = []  # (frame, info) of each dense-Schur factorization
frame_no = [0]
if args.package == "torch":
    factor = torch.linalg.cholesky_ex

    def counted(A, *a, **kw):
        L, info = factor(A, *a, **kw)
        if A.shape[-1] > 12:
            solves.append((frame_no[0], int(info)))
        return L, info

    torch.linalg.cholesky_ex = counted
    from c_orb_slam_tpu_torch import config as cfgm
    from c_orb_slam_tpu_torch.io import trajectory as traj_io
    from c_orb_slam_tpu_torch.system import System
else:
    from c_orb_slam_tpu import config as cfgm
    from c_orb_slam_tpu.io import trajectory as traj_io
    from c_orb_slam_tpu.system import System

SCALE = 0.5
cam = cfgm.CameraConfig(
    fx=500 * SCALE, fy=500 * SCALE, cx=320 * SCALE, cy=240 * SCALE,
    width=int(640 * SCALE), height=int(480 * SCALE), fps=10,
    bf=0.0 if mono else 500.0 * SCALE * e2e_loop_debug.BASELINE)
cfg = cfgm.SlamConfig(
    sensor=cfgm.Sensor.MONOCULAR if mono else cfgm.Sensor.STEREO, camera=cam,
    orb=cfgm.OrbConfig(n_features=800, n_levels=4),
    tracking=cfgm.TrackingConfig(min_stereo_init_points=60, velocity_rotation_fraction=0.5,
                                 max_frames_between_kf=10),
    capacity=cfgm.CapacityConfig(local_ba_max_kfs=16, local_ba_max_points=4096,
                                 local_ba_max_obs=8192))
K4 = (cam.fx, cam.fy, cam.cx, cam.cy)
xw, inten, size = e2e_loop_debug.orbit_world(n=1400, seed=7)
traj = e2e_loop_debug.orbit_trajectory(args.frames)
sysm = (System(cfg, torch.device("cpu"), enable_loop_closing=True) if args.package == "torch"
        else System(cfg))
lc = sysm.loop_closing
t0 = time.time()
loop_at = gba_at = None
for i, T in enumerate(traj):
    frame_no[0] = i
    if mono:
        sysm.track_monocular(render_scene(xw, inten, size, T, K4, h=cam.height, w=cam.width),
                             i * 0.1)
    else:
        left, right = render_stereo_pair(xw, inten, size, T, K4, e2e_loop_debug.BASELINE,
                                         h=cam.height, w=cam.width)
        sysm.track_stereo(left, right, i * 0.1)
    if loop_at is None and lc.n_loops_closed:
        loop_at = i
    if gba_at is None and lc.n_gba_applied:
        gba_at = i
sysm.shutdown()
poses, stamps = sysm.frame_poses()
ids = [int(round(t * 10)) for t in stamps]
failed = [f for f, info in solves if info != 0]
print(json.dumps(dict(
    package=args.package, sensor=args.sensor, frames=args.frames, threads=args.threads,
    tracked=len(poses), ate=float(traj_io.ate_rmse(poses, traj[ids], with_scale=mono)),
    loops=lc.n_loops_closed, loop_at=loop_at, gba=lc.n_gba_applied, gba_at=gba_at,
    untracked=sorted(set(range(args.frames)) - set(ids)), dense_solves=len(solves),
    failed_factorizations=len(failed), seconds=round(time.time() - t0, 1))), flush=True)
