"""Live-source monocular SLAM: the ROS-node equivalent.

Counterpart of examples/stream_mono.py (reference:
Examples/ROS/ORB_SLAM2/src/ros_mono.cc, a subscriber callback feeding
System::TrackMonocular per message, :45-60). The transport is a generic
frame iterator (a directory of images or the built-in synthetic
generator), decoupling acquisition from tracking as the ROS node does.

Usage:
  python3 -m c_orb_slam_tpu_torch.examples.stream_mono synthetic [n_frames] [--device cpu]
  python3 -m c_orb_slam_tpu_torch.examples.stream_mono dir /path/to/pngs settings.yaml
"""

import argparse
import glob
import os
import sys
import time

import numpy as np

from c_orb_slam_tpu_torch.config import CameraConfig, OrbConfig, Sensor, SlamConfig, load_yaml
from c_orb_slam_tpu_torch.examples.common import add_device_arg, pick_device
from c_orb_slam_tpu_torch.io.native import decode_gray
from c_orb_slam_tpu_torch.system import System

_TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "tests")


def synthetic_source(n_frames=60):
    """Built-in generator (no dataset needed): the repo's renderer."""
    sys.path.insert(0, _TESTS)
    from synthetic import blob_world, render_scene, smooth_trajectory

    xw, inten, size = blob_world(400, seed=5)
    traj = smooth_trajectory(n_frames)
    for i in range(n_frames):
        yield i / 10.0, render_scene(xw, inten, size, traj[i], (500, 500, 320, 240))


def directory_source(path):
    """Stream image files from a directory in name order (a file-drop
    'topic'; replace with a socket or camera reader in deployment)."""
    for p in sorted(glob.glob(os.path.join(path, "*.png"))):
        yield float(os.path.getmtime(p)), decode_gray(p)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("mode", nargs="?", default="synthetic", choices=("synthetic", "dir"))
    p.add_argument("rest", nargs="*", help="synthetic: [n_frames]; dir: <dir> <settings.yaml>")
    p.add_argument("--out", default="stream_trajectory.txt")
    add_device_arg(p)
    args = p.parse_args(argv)
    device = pick_device(args.device)
    if args.mode == "dir":
        cfg = load_yaml(args.rest[1], Sensor.MONOCULAR)
        source = directory_source(args.rest[0])
    else:
        cam = CameraConfig(fx=500, fy=500, cx=320, cy=240, width=640, height=480, fps=10)
        cfg = SlamConfig(sensor=Sensor.MONOCULAR, camera=cam,
                         orb=OrbConfig(n_features=1000, n_levels=8))
        source = synthetic_source(int(args.rest[0]) if args.rest else 60)

    sysm = System(cfg, device)
    n_ok = n_all = 0
    t0 = time.time()
    for ts, image in source:
        pose = sysm.track_monocular(np.asarray(image), ts)
        n_all += 1
        n_ok += pose is not None
    sysm.shutdown()
    dt = time.time() - t0
    s = sysm.metrics.summary()
    print(
        f"tracked {n_ok}/{n_all} frames in {dt:.1f}s "
        f"({n_all / dt:.2f} fps incl warmup; steady median "
        f"{s['median_ms']:.0f} ms/frame)"
    )
    sysm.save_trajectory_tum(args.out)
    print(f"trajectory -> {args.out}")
    return sysm


if __name__ == "__main__":
    main()
