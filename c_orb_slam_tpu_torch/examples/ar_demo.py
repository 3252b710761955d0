"""AR demo: track a synthetic sequence, detect the dominant plane from the
map, and render a virtual cube into every frame: the headless equivalent
of the reference's monoAR ROS node (reference:
Examples/ROS/ORB_SLAM2/src/AR/ros_mono_ar.cc + ViewerAR.cc). Counterpart
of examples/ar_demo.py; writes PNGs with PIL.

Usage: python3 -m c_orb_slam_tpu_torch.examples.ar_demo [out_dir] [n_frames] [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

from c_orb_slam_tpu_torch.config import CameraConfig, OrbConfig, Sensor, SlamConfig
from c_orb_slam_tpu_torch.examples.common import add_device_arg, pick_device
from c_orb_slam_tpu_torch.system import System
from c_orb_slam_tpu_torch.viz import ar
from c_orb_slam_tpu_torch.viz.frame_drawer import _to_rgb_u8

_TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "tests")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out_dir", nargs="?", default="ar_out")
    p.add_argument("n_frames", nargs="?", type=int, default=30)
    add_device_arg(p)
    args = p.parse_args(argv)
    device = pick_device(args.device)
    sys.path.insert(0, _TESTS)
    from synthetic import blob_world, render_scene, smooth_trajectory

    cam = CameraConfig(fx=500, fy=500, cx=320, cy=240, width=640, height=480, fps=10)
    cfg = SlamConfig(sensor=Sensor.MONOCULAR, camera=cam,
                     orb=OrbConfig(n_features=1000, n_levels=8))
    xw, inten, size = blob_world(400, seed=5)
    # Make the world plane-dominant (an AR demo needs a surface to anchor
    # to): squash 70% of the blobs onto a fronto-parallel "wall".
    n_plane = int(0.7 * len(xw))
    xw = np.asarray(xw).copy()
    xw[:n_plane, 2] = 6.0
    traj = smooth_trajectory(args.n_frames)
    frames = [render_scene(xw, inten, size, traj[i], (500, 500, 320, 240))
              for i in range(args.n_frames)]
    sysm = System(cfg, device)
    os.makedirs(args.out_dir, exist_ok=True)
    from PIL import Image

    plane = None
    K4 = np.array([cam.fx, cam.fy, cam.cx, cam.cy])
    for i, fr in enumerate(frames):
        pose = sysm.track_monocular(fr, i * 0.1)
        if pose is None:
            continue
        if plane is None and sysm.map.pt_valid.sum() > 100:
            res = ar.detect_plane(sysm.map.pt_xyz[sysm.map.pt_valid])
            if res is not None:
                origin, normal, _ = res
                plane = ar.plane_basis(origin, normal)
                print(f"frame {i}: plane detected, normal={normal.round(3)}")
        img = _to_rgb_u8(fr)
        if plane is not None:
            img = ar.draw_cube_overlay(img, pose, K4, plane, size=0.3)
        Image.fromarray(img).save(f"{args.out_dir}/ar_{i:04d}.png")
    sysm.shutdown()
    print(f"wrote {args.n_frames} frames to {args.out_dir}/")
    return sysm


if __name__ == "__main__":
    main()
