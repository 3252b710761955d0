"""Hold the port's product surface to an accuracy number.

Counterpart of tools/eval_cli_kitti.py. Renders a KITTI-format sequence
tree (PNG images, times.txt and a reference-key settings.yaml) with the
repo's synthetic renderer (tests/synthetic.py), drives the port's real
driver on it (``c_orb_slam_tpu_torch.examples.stereo_kitti``: YAML
parsing, dataset indexer, native decoder, System, trajectory saver) in a
subprocess, and computes the ATE of the saved KITTI trajectory against
the rendered ground truth. Prints one JSON line; writes it to a file only
when given ``--json``.

Usage: python3 -m c_orb_slam_tpu_torch.tools.eval_cli_kitti [--frames N] [--device cuda|cpu] [--json PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np

from c_orb_slam_tpu_torch.io import trajectory as traj_io
from c_orb_slam_tpu_torch.io.images import write_png

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SETTINGS_YAML = """%YAML:1.0
Camera.fx: 718.856
Camera.fy: 718.856
Camera.cx: 607.1928
Camera.cy: 185.2157
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 1241
Camera.height: 376
Camera.fps: 10.0
Camera.bf: 143.7712
Camera.RGB: 1
ThDepth: 35.0
ORBextractor.nFeatures: 2000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
Tracking.minStereoInitPoints: 60
"""

BASELINE = 0.2  # world-units stereo baseline; bf = fx * BASELINE


def generate_tree(d: str, n: int) -> np.ndarray:
    """Write an n-frame KITTI tree under d; returns the (n, 3, 4) world->cam
    ground truth."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from synthetic import blob_world, render_stereo_pair, smooth_trajectory

    os.makedirs(os.path.join(d, "image_0"))
    os.makedirs(os.path.join(d, "image_1"))
    xw, inten, size = blob_world(1200, seed=5, x_max=22.0)
    traj = smooth_trajectory(n, speed=0.35)
    K4 = (718.856, 718.856, 607.1928, 185.2157)
    with open(os.path.join(d, "times.txt"), "w") as f:
        for i in range(n):
            f.write(f"{i * 0.1:.6e}\n")
    for i in range(n):
        pair = render_stereo_pair(xw, inten, size, traj[i], K4, BASELINE, h=376, w=1241)
        for side, img in zip(("image_0", "image_1"), pair):
            write_png(os.path.join(d, side, f"{i:06d}.png"),
                      np.clip(img, 0, 255).astype(np.uint8))
    with open(os.path.join(d, "settings.yaml"), "w") as f:
        f.write(SETTINGS_YAML)
    return traj


def kitti_ate(rows_path: str, traj: np.ndarray) -> tuple[int, Optional[float]]:
    """(rows, ATE m at absolute scale) of a saved KITTI trajectory, whose
    rows are flattened 3x4 camera-to-world poses, one per tracked frame in
    order; with no frame lost, row i is frame i (ATE None otherwise)."""
    rows = np.loadtxt(rows_path).reshape(-1, 3, 4)
    if len(rows) != len(traj):
        return len(rows), None
    poses_cw = np.stack([
        np.concatenate([T[:, :3].T, (-T[:, :3].T @ T[:, 3])[:, None]], axis=1) for T in rows
    ])
    return len(rows), float(traj_io.ate_rmse(poses_cw, traj, with_scale=False))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=80)
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default="", help="also write the JSON line to this file")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="cli_kitti_") as d:
        traj = generate_tree(d, args.frames)
        out = os.path.join(d, "traj.txt")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "c_orb_slam_tpu_torch.examples.stereo_kitti",
             os.path.join(d, "settings.yaml"), d, "--out", out,
             "--kf-out", os.path.join(d, "kf.txt"), "--no-realtime", "--device", args.device],
            capture_output=True, text=True, timeout=3600, cwd=REPO,
        )
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            sys.stderr.write(r.stdout[-2000:] + "\n" + r.stderr[-3000:])
            raise SystemExit("the stereo_kitti driver failed")
        n_rows, ate = kitti_ate(out, traj)
    rec = {"metric": "cli_stereo_kitti_ate_m", "n_frames": args.frames, "n_tracked": n_rows,
           "cli_wall_s": round(wall, 1), "device": args.device, "value": ate}
    print(json.dumps(rec))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)
    if n_rows != args.frames:
        raise SystemExit(f"tracked {n_rows}/{args.frames} frames")
    return rec


if __name__ == "__main__":
    main()
