"""Shared runner for the dataset drivers.

Counterpart of examples/common.py. Reference: each of the six
Examples/*.cc binaries is the same loop: load the image list, construct
System, per-frame Track + timing, real-time throttle, print median/mean
tracking time, save the trajectory (e.g. Examples/Stereo/
stereo_kitti.cc:54-126). This module is that loop, on the device the
caller picks (``--device``, CUDA unless asked otherwise).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from c_orb_slam_tpu_torch.config import Sensor, SlamConfig
from c_orb_slam_tpu_torch.io.native import Prefetcher
from c_orb_slam_tpu_torch.system import System


def standard_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("settings", help="settings YAML (reference key names)")
    p.add_argument("sequence", help="dataset sequence directory")
    p.add_argument("--out", default="CameraTrajectory.txt")
    p.add_argument("--kf-out", default="KeyFrameTrajectory.txt")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--no-realtime", action="store_true",
                   help="run as fast as possible (no frame pacing)")
    p.add_argument("--save-map", default="", help="checkpoint map to this .npz")
    add_device_arg(p)
    return p


def add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; --device cpu for the CPU)")


def pick_device(name: str) -> torch.device:
    """The device a driver runs on. A CUDA device that is not there ends
    the run: the drivers never fall back to the CPU on their own."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"no CUDA device for --device {name}; pass --device cpu to run on the CPU"
        )
    return device


def run_sequence(
    cfg: SlamConfig,
    stamps,
    left_paths,
    right_paths=None,
    depth_paths=None,
    rectifier=None,
    args=None,
    kitti_format=False,
):
    """Track a sequence from disk; RGB-D depth is read at its stored
    value (16-bit included), which cfg.tracking.depth_map_factor scales
    to metres, as the reference does (rgbd_tum.cc reads depth with
    CV_LOAD_IMAGE_UNCHANGED)."""
    n = len(stamps)
    if args and args.max_frames:
        n = min(n, args.max_frames)
        stamps = stamps[:n]
        left_paths = left_paths[:n]
        if right_paths:
            right_paths = right_paths[:n]
        if depth_paths:
            depth_paths = depth_paths[:n]

    sysm = System(cfg, pick_device(args.device if args else "cuda"))
    left_src = Prefetcher(left_paths)
    if right_paths:
        other_src = Prefetcher(right_paths)
    elif depth_paths:
        other_src = Prefetcher(depth_paths, raw=True)
    else:
        other_src = None

    track_times = []
    try:
        for i in range(n):
            _, img_l = next(left_src)
            img_o = next(other_src)[1] if other_src else None
            t0 = time.perf_counter()
            if cfg.sensor == Sensor.STEREO:
                if rectifier is not None:
                    img_l, img_o = rectifier(img_l, img_o)
                sysm.track_stereo(img_l, img_o, stamps[i])
            elif cfg.sensor == Sensor.RGBD:
                sysm.track_rgbd(img_l, img_o, stamps[i])
            else:
                sysm.track_monocular(img_l, stamps[i])
            dt = time.perf_counter() - t0
            track_times.append(dt)
            if args and not args.no_realtime and i + 1 < n:
                budget = stamps[i + 1] - stamps[i]
                if dt < budget:
                    time.sleep(budget - dt)
    finally:
        left_src.close()
        if other_src is not None:
            other_src.close()

    # Median/mean tracking time report (reference: stereo_kitti.cc:113-122).
    tt = np.sort(np.asarray(track_times))
    print("-------")
    print(f"median tracking time: {tt[len(tt) // 2]:.4f}")
    print(f"mean tracking time: {tt.mean():.4f}")

    # Settle tracking, mapping and loop pipelines (incl. any in-flight
    # background global BA) before exporting trajectories, as the
    # reference's Shutdown waits out its GBA thread (System.cc:313).
    sysm.shutdown()
    if args:
        if kitti_format:
            sysm.save_trajectory_kitti(args.out)
        else:
            sysm.save_trajectory_tum(args.out)
        sysm.save_keyframe_trajectory_tum(args.kf_out)
        print(f"trajectory saved to {args.out}")
        if args.save_map:
            sysm.save_map(args.save_map)
            print(f"map saved to {args.save_map}")
    return sysm
