"""Benchmark of the port: end-to-end tracking throughput and accuracy on one
device.

Counterpart of bench.py, run as it runs its four configurations: frames
rendered by tests/synthetic.py along the same paths, System(cfg, device)
with loop closing on and the shipped vocabulary, System.warmup() before the
first frame, and the clock over the frames after the warm-up ones (on a
card with a synchronize before it stops: the pipelined readback leaves
work in flight). The shutdown drain and the gates come after the clock.

    python3 -m c_orb_slam_tpu_torch.tools.bench [--config NAME | --all] [--repeat N] [--max-frames N] [--device cuda|cpu]

With no argument it prints one JSON line for the headline configuration,
mono_tum30, whose metric keeps bench.py's name
``tracked_frames_per_sec_1chip``; ``--config NAME`` prints that
configuration's line; ``--all`` prints mono_fast10, stereo_kitti,
stereo_kitti_long and the headline last; ``--repeat N`` runs each of them
N times in a row, one line a run; ``--max-frames N`` cuts each
configuration longer than N frames to its first N (a prefix of the same
path; the line's ``frames`` says how many ran). It writes no file. ``--device``
defaults to cuda and exits nonzero without a card: there is no CPU
fallback (``--device cpu`` runs on the CPU when asked).

Each line carries bench.py's keys with their meanings (``metric``,
``value`` in tracked frames a second over the timed window, ``unit``,
``vs_baseline`` against the configuration's dataset rate, ``ate_m``,
``ate_gate_m``, ``n_tracked``, ``error`` where a gate fails: a tracker not
OK at the end, or ATE over the gate, sets ``vs_baseline`` to 0.0) and adds,
over the timed window: ``ms_per_frame`` (mean wall), ``host_ms_median``
(per ``track_*`` call), ``stage_ms_per_frame`` (host ms of each stage of
``System.metrics``), ``local_ba_solves``, ``dense_schur_lm_iters`` (their
LM iterations: the solves times the configured iterations of a local BA)
and ``dense_schur_lm_iters_failed`` (those whose float32 factorization
failed, counted on the device and read once after the window) and
``window_top2_launches`` and ``pose_gn_launches`` (the two hand-written
kernels'); over the run, ``loops_closed``;
and the device's name, its power limit as nvidia-smi reports it, and the
torch version.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

_TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "tests")

# bench.py:113-158, the same entries and values.
CONFIGS = {
    # Headline: TUM-like 30 Hz pacing (speed 0.4 = ~0.3-1% of scene depth
    # per frame, the TUM inter-frame motion at 30 Hz).
    "mono_tum30": dict(
        sensor="MONOCULAR", n_frames=70, warmup=15, dt_frame=1 / 30.0,
        speed=0.4, ate_gate=0.05, baseline_fps=30.0,
        cam_kwargs=dict(fx=500, fy=500, cx=320, cy=240, width=640,
                        height=480, fps=30),
        orb_kwargs=dict(n_features=1000, n_levels=8),
    ),
    # 10 Hz fast motion (speed 1.0 = 2-4% of scene depth per frame).
    "mono_fast10": dict(
        sensor="MONOCULAR", n_frames=40, warmup=12, dt_frame=0.1,
        speed=1.0, ate_gate=0.08, baseline_fps=10.0,
        cam_kwargs=dict(fx=500, fy=500, cx=320, cy=240, width=640,
                        height=480, fps=10),
        orb_kwargs=dict(n_features=1000, n_levels=8),
    ),
    # Long KITTI-geometry run: 300 frames over a world of 1200 blobs to
    # x = 22 m, gated on tracking survival and ATE.
    "stereo_kitti_long": dict(
        sensor="STEREO", n_frames=300, warmup=15, dt_frame=0.1,
        speed=0.35, ate_gate=0.08, baseline_fps=10.0,
        world_n=1200, world_x_max=22.0,
        cam_kwargs=dict(fx=718.856, fy=718.856, cx=607.19, cy=185.22,
                        width=1241, height=376, fps=10,
                        bf=718.856 * 0.2),
        orb_kwargs=dict(n_features=2000, n_levels=8),
        tracking_kwargs=dict(min_stereo_init_points=60),
    ),
    # KITTI geometry: 1241x376 stereo, 2000 features, 8 levels, 10 Hz.
    "stereo_kitti": dict(
        sensor="STEREO", n_frames=120, warmup=15, dt_frame=0.1,
        speed=0.5, ate_gate=0.05, baseline_fps=10.0,
        cam_kwargs=dict(fx=718.856, fy=718.856, cx=607.19, cy=185.22,
                        width=1241, height=376, fps=10,
                        bf=718.856 * 0.2),
        orb_kwargs=dict(n_features=2000, n_levels=8),
        tracking_kwargs=dict(min_stereo_init_points=60),
    ),
}
HEADLINE = "mono_tum30"
ALL = ("mono_fast10", "stereo_kitti", "stereo_kitti_long", HEADLINE)


def slam_config(sensor, cam_kwargs, orb_kwargs, tracking_kwargs=None):
    """The SlamConfig of a configuration (`sensor` a config.Sensor value)."""
    from c_orb_slam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig, TrackingConfig

    return SlamConfig(sensor=sensor, camera=CameraConfig(**cam_kwargs),
                      orb=OrbConfig(**orb_kwargs),
                      tracking=TrackingConfig(**(tracking_kwargs or {})))


def render(cfg, n_frames, speed, baseline=0.2, world_n=400, world_x_max=10.0):
    """(frames, traj): uint8 images (pairs for stereo) along
    smooth_trajectory(n_frames, speed) through blob_world(world_n, seed=5),
    as bench.py renders them (8-bit, like the datasets' PNGs)."""
    import numpy as np

    from c_orb_slam_tpu_torch.config import Sensor

    sys.path.insert(0, _TESTS)
    from synthetic import blob_world, render_scene, render_stereo_pair, smooth_trajectory

    cam = cfg.camera
    xw, inten, size = blob_world(world_n, seed=5, x_max=world_x_max)
    traj = smooth_trajectory(n_frames, speed=speed)
    K4 = (cam.fx, cam.fy, cam.cx, cam.cy)
    wh = dict(h=cam.height, w=cam.width)

    def u8(im):
        return np.clip(im, 0, 255).astype(np.uint8)

    if cfg.sensor == Sensor.STEREO:
        frames = [tuple(u8(im) for im in render_stereo_pair(xw, inten, size, T, K4, baseline,
                                                            **wh)) for T in traj]
    else:
        frames = [u8(render_scene(xw, inten, size, T, K4, **wh)) for T in traj]
    return frames, traj


def card(device) -> dict:
    """The device's name, its power limit in W (nvidia-smi) and torch's
    version."""
    import torch

    if device.type != "cuda":
        return dict(device="cpu", power_limit_w=None, torch=torch.__version__)
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)[1].split()[0]
    return dict(device=torch.cuda.get_device_name(device), power_limit_w=float(limit),
                torch=torch.__version__)


def load(name, **cut):
    """CONFIGS[name] with the entries in `cut` replaced (a run cut in
    length: n_frames, warmup): the entry (its sensor a config.Sensor), its
    SlamConfig, and the frames and ground-truth path that bench.py renders
    for it."""
    from c_orb_slam_tpu_torch.config import Sensor

    c = dict(CONFIGS[name], **cut)
    c["sensor"] = getattr(Sensor, c["sensor"])
    cfg = slam_config(c["sensor"], c["cam_kwargs"], c["orb_kwargs"], c.get("tracking_kwargs"))
    frames, traj = render(cfg, c["n_frames"], c["speed"], c.get("baseline", 0.2),
                          c.get("world_n", 400), c.get("world_x_max", 10.0))
    return c, cfg, frames, traj


def start(entry, cfg, frames, device):
    """(System, track): System(cfg, device) with loop closing on and the
    shipped vocabulary, after System.warmup() and the configuration's
    warm-up frames; track(i) feeds frame i through the entry point of the
    configuration's sensor."""
    from c_orb_slam_tpu_torch.config import Sensor
    from c_orb_slam_tpu_torch.system import System

    stereo = entry["sensor"] == Sensor.STEREO
    dt_frame = entry["dt_frame"]
    sysm = System(cfg, device)
    sysm.warmup()

    def track(i):
        if stereo:
            return sysm.track_stereo(frames[i][0], frames[i][1], i * dt_frame)
        return sysm.track_monocular(frames[i], i * dt_frame)

    for i in range(entry["warmup"]):
        track(i)
    return sysm, track


def run_config(name, entry, cfg, frames, traj, *, device):
    """One configuration's record (bench.py `_run_config`) from what
    `load` returns."""
    import torch

    from c_orb_slam_tpu_torch.config import Sensor
    from c_orb_slam_tpu_torch.io import trajectory as traj_io
    from c_orb_slam_tpu_torch.ops import window_top2
    from c_orb_slam_tpu_torch.optim import ba, pose_opt
    from c_orb_slam_tpu_torch.tracking import TrackState

    device = torch.device(device)
    stereo = entry["sensor"] == Sensor.STEREO
    n_frames, warmup, dt_frame = entry["n_frames"], entry["warmup"], entry["dt_frame"]
    sysm, track = start(entry, cfg, frames, device)
    sysm.metrics.reset()  # the stages below cover the timed window
    ba.reset_failed_factorizations()
    window_top2.reset_launches()
    pose_opt.reset_launches()
    n_ba = sysm.local_mapping.n_local_ba
    host_ms = []
    t0 = time.perf_counter()
    for i in range(warmup, n_frames):
        t1 = time.perf_counter()
        track(i)
        host_ms.append((time.perf_counter() - t1) * 1000.0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # the pipelined readback's work in flight
    dt = time.perf_counter() - t0
    n_timed = n_frames - warmup
    fps = n_timed / dt
    launches = window_top2.launches
    pose_launches = pose_opt.launches
    n_ba = sysm.local_mapping.n_local_ba - n_ba
    stages = {k: round(v["total_ms"] / n_timed, 3)
              for k, v in sysm.metrics.summary()["stages"].items()}
    failed = ba.failed_factorizations(device)
    # Each local BA runs its two LM stages to their fixed iteration counts.
    iters = n_ba * (cfg.optimizer.local_ba_its_first + cfg.optimizer.local_ba_its_second)
    sysm.shutdown()

    rec = {
        "metric": f"tracked_frames_per_sec_1chip_{name}",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / entry["baseline_fps"], 3),
        **card(device),
        "loop_closing": sysm.loop_closing is not None,
        "frames": n_frames,
        "timed_frames": n_timed,
        "ms_per_frame": round(dt * 1000.0 / n_timed, 3),
        "host_ms_median": round(statistics.median(host_ms), 3),
        "stage_ms_per_frame": stages,
        "local_ba_solves": n_ba,
        "dense_schur_lm_iters": iters,
        "dense_schur_lm_iters_failed": failed,
        "window_top2_launches": launches,
        "pose_gn_launches": pose_launches,
        "loops_closed": sysm.loop_closing.n_loops_closed,
    }
    # Quality gates: lost tracking or excess ATE zeroes the score.
    if sysm.tracking_state() != TrackState.OK:
        rec.update(vs_baseline=0.0, error="tracking lost during bench")
        return rec
    poses, stamps = sysm.frame_poses()
    ids = [int(round(t / dt_frame)) for t in stamps]
    ate = traj_io.ate_rmse(poses, traj[ids], with_scale=not stereo)
    rec["ate_m"] = round(float(ate), 4)
    ate_gate = entry["ate_gate"]
    rec["ate_gate_m"] = ate_gate
    rec["n_tracked"] = len(poses)
    if ate > ate_gate:
        rec.update(vs_baseline=0.0, error=f"ATE {ate:.4f} > gate {ate_gate}")
    return rec


def run_named(name, device, **cut):
    """run_config on CONFIGS[name], cut by `cut` as `load` cuts it."""
    return run_config(name, *load(name, **cut), device=device)


def max_frames_cut(name, max_frames) -> dict:
    """The `load` cut of --max-frames: n_frames lowered to max_frames
    where the configuration is longer, else nothing."""
    if max_frames is None or CONFIGS[name]["n_frames"] <= max_frames:
        return {}
    if max_frames <= CONFIGS[name]["warmup"]:
        raise ValueError(f"--max-frames {max_frames} leaves {name} no timed frame")
    return dict(n_frames=max_frames)


def main(argv=None):
    from c_orb_slam_tpu_torch.examples.common import add_device_arg, pick_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--all", action="store_true", help="run every configuration")
    ap.add_argument("--config", default=None, choices=list(CONFIGS))
    ap.add_argument("--repeat", type=int, default=1, help="runs of each configuration")
    ap.add_argument("--max-frames", type=int, default=None,
                    help="cut each configuration to at most its first N frames")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = pick_device(args.device)

    names = (args.config,) if args.config else ALL if args.all else (HEADLINE,)
    for name in names:
        cut = max_frames_cut(name, args.max_frames)
        for _ in range(args.repeat):
            rec = run_named(name, device, **cut)
            if name == HEADLINE and not args.config:
                rec["metric"] = "tracked_frames_per_sec_1chip"  # bench.py's headline name
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
