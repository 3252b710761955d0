#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (c_orb_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phase 1 builds the window_top2 kernel (csrc/window_top2.cu, nvcc for
sm_90a) and holds it against its plain PyTorch version on the card, for
exact equality of all four outputs, at the shapes the main path gives it
(TUM geometry with 1000 keypoints on 8 levels, KITTI geometry with 2000,
the loop runs' 800 keypoints on 4 levels) plus unaligned, fully-masked, single-target and tie-heavy cases, the local
map's real window (radius 4-6 px x scale) and the worst case of a kernel
that culls by window first (every target in every window). It times both
(CUDA events around 20 back-to-back calls, median of 7: "ms", which is
what a call costs the main path), the kernel also as a CUDA graph of the
same 20 calls ("device_ms", its time on the device: the wrapper's host
side takes longer than the kernel runs), and an empty kernel launched the
same way; and it computes each case's bound from the case's own inputs.

Phases 2-5 drive the port's entry points with loop closing off, each on a
synthetic sequence rendered by tests/synthetic.py, and check frames
tracked, ATE and that window_top2 launched during that phase's run:
- phase 2: System.track_rgbd, 60 frames at TUM RGB-D geometry (640x480,
  1000 features, 8 levels), ATE at absolute scale; local BA must run;
- phase 3: System.track_monocular at bench.py's mono_tum30 (70 frames, 30
  Hz, 1000 features, 8 levels), ATE after scale alignment;
- phase 4: System.track_stereo at bench.py's stereo_kitti geometry
  (1241x376, 2000 features, 8 levels, baseline 0.2 m), cut from 120 to 60
  frames, ATE at absolute scale;
- phase 5: relocalization: the 40-frame RGB-D sequence of
  tests/test_torch_reloc.py with frames 28-29 blank, in lock-step
  (pipeline depth 1), must relocalize at frame 30 or later and end OK;
  the same run at the default pipeline depth must end OK.
Phase 6 runs the two-view and PnP RANSAC solvers on CUDA and on the CPU
with the same inputs and injected first-round draws, and holds the CUDA
results (cuSOLVER eigh/svd) to the CPU ones; then the loop path's solvers
the same way: solve_sim3_ransac (injected draw), optimize_sim3, one
pose_graph.gn_step and one implicit-Schur (PCG) ba.lm_step.

Phases 7 and 8 close a loop end to end with System(enable_loop_closing=
True) and the shipped 10^5-word vocabulary, on the outward-facing orbit
of tests/e2e_loop_debug.py (1400 blobs, 240 frames at 10 Hz, 640x480,
fx = fy = 500, 800 features, 4 levels), which revisits its start sector
after frame 200:
- phase 7: stereo (baseline 0.2 m): more than 90% of the frames tracked,
  at least one loop closed, ATE < 0.4 m at absolute scale, the background
  global BA applied, and, where it was applied during the run, at least 5
  frames after the loop event (the gates of tests/test_e2e_loop.py);
- phase 8: monocular, free scale: the same gates on the scale-aligned ATE.

Exits nonzero, printing no result, when there is no CUDA device or any
phase fails. The last line of standard output is
{"ok": true, "device": {...}}; the line before it lists each kernel.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WARMUP_FRAMES = 15


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def make_case(rng, B, Q, T, *, w=640, h=480, levels=8, masked_rows=False, ties=False,
              window="motion"):
    """Numpy inputs for window_top2 shaped like the main path's calls:
    targets across a w x h image on `levels` pyramid levels, projected
    queries near some of them, octave windows of width 3. The radius is
    the motion model's (15 px x level scale), the local map's
    (`window="local_map"`: 4-6 px x level scale) or holds every target
    (`window="all"`, and with `ties`)."""
    import numpy as np

    lead = (B,) if B else ()
    n_distinct = 3 if ties else None
    if ties:
        pool = rng.integers(0, 2**32, (n_distinct, 8), dtype=np.uint64).astype(np.uint32)
        qd = pool[rng.integers(0, n_distinct, lead + (Q,))]
        td = pool[rng.integers(0, n_distinct, lead + (T,))]
    else:
        qd = rng.integers(0, 2**32, lead + (Q, 8), dtype=np.uint64).astype(np.uint32)
        td = rng.integers(0, 2**32, lead + (T, 8), dtype=np.uint64).astype(np.uint32)
    txy = rng.uniform(0, [w, h], lead + (T, 2)).astype(np.float32)
    near = rng.integers(0, T, lead + (Q,))
    quv = (np.take_along_axis(txy, near[..., None].repeat(2, -1), -2)
           + rng.normal(0, 6, lead + (Q, 2))).astype(np.float32)
    lo = rng.integers(0, levels - 2, lead + (Q,)).astype(np.int32)
    qr = (15.0 * 1.2 ** lo).astype(np.float32)
    if window == "local_map":
        qr = (rng.uniform(4.0, 6.0, lead + (Q,)) * 1.2 ** lo).astype(np.float32)
    if ties or window == "all":
        qr[:] = 2000.0  # every target in the window (with ties: ties everywhere)
    qv = rng.random(lead + (Q,)) > 0.1
    if masked_rows:
        qv[..., : Q // 2] = False  # half the rows fully masked
    return dict(
        q_desc=qd.view(np.int32), q_uv=quv, q_radius=qr, q_lo=lo,
        q_hi=np.minimum(lo + 2, levels - 1).astype(np.int32), q_valid=qv,
        t_desc=td.view(np.int32), t_xy=txy,
        t_octave=rng.integers(0, levels, lead + (T,)).astype(np.int32),
        t_valid=rng.random(lead + (T,)) > 0.05,
    )


def _event_ms(run, repeats):
    """Median over `repeats` of the CUDA-event time of run(), in ms."""
    import torch

    times = []
    for _ in range(repeats):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_call(fn, args, launches=20, repeats=7):
    """Median over `repeats` of the CUDA-event time of `launches`
    back-to-back calls, divided by `launches` (ms per call). Reads the
    host's time to enqueue a call where that exceeds the device's."""
    for _ in range(3):
        fn(**args)

    def run():
        for _ in range(launches):
            fn(**args)

    return _event_ms(run, repeats) / launches


def time_graph(fn, args, launches=20, repeats=7):
    """The same `launches` calls captured once into a CUDA graph and
    replayed: ms per call on the device, free of the host's enqueue time."""
    import torch

    fn(**args)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn(**args)
    graph.replay()
    torch.cuda.synchronize()
    return _event_ms(graph.replay, repeats) / launches


# Peak rates of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM, and
# 67 TFLOP/s of float32 outside the tensor cores, which is one operation
# per lane per clock with a fused multiply-add counted as two: 33.5e12
# plain float or integer operations a second. POPC runs at 16 a clock an
# SM against 128 for those (NVIDIA's table of arithmetic throughput for
# compute capability 9.0): an eighth of that rate.
HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = 67e12 / 2
POPC_PER_S = LANE_OPS_PER_S / 8
# The window test of one pair needs 2 subtractions, 2 compares of |.| with
# the radius, and for the octave range one subtraction and one unsigned
# compare. Validity is folded into the target once (x = NaN), not per
# pair, and the conjunction rides on the compares' predicates.
GATE_OPS_PER_PAIR = 6
POPC_PER_INSIDE_PAIR = 8  # one per descriptor word
PLAIN_OPS_PER_INSIDE_PAIR = 15  # 8 XOR + 7 adds of the 8 counts


def window_top2_bound(args):
    """(bound ms, "bytes" or "operations", in-window pairs) of one
    window_top2 call on these inputs: each input read and each output
    written once over the HBM rate, against the window test of every pair
    plus the popcounts of the pairs inside a window, which is what these
    inputs need, over the pipes' peak rates."""
    from c_orb_slam_tpu_torch.ops import match

    q = args["q_valid"]
    mask = (match.window_mask(args["q_uv"], args["q_radius"], args["t_xy"])
            & match.octave_mask(args["t_octave"], args["q_lo"], args["q_hi"])
            & q.unsqueeze(-1) & args["t_valid"].unsqueeze(-2))
    inside = int(mask.sum())
    n_bytes = sum(t.numel() * t.element_size() for t in args.values()) + 4 * 4 * q.numel()
    pairs = q.numel() * args["t_valid"].shape[-1]
    ops_s = ((pairs * GATE_OPS_PER_PAIR + inside * PLAIN_OPS_PER_INSIDE_PAIR) / LANE_OPS_PER_S
             + inside * POPC_PER_INSIDE_PAIR / POPC_PER_S)
    bytes_s = n_bytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes", inside


def phase1(dev):
    """window_top2 kernel == plain version, exactly; both timed, beside
    the empty launch and each case's bound."""
    import numpy as np
    import torch
    from c_orb_slam_tpu_torch.ops import window_top2 as w2

    w2.build()
    print("nvcc build log:", w2.build_log.strip().replace("\n", " | "), flush=True)
    cases = [
        ("motion_model_1000x1000", dict(B=0, Q=1000, T=1000)),
        ("local_map_8192x1000", dict(B=0, Q=8192, T=1000)),
        ("unaligned_200x300", dict(B=0, Q=200, T=300)),
        ("fuse_batch_32x1000x1000", dict(B=32, Q=1000, T=1000)),
        ("masked_rows_512x1000", dict(B=0, Q=512, T=1000, masked_rows=True)),
        ("single_target_300x1", dict(B=0, Q=300, T=1)),
        ("ties_1000x1000", dict(B=0, Q=1000, T=1000, ties=True)),
        # KITTI geometry (phase 4): 2000 keypoints across 1241x376.
        ("kitti_motion_model_2000x2000", dict(B=0, Q=2000, T=2000, w=1241, h=376)),
        ("kitti_local_map_8192x2000", dict(B=0, Q=8192, T=2000, w=1241, h=376)),
        ("kitti_fuse_batch_32x2000x2000", dict(B=32, Q=2000, T=2000, w=1241, h=376)),
        # The cull's worst case, and the local map's real window.
        ("dense_window_8192x1000", dict(B=0, Q=8192, T=1000, window="all")),
        ("sparse_local_map_8192x1000", dict(B=0, Q=8192, T=1000, window="local_map")),
        # The loop runs (phases 7-8): 800 keypoints on 4 levels, 640x480.
        ("loop_motion_model_800x800", dict(B=0, Q=800, T=800, levels=4)),
        ("loop_local_map_8192x800", dict(B=0, Q=8192, T=800, levels=4)),
        ("loop_sparse_local_map_8192x800", dict(B=0, Q=8192, T=800, levels=4,
                                                window="local_map")),
        ("loop_fuse_batch_32x800x800", dict(B=32, Q=800, T=800, levels=4)),
    ]
    empty_ms = time_call(lambda: w2.empty_launch(dev), {})
    print(f"phase1 empty kernel through the same ctypes launch: {empty_ms:.4f} ms", flush=True)
    rng = np.random.default_rng(0)
    rows, max_err = {}, 0
    for name, spec in cases:
        host = make_case(rng, **spec)
        args = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in host.items()}
        got = w2.window_top2(**args)
        torch.cuda.synchronize()
        want = w2.window_top2_reference(**args)
        for label, g, r in zip(("best", "idx", "second", "idx2"), got, want):
            err = int((g.long() - r.long()).abs().max().item())
            max_err = max(max_err, err)
            if err:
                raise AssertionError(f"{name}: {label} differs from the plain version (max {err})")
        bound_ms, bound_by, inside = window_top2_bound(args)
        # "ms" is the time of a back-to-back wrapper call, which the main
        # path pays: the wrapper's host side (argument checks, one
        # allocation, the ctypes call) takes longer than the kernel runs.
        # "device_ms" is the kernel's time on the device, in a CUDA graph.
        rows[name] = dict(
            ms=time_call(w2.window_top2, args), device_ms=time_graph(w2.window_top2, args),
            plain_ms=time_call(w2.window_top2_reference, args), bound_ms=bound_ms,
            bound_by=bound_by)
        r = rows[name]
        print(f"phase1 {name}: kernel == plain on best/idx/second/idx2; "
              f"kernel {r['ms']:.4f} ms back to back, {r['device_ms']:.4f} ms as a CUDA graph, "
              f"plain {r['plain_ms']:.4f} ms, bound {bound_ms:.5f} ms by {bound_by} "
              f"({inside} pairs in a window)", flush=True)
    return rows, max_err, empty_ms


def _synthetic():
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import synthetic

    return synthetic


def _u8(im):
    """8-bit frames, as the datasets deliver them."""
    import numpy as np

    return np.clip(im, 0, 255).astype(np.uint8)


def _timed(obj, name, log):
    """Wrap obj.name so each call appends (host ms incl. a device sync,
    result) to log."""
    import torch

    orig = getattr(obj, name)

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        log.append(((time.perf_counter() - t0) * 1000.0, out))
        return out

    setattr(obj, name, wrapper)


def drive(label, sysm, frames, track, traj, fps, with_scale, warmup=WARMUP_FRAMES,
          on_frame=None):
    """Run `track(sysm, i, frame)` over the frames with the window_top2
    launch count set to 0 just before and read just after; print and
    return the run's numbers. `on_frame(i)` runs after each frame."""
    import numpy as np
    import torch
    from c_orb_slam_tpu_torch.io import trajectory as traj_io
    from c_orb_slam_tpu_torch.ops import window_top2 as w2

    torch.cuda.synchronize()
    w2.reset_launches()
    host_ms = []
    t_steady = None
    for i, fr in enumerate(frames):
        if i == warmup:
            torch.cuda.synchronize()
            sysm.metrics.reset()  # stage totals below cover the steady frames
            t_steady = time.perf_counter()
        t0 = time.perf_counter()
        track(sysm, i, fr)
        host_ms.append((time.perf_counter() - t0) * 1000.0)
        if on_frame is not None:
            on_frame(i)
    sysm.shutdown()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t_steady) * 1000.0
    launches = w2.launches
    shapes = {"x".join(map(str, k)): v for k, v in sorted(w2.launch_shapes.items())}

    poses, stamps = sysm.frame_poses()
    if poses.ndim != 3 or poses.shape[1:] != (3, 4) or not np.isfinite(poses).all():
        raise AssertionError(f"{label}: frame poses malformed: shape {poses.shape}")
    ids = [int(round(t * fps)) for t in stamps]
    ate = traj_io.ate_rmse(poses, traj[ids], with_scale=with_scale)
    n = len(frames)
    steady = host_ms[warmup:]
    scale = "scale-aligned" if with_scale else "absolute scale"
    print(f"{label} frames tracked {len(poses)}/{n}, ATE {ate:.5f} m ({scale}), "
          f"local BA solves {sysm.local_mapping.n_local_ba}, window_top2 launches {launches}, "
          f"final state {sysm.tracking_state()}", flush=True)
    print(f"{label} window_top2 launches by shape B x Q x T over {n} frames: {json.dumps(shapes)}",
          flush=True)
    print(f"{label} ms/frame after {warmup} warm-up frames: mean {wall_ms / len(steady):.3f} "
          f"(wall incl. final sync), median {statistics.median(steady):.3f} (host per call)",
          flush=True)
    stages = {k: v["total_ms"] for k, v in sysm.metrics.summary()["stages"].items()}
    print(f"{label} host ms per stage over the steady frames: {json.dumps(stages)}", flush=True)
    if launches <= 0:
        raise AssertionError(f"{label}: window_top2 never launched on the main path")
    return dict(n_ok=len(poses), ate=ate, launches=launches, ids=ids, host_ms=host_ms)


def _gates(label, run, n, ate_gate):
    if run["n_ok"] < 0.8 * n:
        raise AssertionError(f"{label}: tracked only {run['n_ok']}/{n} frames")
    if not run["ate"] < ate_gate:
        raise AssertionError(f"{label}: ATE {run['ate']:.4f} m >= {ate_gate} m")


def _tum_cfg(mod, sensor):
    """TUM-geometry configuration: 640x480, fx = fy = 500, 1000 features,
    8 levels (bench.py mono_tum30; bf = 100 for the RGB-D runs)."""
    cam = mod.CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480,
                           fps=30, bf=100.0)
    return mod.SlamConfig(
        sensor=sensor, camera=cam, orb=mod.OrbConfig(n_features=1000, n_levels=8),
        tracking=mod.TrackingConfig(min_stereo_init_points=60),
    )


def phase2(dev):
    """System.track_rgbd on a rendered 60-frame TUM-geometry sequence."""
    from c_orb_slam_tpu_torch import config as tcfg
    from c_orb_slam_tpu_torch.system import System

    syn = _synthetic()
    n = 60
    cfg = _tum_cfg(tcfg, tcfg.Sensor.RGBD)
    K4 = (cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
    xw, inten, size = syn.blob_world(400, seed=5)
    traj = syn.smooth_trajectory(n, speed=0.4)
    frames = [(_u8(syn.render_scene(xw, inten, size, T, K4)), syn.render_depth(xw, size, T, K4))
              for T in traj]
    sysm = System(cfg, dev, enable_loop_closing=False)
    sysm.warmup()
    run = drive("phase2", sysm, frames, lambda s, i, f: s.track_rgbd(f[0], f[1], i / 30.0),
                traj, 30.0, with_scale=False)
    _gates("phase2", run, n, 0.05)
    if sysm.local_mapping.n_local_ba < 1:
        raise AssertionError("phase2: no local BA ran")
    return run["launches"]


def phase3(dev):
    """System.track_monocular at bench.py's mono_tum30."""
    from c_orb_slam_tpu_torch import config as tcfg
    from c_orb_slam_tpu_torch.system import System
    from c_orb_slam_tpu_torch.tracking import TrackState

    syn = _synthetic()
    n = 70
    cfg = _tum_cfg(tcfg, tcfg.Sensor.MONOCULAR)
    K4 = (cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
    xw, inten, size = syn.blob_world(400, seed=5)
    traj = syn.smooth_trajectory(n, speed=0.4)
    frames = [_u8(syn.render_scene(xw, inten, size, T, K4)) for T in traj]
    sysm = System(cfg, dev, enable_loop_closing=False)
    sysm.warmup()
    inits = []
    _timed(sysm.tracker, "_monocular_initialization", inits)
    run = drive("phase3", sysm, frames, lambda s, i, f: s.track_monocular(f, i / 30.0),
                traj, 30.0, with_scale=True)
    print(f"phase3 two-view initialization calls (host ms incl. sync): "
          f"{[round(ms, 3) for ms, _ in inits]}; the last one initialized the map", flush=True)
    _gates("phase3", run, n, 0.05)
    if sysm.tracking_state() != TrackState.OK:
        raise AssertionError("phase3: tracking not OK at the end")
    return run["launches"]


def phase4(dev):
    """System.track_stereo at bench.py's stereo_kitti geometry, 60 frames."""
    from c_orb_slam_tpu_torch import config as tcfg
    from c_orb_slam_tpu_torch.system import System

    syn = _synthetic()
    n = 60
    cam = tcfg.CameraConfig(fx=718.856, fy=718.856, cx=607.19, cy=185.22, width=1241,
                            height=376, fps=10, bf=718.856 * 0.2)
    cfg = tcfg.SlamConfig(
        sensor=tcfg.Sensor.STEREO, camera=cam, orb=tcfg.OrbConfig(n_features=2000, n_levels=8),
        tracking=tcfg.TrackingConfig(min_stereo_init_points=60),
    )
    K4 = (cam.fx, cam.fy, cam.cx, cam.cy)
    xw, inten, size = syn.blob_world(400, seed=5)
    traj = syn.smooth_trajectory(n, speed=0.5)
    frames = [tuple(_u8(im) for im in syn.render_stereo_pair(xw, inten, size, T, K4, 0.2,
                                                             h=376, w=1241)) for T in traj]
    sysm = System(cfg, dev, enable_loop_closing=False)
    sysm.warmup()
    run = drive("phase4", sysm, frames, lambda s, i, f: s.track_stereo(f[0], f[1], i / 10.0),
                traj, 10.0, with_scale=False)
    _gates("phase4", run, n, 0.05)
    return run["launches"]


def phase5(dev):
    """Relocalization after two blank frames (tests/test_torch_reloc.py's
    40-frame RGB-D sequence, its configuration: 800 features, 4 levels)."""
    import dataclasses

    import numpy as np
    from c_orb_slam_tpu_torch import config as tcfg
    from c_orb_slam_tpu_torch.system import System
    from c_orb_slam_tpu_torch.tracking import TrackState

    syn = _synthetic()
    n, blank = 40, (28, 29)
    cam = tcfg.CameraConfig(fx=500, fy=500, cx=320, cy=240, width=640, height=480, fps=10,
                            bf=100.0)
    base = tcfg.SlamConfig(
        sensor=tcfg.Sensor.RGBD, camera=cam, orb=tcfg.OrbConfig(n_features=800, n_levels=4),
        tracking=tcfg.TrackingConfig(min_stereo_init_points=60, velocity_rotation_fraction=0.5,
                                     max_frames_between_kf=10),
    )
    K4 = (500.0, 500.0, 320.0, 240.0)
    xw, inten, size = syn.blob_world(400, seed=5)
    traj = syn.smooth_trajectory(n)
    zero = np.zeros((480, 640), np.float32)
    frames = [(zero, zero) if i in blank else
              (syn.render_scene(xw, inten, size, T, K4), syn.render_depth(xw, size, T, K4))
              for i, T in enumerate(traj)]
    launches = 0
    for depth in (1, 0):  # lock-step, then the default (3 on a GPU)
        cfg = dataclasses.replace(
            base, tracking=dataclasses.replace(base.tracking, pipeline_depth=depth))
        sysm = System(cfg, dev, enable_loop_closing=False)
        relocs = []
        _timed(sysm.tracker, "_relocalize", relocs)
        label = f"phase5 depth {sysm.tracker.pipeline_depth}"
        run = drive(label, sysm, frames, lambda s, i, f: s.track_rgbd(f[0], f[1], i / 10.0),
                    traj, 10.0, with_scale=False)
        launches += run["launches"]
        reloc_id = sysm.tracker.last_reloc_frame_id
        print(f"{label}: last_reloc_frame_id {reloc_id}, relocalize calls (host ms incl. sync, "
              f"ok) {[(round(ms, 3), bool(out[0])) for ms, out in relocs]}", flush=True)
        if sysm.tracking_state() != TrackState.OK:
            raise AssertionError(f"{label}: tracking not OK at the end")
        if depth == 1:
            if reloc_id < 30:
                raise AssertionError(f"{label}: no relocalization at frame 30 or later")
            _gates(label, run, n, 0.05)
    return launches


def _angle(R):
    import torch
    from c_orb_slam_tpu_torch.geometry import so3

    return float(torch.linalg.vector_norm(so3.log(R)))


def _compare_poses(label, g, c, flags_g, flags_c, ok_g, ok_c):
    """CUDA result g against CPU result c: same ok; rotation and
    translation direction within 1e-3; >= 95% of flags equal."""
    import torch

    if bool(ok_g) != bool(ok_c):
        raise AssertionError(f"{label}: ok differs (cuda {bool(ok_g)}, cpu {bool(ok_c)})")
    agree = float((flags_g.cpu() == flags_c).to(torch.float32).mean())
    g = g.cpu()
    dr = _angle(g[:, :3] @ c[:, :3].T)
    dt = float(torch.linalg.vector_norm(
        g[:, 3] / torch.linalg.vector_norm(g[:, 3]) - c[:, 3] / torch.linalg.vector_norm(c[:, 3])))
    print(f"phase6 {label}: ok {bool(ok_c)}, rotation diff {dr:.3e} rad, translation direction "
          f"diff {dt:.3e}, flags agree {agree:.4f}", flush=True)
    if bool(ok_c) and not (dr < 1e-3 and dt < 1e-3):
        raise AssertionError(f"{label}: CUDA pose differs from the CPU pose")
    if agree < 0.95:
        raise AssertionError(f"{label}: only {agree:.3f} of the flags agree")


def _cuda_ms(fn, repeats=3):
    """Median host ms of fn() between device syncs."""
    import torch

    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000.0)
    return statistics.median(times)


def phase6(dev):
    """twoview.initialize and pnp.solve_pnp_ransac, CUDA against CPU."""
    import numpy as np
    import torch
    from c_orb_slam_tpu_torch.geometry import so3
    from c_orb_slam_tpu_torch.ops import pnp, twoview

    syn = _synthetic()
    K = np.array([500.0, 500.0, 320.0, 240.0], np.float32)

    def project(xc):
        return np.stack([K[0] * xc[:, 0] / xc[:, 2] + K[2], K[1] * xc[:, 1] / xc[:, 2] + K[3]], 1)

    def both(fn, arrays, idx, **kw):
        cpu = fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays),
                 generator=torch.Generator().manual_seed(0), idx=torch.from_numpy(idx), **kw)
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
        gen = torch.Generator(device=dev)

        def on_card():
            return fn(*args, generator=gen.manual_seed(0), idx=torch.from_numpy(idx).to(dev), **kw)

        return on_card(), cpu, _cuda_ms(on_card)

    # Two-view: the general scene of tests/test_twoview.py at 10% outliers
    # and, at a low inlier ratio, 35% outliers.
    for name, out_frac in (("twoview general 300 pts", 0.1), ("twoview low-inlier 300 pts", 0.35)):
        rng = np.random.default_rng(1)
        xw = np.c_[rng.uniform(-3, 3, (300, 2)), rng.uniform(4, 12, 300)]
        R = so3.exp(torch.tensor([0.02, -0.04, 0.01])).numpy()
        uv1 = project(xw) + rng.normal(0, 0.5, (300, 2))
        uv2 = project(xw @ R.T + np.array([-0.4, 0.05, 0.02])) + rng.normal(0, 0.5, (300, 2))
        out = rng.choice(300, int(300 * out_frac), replace=False)
        uv2[out] += rng.uniform(15, 60, (len(out), 2))
        idx = rng.integers(0, 300, (256, 8))
        g, c, ms = both(twoview.initialize, (uv1.astype(np.float32), uv2.astype(np.float32),
                                             np.ones(300, bool), K), idx)
        if not bool(c.ok):
            raise AssertionError(f"{name}: the CPU solve did not initialize")
        _compare_poses(name, g.T21, c.T21, g.good, c.good, g.ok, c.ok)
        print(f"phase6 {name}: {ms:.3f} ms per call on the card (host incl. sync, median of 3)",
              flush=True)

    # PnP: tests/test_solvers.py's 150 points at 30% outliers, and the
    # low-inlier-ratio case (30 points at 50% inliers, 512 hypotheses).
    rng = np.random.default_rng(0)
    xw = syn.random_scene(150, seed=0)
    R = so3.exp(torch.tensor([0.1, -0.2, 0.05])).numpy()
    uv = project(xw @ R.T + np.array([0.4, -0.3, 0.6])) + rng.normal(0, 0.5, (150, 2))
    out = rng.choice(150, 45, replace=False)
    uv[out] += rng.uniform(25, 120, (45, 2))
    M = 30
    xw30 = np.c_[rng.uniform(-3, 3, (M, 2)), rng.uniform(4, 9, M)]
    uv30 = project(xw30 + np.array([0.3, -0.1, 0.0])) + rng.normal(0, 0.5, (M, 2))
    oi = rng.choice(M, M // 2, replace=False)
    uv30[oi] = rng.uniform([0, 0], [640, 480], (len(oi), 2))
    for name, pw, puv, n_hyp, min_inl in (("pnp 150 pts 30% outliers", xw, uv, 256, 15),
                                          ("pnp low-inlier 30 pts 50% inliers", xw30, uv30, 512, 8)):
        m = len(pw)
        idx = rng.integers(0, m, (n_hyp, 6))
        g, c, ms = both(pnp.solve_pnp_ransac,
                        (pw.astype(np.float32), puv.astype(np.float32), np.ones(m, bool),
                         np.ones(m, np.float32), K), idx, n_hypotheses=n_hyp, min_inliers=min_inl)
        if not bool(c.ok):
            raise AssertionError(f"{name}: the CPU solve failed")
        _compare_poses(name, g.pose, c.pose, g.inliers, c.inliers, g.ok, c.ok)
        print(f"phase6 {name}: {ms:.3f} ms per call on the card (host incl. sync, median of 3)",
              flush=True)


def _sim3_diff(label, Sg, Sc, tol):
    """log(Sg ∘ Sc^-1) of a CUDA and a CPU Sim3: rotation (rad),
    translation and log-scale parts, each held under `tol`."""
    import torch
    from c_orb_slam_tpu_torch.geometry import sim3

    d = sim3.log(sim3.compose(Sg.cpu(), sim3.inverse(Sc)))
    dt, dr, ds = (float(torch.linalg.vector_norm(d[0:3])), float(torch.linalg.vector_norm(d[3:6])),
                  abs(float(d[6])))
    print(f"phase6 {label}: rotation diff {dr:.3e} rad, translation diff {dt:.3e}, "
          f"log-scale diff {ds:.3e} (tolerance {tol:.0e} each)", flush=True)
    if not max(dt, dr, ds) < tol:
        raise AssertionError(f"{label}: CUDA Sim3 differs from the CPU Sim3")


def phase6_loop(dev):
    """The loop path's parts, CUDA against CPU on the same numpy inputs:
    place recognition, solve_sim3_ransac under an injected draw, optimize_sim3 (free and
    fixed scale), one pose_graph.gn_step and one PCG ba.lm_step."""
    import numpy as np
    import torch
    from c_orb_slam_tpu_torch.bow import database, vocab
    from c_orb_slam_tpu_torch.geometry import sim3
    from c_orb_slam_tpu_torch.ops import sim3solve
    from c_orb_slam_tpu_torch.optim import ba, pose_graph, sim3_opt

    syn = _synthetic()
    K = np.array([500.0, 500.0, 320.0, 240.0], np.float32)

    def project(xc):
        return np.stack([K[0] * xc[:, 0] / xc[:, 2] + K[2], K[1] * xc[:, 1] / xc[:, 2] + K[3]],
                        1).astype(np.float32)

    def t(a, device="cpu"):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # Place recognition on the shipped vocabulary: the descent's
    # first-child-on-a-tie rule, the stable sort of the aggregation and
    # the overflow slots of the scatters must give the card what they give
    # the CPU. Words, nodes and shared-word counts equal; scores to 1e-6.
    voc = vocab.load(vocab.builtin_vocabulary_path())
    voc_d = voc.to(dev)
    rng = np.random.default_rng(5)
    leaves = voc.levels[-1].numpy()
    n_kf, n_desc = 24, 800
    word_rows, weight_rows = {"cpu": [], "card": []}, {"cpu": [], "card": []}
    for k in range(n_kf + 1):
        # Half random descriptors, half tree leaves with one bit flipped
        # (near-word queries, where equal distances between children are
        # common); frames share a pool of leaves so that scores are far
        # from zero.
        near = leaves[rng.integers(0, 4000, n_desc // 2)].copy()
        near[:, rng.integers(0, 8)] ^= np.int32(1 << 7)
        d = np.concatenate([rng.integers(-2**31, 2**31, (n_desc // 2, 8)).astype(np.int32), near])
        valid = rng.random(n_desc) > 0.05
        fc = vocab.transform(voc, t(d), t(valid))
        fg = vocab.transform(voc_d, t(d, dev), t(valid, dev))
        if not (torch.equal(fg.word.cpu(), fc.word) and torch.equal(fg.node.cpu(), fc.node)
                and torch.equal(fg.weight.cpu(), fc.weight)):
            raise AssertionError("bow: vocab.transform differs between CUDA and the CPU")
        for side, fb in (("cpu", fc), ("card", fg)):
            w, a = database.aggregate_bow_dev(fb.word, fb.weight, n_desc)
            word_rows[side].append(w)
            weight_rows[side].append(a)
        if not torch.equal(word_rows["card"][-1].cpu(), word_rows["cpu"][-1]):
            raise AssertionError("bow: aggregate_bow_dev's words differ between CUDA and the CPU")
    scores = {}
    for side, v in (("cpu", voc), ("card", voc_d)):
        db = database.KeyFrameDatabase(v, 32, n_desc)
        for k in range(n_kf):
            db.add_dev(k, word_rows[side][k], weight_rows[side][k])
        scores[side] = db.scores_dev(word_rows[side][n_kf], weight_rows[side][n_kf], exclude=(3,))
    ds = float((scores["card"][0].cpu() - scores["cpu"][0]).abs().max())
    da = max(float((g.cpu() - c).abs().max())
             for g, c in zip(weight_rows["card"], weight_rows["cpu"]))
    print(f"phase6 bow on the 10^5-word vocabulary, {n_kf + 1} frames of {n_desc} descriptors: "
          f"words, nodes and idf equal on CUDA and CPU; tf-idf rows differ by {da:.3e}, scores "
          f"against {n_kf} keyframes by {ds:.3e} (max score {float(scores['cpu'][0].max()):.4f}), "
          f"shared-word counts equal: {torch.equal(scores['card'][1].cpu(), scores['cpu'][1])}; "
          f"transform {_cuda_ms(lambda: vocab.transform(voc_d, t(d, dev), t(valid, dev))):.3f} ms "
          f"per frame on the card", flush=True)
    if not (ds < 1e-6 and da < 1e-6 and torch.equal(scores["card"][1].cpu(), scores["cpu"][1])):
        raise AssertionError("bow: database scores differ between CUDA and the CPU")

    # Sim3 RANSAC + polish: 200 matched points of two cameras a Sim3
    # apart (unit scale for the fixed-scale case), 0.4 px noise, a tenth
    # invalid, 16 gross outliers.
    M = 200
    valid = np.ones(M, bool)
    valid[::10] = False
    gate = np.full(M, 9.21, np.float32)
    ones = np.ones(M, np.float32)

    def pairs(fix_scale):
        rng = np.random.default_rng(8)
        x2 = np.c_[rng.uniform(-2, 2, (M, 2)), rng.uniform(4, 9, M)].astype(np.float32)
        S_gt = sim3.exp(torch.tensor(
            [0.3, -0.2, 0.1, 0.05, -0.08, 0.03, 0.0 if fix_scale else 0.1]))
        x1 = sim3.apply(S_gt, t(x2)).numpy()
        uv1 = project(x1) + rng.normal(0, 0.4, (M, 2)).astype(np.float32)
        uv2 = project(x2) + rng.normal(0, 0.4, (M, 2)).astype(np.float32)
        uv1[:16] += 40.0
        x1 = x1 + rng.normal(0, 0.01, (M, 3)).astype(np.float32)
        return x1, x2, uv1, uv2, rng.integers(0, M, (300, 3))

    for fix_scale in (False, True):
        name = f"sim3 ransac fix_scale={fix_scale}"
        x1, x2, uv1, uv2, idx = pairs(fix_scale)
        arrs = (x1, x2, uv1, uv2, valid, gate, gate, K, K)

        def ransac(device):
            return sim3solve.solve_sim3_ransac(
                *(t(a, device) for a in arrs), fix_scale=fix_scale, idx=t(idx, device))

        c, g = ransac("cpu"), ransac(dev)
        agree = float((g.inliers.cpu() == c.inliers).to(torch.float32).mean())
        print(f"phase6 {name}: ok {bool(c.ok)}/{bool(g.ok)}, inliers {int(c.n_inliers)} cpu "
              f"{int(g.n_inliers)} cuda, flags agree {agree:.4f}, "
              f"{_cuda_ms(lambda: ransac(dev)):.3f} ms per call on the card", flush=True)
        if not (bool(c.ok) and bool(g.ok)) or agree < 0.99:
            raise AssertionError(f"{name}: CUDA and CPU disagree")
        _sim3_diff(name, g.S12, c.S12, 1e-4)

        def polish(device, S0):
            return sim3_opt.optimize_sim3(
                S0.to(device), *(t(a, device) for a in (x1, x2, uv1, uv2, ones, ones)),
                c.inliers.to(device), t(K, device), t(K, device), fix_scale=fix_scale)

        oc, og = polish("cpu", c.S12), polish(dev, c.S12)
        name = f"optimize_sim3 fix_scale={fix_scale}"
        print(f"phase6 {name}: inliers {int(oc.n_inliers)} cpu {int(og.n_inliers)} cuda, "
              f"{_cuda_ms(lambda: polish(dev, c.S12)):.3f} ms per call on the card", flush=True)
        if int(oc.n_inliers) != int(og.n_inliers) or int(oc.n_inliers) < 100:
            raise AssertionError(f"{name}: inlier counts differ or collapsed")
        _sim3_diff(name, og.S12, oc.S12, 1e-4)

    # The float32 top eigenvectors of Horn's N on the two devices, which
    # horn_sim3 avoids by diagonalizing in float64.
    p1s, p2s = t(x1)[idx], t(x2)[idx]
    N = sim3solve.horn_matrix(
        (p2s - p2s.mean(1, keepdim=True)).transpose(1, 2) @ (p1s - p1s.mean(1, keepdim=True)))

    def top(Nm):
        v = torch.linalg.eigh(Nm)[1][..., -1]
        return (v * torch.where(v[:, :1] < 0, -1.0, 1.0)).cpu().double()

    d32 = (top(N.to(dev)) - top(N)).abs().amax(1)
    d64 = (top(N.double().to(dev)) - top(N.double())).abs().amax(1)
    print(f"phase6 horn top eigenvector, CUDA against CPU over {len(N)} samples: float32 median "
          f"{float(d32.median()):.3e} max {float(d32.max()):.3e}; float64 median "
          f"{float(d64.median()):.3e} max {float(d64.max()):.3e}", flush=True)

    # Pose graph: a ring of 80 vertices, chain + skip + one loop edge,
    # measurements 0.02 off the true relatives. The bound on CUDA-CPU is
    # taken from the CPU's own float32-float64 gap (PCG amplifies
    # summation order): 20x that gap, between 1e-5 and 5e-3.
    Kv = 80
    gen = torch.Generator().manual_seed(0)
    gt = sim3.exp(torch.randn(Kv, 7, generator=gen) * 0.3)
    ei = torch.cat([torch.arange(Kv - 1), torch.arange(Kv - 2), torch.tensor([0])])
    ej = torch.cat([torch.arange(1, Kv), torch.arange(2, Kv), torch.tensor([Kv - 1])])
    E = len(ei)
    meas = sim3.compose(sim3.exp(torch.randn(E, 7, generator=gen) * 0.02),
                        sim3.compose(gt[ej], sim3.inverse(gt[ei])))
    verts = sim3.compose(sim3.exp(torch.randn(Kv, 7, generator=gen) * 0.05), gt)
    fixed = torch.arange(Kv) == 0

    def problem(device, dtype):
        return pose_graph.PoseGraphProblem(
            vertices=verts.to(device, dtype), v_fixed=fixed.to(device),
            v_valid=torch.ones(Kv, dtype=torch.bool, device=device), edge_i=ei.to(device),
            edge_j=ej.to(device), edge_Sji=meas.to(device, dtype),
            edge_weight=torch.ones(E, dtype=dtype, device=device),
            edge_valid=torch.ones(E, dtype=torch.bool, device=device))

    def gn(device, dtype=torch.float32):
        p = problem(device, dtype)
        return pose_graph.gn_step(p, p.vertices, pcg_iters=50)

    ref, c32, g32 = gn("cpu", torch.float64), gn("cpu"), gn(dev).cpu()
    gap = float((c32 - ref).abs().max())
    bound = min(max(20 * gap, 1e-5), 5e-3)
    diff = float((g32 - c32).abs().max())
    print(f"phase6 pose_graph.gn_step {Kv} vertices {E} edges 50 PCG iterations: CUDA-CPU "
          f"{diff:.3e}, CUDA-float64 {float((g32 - ref).abs().max()):.3e}, CPU float32-float64 "
          f"{gap:.3e} (bound {bound:.3e}), {_cuda_ms(lambda: gn(dev)):.3f} ms per call on the "
          f"card", flush=True)
    if not diff < bound:
        raise AssertionError("pose_graph.gn_step: CUDA differs from the CPU beyond the bound")

    # Global-BA-sized LM step with PCG: 64 stereo cameras (bf = 100, so
    # the scale is observed), 4096 points, 6 observations a point. 50 PCG iterations amplify
    # summation order, so the bound is again 20x the CPU's own
    # float32-float64 gap (at most 5e-3 for poses, 5e-2 m for points), and
    # the two devices must end within 1% of each other's error. (With a
    # monocular problem whose two fixed cameras sit 0.08 m apart the scale
    # is barely observed, and float32 alone parts from float64 by 2e-2.)
    C, P, per = 64, 4096, 6
    rng = np.random.default_rng(3)
    xw = syn.random_scene(P, depth_range=(5, 12), spread=5, seed=3).astype(np.float32)
    traj = syn.smooth_trajectory(C, speed=0.5)
    obs_pt = np.repeat(np.arange(P), per).astype(np.int32)
    obs_cam = np.concatenate([rng.choice(C, per, replace=False) for _ in range(P)]).astype(np.int32)
    xc = np.einsum("nij,nj->ni", traj[obs_cam][:, :, :3], xw[obs_pt]) + traj[obs_cam][:, :, 3]
    uv = project(xc) + rng.normal(0, 0.3, (len(xc), 2)).astype(np.float32)
    cam_T = traj.copy()
    cam_T[1:, :, 3] += rng.normal(0, 0.01, (C - 1, 3)).astype(np.float32)
    arrs = dict(
        cam_T=cam_T, cam_fixed=np.arange(C) < 1, cam_valid=np.ones(C, bool),
        points=xw + rng.normal(0, 0.02, xw.shape).astype(np.float32),
        point_valid=np.ones(P, bool), obs_cam=obs_cam, obs_pt=obs_pt,
        obs_uv=np.c_[uv, uv[:, 0] - 100.0 / xc[:, 2]].astype(np.float32),
        obs_stereo=np.ones(len(uv), bool),
        obs_inv_sigma2=np.ones(len(uv), np.float32), obs_valid=np.ones(len(uv), bool),
        K=K, bf=np.float32(100.0))

    def lm(device, dtype=torch.float32):
        tens = {k: t(v, device) for k, v in arrs.items()}
        tens = {k: v.to(dtype) if v.is_floating_point() else v for k, v in tens.items()}
        p = ba.sort_by_point(ba.BAProblem(**tens))
        err = ba.stage_error(p)
        return ba.lm_step(p, torch.tensor(1e-4, dtype=dtype, device=device), err, pcg_iters=50,
                          schur="pcg") + (err,)

    ref, lc_, lg = lm("cpu", torch.float64), lm("cpu"), lm(dev)
    gapT = float((lc_[0] - ref[0]).abs().max())
    gapx = float((lc_[1] - ref[1]).abs().max())
    bT, bx = min(max(20 * gapT, 1e-5), 5e-3), min(max(20 * gapx, 1e-4), 5e-2)
    dT = float((lg[0].cpu() - lc_[0]).abs().max())
    dx = float((lg[1].cpu() - lc_[1]).abs().max())
    print(f"phase6 ba.lm_step PCG {C} cameras {P} points {len(uv)} observations: CUDA-CPU pose "
          f"diff {dT:.3e} (CPU float32-float64 {gapT:.3e}, bound {bT:.3e}), point diff {dx:.3e} m "
          f"({gapx:.3e}, bound {bx:.3e}), error {float(lc_[4]):.1f} -> {float(lc_[3]):.1f} cpu "
          f"{float(lg[3]):.1f} cuda {float(ref[3]):.1f} float64, "
          f"{_cuda_ms(lambda: lm(dev)):.3f} ms per call on the card", flush=True)
    same_err = abs(float(lg[3]) - float(lc_[3])) < 0.01 * float(lc_[3])
    if not (dT < bT and dx < bx and same_err and float(lg[3]) < float(lg[4])):
        raise AssertionError("ba.lm_step (PCG): CUDA differs from the CPU or did not descend")


BASELINE = 0.2


def orbit_world(n=1400, r_path=8.0, seed=7):
    """Blobs in an annulus OUTSIDE an orbit of radius r_path (the world of
    tests/e2e_loop_debug.py): an outward-looking camera sees only its
    local sector, so covisibility breaks and the return is a true loop."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(r_path + 3.0, r_path + 9.0, n)
    y = rng.uniform(-3.0, 3.0, n)
    xw = np.stack([rad * np.cos(ang), y, rad * np.sin(ang)], axis=1).astype(np.float32)
    intensity = rng.uniform(40, 215, n).astype(np.float32)
    world_size = rng.uniform(0.10, 0.22, n).astype(np.float32)
    return xw, intensity, world_size


def orbit_trajectory(n_frames, r_path=8.0, frac=1.18):
    """World->cam poses on a circle of radius r_path, camera looking
    radially outward; frac > 1 overlaps the start sector at the end."""
    import numpy as np

    poses = []
    for i in range(n_frames):
        a = 2 * np.pi * frac * i / n_frames
        c_w = np.array([r_path * np.cos(a), 0.0, r_path * np.sin(a)])
        z_axis = np.array([np.cos(a), 0.0, np.sin(a)])
        y_axis = np.array([0.0, 1.0, 0.0])
        R_cw = np.stack([np.cross(y_axis, z_axis), y_axis, z_axis], axis=1).T
        poses.append(np.concatenate([R_cw, (-R_cw @ c_w)[:, None]], axis=1))
    return np.stack(poses).astype(np.float32)


def loop_run(label, dev, sensor_name):
    """The 240-frame orbit with loop closing on; returns window_top2's
    launches. Gates: tests/test_e2e_loop.py's."""
    import numpy as np
    from c_orb_slam_tpu_torch import config as tcfg
    from c_orb_slam_tpu_torch.system import System

    syn = _synthetic()
    n = 240
    mono = sensor_name == "mono"
    cam = tcfg.CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480,
                            fps=10, bf=0.0 if mono else 500.0 * BASELINE)
    cfg = tcfg.SlamConfig(
        sensor=tcfg.Sensor.MONOCULAR if mono else tcfg.Sensor.STEREO, camera=cam,
        orb=tcfg.OrbConfig(n_features=800, n_levels=4),
        tracking=tcfg.TrackingConfig(min_stereo_init_points=60, velocity_rotation_fraction=0.5,
                                     max_frames_between_kf=10),
    )
    K4 = (cam.fx, cam.fy, cam.cx, cam.cy)
    xw, inten, size = orbit_world()
    traj = orbit_trajectory(n)
    if mono:
        frames = [syn.render_scene(xw, inten, size, T, K4) for T in traj]
        track = lambda s, i, f: s.track_monocular(f, i * 0.1)  # noqa: E731
    else:
        frames = [syn.render_stereo_pair(xw, inten, size, T, K4, BASELINE) for T in traj]
        track = lambda s, i, f: s.track_stereo(f[0], f[1], i * 0.1)  # noqa: E731
    sysm = System(cfg, dev, enable_loop_closing=True)
    sysm.warmup()
    lc = sysm.loop_closing
    if lc.voc is None or lc.voc.n_words != 10**5:
        raise AssertionError(f"{label}: the shipped 10^5-word vocabulary did not load")

    # Host ms of each advance_background call, by what it advanced.
    chunks = {}
    advance = lc.advance_background

    def timed_advance():
        kind = ("correction." + lc.correction_job.stage if lc.correction_job is not None
                else "sim3." + lc.sim3_job.stage if lc.sim3_job is not None
                else "gba" if lc.gba_job is not None else "idle")
        t0 = time.perf_counter()
        out = advance()
        chunks.setdefault(kind, []).append((time.perf_counter() - t0) * 1000.0)
        return out

    lc.advance_background = timed_advance

    # Keyframe ATE around each of the correction's three map writes: which
    # of them brings the trajectory home.
    from c_orb_slam_tpu_torch.io import trajectory as traj_io

    kf_ate = []

    def around(name):
        orig = getattr(lc, name)

        def wrapper(*args, **kwargs):
            def ate():
                live = sysm.map.live_keyframes()
                ids = [int(round(float(sysm.map.kf_timestamp[k]) * 10.0)) for k in live]
                return round(float(traj_io.ate_rmse(sysm.map.kf_pose[live], traj[ids],
                                                    with_scale=mono)), 5)

            before = ate()
            n_obs = int((sysm.map.kf_mp >= 0).sum())
            out = orig(*args, **kwargs)
            row = [name, before, ate(), n_obs]
            if name == "_apply_gba":  # the solve's last error and damping
                job = args[0]
                row += [round(float(job.err), 1) if job.err is not None else None,
                        float(job.lam)]
            kf_ate.append(row)
            return out

        setattr(lc, name, wrapper)

    for name in ("_correct_loop", "_apply_pose_graph_result", "_apply_gba"):
        around(name)
    loops_at, gba_at = [], []

    def on_frame(i):
        if lc.n_loops_closed > len(loops_at):
            loops_at.append(i)
        if lc.n_gba_applied > len(gba_at):
            gba_at.append(i)

    run = drive(label, sysm, frames, track, traj, 10.0, with_scale=mono, on_frame=on_frame)
    med = statistics.median(run["host_ms"][WARMUP_FRAMES:])
    print(f"{label} loops closed {lc.n_loops_closed} at frames {loops_at}, global BA applied "
          f"{lc.n_gba_applied} at frames {gba_at or 'none (in the shutdown drain)'}, keyframes "
          f"{len(sysm.map.live_keyframes())}, points {int(sysm.map.pt_valid.sum())}", flush=True)
    print(f"{label} host ms per advance_background call by chunk (median, max, calls): "
          + json.dumps({k: [round(statistics.median(v), 3), round(max(v), 3), len(v)]
                        for k, v in sorted(chunks.items())}), flush=True)
    print(f"{label} keyframe ATE (m, {'scale-aligned' if mono else 'absolute scale'}) before and "
          f"after each map write of the correction, with the map's observation count before it "
          f"(and the global BA's last error and damping): {json.dumps(kf_ate)}; observations at "
          f"the end {int((sysm.map.kf_mp >= 0).sum())}", flush=True)
    if loops_at:
        print(f"{label} correction frame {loops_at[0]}: {run['host_ms'][loops_at[0]]:.3f} ms "
              f"against the median frame's {med:.3f} ms (host per call)", flush=True)
    if run["n_ok"] <= 0.9 * n:
        raise AssertionError(f"{label}: tracked only {run['n_ok']}/{n} frames")
    if lc.n_loops_closed < 1:
        raise AssertionError(f"{label}: no loop closed")
    if not run["ate"] < 0.4:
        raise AssertionError(f"{label}: ATE {run['ate']:.4f} m >= 0.4 m")
    if lc.n_gba_applied < 1:
        raise AssertionError(f"{label}: the background global BA was never applied")
    if gba_at and gba_at[0] - loops_at[0] < 5:
        raise AssertionError(f"{label}: global BA applied {gba_at[0] - loops_at[0]} frames after "
                             f"the loop event: the solve was not spread over frames")
    if not np.isfinite(sysm.map.pt_xyz[sysm.map.live_points()]).all():
        raise AssertionError(f"{label}: non-finite map points after the correction")
    return run["launches"]


def phase7(dev):
    """Stereo orbit, loop closing on (fixed scale)."""
    return loop_run("phase7", dev, "stereo")


def phase8(dev):
    """Monocular orbit, loop closing on (free scale)."""
    return loop_run("phase8", dev, "mono")


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch missing: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import c_orb_slam_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not next to this script: {e}", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    try:
        rows, max_err, empty_ms = phase1(dev)
        launches = 0
        for num, phase in ((2, phase2), (3, phase3), (4, phase4), (5, phase5), (6, phase6),
                           (7, phase7), (8, phase8)):
            t0 = time.perf_counter()
            launches += phase(dev) or 0
            if num == 6:
                phase6_loop(dev)
            print(f"phase{num} took {time.perf_counter() - t0:.1f} s", flush=True)
    except Exception as e:  # any failed phase fails the run, with its cause
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # The times are those of the local map's search, the largest call of a
    # tracked frame (phases 2, 3 and 5; "by_shape" has every case's times,
    # the loop runs' shapes among them). No single PyTorch call computes a
    # windowed top-2: no library time.
    print(json.dumps({"kernels": [{
        "name": "window_top2",
        "route": "cuda",
        "source": "c_orb_slam_tpu_torch/csrc/window_top2.cu",
        "replaces": "c_orb_slam_tpu/ops/pallas_match.py:163",
        "launches": launches,
        "max_abs_err": max_err,
        **rows["local_map_8192x1000"],
        "empty_launch_ms": empty_ms,
        "library_ms": None,
        "by_shape": rows,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
