#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (c_orb_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phase 1 builds the window_top2 kernel (csrc/window_top2.cu, nvcc for
sm_90a) and holds it against its plain PyTorch version on the card, for
exact equality of all four outputs, at the shapes the main path gives it
(TUM geometry with 1000 keypoints, KITTI geometry with 2000) plus
unaligned, fully-masked, single-target and tie-heavy cases, the local
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
results (cuSOLVER eigh/svd) to the CPU ones.

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


def make_case(rng, B, Q, T, *, w=640, h=480, masked_rows=False, ties=False, window="motion"):
    """Numpy inputs for window_top2 shaped like the main path's calls:
    targets across a w x h image, projected queries near some of them,
    octave windows of width 3. The radius is the motion model's (15 px x
    level scale), the local map's (`window="local_map"`: 4-6 px x level
    scale) or holds every target (`window="all"`, and with `ties`)."""
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
    lo = rng.integers(0, 6, lead + (Q,)).astype(np.int32)
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
        q_hi=np.minimum(lo + 2, 7).astype(np.int32), q_valid=qv,
        t_desc=td.view(np.int32), t_xy=txy,
        t_octave=rng.integers(0, 8, lead + (T,)).astype(np.int32),
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


def drive(label, sysm, frames, track, traj, fps, with_scale, warmup=WARMUP_FRAMES):
    """Run `track(sysm, i, frame)` over the frames with the window_top2
    launch count set to 0 just before and read just after; print and
    return the run's numbers."""
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
    return dict(n_ok=len(poses), ate=ate, launches=launches, ids=ids)


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
        launches = phase2(dev) + phase3(dev) + phase4(dev) + phase5(dev)
        phase6(dev)
    except Exception as e:  # any failed phase fails the run, with its cause
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # The local map's search, the largest call of a tracked frame. No
    # single PyTorch call computes a windowed top-2: no library time.
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
