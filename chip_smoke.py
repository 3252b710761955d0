#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (c_orb_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phase 1 builds the window_top2 kernel (csrc/window_top2.cu, nvcc for
sm_90a) and holds it against its plain PyTorch version on the card, for
exact equality of all four outputs, at the shapes the main path gives it
(TUM geometry with 1000 keypoints on 8 levels, KITTI geometry with 2000,
the loop runs' 800 keypoints on 4 levels; the mapper's fuse batches at 32
pairs, its cap, and at the live counts it launches: 16, 17 and 1) plus
unaligned, fully-masked, single-target and tie-heavy cases, the local
map's real window (radius 4-6 px x scale) and the worst case of a kernel
that culls by window first (every target in every window). It times both
(CUDA events around 20 back-to-back calls, median of 7: "ms", which is
what a call costs the main path), the kernel also as a CUDA graph of the
same 20 calls ("device_ms", its time on the device: the wrapper's host
side takes longer than the kernel runs), and an empty kernel launched the
same way; and it computes each case's bound from the case's own inputs.
Then it builds the pose-solve kernel (csrc/pose_gn.cu) and holds it to
its plain version (optim/pose_opt.py optimize_pose_reference: poses within
1e-4, inlier flags equal but at their chi2 gate, n_inliers the flags'
sums) on the tracker's solve (tests/pose_problems.py: 1 x 2,000 rows of
KITTI geometry, 60% stereo, 30% gross outliers, 4 x 10 iterations), and
times it: "ms" per
call back to back, "device_ms" as a CUDA graph, "host_ms" the wrapper's
enqueue alone, and the plain version. Then it builds the FAST detection and
selection kernel (csrc/fast_select.cu) and holds it to its plain version
(ops/fast_select.py detect_and_select_reference: yx, response and valid of
every slot equal, subpixel offsets within 1e-6, 3 launches a call) on one
image's 8 levels at KITTI's 1241x376 with 2,000 features and TUM's 640x480
with 1,000 (tests/fast_images.py), times it the same way, and prints its
bound. Every System run below must launch it 3 times an extraction.

Phases 2-5 drive the port's entry points with loop closing off (the main
path's loop-off runs), each on a synthetic sequence rendered by
tests/synthetic.py, and check frames tracked, ATE and that window_top2
and the pose-solve kernel launched during that phase's run (each prints
both kernels' launches):
- phase 2: System.track_rgbd, 60 frames at TUM RGB-D geometry (640x480,
  1000 features, 8 levels), ATE at absolute scale; local BA must run;
- phase 3: System.track_monocular on bench.py's mono_tum30 (70 frames, 30
  Hz, 1000 features, 8 levels; the entry of the port's bench CONFIGS)
  with loop closing off, which bench.py leaves on; ATE after scale
  alignment; run twice in this process, and the two trajectories (stamps
  and poses as float32 bytes) must hash equal;
- phase 4: System.track_stereo on bench.py's stereo_kitti (1241x376, 2000
  features, 8 levels, baseline 0.2 m; the port's CONFIGS entry), cut from
  120 to 30 frames and with loop closing off; ATE at absolute scale;
- phase 5: relocalization: the 40-frame RGB-D sequence of
  tests/test_torch_reloc.py with frames 28-29 blank, must relocalize at
  frame 30 or later and end OK.
Phase 6 runs the two-view and PnP RANSAC solvers on CUDA and on the CPU
with the same inputs and injected first-round draws, and holds the CUDA
results (cuSOLVER eigh/svd) to the CPU ones; then the loop path's solvers
the same way: solve_sim3_ransac (injected draw), optimize_sim3, one
pose_graph.gn_step and one implicit-Schur (PCG) ba.lm_step; then the
dense solves on singular input: a local BA at the full bucket whose
float32 dense-Schur Cholesky fails must reject its LM step on both
devices (state unchanged, damping x 4), and every LU call of the port on
a singular input must give the same non-finite entries on CUDA as on the
CPU, and as the JAX package (recorded in SINGULAR_JAX); last, three
solvers run 3 times each on one seeded input must give the same bits every
time: ba.bundle_adjust at the full local-BA bucket (64 cameras x 8192
points x 16384 observations), a pose_graph.gn_step on phase 10a's 512
vertices x 7,396 edges, and BoW aggregation and scoring over a filled
database.

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
Both print the dense-Schur LM iterations whose factorization failed,
counted on the device and read once at the end of the run (10c too).

Phase 9 drives the product surface at TUM RGB-D geometry (blob_world(400,
seed=5), 640x480, 1000 features, 8 levels, DepthMapFactor 5000): it
writes 60 rendered frames as a TUM tree (8-bit P5 images, 16-bit P5
depth, rgb.txt and an associations file), requires the native image
loader's PNM decoder, checks that the depth decodes natively to the values
written, runs the RGB-D driver (examples/rgbd_tum.py, --device cuda, its
reads native, PIL refused) over the first 20 frames with --save-map (ATE < 0.05 m on
the saved TUM trajectory), then System.from_saved_map relocalizes into the
map and tracks frames 14-59 in localization mode: relocalized on the first
frames, >= 90% of the mapped frames tracked with ATE < 0.05 m, the map
unchanged, VO mode on at least 5 frames past the mapped region; one frame
drawn with FrameDrawer. Where the machine reads PNG (natively or through PIL), the stereo
KITTI driver runs 30 frames of a rendered KITTI tree (every frame tracked,
ATE < 0.05 m). It prints which decoders the machine offers. Two fresh
child processes relocalize into the saved map, one without and one after
System.warmup(), and print the first relocalization's ms.

Phase 10 runs the sharded solvers of parallel/ (in-process meshes of 4
shards on the one card, as the JAX tests' 8 virtual CPU devices):
- 10a: dba.distributed_bundle_adjust (dense Schur) at the full local-BA
  bucket (64 cameras x 8192 points x 16384 observations),
  sharded_ba.sharded_bundle_adjust on a global BA of 512 keyframes x 65536
  points x 524288 observations and dpose_graph.distributed_pose_graph on
  512 vertices x 7,396 edges, each held against its single-device solve
  on the card (cam_T within 5e-4 / 2e-4, vertices within 1e-4, the JAX
  tests' tolerances; the points seen from two cameras or more, the inlier
  flags in slab order against the solve of the partitioned problem, and
  the mean inlier chi2, at five times the gaps measured on the card) and timed
  beside it (CUDA events, one call after the checked one), with its collectives per
  iteration;
- 10b: two gloo ranks on cuda:0 (2 shards each; gloo's CUDA tensors cross
  through host memory) run the global BA and the essential graph, then one
  NCCL rank (world size 1, 4 shards) the global BA, each in a child
  process joined by parallel/multihost.initialize; rank 0 is held against
  the single-device solves on every output (its own blocks of the points
  and the inlier flags);
- 10c: phase 7's stereo orbit with System(cfg, "cuda", mesh=4 shards),
  run on for 20 frames past phase 7's 240 along the same orbit: phase 7's
  gates, the essential graph through dpose_graph, the global BA as a
  _ShardedGbaJob (both one iteration a frame), at least one full-bucket
  local BA through dba; it prints the local BAs by route, the frame on
  which the global BA was applied and the worst frame with what the loop
  closer advanced on it.

Phase 11 runs the port's benchmark entry point, `python3 -m
c_orb_slam_tpu_torch.tools.bench --all --max-frames 90`, in a child
process: bench.py's four configurations (mono_fast10, stereo_kitti,
stereo_kitti_long, then the headline mono_tum30) as bench.py runs them,
with loop closing on; stereo_kitti (120 frames) and stereo_kitti_long
(300) are cut to their first 90, the monocular two run whole. It prints the four records and fails
unless the child exits 0 and each record holds its bench.py gate, ran its
frames with loop closing on on this card with its power limit recorded,
and launched window_top2 and pose_gn; those launches count toward the
kernels'.

Phase 12 runs the port's profiling entry points in child processes:
`python3 -m c_orb_slam_tpu_torch.tools.profile_stages --config mono_tum30
--frames 40 --trace 5` (the configuration cut from 70 to 40 frames; the
counterpart of tools/profile_stages.py --tum30 and
tools/profile_track_fine.py: stage and tracking sub-stage ms a frame, and a
torch.profiler window of 5 frames: the device's busy and idle share,
launches a frame, the device operations with the most time), then
`python3 -m c_orb_slam_tpu_torch.tools.profile_kernels --config NAME` for
mono_tum30 and for stereo_kitti (the counterpart of tools/profile_kernels.py,
profile_device_kernels.py, profile_mapping.py and profile_latency.py: each
hot program's host ms, device ms, kernel ms, launches and launch floor,
and the mapper's three dispatches split into enqueue, ready and fetch; a
profiler session that recorded no CUDA kernel runs again, up to 3 in all,
and is reported). It prints their records and fails unless each child exits 0 and every record
has its fields, names this card with its power limit, and holds device
fields read on the card (nonzero, the idle share within [0, 1]), and the
tracking sub-stages sum to no more than the tracking stage.

Exits nonzero, printing no result, when there is no CUDA device or any
phase fails. The last line of standard output is
{"ok": true, "device": {...}}; the line before it lists each kernel.
"""

from __future__ import annotations

import collections
import contextlib
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


# Plain float operations of the pose-solve kernel (csrc/pose_gn.cu), counted
# from its source: a row's residual, Jacobian, weight and its 27 terms of
# the normal system in one iteration (the transform 18, the projection and
# residual 20, the projection's Jacobian 17, the pose Jacobian 36, the
# weight and Huber factor 7, the terms 180), and a row's inlier test at a
# round's end (the transform, projection, residual and chi2: 40).
POSE_GN_OPS_PER_ROW_ITERATION = 278
POSE_GN_OPS_PER_ROW_ROUND = 40


def pose_gn_bound(B, N, rounds, iters):
    """(bound ms, "bytes" or "operations") of one pose solve of B problems
    of N rows: the rows (points, observations and weight, 7 floats; two
    flags; an inlier flag out), the poses, K and the counts each read or
    written once, over
    the HBM rate, against the kernel's row operations over the lanes' peak
    rate. The serial 6x6 solve of each iteration is left out: it is a few
    hundred operations of one thread."""
    n_bytes = B * N * (4 * 7 + 2 + 1) + B * (2 * 48 + 4) + 16
    ops = B * N * (rounds * iters * POSE_GN_OPS_PER_ROW_ITERATION
                   + rounds * POSE_GN_OPS_PER_ROW_ROUND)
    ops_s, bytes_s = ops / LANE_OPS_PER_S, n_bytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def pose_gn_row(dev):
    """The pose-solve kernel at the tracker's shape against its plain
    version (tests/test_torch_pose_gn_cuda.py's tolerances: poses within
    1e-4; inlier flags equal but on rows whose chi2 lies within 1e-3 of
    their gate; each n_inliers the sum of its flags), and its times: ms per
    call back to back (CUDA events), as a CUDA graph (the device's time),
    the wrapper's host ms to enqueue a call, and the plain version's ms."""
    import numpy as np
    import torch
    from c_orb_slam_tpu_torch.optim import pose_opt
    from c_orb_slam_tpu_torch.optim import residuals as res
    from c_orb_slam_tpu_torch.utils import nvcc

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from pose_problems import tracker_problem

    pose_opt.load()
    print("nvcc build log (pose_gn):",
          nvcc.build_logs.get("pose_gn", "").strip().replace("\n", " | "), flush=True)
    a, kw = tracker_problem(0)
    args = {**{k: v.to(dev) for k, v in a.items()}, **kw}
    got = pose_opt.optimize_pose(**args)
    want = pose_opt.optimize_pose_reference(**args)
    err = float((got.pose - want.pose).abs().max())
    if not np.allclose(got.pose.cpu().numpy(), want.pose.cpu().numpy(), rtol=1e-4, atol=1e-4):
        raise AssertionError(f"pose_gn: pose differs from the plain version by {err:.3e}")
    r, _, _ = res.residual_and_jacobians(want.pose, args["xw"], args["obs"], args["K"],
                                         kw["bf"], args["is_stereo"])
    gate = torch.where(args["is_stereo"], 7.815, 5.991)
    near = ((res.chi2(r, args["inv_sigma2"]) / gate - 1.0).abs() <= 1e-3).cpu()
    differ = (got.inliers != want.inliers).cpu()
    counts = [int(got.n_inliers), int(want.n_inliers)]
    if (differ & ~near).any():
        raise AssertionError(f"pose_gn: {int((differ & ~near).sum())} inlier flags differ from "
                             f"the plain version's away from their gate")
    if counts != [int(got.inliers.sum()), int(want.inliers.sum())]:
        raise AssertionError(f"pose_gn: n_inliers {counts} are not the sums of the flags")
    if abs(counts[0] - counts[1]) > int(differ.sum()):
        raise AssertionError(f"pose_gn: n_inliers {counts[0]} against the plain version's "
                             f"{counts[1]}, with {int(differ.sum())} flags apart")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        pose_opt.optimize_pose(**args)
    host_ms = (time.perf_counter() - t0) * 1e3 / 20
    row = dict(ms=time_call(pose_opt.optimize_pose, args),
               device_ms=time_graph(pose_opt.optimize_pose, args), host_ms=host_ms,
               plain_ms=time_call(pose_opt.optimize_pose_reference, args, launches=2, repeats=3),
               max_abs_err=err, n_inliers=counts, inliers_apart=int(differ.sum()))
    row["bound_ms"], row["bound_by"] = pose_gn_bound(1, a["xw"].shape[0], 4, 10)
    print(f"phase1 pose_gn tracker 1x2000 (4 x 10): kernel == plain within 1e-4 (max "
          f"{err:.2e}; inliers {counts[0]} / {counts[1]}, {int(differ.sum())} flags apart, all "
          f"at their gate); kernel "
          f"{row['ms']:.4f} ms back to back, {row['device_ms']:.4f} ms as a CUDA graph, "
          f"wrapper host {host_ms:.4f} ms; plain {row['plain_ms']:.3f} ms; bound "
          f"{row['bound_ms']:.5f} ms by {row['bound_by']}", flush=True)
    return row


# Plain operations a pixel of the FAST kernel (csrc/fast_select.cu), counted
# from its source: launch A stages 1.44 tile pixels a pixel (clamps, address,
# bf16 rounding: 8 each, 12), tests the high threshold (16 neighbours of a
# load, a subtraction, two conversions, two compares and two flag updates:
# 112; two 9-run tests: 40) and scores at the cell's threshold (the same 152,
# 64 for the two sums, 8 for the maximum and the border); launch B stages
# 1.14 halo pixels a pixel (7), takes the 3 x 3 maximum and the keep test
# (13) and builds and compares a packed key in each of 4 rounds (24). Pass 1
# is counted over every pixel, which is the most it does: a cell's pass 1
# stops at its first high-threshold corner. Launch C's sorts are under 1%.
FAST_SELECT_OPS_PER_PIXEL = 12 + 152 + 152 + 64 + 8 + 7 + 13 + 24
# Bytes a pixel: the level read once, the score map written and read, the
# NMS'd map written; a candidate's value and yx written and read; an output
# slot's yx, response, valid and offset written.
FAST_SELECT_BYTES_PER_PIXEL = 16
FAST_SELECT_BYTES_PER_CANDIDATE = 2 * 12
FAST_SELECT_BYTES_PER_SLOT = 8 + 4 + 1 + 8


def fast_select_bound(levels, cfg):
    """(bound ms, "bytes" or "operations") of one image's detection and
    selection: its bytes over the HBM rate against its operations over the
    lanes' peak rate."""
    cell = cfg.cell_size
    pixels = sum(lv.numel() for lv in levels)
    cells = sum(-(-lv.shape[0] // cell) * -(-lv.shape[1] // cell) for lv in levels)
    n_bytes = (pixels * FAST_SELECT_BYTES_PER_PIXEL + 4 * cells * FAST_SELECT_BYTES_PER_CANDIDATE
               + sum(cfg.features_per_level()) * FAST_SELECT_BYTES_PER_SLOT)
    ops_s = pixels * FAST_SELECT_OPS_PER_PIXEL / LANE_OPS_PER_S
    bytes_s = n_bytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def fast_select_row(dev):
    """The FAST detection and selection kernel at the KITTI and TUM shapes
    against its plain version (tests/test_torch_fast_select_cuda.py's
    tolerances: yx, response and valid of every slot exactly, the subpixel
    offsets within 1e-6), and its times: ms per call back to back (CUDA
    events), as a CUDA graph (the device's time), the wrapper's host ms to
    enqueue a call, and the plain version's ms. Returns a row by shape."""
    import torch
    from c_orb_slam_tpu_torch.ops import fast_select
    from c_orb_slam_tpu_torch.utils import nvcc

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from fast_images import CASES, levels_of

    fast_select.load()
    print("nvcc build log (fast_select):",
          nvcc.build_logs.get("fast_select", "").strip().replace("\n", " | "), flush=True)
    rows = {}
    for name in ("kitti_1241x376_2000", "tum_640x480_1000"):
        image, cfg = CASES[name]()
        args = dict(levels=levels_of(image, cfg, dev), cfg=cfg)
        before = fast_select.launches
        got = fast_select.detect_and_select(**args)
        torch.cuda.synchronize()
        launches = fast_select.launches - before
        want = fast_select.detect_and_select_reference(**args)
        err = 0.0
        for lvl, (g, w) in enumerate(zip(got, want)):
            for label, a, b in zip(("yx", "response", "valid"), g[:3], w[:3]):
                if not torch.equal(a, b):
                    raise AssertionError(f"fast_select {name} level {lvl}: {label} differs "
                                         f"from the plain version")
            err = max(err, float((g[3] - w[3]).abs().max()) if g[3].numel() else 0.0)
        if not err <= 1e-6:
            raise AssertionError(f"fast_select {name}: subpixel offsets {err:.3e} from the "
                                 f"plain version's")
        if launches != fast_select.LAUNCHES_PER_CALL:
            raise AssertionError(f"fast_select {name}: {launches} launches a call")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fast_select.detect_and_select(**args)
        host_ms = (time.perf_counter() - t0) * 1e3 / 20
        row = dict(ms=time_call(fast_select.detect_and_select, args),
                   device_ms=time_graph(fast_select.detect_and_select, args), host_ms=host_ms,
                   plain_ms=time_call(fast_select.detect_and_select_reference, args,
                                      launches=2, repeats=3),
                   max_abs_err=err, launches_per_call=launches,
                   valid=int(sum(int(g[2].sum()) for g in got)))
        row["bound_ms"], row["bound_by"] = fast_select_bound(args["levels"], cfg)
        row["device_over_bound"] = row["device_ms"] / row["bound_ms"]
        rows[name] = row
        print(f"phase1 fast_select {name} ({cfg.n_levels} levels): kernel == plain on yx, "
              f"response, valid (subpixel max {err:.2e}; {row['valid']} valid); {launches} "
              f"launches; kernel {row['ms']:.4f} ms back to back, {row['device_ms']:.4f} ms as a "
              f"CUDA graph, wrapper host {host_ms:.4f} ms; plain {row['plain_ms']:.3f} ms; bound "
              f"{row['bound_ms']:.5f} ms by {row['bound_by']} (device / bound "
              f"{row['device_over_bound']:.1f})", flush=True)
    return rows


def phase1(dev):
    """window_top2 kernel == plain version, exactly; both timed, beside
    the empty launch and each case's bound."""
    import numpy as np
    import torch
    from c_orb_slam_tpu_torch.ops import window_top2 as w2

    from c_orb_slam_tpu_torch.utils import nvcc

    w2.load()
    print("nvcc build log:", nvcc.build_logs.get("window_top2", "").strip().replace("\n", " | "),
          flush=True)
    cases = [
        ("motion_model_1000x1000", dict(B=0, Q=1000, T=1000)),
        ("local_map_8192x1000", dict(B=0, Q=8192, T=1000)),
        ("unaligned_200x300", dict(B=0, Q=200, T=300)),
        ("fuse_batch_32x1000x1000", dict(B=32, Q=1000, T=1000)),
        # The fuse's batch is its live pair count (at most 32): a typical
        # 16, an odd 17 and a batch of one.
        ("fuse_live_16x1000x1000", dict(B=16, Q=1000, T=1000)),
        ("fuse_live_17x1000x1000", dict(B=17, Q=1000, T=1000)),
        ("fuse_live_1x1000x1000", dict(B=1, Q=1000, T=1000)),
        ("masked_rows_512x1000", dict(B=0, Q=512, T=1000, masked_rows=True)),
        ("single_target_300x1", dict(B=0, Q=300, T=1)),
        ("ties_1000x1000", dict(B=0, Q=1000, T=1000, ties=True)),
        # KITTI geometry (phase 4): 2000 keypoints across 1241x376.
        ("kitti_motion_model_2000x2000", dict(B=0, Q=2000, T=2000, w=1241, h=376)),
        ("kitti_local_map_8192x2000", dict(B=0, Q=8192, T=2000, w=1241, h=376)),
        ("kitti_fuse_batch_32x2000x2000", dict(B=32, Q=2000, T=2000, w=1241, h=376)),
        ("kitti_fuse_live_16x2000x2000", dict(B=16, Q=2000, T=2000, w=1241, h=376)),
        # The cull's worst case, and the local map's real window.
        ("dense_window_8192x1000", dict(B=0, Q=8192, T=1000, window="all")),
        ("sparse_local_map_8192x1000", dict(B=0, Q=8192, T=1000, window="local_map")),
        # The loop runs (phases 7-8): 800 keypoints on 4 levels, 640x480.
        ("loop_motion_model_800x800", dict(B=0, Q=800, T=800, levels=4)),
        ("loop_local_map_8192x800", dict(B=0, Q=8192, T=800, levels=4)),
        ("loop_sparse_local_map_8192x800", dict(B=0, Q=8192, T=800, levels=4,
                                                window="local_map")),
        ("loop_fuse_batch_32x800x800", dict(B=32, Q=800, T=800, levels=4)),
        ("loop_fuse_live_16x800x800", dict(B=16, Q=800, T=800, levels=4)),
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
    """Run `track(sysm, i, frame)` over the frames with the kernels' launch
    counts set to 0 just before and read just after; print and return the
    run's numbers. `on_frame(i)` runs after each frame. The FAST kernel
    must have launched 3 times for each extraction of the run."""
    import numpy as np
    import torch
    from c_orb_slam_tpu_torch.io import trajectory as traj_io
    from c_orb_slam_tpu_torch.ops import extract, fast_select
    from c_orb_slam_tpu_torch.ops import window_top2 as w2
    from c_orb_slam_tpu_torch.optim import pose_opt

    extract_orb, extractions = extract.extract_orb, [0]

    def counted(*args, **kwargs):
        extractions[0] += 1
        return extract_orb(*args, **kwargs)

    torch.cuda.synchronize()
    w2.reset_launches()
    pose_opt.reset_launches()
    fast_select.reset_launches()
    host_ms = []
    t_steady = None
    extract.extract_orb = counted
    try:
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
    finally:
        extract.extract_orb = extract_orb
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t_steady) * 1000.0
    launches = w2.launches
    pose_launches = pose_opt.launches
    fast_launches = fast_select.launches
    shapes = {"x".join(map(str, k)): v for k, v in sorted(w2.launch_shapes.items())}

    poses, stamps = sysm.frame_poses()
    if poses.ndim != 3 or poses.shape[1:] != (3, 4) or not np.isfinite(poses).all():
        raise AssertionError(f"{label}: frame poses malformed: shape {poses.shape}")
    ids = [int(round(t * fps)) for t in stamps]
    ate = traj_io.ate_rmse(poses, traj[ids], with_scale=with_scale)
    n = len(frames)
    steady = host_ms[warmup:]
    scale = "scale-aligned" if with_scale else "absolute scale"
    sha = traj_io.sha256(poses, stamps)
    print(f"{label} frames tracked {len(poses)}/{n}, ATE {ate:.5f} m ({scale}), "
          f"local BA solves {sysm.local_mapping.n_local_ba}, window_top2 launches {launches}, "
          f"pose_gn launches {pose_launches}, fast_select launches {fast_launches} over "
          f"{extractions[0]} extractions, final state {sysm.tracking_state()}, trajectory sha256 "
          f"{sha}", flush=True)
    print(f"{label} window_top2 launches by shape B x Q x T over {n} frames: {json.dumps(shapes)}",
          flush=True)
    print(f"{label} ms/frame after {warmup} warm-up frames: mean {wall_ms / len(steady):.3f} "
          f"(wall incl. final sync), median {statistics.median(steady):.3f} (host per call)",
          flush=True)
    stages = {k: v["total_ms"] for k, v in sysm.metrics.summary()["stages"].items()}
    print(f"{label} host ms per stage over the steady frames: {json.dumps(stages)}", flush=True)
    if launches <= 0:
        raise AssertionError(f"{label}: window_top2 never launched on the main path")
    if pose_launches <= 0:
        raise AssertionError(f"{label}: the pose-solve kernel never launched on the main path")
    if fast_launches != fast_select.LAUNCHES_PER_CALL * extractions[0] or not extractions[0]:
        raise AssertionError(f"{label}: {fast_launches} fast_select launches over "
                             f"{extractions[0]} extractions")
    return dict(n_ok=len(poses), ate=ate, launches=launches, pose_launches=pose_launches,
                fast_launches=fast_launches, ids=ids, host_ms=host_ms, sha=sha)


def _launches(run):
    """A main-path run's launches of the three kernels, as the phases sum
    them."""
    return collections.Counter(window_top2=run["launches"], pose_gn=run["pose_launches"],
                               fast_select=run["fast_launches"])


def _gates(label, run, n, ate_gate):
    if run["n_ok"] < 0.8 * n:
        raise AssertionError(f"{label}: tracked only {run['n_ok']}/{n} frames")
    if not run["ate"] < ate_gate:
        raise AssertionError(f"{label}: ATE {run['ate']:.4f} m >= {ate_gate} m")


def _tum_cfg(mod, sensor):
    """TUM-geometry configuration: 640x480, fx = fy = 500, 1000 features,
    8 levels (bench.py mono_tum30's geometry; bf = 100 for the RGB-D runs)."""
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
    return _launches(run)


def phase3(dev):
    """System.track_monocular at bench.py's mono_tum30, whole, with loop
    closing off (phase 11 runs it with loop closing on), twice in this
    process: the two trajectories (stamps and poses as float32 bytes) must
    hash equal."""
    from c_orb_slam_tpu_torch.system import System
    from c_orb_slam_tpu_torch.tools import bench
    from c_orb_slam_tpu_torch.tracking import TrackState

    c, cfg, frames, traj = bench.load("mono_tum30")
    dt = c["dt_frame"]
    launches, shas = collections.Counter(), []
    for k in (1, 2):
        label = f"phase3 run {k}"
        sysm = System(cfg, dev, enable_loop_closing=False)
        sysm.warmup()
        inits = []
        _timed(sysm.tracker, "_monocular_initialization", inits)
        run = drive(label, sysm, frames, lambda s, i, f: s.track_monocular(f, i * dt),
                    traj, 1.0 / dt, with_scale=True, warmup=c["warmup"])
        print(f"{label} two-view initialization calls (host ms incl. sync): "
              f"{[round(ms, 3) for ms, _ in inits]}; the last one initialized the map",
              flush=True)
        _gates(label, run, c["n_frames"], c["ate_gate"])
        if sysm.tracking_state() != TrackState.OK:
            raise AssertionError(f"{label}: tracking not OK at the end")
        launches += _launches(run)
        shas.append(run["sha"])
    print(f"phase3 trajectory sha256 of the two runs: {shas[0]} {shas[1]}", flush=True)
    if shas[0] != shas[1]:
        raise AssertionError("phase3: two runs of one configuration gave different trajectories")
    return launches


def phase4(dev):
    """System.track_stereo at bench.py's stereo_kitti, cut from 120 to 30
    frames (the first quarter of its path), with loop closing off (phase 11
    runs it whole with loop closing on)."""
    from c_orb_slam_tpu_torch.system import System
    from c_orb_slam_tpu_torch.tools import bench

    c, cfg, frames, traj = bench.load("stereo_kitti", n_frames=30)
    dt = c["dt_frame"]
    sysm = System(cfg, dev, enable_loop_closing=False)
    sysm.warmup()
    run = drive("phase4", sysm, frames, lambda s, i, f: s.track_stereo(f[0], f[1], i * dt),
                traj, 1.0 / dt, with_scale=False, warmup=c["warmup"])
    _gates("phase4", run, c["n_frames"], c["ate_gate"])
    return _launches(run)


def phase5(dev):
    """Relocalization after two blank frames (tests/test_torch_reloc.py's
    40-frame RGB-D sequence, its configuration: 800 features, 4 levels). The
    run must end OK, relocalize at frame 30 or later and hold the gates."""
    import numpy as np
    from c_orb_slam_tpu_torch import config as tcfg
    from c_orb_slam_tpu_torch.system import System
    from c_orb_slam_tpu_torch.tracking import TrackState

    syn = _synthetic()
    n, blank = 40, (28, 29)
    cam = tcfg.CameraConfig(fx=500, fy=500, cx=320, cy=240, width=640, height=480, fps=10,
                            bf=100.0)
    cfg = tcfg.SlamConfig(
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
    sysm = System(cfg, dev, enable_loop_closing=False)
    relocs = []
    _timed(sysm.tracker, "_relocalize", relocs)
    label = "phase5"
    run = drive(label, sysm, frames, lambda s, i, f: s.track_rgbd(f[0], f[1], i / 10.0),
                traj, 10.0, with_scale=False)
    reloc_id = sysm.tracker.last_reloc_frame_id
    print(f"{label}: last_reloc_frame_id {reloc_id}, relocalize calls (host ms incl. sync, "
          f"ok) {[(round(ms, 3), bool(out[0])) for ms, out in relocs]}", flush=True)
    if sysm.tracking_state() != TrackState.OK:
        raise AssertionError(f"{label}: tracking not OK at the end")
    if reloc_id < 30:
        raise AssertionError(f"{label}: no relocalization at frame 30 or later")
    _gates(label, run, n, 0.05)
    return _launches(run)


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


def _sha(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def phase6_repeat(dev, runs=3):
    """Three solvers of the main path, each `runs` times on one seeded input
    on the card, must give the same bits every time (their sums are ordered
    segment sums, ops/segment.py, where index_add_ adds with float
    atomics): ba.bundle_adjust at the full local-BA bucket (dense Schur, the
    live iteration counts), one pose_graph.gn_step on phase 10a's essential
    graph, and the aggregation and scoring of a query against a filled
    BoW database on the shipped vocabulary."""
    import numpy as np
    import torch
    from c_orb_slam_tpu_torch import config as tcfg
    from c_orb_slam_tpu_torch.bow import database, vocab
    from c_orb_slam_tpu_torch.optim import ba, pose_graph

    opt = tcfg.OptimizerConfig()
    p_l = ba_problem(*DBA_SIZE, dev, seed=1)
    p_p = pg_problem(PG_VERTICES, dev)
    voc = vocab.load(vocab.builtin_vocabulary_path()).to(dev)
    rng = np.random.default_rng(6)
    n_kf, n_desc = 64, 1000
    leaves = voc.levels[-1].cpu().numpy()

    def frame_bow():
        d = leaves[rng.integers(0, 2000, n_desc)].copy()  # frames share words
        d[:, 0] ^= rng.integers(0, 2, n_desc).astype(np.int32) << 3
        return vocab.transform(voc, torch.from_numpy(d).to(dev),
                               torch.ones(n_desc, dtype=torch.bool, device=dev))

    db = database.KeyFrameDatabase(voc, n_kf, n_desc)
    for k in range(n_kf):
        fb = frame_bow()
        db.add_dev(k, *database.aggregate_bow_dev(fb.word, fb.weight, n_desc))
    q = frame_bow()

    def bow():
        w, a = database.aggregate_bow_dev(q.word, q.weight, n_desc)
        return (w, a, *db.scores_dev(w, a, exclude=()))

    solvers = (
        (f"ba.bundle_adjust ({DBA_SIZE[0]} cameras x {DBA_SIZE[3]} point slots x "
         f"{DBA_SIZE[4]} observation slots, dense Schur)",
         lambda: ba.bundle_adjust(p_l, iters_first=opt.local_ba_its_first,
                                  iters_second=opt.local_ba_its_second, schur="dense")),
        (f"pose_graph.gn_step ({PG_VERTICES} vertices x {p_p.edge_i.shape[0]} edges)",
         lambda: [pose_graph.gn_step(p_p, p_p.vertices, pcg_iters=opt.pcg_iters)]),
        (f"BoW aggregation and score against {n_kf} keyframes of {n_desc} descriptors", bow),
    )
    for name, fn in solvers:
        shas = [_sha(fn()) for _ in range(runs)]
        print(f"phase6 repeat {name}: {runs} runs, sha256 {' '.join(s[:16] for s in shas)}",
              flush=True)
        if len(set(shas)) != 1:
            raise AssertionError(f"phase6: {name} gave other bits on another run")


def zero_pivot(batch, n, seed=0):
    """`batch` regular float32 matrices, the first one singular: its last
    row and column zero (a zero pivot whatever the pivoting)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a = rng.normal(size=(batch, n, n)).astype(np.float32)
    a = a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
    a[0, -1, :] = 0
    a[0, :, -1] = 0
    return a


def singular_ops():
    """The LU calls of the port whose matrix no argument can make singular,
    each as written at its site ("inv": inv_ex, "solve": solve_ex against
    one right-hand side), on a matrix of the site's shape with an exactly
    zero pivot: (site, op, matrices)."""
    return [
        ("ops/twoview.py _motions_from_h inv_ex(K)", "inv", zero_pivot(1, 3)),
        ("ops/twoview.py initialize inv_ex(T2)", "inv", zero_pivot(1, 3, seed=1)),
        ("mapping.py _fundamental_from_poses inv_ex(K)", "inv", zero_pivot(1, 3, seed=2)),
        ("optim/pose_graph.py GraphSolve inv_ex", "inv", zero_pivot(8, 7)),
        ("optim/sim3_opt.py optimize_sim3 solve_ex", "solve", zero_pivot(1, 7, seed=3)),
        ("geometry/sim3.py log solve_ex", "solve", zero_pivot(5, 3, seed=4)),
    ]


def singular_op(op, a, device):
    """One of singular_ops' calls on `device`: the result as float64 numpy."""
    import numpy as np
    import torch

    A = torch.from_numpy(a).to(device)
    if op == "inv":
        out = torch.linalg.inv_ex(A)[0]
    else:
        b = torch.from_numpy(np.random.default_rng(1).normal(size=a.shape[:-1] + (1,))
                             .astype(np.float32)).to(device)
        out = torch.linalg.solve_ex(A, b)[0]
    return out.cpu().double().numpy()


# The JAX package's result on singular_ops' inputs (jnp.linalg.inv / solve,
# float32, on the CPU): (NaN, +inf, -inf) entries. tests/
# test_torch_singular_solves.py holds this record to JAX.
SINGULAR_JAX = {
    "ops/twoview.py _motions_from_h inv_ex(K)": (8, 1, 0),
    "ops/twoview.py initialize inv_ex(T2)": (8, 1, 0),
    "mapping.py _fundamental_from_poses inv_ex(K)": (8, 1, 0),
    "optim/pose_graph.py GraphSolve inv_ex": (48, 1, 0),
    "optim/sim3_opt.py optimize_sim3 solve_ex": (6, 0, 1),
    "geometry/sim3.py log solve_ex": (2, 1, 0),
}


def phase6_singular(dev):
    """The repaired dense solves, CUDA against the CPU. (1) The non-PD
    local BA of tests/test_torch_optim.py at the full local-BA bucket: the
    float32 dense-Schur Cholesky fails and the LM step is rejected on both
    devices, as the JAX package's NaN step is (state unchanged, damping x
    4). (2) Each LU call on a singular input: a BA step at zero damping
    beside a camera with no valid observation (PCG, and the map-sharded
    iteration on SHARDS shards), a pose solve at zero damping with no valid
    match, a rank-2 homography score, and singular_ops: the same
    non-finite entries on CUDA as on the CPU, and as the JAX package
    gives (SINGULAR_JAX, or its outcome: a rejected step, a NaN pose)."""
    import numpy as np
    import torch
    from c_orb_slam_tpu_torch.ops import twoview
    from c_orb_slam_tpu_torch.optim import ba, pose_opt
    from c_orb_slam_tpu_torch.parallel import sharded_ba
    from c_orb_slam_tpu_torch.parallel.mesh import Mesh

    def rejected(label, p, out, lam):
        if not (torch.equal(out[0], p.cam_T) and torch.equal(out[1], p.points)
                and float(out[2]) == np.float32(lam) * 4):
            raise AssertionError(f"{label}: the step was not rejected with the damping x 4")

    lam = 1e-4  # the clean stage's first damping: the parent port accepted this step
    for device in ("cpu", dev):
        p = ba.sort_by_point(unobserved_camera_problem(device, n_single=20))
        err = ba.stage_error(p, use_huber=False)
        ba.reset_failed_factorizations()
        out = ba.lm_step(p, torch.tensor(lam, device=device), err, use_huber=False)
        fails = ba.failed_factorizations(device)
        rejected(f"non-PD dense Schur on {device}", p, out, lam)
        ms = "" if device == "cpu" else "{:.3f} ms per call on the card".format(_cuda_ms(
            lambda: ba.lm_step(p, torch.tensor(lam, device=device), err, use_huber=False)))
        print(f"phase6 non-PD dense-Schur local BA on {device} (64 x 8192 x 16384 slots, 24 "
              f"cameras, the last unobserved, 20 points left with one free view, damping "
              f"{lam:.3e}): factorizations failed {fails}, step rejected, damping "
              f"{float(out[2]):.3e}, error {float(out[3]):.1f} = {float(err):.1f}; {ms}",
              flush=True)
        if fails != 1:
            raise AssertionError(f"non-PD dense Schur on {device}: {fails} failed factorizations "
                                 f"counted, not 1")

    # A step at zero damping beside a camera with no valid observation: its
    # Hcc block is zero, the block-Jacobi inverse non-finite, the step NaN
    # and rejected, as JAX's (tests/test_torch_singular_solves.py).
    for device in ("cpu", dev):
        p = ba.sort_by_point(unobserved_camera_problem(device, n_single=0))
        out = ba.lm_step(p, torch.tensor(0.0, device=device), ba.stage_error(p), schur="pcg")
        if not (torch.equal(out[0], p.cam_T) and torch.equal(out[1], p.points)
                and float(out[2]) == 0.0):
            raise AssertionError(f"PCG step at zero damping on {device}: not rejected")
        solve, pp = sharded_ba.map_sharded_solve(p, Mesh([device] * SHARDS))
        solve.lm_lambda0 = 0.0
        solve.step()
        if not (torch.equal(solve.cam_T[0][:64], p.cam_T)
                and torch.equal(solve.mesh.gather_local(solve.points).cpu(),
                                torch.as_tensor(np.asarray(pp.points)).cpu())
                and float(solve.lam[0]) == 0.0):
            raise AssertionError(f"map-sharded step at zero damping on {device}: not rejected")
    print(f"phase6 singular block-Jacobi inverse (ba.py PCG, sharded_ba.py on {SHARDS} shards), "
          f"zero damping beside an unobserved camera: the step rejected on the CPU and on CUDA, "
          f"as the JAX package rejects it", flush=True)

    rng = np.random.default_rng(0)
    n = 50
    xw = (rng.normal(size=(n, 3)) + [0, 0, 6]).astype(np.float32)
    args = (np.eye(3, 4, dtype=np.float32), xw, rng.uniform(0, 400, (n, 3)).astype(np.float32),
            np.ones(n, np.float32), np.zeros(n, bool), np.zeros(n, bool),
            np.array([500.0, 500.0, 320.0, 240.0], np.float32))
    poses = [pose_opt.optimize_pose(*(torch.from_numpy(a).to(device) for a in args), 0.0,
                                    damping=0.0).pose.cpu() for device in ("cpu", dev)]
    if not all(bool(torch.isnan(q).all()) for q in poses):
        raise AssertionError("pose solve at zero damping with no valid match: not all NaN")

    rng = np.random.default_rng(3)
    H = (np.eye(3) + rng.normal(0, 1e-4, (4, 3, 3))).astype(np.float32)
    H[0, 2] = 0
    uv1 = rng.uniform(0, 640, (120, 2)).astype(np.float32)
    uv2 = (uv1 + rng.normal(0, 1, uv1.shape)).astype(np.float32)
    valid = rng.random(120) > 0.1
    sc = [twoview._score_h(*(torch.from_numpy(a).to(device) for a in (H, uv1, uv2, valid)), 1.0)
          for device in ("cpu", dev)]
    if not (torch.equal(sc[0][1], sc[1][1].cpu())
            and torch.allclose(sc[0][0], sc[1][0].cpu(), rtol=1e-4, equal_nan=True)):
        raise AssertionError("homography score of a rank-2 hypothesis: CUDA differs from the CPU")
    print(f"phase6 pose solve at zero damping (pose_opt.py: solve_ex on the CPU, the pose_gn "
          f"kernel's elimination on CUDA): NaN pose on both devices, "
          f"as JAX's; rank-2 homography score (twoview.py _score_h inv_ex): scores "
          f"{[round(float(x), 3) for x in sc[1][0].cpu()]} on CUDA, equal to the CPU's, inlier "
          f"flags equal", flush=True)

    for site, op, a in singular_ops():
        got = {device: singular_op(op, a, device) for device in ("cpu", dev)}
        counts = {d: tuple(int(f(g[0]).sum()) for f in (np.isnan, np.isposinf, np.isneginf))
                  for d, g in got.items()}
        fin = np.isfinite(got["cpu"])
        agree = (np.array_equal(fin, np.isfinite(got[dev]))
                 and np.allclose(got["cpu"][fin], got[dev][fin], rtol=1e-4, atol=1e-5))
        print(f"phase6 singular {op} ({site}), {a.shape}: (NaN, +inf, -inf) of the singular "
              f"matrix's result: cpu {counts['cpu']}, cuda {counts[dev]}, JAX "
              f"{SINGULAR_JAX[site]}; finite entries agree: {agree}", flush=True)
        if counts["cpu"] != SINGULAR_JAX[site] or not agree:
            raise AssertionError(f"singular {op} at {site}: CUDA, CPU and JAX disagree")

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


def loop_run(label, dev, sensor_name, mesh=None, n=240):
    """The 240-frame orbit with loop closing on; returns the two kernels'
    launches. Gates: tests/test_e2e_loop.py's. With a `mesh` of more than
    one shard the System takes the sharded routes, and the run must show
    them: the essential graph through dpose_graph, the global BA as a
    _ShardedGbaJob, and the full-bucket local BAs through dba. `n` > 240
    goes on along the orbit at the same step past its 1.18 laps."""
    import numpy as np
    from c_orb_slam_tpu_torch import config as tcfg
    from c_orb_slam_tpu_torch.optim import ba
    from c_orb_slam_tpu_torch.system import System

    syn = _synthetic()
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
    traj = orbit_trajectory(n, frac=1.18 * n / 240)
    if mono:
        frames = [syn.render_scene(xw, inten, size, T, K4) for T in traj]
        track = lambda s, i, f: s.track_monocular(f, i * 0.1)  # noqa: E731
    else:
        frames = [syn.render_stereo_pair(xw, inten, size, T, K4, BASELINE) for T in traj]
        track = lambda s, i, f: s.track_stereo(f[0], f[1], i * 0.1)  # noqa: E731
    sysm = System(cfg, dev, enable_loop_closing=True, mesh=mesh)
    sysm.warmup()
    routes0 = dict(sysm.local_mapping.ba_routes)  # warmup's solves
    lc = sysm.loop_closing
    if lc.voc is None or lc.voc.n_words != 10**5:
        raise AssertionError(f"{label}: the shipped 10^5-word vocabulary did not load")

    # Host ms of each advance_background call, by what it advanced, and
    # the calls of each frame.
    chunks, by_frame, frame_no = {}, {}, [0]
    advance = lc.advance_background

    def timed_advance():
        kind = ("correction." + lc.correction_job.stage if lc.correction_job is not None
                else "sim3." + lc.sim3_job.stage if lc.sim3_job is not None
                else "gba" if lc.gba_job is not None else "idle")
        t0 = time.perf_counter()
        out = advance()
        ms = (time.perf_counter() - t0) * 1000.0
        chunks.setdefault(kind, []).append(ms)
        by_frame.setdefault(frame_no[0], []).append([kind, round(ms, 3)])
        return out

    lc.advance_background = timed_advance

    # Keyframe ATE around each of the correction's three map writes: which
    # of them brings the trajectory home.
    from c_orb_slam_tpu_torch.io import trajectory as traj_io

    kf_ate, gba_jobs = [], []

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
            if name == "_apply_gba":  # the job's class, the solve's last error and damping
                job = args[0]
                gba_jobs.append(type(job).__name__)
                if job.err is not None:
                    row += [round(float(job.err), 1), float(job.lam)]
            kf_ate.append(row)
            return out

        setattr(lc, name, wrapper)

    for name in ("_correct_loop", "_apply_pose_graph_result", "_apply_gba"):
        around(name)
    loops_at, gba_at = [], []

    def on_frame(i):
        frame_no[0] = i + 1
        if lc.n_loops_closed > len(loops_at):
            loops_at.append(i)
        if lc.n_gba_applied > len(gba_at):
            gba_at.append(i)

    ba.reset_failed_factorizations()
    run = drive(label, sysm, frames, track, traj, 10.0, with_scale=mono, on_frame=on_frame)
    failed = ba.failed_factorizations(dev)  # counted on the device, read once
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
    host = run["host_ms"]
    worst = max(range(WARMUP_FRAMES, n), key=lambda i: host[i])
    marks = {k: [i for i, calls in sorted(by_frame.items()) if any(c[0] == k for c in calls)]
             for k in ("correction.pg_build", "correction.arm_gba")}
    print(f"{label} worst frame after warm-up {worst}: {host[worst]:.3f} ms host, median "
          f"{med:.3f}; its advance_background calls (chunk, ms): {json.dumps(by_frame.get(worst))}"
          f"; frames that built the essential graph and armed the global BA (frame, host ms): "
          f"{json.dumps({k: [[i, round(host[i], 3)] for i in v] for k, v in marks.items()})}",
          flush=True)
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
    routes = {k: v - routes0[k] for k, v in sysm.local_mapping.ba_routes.items()}
    its = cfg.optimizer.local_ba_its_first + cfg.optimizer.local_ba_its_second
    print(f"{label} local BA: {sum(routes.values())} solves, {its * sum(routes.values())} LM "
          f"iterations; dense-Schur LM iterations whose factorization failed (the step rejected; "
          f"the monocular initial BA included): {failed}", flush=True)
    live = [f for f in gba_at if f < n]
    print(f"{label} mesh {sysm.mesh}: local BA solves by route {json.dumps(routes)}, essential "
          f"graph by route {json.dumps(lc.pg_routes)}, global BA jobs applied {gba_jobs}, "
          f"applied on frames {gba_at or 'none'} "
          f"({'live, beside tracking' if live else 'in the shutdown drain'})", flush=True)
    if mesh is not None and mesh.size > 1:
        if lc.pg_routes["dpose_graph"] < 1 or lc.pg_routes["gn_step"]:
            raise AssertionError(f"{label}: the essential graph did not take dpose_graph")
        if "_ShardedGbaJob" not in gba_jobs or "_GbaJob" in gba_jobs:
            raise AssertionError(f"{label}: the global BA was not a _ShardedGbaJob: {gba_jobs}")
        if routes["dba"] < 1:
            raise AssertionError(f"{label}: no full-bucket local BA went through dba")
    return _launches(run)


def phase7(dev):
    """Stereo orbit, loop closing on (fixed scale)."""
    return loop_run("phase7", dev, "stereo")


def phase8(dev):
    """Monocular orbit, loop closing on (free scale)."""
    return loop_run("phase8", dev, "mono")


TUM_SETTINGS = """%YAML:1.0
Camera.fx: 500.0
Camera.fy: 500.0
Camera.cx: 320.0
Camera.cy: 240.0
Camera.width: 640
Camera.height: 480
Camera.fps: 30.0
Camera.bf: 100.0
ThDepth: 35.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
Tracking.minStereoInitPoints: 60
"""
PHASE9_MAP, PHASE9_ALL, PHASE9_LOC = 20, 60, 14  # frames mapped, rendered; localization start
PHASE9_MIN_VO = 5  # frames in VO mode past the mapped region (a CPU run of this phase: all 20)


def _image_io() -> dict:
    """Print and return what this machine offers the image loader: PIL,
    the libpng / libjpeg headers, g++ and the native build's decoders."""
    import importlib.util
    import shutil

    from c_orb_slam_tpu_torch.io.native import loader

    found = {"PIL": importlib.util.find_spec("PIL") is not None,
             "png.h": os.path.exists("/usr/include/png.h"),
             "jpeglib.h": os.path.exists("/usr/include/jpeglib.h"),
             "g++": shutil.which("g++"),
             "native decoders": loader.native_decoders()}
    print(f"phase9 image IO on this machine: {json.dumps(found)}; native build: "
          f"{loader.build_log.strip()[-600:]}", flush=True)
    return found


@contextlib.contextmanager
def _native_reads_only():
    """Within it, an image the native build cannot read raises instead of
    going to PIL: the reads it holds are the native loader's."""
    from c_orb_slam_tpu_torch.io.native import loader

    def refuse(path, raw=False):
        raise ImportError("PIL is not used inside this check")

    saved, loader._decode_pil = loader._decode_pil, refuse
    try:
        yield
    finally:
        loader._decode_pil = saved


def phase9(dev):
    """The product surface at TUM RGB-D geometry: a rendered sequence on
    disk (8-bit P5 images, 16-bit P5 depth at 5000 per metre, rgb.txt and
    an associations file) through the RGB-D driver, which saves the map;
    then System.from_saved_map relocalizes into it and tracks in
    localization mode over the mapped region and past it, into VO mode;
    one frame drawn with FrameDrawer; where the machine reads PNG, the
    stereo KITTI driver on a rendered KITTI tree."""
    import tempfile

    import numpy as np
    import torch
    from c_orb_slam_tpu_torch import config as tcfg
    from c_orb_slam_tpu_torch.examples import rgbd_tum, stereo_kitti
    from c_orb_slam_tpu_torch.io import trajectory as traj_io
    from c_orb_slam_tpu_torch.io.images import write_pgm, write_tum_rgbd_tree
    from c_orb_slam_tpu_torch.io.native import decode_raw
    from c_orb_slam_tpu_torch.ops import fast_select
    from c_orb_slam_tpu_torch.ops import window_top2 as w2
    from c_orb_slam_tpu_torch.optim import pose_opt
    from c_orb_slam_tpu_torch.system import System
    from c_orb_slam_tpu_torch.tools import eval_cli_kitti
    from c_orb_slam_tpu_torch.tracking import TrackState
    from c_orb_slam_tpu_torch.viz import FrameDrawer

    io = _image_io()
    if "pnm" not in io["native decoders"]:
        raise AssertionError("phase9: the native image loader has no PNM decoder")
    png_readable = io["PIL"] or "png" in io["native decoders"]
    syn = _synthetic()
    fps = 30.0
    K4 = (500.0, 500.0, 320.0, 240.0)
    xw, inten, size = syn.blob_world(400, seed=5)
    traj = syn.smooth_trajectory(PHASE9_ALL)
    images = [_u8(syn.render_scene(xw, inten, size, T, K4)) for T in traj]
    depths = [np.round(syn.render_depth(xw, size, T, K4) * 5000).astype(np.uint16) for T in traj]
    launches = collections.Counter()
    with tempfile.TemporaryDirectory(prefix="phase9_") as d:
        seq = os.path.join(d, "tum")
        assoc = write_tum_rgbd_tree(seq, images, depths, [i / fps for i in range(PHASE9_ALL)],
                                    depth_writer=write_pgm)
        settings = os.path.join(d, "settings.yaml")
        with open(settings, "w") as f:
            f.write(TUM_SETTINGS)
        # The depth check and the driver's reads go through the native
        # build alone (the PGM images and 16-bit PGM depth), PIL refused.
        with _native_reads_only():
            for i in range(PHASE9_MAP):
                got = decode_raw(os.path.join(seq, "depth", f"{i:06d}.pgm"))
                if not np.array_equal(got, depths[i].astype(np.float32)):
                    raise AssertionError(f"phase9: depth {i} decodes to other values than written")
            print(f"phase9 the {PHASE9_MAP} 16-bit depth maps decode natively to the values "
                  f"written (max {int(max(d.max() for d in depths[:PHASE9_MAP]))})", flush=True)

            # The RGB-D driver, as a user starts it, mapping the first frames.
            out, map_path = os.path.join(d, "traj.txt"), os.path.join(d, "map.npz")
            torch.cuda.synchronize()
            w2.reset_launches()
            pose_opt.reset_launches()
            fast_select.reset_launches()
            t0 = time.perf_counter()
            mapper = rgbd_tum.main([settings, seq, "--associations", assoc, "--out", out,
                                    "--kf-out", os.path.join(d, "kf.txt"), "--no-realtime",
                                    "--device", str(dev), "--save-map", map_path,
                                    "--max-frames", str(PHASE9_MAP)])
            torch.cuda.synchronize()
            drv_s = time.perf_counter() - t0
        launches += collections.Counter(window_top2=w2.launches, pose_gn=pose_opt.launches,
                                        fast_select=fast_select.launches)
        rows = np.loadtxt(out)
        ids = np.round(rows[:, 0] * fps).astype(int)
        centres = np.concatenate([np.tile(np.eye(3), (len(rows), 1, 1)), -rows[:, 1:4, None]], 2)
        ate = traj_io.ate_rmse(centres, traj[ids], with_scale=False)
        n_kf, n_pt = len(mapper.map.live_keyframes()), int(mapper.map.pt_valid.sum())
        print(f"phase9 rgbd_tum driver: {len(rows)}/{PHASE9_MAP} frames in the saved TUM "
              f"trajectory, ATE {ate:.5f} m (absolute scale), {drv_s:.1f} s with the map save, "
              f"{n_kf} keyframes, {n_pt} points, pose_gn launches {pose_opt.launches}, "
              f"window_top2 launches {w2.launches} "
              f"{json.dumps({'x'.join(map(str, k)): v for k, v in sorted(w2.launch_shapes.items())})}",
              flush=True)
        if len(rows) < 0.9 * PHASE9_MAP or not ate < 0.05:
            raise AssertionError(f"phase9: the driver tracked {len(rows)} frames, ATE {ate:.4f} m")

        # Relocalize into the saved map and track in localization mode.
        cfg = tcfg.load_yaml(settings, tcfg.Sensor.RGBD)
        t0 = time.perf_counter()
        loc = System.from_saved_map(map_path, cfg, dev)
        load_ms = (time.perf_counter() - t0) * 1000.0
        if (len(loc.map.live_keyframes()), int(loc.map.pt_valid.sum())) != (n_kf, n_pt):
            raise AssertionError("phase9: the loaded map differs from the saved one")
        relocs, vo, ok = [], [], []
        _timed(loc.tracker, "_relocalize", relocs)
        frames = [(images[i], depths[i]) for i in range(PHASE9_LOC, PHASE9_ALL)]

        def on_frame(j):
            if loc.tracker.state == TrackState.OK:
                ok.append(PHASE9_LOC + j)
                if loc.tracker._vo_mode:
                    vo.append(PHASE9_LOC + j)

        run = drive("phase9 localization", loc, frames,
                    lambda s, j, f: s.track_rgbd(f[0], f[1], (PHASE9_LOC + j) / fps),
                    traj, fps, with_scale=False, on_frame=on_frame)
        launches += _launches(run)
        mapped = [i for i in run["ids"] if i < PHASE9_MAP]
        poses, stamps = loc.frame_poses()
        sel = [k for k, t in enumerate(stamps) if round(t * fps) < PHASE9_MAP]
        ate_map = traj_io.ate_rmse(poses[sel], traj[[run["ids"][k] for k in sel]],
                                   with_scale=False)
        past = [i for i in run["ids"] if i >= PHASE9_MAP]
        print(f"phase9 from_saved_map {load_ms:.1f} ms (load + BoW index of {n_kf} keyframes); "
              f"relocalize calls (host ms incl. sync, ok) "
              f"{[(round(ms, 3), bool(o[0])) for ms, o in relocs]}, first frame OK "
              f"{ok[0] if ok else None}; mapped frames tracked "
              f"{len(mapped)}/{PHASE9_MAP - PHASE9_LOC}, ATE over them {ate_map:.5f} m; past the "
              f"map tracked {len(past)}/{PHASE9_ALL - PHASE9_MAP}; VO mode on frames {vo}; map "
              f"{len(loc.map.live_keyframes())} keyframes, {int(loc.map.pt_valid.sum())} points",
              flush=True)
        if not ok or ok[0] > PHASE9_LOC + 2:
            raise AssertionError("phase9: no relocalization on the first frames")
        if len(mapped) < 0.9 * (PHASE9_MAP - PHASE9_LOC) or not ate_map < 0.05:
            raise AssertionError(f"phase9: mapped frames {len(mapped)} tracked, ATE {ate_map:.4f}")
        if (len(loc.map.live_keyframes()), int(loc.map.pt_valid.sum())) != (n_kf, n_pt):
            raise AssertionError("phase9: localization mode changed the map")
        if len([i for i in vo if i >= PHASE9_MAP]) < PHASE9_MIN_VO:
            raise AssertionError(f"phase9: VO mode on frames {vo} only past the mapped region")
        # The first relocalization of a fresh process, without and with
        # System.warmup() (which pays the solvers' first-call costs).
        frame = os.path.join(d, "frame.npz")
        first = range(PHASE9_LOC, PHASE9_LOC + 3)
        np.savez(frame, image=np.stack([images[i] for i in first]),
                 depth=np.stack([depths[i] for i in first]), t=np.asarray(first) / fps)
        fresh = {}
        for warm in ("0", "1"):
            r = subprocess.run([sys.executable, os.path.abspath(__file__), "--fresh-reloc",
                                map_path, settings, frame, warm],
                               capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise AssertionError(f"phase9 fresh-process relocalization (warmup {warm}) "
                                     f"exited {r.returncode}:\n{r.stdout[-2000:]}{r.stderr[-2000:]}")
            fresh[warm] = json.loads(r.stdout.strip().splitlines()[-1])
        print(f"phase9 first relocalization of a fresh process into the saved map (host ms incl. "
              f"sync): {fresh['0']['reloc_ms']:.1f} without warmup, {fresh['1']['reloc_ms']:.1f} "
              f"after System.warmup() (which took {fresh['1']['warmup_ms']:.1f} ms); PR 5 measured "
              f"2,817.6 ms without; {json.dumps(fresh)}", flush=True)
        if not all(f["ok"] for f in fresh.values()):
            raise AssertionError(f"phase9: a fresh process did not relocalize: {fresh}")
        fd = FrameDrawer(loc)
        fd.update(images[PHASE9_MAP - 1])
        img = fd.draw_frame()
        if img.dtype != np.uint8 or img.shape[:2] != (480 + 22, 640):
            raise AssertionError(f"phase9: FrameDrawer drew {img.dtype} {img.shape}")
        print(f"phase9 FrameDrawer drew a {img.shape} frame", flush=True)

        if not png_readable:
            print("phase9 no PNG decoder on this machine (no libpng headers, no PIL): the "
                  "stereo KITTI driver is not driven", flush=True)
            return launches
        n = 30
        kitti = os.path.join(d, "kitti")
        gt = eval_cli_kitti.generate_tree(kitti, n)
        out = os.path.join(d, "kitti.txt")
        w2.reset_launches()
        pose_opt.reset_launches()
        fast_select.reset_launches()
        stereo_kitti.main([os.path.join(kitti, "settings.yaml"), kitti, "--out", out, "--kf-out",
                           os.path.join(d, "kitti_kf.txt"), "--no-realtime", "--device", str(dev)])
        torch.cuda.synchronize()
        launches += collections.Counter(window_top2=w2.launches, pose_gn=pose_opt.launches,
                                        fast_select=fast_select.launches)
        n_rows, ate = eval_cli_kitti.kitti_ate(out, gt)
        print(f"phase9 stereo_kitti driver at KITTI geometry: {n_rows}/{n} frames, ATE "
              f"{ate} m, window_top2 launches {w2.launches}, pose_gn launches {pose_opt.launches}",
              flush=True)
        if n_rows != n or not ate < 0.05:
            raise AssertionError(f"phase9: stereo_kitti tracked {n_rows}/{n}, ATE {ate}")
    return launches


def _fresh_reloc(map_path, settings, frame, warm):
    """A child of phase 9: System.from_saved_map in a fresh process,
    System.warmup() when `warm` is "1", then the first three localization
    frames, the first of which relocalizes; prints one JSON line of host
    ms."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    from c_orb_slam_tpu_torch import config as tcfg
    from c_orb_slam_tpu_torch.system import System
    from c_orb_slam_tpu_torch.tracking import TrackState

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = tcfg.load_yaml(settings, tcfg.Sensor.RGBD)
    loc = System.from_saved_map(map_path, cfg, dev)
    warm_ms = None
    if warm == "1":
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loc.warmup()
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1000.0
    z = np.load(frame)
    relocs = []
    _timed(loc.tracker, "_relocalize", relocs)
    for image, depth, t in zip(z["image"], z["depth"], z["t"]):
        loc.track_rgbd(image, depth, float(t))
    loc.tracker.flush_pending()
    print(json.dumps({"warmup_ms": warm_ms, "reloc_ms": relocs[0][0] if relocs else None,
                      "ok": bool(relocs) and loc.tracker.state == TrackState.OK}))
    return 0


# ---------------------------------------------------------------------------
# Phase 10: the sharded solvers of parallel/ on the card.
# ---------------------------------------------------------------------------

SHARDS = 4
# Shard against single device. cam_T: the JAX tests' tolerances
# (tests/test_parallel.py, tests/test_sharded_ba.py), pose-graph vertices
# 1e-4 (tests/test_sharded_ba.py). Points seen from two cameras or more
# (max |difference|, m) and the mean inlier chi2 (relative): five times
# the largest gap measured on an H100 (700 W), rounded up, since CUDA's
# atomic segment sums vary from run to run (dba 7.2e-5 m and 6.6e-7;
# sharded_ba over 4 in-process shards, 2 gloo ranks and 1 NCCL rank
# 3.3e-6, 3.2e-6 and 6.6e-7 m, 9.1e-8). Inlier flags: none may differ
# (none did).
DBA_TOL = {"cam_T": 5e-4, "points": 5e-4, "inlier": 0, "chi2": 5e-6}
SBA_TOL = {"cam_T": 2e-4, "points": 2e-5, "inlier": 0, "chi2": 5e-7}
PG_TOL = {"verts": 1e-4}
# The sizes: local BA at its full bucket (config.py local_ba_max_*: 64
# camera, 8192 point and 16384 observation slots; 5461 live points seen 3
# times each fill it, as a window's live rows fill a padded bucket; with
# 2 views a point the camera chain's scale is too loosely held for two
# float32 solves to agree), a global BA of 512 keyframes, an essential
# graph of 512 vertices.
DBA_SIZE = (64, 5461, 3, 8192, 16384)  # cameras, live points, views a point, slots
SBA_SIZE = (512, 65536, 8)  # keyframes, points, views a point
PG_VERTICES = 512


def ba_problem(C, P, per_point, P_slots, O_slots, device, seed=0, spacing=0.3):
    """A well-posed synthetic stereo BA problem (phase 7's rig: fx = 500,
    baseline 0.2 m) at these widths: C cameras on a line `spacing` m apart
    looking along +z (the first two fixed), P points 4-12 m in front, each
    seen by `per_point` of the 2 * per_point cameras nearest to it, 0.5 px
    of pixel noise, the start perturbed by 1 cm (cameras) and 3 cm
    (points); padded with invalid slots to P_slots points and O_slots
    observations."""
    import numpy as np
    import torch
    from c_orb_slam_tpu_torch.optim import ba

    rng = np.random.default_rng(seed)
    cx = spacing * np.arange(C)
    px = rng.uniform(0, cx[-1], P)
    pts = np.c_[px, rng.uniform(-2, 2, P), rng.uniform(4, 12, P)].astype(np.float32)
    w = min(2 * per_point, C)
    first = np.clip(np.round(px / spacing).astype(int) - w // 2, 0, C - w)
    pick = np.sort(np.argsort(rng.random((P, w)), axis=1)[:, :per_point], axis=1)
    obs_cam = (first[:, None] + pick).reshape(-1).astype(np.int32)
    obs_pt = np.repeat(np.arange(P), per_point).astype(np.int32)
    xc = pts[obs_pt] - np.c_[cx[obs_cam], np.zeros((len(obs_cam), 2))]
    u = 500 * xc[:, 0] / xc[:, 2] + 320
    uv = np.stack([u, 500 * xc[:, 1] / xc[:, 2] + 240, u - BASELINE * 500 / xc[:, 2]], 1)
    uv += rng.normal(0, 0.5, uv.shape)
    cam_T = np.tile(np.eye(3, 4), (C, 1, 1))
    cam_T[:, 0, 3] = -cx
    cam_T[2:, :, 3] += rng.normal(0, 0.01, (C - 2, 3))
    t = lambda a, dt=None: torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)  # noqa: E731

    def pad(a, n):
        return np.concatenate([a, np.zeros((n - len(a),) + a.shape[1:], a.dtype)])

    O = len(obs_cam)
    return ba.BAProblem(
        cam_T=t(cam_T, np.float32), cam_fixed=t(np.arange(C) < 2), cam_valid=t(np.ones(C, bool)),
        points=t(pad(pts + rng.normal(0, 0.03, pts.shape), P_slots), np.float32),
        point_valid=t(np.arange(P_slots) < P), obs_cam=t(pad(obs_cam, O_slots)),
        obs_pt=t(pad(obs_pt, O_slots)), obs_uv=t(pad(uv, O_slots), np.float32),
        obs_stereo=t(np.arange(O_slots) < O), obs_inv_sigma2=t(np.ones(O_slots), np.float32),
        obs_valid=t(np.arange(O_slots) < O),
        K=t([500.0, 500.0, 320.0, 240.0], np.float32), bf=t(BASELINE * 500, np.float32),
    )


def unobserved_camera_problem(device, C=24, P=5000, per_point=3, n_single=40, seed=0):
    """tests/test_torch_optim.py's non-PD local BA at the full local-BA
    bucket (64 camera, 8192 point and 16384 observation slots): ba_problem's
    C cameras and P points, monocular, as the clean LM stage sees them
    after the Huber stage classified out every observation of the last
    camera (badly posed, 0.3 rad off), whose pivot is then the damping
    alone; n_single of its points were seen besides by one free camera
    only, so that camera holds them alone (their Hpp rank 2 plus the
    damping) and, at a small damping, its float32 Schur pivot cancels to a
    non-positive value: the reduced system fails Cholesky."""
    import numpy as np
    import torch
    from c_orb_slam_tpu_torch.geometry import se3

    p = ba_problem(C, P, per_point, 8192, 16384, "cpu", seed=seed)
    rng = np.random.default_rng(seed + 1)
    obs_cam, obs_pt = p.obs_cam.numpy(), p.obs_pt.numpy()
    valid = p.obs_valid.numpy().copy()
    bad = C - 1
    seen = np.unique(obs_pt[valid & (obs_cam == bad)])
    for q in rng.choice(seen, min(n_single, len(seen)), replace=False):
        rows = np.nonzero(valid & (obs_pt == q) & (obs_cam != bad))[0]
        free = rows[obs_cam[rows] >= 2]
        if len(free):
            valid[np.setdiff1d(rows, free[:1])] = False
    valid &= obs_cam != bad
    cam_T = p.cam_T.clone()
    cam_T[bad] = se3.compose(se3.exp(torch.tensor([0.0, 0.0, 0.0, 0.0, 0.3, 0.0])), cam_T[bad])
    pad = torch.zeros(64 - C, dtype=torch.bool)
    p = p._replace(
        cam_T=torch.cat([cam_T, torch.eye(3, 4).repeat(64 - C, 1, 1)]),
        cam_fixed=torch.cat([p.cam_fixed, pad]), cam_valid=torch.cat([p.cam_valid, pad]),
        obs_valid=torch.from_numpy(valid), obs_stereo=torch.zeros_like(p.obs_stereo),
        bf=torch.tensor(0.0))
    return type(p)(*(x.to(device) for x in p))


def ring_problem(C, P, per_point, device, seed=0, radius=10.0):
    """A global-BA problem of an object scan, stereo on phase 7's rig: C
    keyframes on a ring of `radius` m, all looking at its centre (the
    first two fixed), P points in a ball of 3 m there, each seen by
    `per_point` keyframes spread around the ring, 0.5 px of pixel noise,
    the start perturbed by 1 cm (keyframes) and 3 cm (points). Every
    keyframe shares points with keyframes all around the ring, so the
    reduced camera system is well conditioned and 50 PCG iterations
    converge: a float32 solve is then not dominated by rounding."""
    import numpy as np
    import torch
    from c_orb_slam_tpu_torch.optim import ba

    rng = np.random.default_rng(seed)
    a = 2 * np.pi * np.arange(C) / C
    centre = np.stack([radius * np.cos(a), np.zeros(C), radius * np.sin(a)], 1)
    z = -centre / radius
    x = np.cross(np.tile([0.0, 1.0, 0.0], (C, 1)), z)
    R = np.stack([x, np.tile([0.0, 1.0, 0.0], (C, 1)), z], 1)  # rows: camera axes
    cam_T = np.concatenate([R, -(R @ centre[..., None])], 2)
    d = rng.normal(size=(P, 3))
    pts = 3.0 * d / np.linalg.norm(d, axis=1, keepdims=True) * rng.random((P, 1)) ** (1 / 3)
    stride = C // per_point
    obs_cam = ((rng.integers(0, C, (P, 1)) + stride * np.arange(per_point)
                + rng.integers(0, stride, (P, per_point))) % C).reshape(-1).astype(np.int32)
    obs_pt = np.repeat(np.arange(P), per_point).astype(np.int32)
    xc = np.einsum("nij,nj->ni", R[obs_cam], pts[obs_pt]) + cam_T[obs_cam, :, 3]
    u = 500 * xc[:, 0] / xc[:, 2] + 320
    uv = np.stack([u, 500 * xc[:, 1] / xc[:, 2] + 240, u - BASELINE * 500 / xc[:, 2]], 1)
    uv += rng.normal(0, 0.5, uv.shape)
    cam_T[2:, :, 3] += rng.normal(0, 0.01, (C - 2, 3))
    O = len(obs_cam)
    t = lambda v, dt=None: torch.from_numpy(np.ascontiguousarray(v, dt)).to(device)  # noqa: E731
    return ba.BAProblem(
        cam_T=t(cam_T, np.float32), cam_fixed=t(np.arange(C) < 2), cam_valid=t(np.ones(C, bool)),
        points=t(pts + rng.normal(0, 0.03, pts.shape), np.float32),
        point_valid=t(np.ones(P, bool)), obs_cam=t(obs_cam), obs_pt=t(obs_pt),
        obs_uv=t(uv, np.float32), obs_stereo=t(np.ones(O, bool)),
        obs_inv_sigma2=t(np.ones(O), np.float32), obs_valid=t(np.ones(O, bool)),
        K=t([500.0, 500.0, 320.0, 240.0], np.float32), bf=t(BASELINE * 500, np.float32),
    )


def pg_problem(K, device, laps=4, span=7, across=2, radius=5.0):
    """An essential graph of K keyframes on `laps` laps of a circle of
    `radius` m (tests/test_loop_optim.py's circle; K / laps keyframes a
    lap, the same places on every lap).
    The estimate drifts a little at every step. Edges: the spanning tree
    and the covisibility of keyframes up to `span` apart on one lap,
    measuring the drifted estimate; and the covisibility of the same place
    on other laps (keyframe k with k + m * K / laps, up to `across` apart),
    measuring the truth, as loop closures do. Vertex 0 fixed."""
    import numpy as np
    import torch
    from c_orb_slam_tpu_torch.geometry import sim3
    from c_orb_slam_tpu_torch.optim import pose_graph

    a = 2 * np.pi * laps * np.arange(K) / K
    R_wc = np.stack([np.stack([np.cos(-a), 0 * a, np.sin(-a)], -1), np.tile([0, 1, 0], (K, 1)),
                     np.stack([-np.sin(-a), 0 * a, np.cos(-a)], -1)], 1)
    c = np.stack([radius * np.cos(a), 0 * a, radius * np.sin(a)], -1)
    R_cw = R_wc.transpose(0, 2, 1)
    T = np.concatenate([R_cw, -(R_cw @ c[..., None])], 2)
    gt = sim3.from_se3(torch.from_numpy(T.astype(np.float32)).double())
    drift = sim3.exp(torch.tensor([0.002, 0.0, 0.001, 0.0, 0.0015, 0.0, 0.0006],
                                  dtype=torch.float64))
    est = [gt[0]]
    for k in range(1, K):
        est.append(sim3.compose(sim3.compose(drift, sim3.compose(gt[k], sim3.inverse(gt[k - 1]))),
                                est[k - 1]))
    est = torch.stack(est)
    lap = K // laps
    near = [(i, i + d) for d in range(1, span + 1) for i in range(K - d)]
    far = sorted({(i, j) for i in range(K) for m in range(1, laps) for o in range(-across, across + 1)
                  for j in [i + m * lap + o] if i < j < K})
    ei = torch.tensor([e[0] for e in near + far])
    ej = torch.tensor([e[1] for e in near + far])
    src = torch.cat([est[ei[:len(near)]], gt[ei[len(near):]]])
    dst = torch.cat([est[ej[:len(near)]], gt[ej[len(near):]]])
    E = len(ei)
    return pose_graph.PoseGraphProblem(
        vertices=est.float().to(device), v_fixed=(torch.arange(K) == 0).to(device),
        v_valid=torch.ones(K, dtype=torch.bool, device=device),
        edge_i=ei.int().to(device), edge_j=ej.int().to(device),
        edge_Sji=sim3.compose(dst, sim3.inverse(src)).float().to(device),
        edge_weight=torch.ones(E, device=device),
        edge_valid=torch.ones(E, dtype=torch.bool, device=device),
    )


def _seen_twice(p):
    """(P,) bool numpy: points seen from two cameras or more (the only
    points a solve pins down)."""
    import numpy as np

    ok = p.obs_valid.cpu().numpy()
    pt, cam = p.obs_pt.cpu().numpy()[ok].astype(np.int64), p.obs_cam.cpu().numpy()[ok]
    C = p.cam_T.shape[0]
    pairs = np.unique(pt * C + cam)
    return np.bincount(pairs // C, minlength=p.points.shape[0]) >= 2


def _ba_out(cam_T, points, inlier, chi2):
    return {"cam_T": cam_T, "points": points, "inlier": inlier, "chi2": chi2}


def _phase10_solvers(dev):
    """The three solves of phase 10 as (name, description, single-device
    solve, sharded solve on a mesh, tolerances, points seen twice,
    iterations, iteration's name), at the live configuration's iteration
    counts. A solve returns a dict: cam_T, points, inlier (flags) and chi2
    (the mean inlier chi2) of a BA, verts of a pose graph. The global BA's
    single-device solve runs on the partitioned problem, so its inlier
    flags are in the sharded solve's slab order."""
    import numpy as np
    import torch
    from c_orb_slam_tpu_torch import config as tcfg
    from c_orb_slam_tpu_torch.optim import ba, pose_graph
    from c_orb_slam_tpu_torch.parallel import dba, dpose_graph, sharded_ba

    opt = tcfg.OptimizerConfig()
    lba = dict(iters_first=opt.local_ba_its_first, iters_second=opt.local_ba_its_second,
               chi2_mono=opt.chi2_mono, chi2_stereo=opt.chi2_stereo, pcg_iters=opt.pcg_iters)
    gba = dict(iters_first=opt.global_ba_its, iters_second=opt.global_ba_its,
               chi2_mono=opt.chi2_mono, chi2_stereo=opt.chi2_stereo, pcg_iters=opt.pcg_iters)
    pg = dict(iters=opt.essential_graph_its, pcg_iters=opt.pcg_iters, fix_scale=False)
    p_l = ba_problem(*DBA_SIZE, dev, seed=1)
    p_g = ring_problem(*SBA_SIZE, dev, seed=2)
    p_gp = ba.BAProblem(*(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                          for x in sharded_ba.partition_problem(p_g, SHARDS)))
    p_p = pg_problem(PG_VERTICES, dev)
    O_l = p_l.obs_cam.shape[0]

    def dba_single():
        r = ba.bundle_adjust(p_l, schur="dense", **lba)
        return _ba_out(r.cam_T, r.points, r.obs_inlier, r.final_chi2)

    def dba_sharded(m):
        r = dba.distributed_bundle_adjust(dba.pad_observations(p_l, m.size), m, schur="dense",
                                          **lba)
        return _ba_out(r.cam_T, r.points, r.obs_inlier[:O_l], r.final_chi2)

    def sba_single():
        r = ba.bundle_adjust(p_gp, schur="pcg", **gba)
        return _ba_out(r.cam_T, r.points, r.obs_inlier, r.final_chi2)

    def sba_sharded(m):
        return _ba_out(*sharded_ba.sharded_bundle_adjust(p_g, m, **gba)[0])

    return [
        ("dba", f"{DBA_SIZE[0]} cameras x {DBA_SIZE[3]} point slots x {DBA_SIZE[4]} "
         f"observation slots ({DBA_SIZE[1]} points seen {DBA_SIZE[2]} times), dense Schur",
         dba_single, dba_sharded, DBA_TOL, _seen_twice(p_l),
         lba["iters_first"] + lba["iters_second"], "LM iteration"),
        ("sharded_ba", f"{SBA_SIZE[0]} keyframes x {SBA_SIZE[1]} points x "
         f"{SBA_SIZE[1] * SBA_SIZE[2]} observations, PCG",
         sba_single, sba_sharded, SBA_TOL, _seen_twice(p_g),
         gba["iters_first"] + gba["iters_second"], "LM iteration"),
        ("dpose_graph", f"{PG_VERTICES} vertices x {p_p.edge_i.shape[0]} edges",
         lambda: {"verts": pose_graph.optimize_pose_graph(p_p, **pg)},
         lambda m: {"verts": dpose_graph.distributed_pose_graph(p_p, m, **pg)},
         PG_TOL, None, pg["iters"], "GN iteration"),
    ]


def _gaps(got, ref, seen):
    """Sharded against single device, output by output: max |difference|
    (cam_T, verts; points over those seen twice), the count of differing
    inlier flags, the relative gap of the mean chi2. A rank of a process
    group holds its own blocks of the points and the flags, which lead
    the single solve's."""
    import numpy as np

    out = {}
    for k, g in got.items():
        g = np.asarray(g.cpu().numpy() if hasattr(g, "cpu") else g)
        r = ref[k].cpu().numpy()
        n = min(len(g), len(r)) if g.ndim else 0
        if k == "chi2":
            out[k] = float(abs(g - r) / abs(r))
        elif k == "inlier":
            out[k] = int((g[:n] != r[:n]).sum())
        elif k == "points":
            m = seen[:n]
            out[k] = float(np.abs(g[:n][m] - r[:n][m]).max())
        else:
            out[k] = float(np.abs(g - r).max())
        if not np.isfinite(g).all():
            out[k] = float("inf")
    return out


def _check_gaps(label, gaps, tols):
    bad = {k: (v, tols[k]) for k, v in gaps.items() if not v <= tols[k]}
    if bad:
        raise AssertionError(f"{label}: sharded and single-device solves differ beyond the "
                             f"tolerance (gap, tolerance): {bad}")


def phase10a(dev):
    """The three sharded solvers on a mesh of SHARDS shards on one card,
    each held against its single-device solve on the card (every output)
    and timed (CUDA events, one call after the checked one) beside it; collectives per
    iteration. Returns the single-device results and the points seen
    twice, for phase 10b."""
    import torch
    from c_orb_slam_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh([dev] * SHARDS)
    singles = {}
    for name, what, single, sharded, tols, seen, iters, unit in _phase10_solvers(dev):
        ref = single()
        mesh.reset_counts()
        got = sharded(mesh)
        torch.cuda.synchronize()
        counts = {k: [v[0] / iters, v[1] / iters] for k, v in mesh.counts.items()}
        gaps = _gaps(got, ref, seen)
        single_ms = _event_ms(single, 1)
        sharded_ms = _event_ms(lambda: sharded(mesh), 1)
        print(f"phase10a {name} ({what}) on {SHARDS} shards of {dev}: sharded against single "
              f"device (gap, tolerance) {json.dumps({k: [v, tols[k]] for k, v in gaps.items()})} "
              f"(max |difference|; points seen from two cameras or more; differing inlier "
              f"flags; relative gap of the mean inlier chi2); sharded {sharded_ms:.3f} ms, "
              f"single device {single_ms:.3f} ms (CUDA events, one call); collectives per "
              f"{unit} (calls, elements): {json.dumps(counts)}", flush=True)
        _check_gaps(f"phase10a {name}", gaps, tols)
        singles[name] = (ref, seen)
    return singles


def _phase10_rank(role, rank, world, store, out, device, sizes):
    """One rank of phase 10b (a child process): join the group, run the
    sharded solves on a process-group mesh of SHARDS // world shards a
    rank on `device`, at the parent's problem `sizes`; rank 0 writes what
    it holds (cam_T, its blocks of the points and the inlier flags, the
    mean chi2; the vertices)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    global DBA_SIZE, SBA_SIZE, PG_VERTICES
    DBA_SIZE, SBA_SIZE, PG_VERTICES = (tuple(x) if isinstance(x, list) else x
                                       for x in json.loads(sizes))
    sys.path.insert(0, HERE)
    from c_orb_slam_tpu_torch.parallel import multihost
    from c_orb_slam_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    joined = multihost.initialize(f"file://{store}", world, rank, backend=role, timeout_s=300)
    try:
        if joined != (world > 1) or dist.get_backend() != role:
            raise RuntimeError(f"rank {rank}: initialize -> {joined}, {dist.get_backend()}")
        mesh = make_mesh([dev] * (SHARDS // world))
        res = {}
        for name, _, _, sharded, *_ in _phase10_solvers(dev):
            if role == "nccl" and name != "sharded_ba":
                continue
            if name == "dba":  # the local BA is not a process-group solve in the System
                continue
            t0 = time.perf_counter()
            for k, v in sharded(mesh).items():
                res[f"{name}.{k}"] = v.cpu().numpy()
            res[name + ".ms"] = (time.perf_counter() - t0) * 1000.0
        if multihost.is_primary():
            np.savez(os.path.join(out, f"{role}.npz"), counts=json.dumps(mesh.counts), **res)
    finally:
        dist.destroy_process_group()
    return 0


def phase10b(dev, singles):
    """Two gloo ranks on cuda:0 (2 shards each) run sharded_bundle_adjust
    and distributed_pose_graph; then one NCCL rank (world size 1, 4
    shards) runs sharded_bundle_adjust. Rank 0's results are held against
    the single-device solves of phase 10a: every output, its own blocks
    of the points and the inlier flags."""
    import tempfile

    import numpy as np

    tols = {"sharded_ba": SBA_TOL, "dpose_graph": PG_TOL}
    with tempfile.TemporaryDirectory(prefix="phase10b_") as d:
        for role, world in (("gloo", 2), ("nccl", 1)):
            store = os.path.join(d, f"{role}.store")
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--phase10-rank", role, str(r),
                 str(world), store, d, str(dev), json.dumps([DBA_SIZE, SBA_SIZE, PG_VERTICES])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for r in range(world)]
            try:
                for r, pr in enumerate(procs):
                    out, _ = pr.communicate(timeout=600)
                    if pr.returncode != 0:
                        raise AssertionError(f"phase10b {role} rank {r} exited {pr.returncode}:\n"
                                             f"{out[-3000:]}")
            finally:
                for pr in procs:
                    if pr.poll() is None:
                        pr.kill()
                        pr.wait()
            z = np.load(os.path.join(d, f"{role}.npz"))
            rows = []
            for name, tol in tols.items():
                got = {k.split(".", 1)[1]: z[k] for k in z.files
                       if k.startswith(name + ".") and not k.endswith(".ms")}
                if not got:
                    continue
                ref, seen = singles[name]
                gaps = _gaps(got, ref, seen)
                rows.append(f"{name} rank 0 against single device (gap, tolerance) "
                            f"{json.dumps({k: [v, tol[k]] for k, v in gaps.items()})}, "
                            f"{float(z[name + '.ms']):.1f} ms")
                _check_gaps(f"phase10b {role} {name}", gaps, tol)
            print(f"phase10b {role}, {world} rank(s) on {dev}, {SHARDS // world} shards a rank: "
                  f"{'; '.join(rows)}; rank 0's collectives (calls, elements): "
                  f"{str(z['counts'])}; {time.perf_counter() - t0:.1f} s with process start",
                  flush=True)


def phase10c(dev):
    """Phase 7's stereo orbit with System(..., mesh=Mesh([dev] * SHARDS)):
    phase 7's gates, and the sharded routes taken. 260 frames, 20 past
    phase 7's end along the same orbit: the essential graph (20 GN
    iterations) and the global BA (20 LM iterations) advance one
    iteration a frame after the loop event near frame 205, so the global
    BA's apply (at frame 251 on the card) lands during the run, beside
    tracking, not in the shutdown drain."""
    from c_orb_slam_tpu_torch.parallel.mesh import Mesh

    return loop_run("phase10c", dev, "stereo", mesh=Mesh([dev] * SHARDS), n=260)


# Phase 11's cut: the stereo configurations to their first 90 frames (75
# timed; stereo_kitti has 120, stereo_kitti_long 300); the monocular ones,
# 40 and 70 frames, run whole.
BENCH_MAX_FRAMES = 90


def phase11(dev):
    """The port's benchmark entry point, `python3 -m
    c_orb_slam_tpu_torch.tools.bench --all --max-frames 90`, in a child
    process on the card: bench.py's four configurations, as bench.py runs
    them (loop closing on, the shipped vocabulary), the two stereo ones
    cut to 90 frames. Prints its four records; fails unless the child exits 0
    and every record holds its bench.py gate (no error, vs_baseline > 0),
    ran its frames with loop closing on on this card, carries its power
    limit, and launched window_top2 and pose_gn. Returns the two kernels'
    launches (over each configuration's timed window)."""
    import torch
    from c_orb_slam_tpu_torch.tools import bench

    r = subprocess.run([sys.executable, "-m", "c_orb_slam_tpu_torch.tools.bench", "--all",
                        "--max-frames", str(BENCH_MAX_FRAMES), "--device", str(dev)], cwd=HERE,
                       capture_output=True, text=True, timeout=900)
    recs = [json.loads(line) for line in r.stdout.splitlines() if line.startswith("{")]
    for rec in recs:
        print("phase11 bench", json.dumps(rec), flush=True)
    if r.returncode != 0:
        raise AssertionError(f"phase11: the bench exited {r.returncode}: {r.stderr[-3000:]}")
    names = [rec["metric"].removeprefix("tracked_frames_per_sec_1chip").lstrip("_")
             for rec in recs]
    if names != [*bench.ALL[:-1], ""]:
        raise AssertionError(f"phase11: records {names}, not {list(bench.ALL)} (headline last)")
    kind = torch.cuda.get_device_name(dev)
    for name, rec in zip(bench.ALL, recs):
        if "error" in rec or not rec["vs_baseline"] > 0:
            raise AssertionError(f"phase11 {name}: failed its gate: {rec.get('error')}")
        if not rec["loop_closing"] or rec["device"] != kind or not rec["power_limit_w"]:
            raise AssertionError(f"phase11 {name}: not a loop-closing run on {kind} with its "
                                 f"power limit: {rec}")
        if rec["frames"] != min(BENCH_MAX_FRAMES, bench.CONFIGS[name]["n_frames"]):
            raise AssertionError(f"phase11 {name}: ran {rec['frames']} frames")
        if rec["window_top2_launches"] <= 0 or rec["pose_gn_launches"] <= 0:
            raise AssertionError(f"phase11 {name}: window_top2 or pose_gn never launched")
        if rec["loops_closed"]:
            print(f"phase11 {name}: {rec['loops_closed']} loop(s) closed on a path that never "
                  f"comes back to a place it saw: a false detection", flush=True)
    return sum((collections.Counter(window_top2=rec["window_top2_launches"],
                                    pose_gn=rec["pose_gn_launches"]) for rec in recs),
               collections.Counter())


def _phase12_child(dev, kind, args, timeout):
    """The records of one profiling tool run in a child process on the
    card, printed; fails unless it exits 0 and each names this card with
    its power limit."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", *args, "--device", str(dev)], cwd=HERE,
                       capture_output=True, text=True, timeout=timeout)
    recs = [json.loads(line) for line in r.stdout.splitlines() if line.startswith("{")]
    for rec in recs:
        print("phase12", json.dumps(rec), flush=True)
    print(f"phase12 {' '.join(args[1:])} took {time.perf_counter() - t0:.1f} s", flush=True)
    if r.returncode != 0 or not recs:
        raise AssertionError(f"phase12: {' '.join(args)} exited {r.returncode}: "
                             f"{r.stderr[-3000:]}")
    for rec in recs:
        if rec.get("device") != kind or not rec.get("power_limit_w"):
            raise AssertionError(f"phase12: a record not of {kind} with its power limit: {rec}")
    return recs


def _positive(label, rec, keys):
    for key in keys:
        if not (isinstance(rec.get(key), (int, float)) and rec[key] > 0):
            raise AssertionError(f"phase12 {label}: {key} missing or not positive: {rec}")


def phase12(dev):
    """The port's profiling entry points on the card, each in a child
    process: profile_stages at mono_tum30, cut to 40 frames, with a 5-frame trace window,
    profile_kernels at mono_tum30 and at stereo_kitti. Prints their records
    and fails unless every device field was read on the card."""
    import torch
    from c_orb_slam_tpu_torch.tools import profile_stages

    kind = torch.cuda.get_device_name(dev)
    [rec] = _phase12_child(dev, kind, ["c_orb_slam_tpu_torch.tools.profile_stages", "--config",
                                       "mono_tum30", "--frames", "40", "--trace", "5"], 400)
    _positive("profile_stages", rec, ("fps", "ms_per_frame", "frame_ms_median"))
    sub = rec["track_substages"]
    if set(sub) != {*profile_stages.SUBSTAGES, "tracking_other"}:
        raise AssertionError(f"phase12: tracking sub-stages {sorted(sub)}")
    if min(sub.values()) < 0:  # tracking_other < 0: the sub-stages exceed tracking
        raise AssertionError(f"phase12: a negative tracking sub-stage: {sub}")
    trace = rec["trace"]
    _positive("profile_stages trace", trace,
              ("ms_per_frame", "device_busy_share", "launches_per_frame"))
    if not 0.0 <= trace["device_idle_share"] <= 1.0 or not trace["top_ops"]:
        raise AssertionError(f"phase12: trace window off the card: {trace}")
    for config, build in (("mono_tum30", "frame.build_mono"),
                          ("stereo_kitti", "frame.build_stereo")):
        recs = _phase12_child(dev, kind, ["c_orb_slam_tpu_torch.tools.profile_kernels",
                                          "--config", config], 400)
        names = {r["program"] for r in recs}
        for want in ("tracking._full_track_step", "tracking._optimize", "ba.bundle_adjust",
                     "match.search_by_projection", "LocalMapping._ba_dispatch", build):
            if want not in names:
                raise AssertionError(f"phase12 {config}: no record of {want}")
        for r in recs:
            _positive(f"{config} {r['program']}", r,
                      ("host_ms", "device_ms", "kernel_ms", "launches", "launch_floor_ms",
                       "op_floor_ms", "empty_launch_ms", "profile_sessions"))
        retried = [r["program"] for r in recs if r["profile_sessions"] > 1]
        if retried:
            print(f"phase12 {config}: a profiler session recorded no CUDA kernel and was "
                  f"run again for {retried}", flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--phase10-rank"]:  # a child of phase 10b
        role, rank, world, store, out, device, sizes = sys.argv[2:9]
        return _phase10_rank(role, int(rank), int(world), store, out, device, sizes)
    if sys.argv[1:2] == ["--fresh-reloc"]:  # a child of phase 9
        return _fresh_reloc(*sys.argv[2:6])
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
        pose_row = pose_gn_row(dev)
        fast_rows = fast_select_row(dev)
        launches = collections.Counter()
        for num, phase in ((2, phase2), (3, phase3), (4, phase4), (5, phase5), (6, phase6),
                           (7, phase7), (8, phase8), (9, phase9)):
            t0 = time.perf_counter()
            got = phase(dev) or collections.Counter()
            launches += got
            if num == 6:
                phase6_loop(dev)
                phase6_singular(dev)
                phase6_repeat(dev)
            print(f"phase{num} took {time.perf_counter() - t0:.1f} s, main-path kernel launches "
                  f"{json.dumps(got)}", flush=True)
        t0 = time.perf_counter()
        singles = phase10a(dev)
        phase10b(dev, singles)
        got = phase10c(dev)
        launches += got
        print(f"phase10 took {time.perf_counter() - t0:.1f} s, main-path kernel launches "
              f"{json.dumps(got)}", flush=True)
        t0 = time.perf_counter()
        got = phase11(dev)
        launches += got
        print(f"phase11 took {time.perf_counter() - t0:.1f} s, main-path kernel launches "
              f"{json.dumps(got)}", flush=True)
        t0 = time.perf_counter()
        phase12(dev)
        print(f"phase12 took {time.perf_counter() - t0:.1f} s", flush=True)
    except Exception as e:  # any failed phase fails the run, with its cause
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # The times are those of the local map's search, the largest call of a
    # tracked frame (phases 2, 3 and 5; "by_shape" has every case's times,
    # the loop runs' shapes among them). No single PyTorch call computes a
    # windowed top-2: no library time. pose_gn replaces no TPU kernel (the
    # JAX package leaves its loop to XLA); its times are the tracker's
    # solve. fast_select replaces none either (XLA fuses FAST and the top-k);
    # its times are one KITTI image's 8 levels, "by_shape" adds TUM's. Each
    # kernel's launches are those of the main-path runs of phases 2-10 (the
    # System runs and the example programs; phase 11's records count the
    # first two), not of the checks.
    print(json.dumps({"kernels": [{
        "name": "window_top2",
        "route": "cuda",
        "source": "c_orb_slam_tpu_torch/csrc/window_top2.cu",
        "replaces": "c_orb_slam_tpu/ops/pallas_match.py:163",
        "launches": launches["window_top2"],
        "max_abs_err": max_err,
        **rows["local_map_8192x1000"],
        "empty_launch_ms": empty_ms,
        "library_ms": None,
        "by_shape": rows,
    }, {
        "name": "pose_gn",
        "route": "cuda",
        "source": "c_orb_slam_tpu_torch/csrc/pose_gn.cu",
        "replaces": None,
        "launches": launches["pose_gn"],
        **pose_row,
        "library_ms": None,
    }, {
        "name": "fast_select",
        "route": "cuda",
        "source": "c_orb_slam_tpu_torch/csrc/fast_select.cu",
        "replaces": None,
        "launches": launches["fast_select"],
        **fast_rows["kitti_1241x376_2000"],
        "library_ms": None,
        "by_shape": fast_rows,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
