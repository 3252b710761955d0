"""Each hot program of the main path, timed alone at one benchmark
configuration's shapes: host time, device time, CUDA launches and the
launch floor.

Counterpart of tools/profile_kernels.py (build_mono and the pieces of
extraction, the fused track step, search_by_projection at 8192 x N and N x
N, the pose solve), tools/profile_device_kernels.py (the fused step, the
mapper's triangulation and fuse batches, the local BA at capacity),
tools/profile_mapping.py (enqueue, device and fetch of the mapper's three
dispatches) and tools/profile_latency.py (match.match at 2048 x 2048,
alone and batched x 20).

    python3 -m c_orb_slam_tpu_torch.tools.profile_kernels [--config NAME] [--device cuda|cpu]

Inputs come from a seeded numpy generator and the first frame that
tools/bench.py renders for the configuration (``bench.load``), as in the
JAX tools; each program is the package's own function (``programs``), so
the profile cannot go stale against a copy. The mapper's three dispatches
run on a System after the configuration's warm-up frames, on the newest
keyframe for which each dispatches.

It prints one JSON line a program: the card and its power limit,
``program``, ``shape``, and
- ``host_ms``: wall time of a call, back to back, closed by one
  synchronize (the median of 5 runs of calls);
- ``device_ms``: CUDA events around such a run of calls after warm-up,
  over their count (the stream's time a call: the host's where the host
  is slower; the median of 5 runs);
- ``kernel_ms``: the kernels' own time in one call (torch.profiler);
- ``launches`` and ``copies``: CUDA kernels, and memcpy and memset
  records, in one call (torch.profiler);
- ``profile_sessions``: the torch.profiler sessions that call took: a
  session can end with no CUDA record at all (CUPTI's buffers lost), and
  then the call runs again in a new one, up to PROFILE_SESSIONS;
- ``launch_floor_ms``: launches x ``empty_launch_ms``, an empty kernel
  launched through window_top2's ctypes route and timed back to back in
  the same run (chip_smoke phase 1's ``empty_launch_ms``), and
  ``op_floor_ms``: launches x ``op_ms``, a one-element torch add timed
  the same way: how much of host_ms launching alone costs;
- for the mapper's dispatches, ``enqueue_ms``, ``ready_ms`` and
  ``fetch_ms``: the median host time of the dispatch, of the wait for its
  device work, and of its readback.

A run on the card that reads no CUDA event, or records no kernel for a
program in any of its sessions, fails. With ``--device cpu`` only
host_ms (and the mapper's split) is measured; every device field is
null. ``--device`` defaults to cuda and exits nonzero without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, NamedTuple

# host_ms and device_ms are medians over REPEATS runs of back-to-back
# calls, each run about RUN_S seconds long (at least one call).
REPEATS = 5
RUN_S = 0.05
MAPPER_TRIALS = 5
PROFILE_SESSIONS = 3


class Program(NamedTuple):
    name: str
    shape: str
    fn: Callable
    args: tuple
    kwargs: dict | None = None

    def __call__(self):
        return self.fn(*self.args, **(self.kwargs or {}))


def programs(name, device) -> list:
    """The hot programs of the main path at configuration `name`'s shapes,
    each the package's own callable with its inputs on `device`."""
    import numpy as np
    import torch

    from c_orb_slam_tpu_torch import mapping, tracking
    from c_orb_slam_tpu_torch.config import Sensor
    from c_orb_slam_tpu_torch.frontend import frame
    from c_orb_slam_tpu_torch.geometry import camera
    from c_orb_slam_tpu_torch.ops import extract, match, pyramid
    from c_orb_slam_tpu_torch.optim import ba
    from c_orb_slam_tpu_torch.system import _to_gray_f32
    from c_orb_slam_tpu_torch.tools import bench

    _, cfg, frames, _ = bench.load(name, n_frames=1)
    orb, seed = cfg.orb, cfg.vocabulary.seed
    stereo = cfg.sensor == Sensor.STEREO
    rng = np.random.default_rng(0)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def rand_desc(*shape):
        return dev(rng.integers(0, 2**32, (*shape, 8), dtype=np.uint64).astype(np.uint32)
                   .view(np.int32))

    def rand_xyz(n):
        return dev(rng.normal(size=(n, 3)).astype(np.float32) + np.float32([0, 0, 5]))

    if stereo:
        left, right = (_to_gray_f32(im, device) for im in frames[0])
        build = Program("frame.build_stereo", "", frame.build_stereo, (left, right, cfg))
        img = left
    else:
        img = _to_gray_f32(frames[0], device)
        build = Program("frame.build_mono", "", frame.build_mono, (img, cfg))
    f = build()
    N = f.xy.shape[0]
    size = f"{img.shape[1]}x{img.shape[0]}, {N} keypoints on {orb.n_levels} levels"
    levels = pyramid.build_pyramid(img, orb.n_levels, orb.scale_factor)
    scores = extract.detect_levels(levels, orb)
    picks = extract.select_levels(scores, orb)
    angles = extract.orient_levels(levels, picks, orb)
    out = [
        build._replace(shape=size),
        Program("pyramid.build_pyramid", size, pyramid.build_pyramid,
                (img, orb.n_levels, orb.scale_factor)),
        Program("extract.detect_levels", size, extract.detect_levels, (levels, orb)),
        Program("extract.select_levels", size, extract.select_levels, (scores, orb)),
        Program("extract.orient_levels", size, extract.orient_levels, (levels, picks, orb)),
        Program("extract.describe_levels", size, extract.describe_levels,
                (levels, picks, angles, seed)),
    ]
    if stereo:
        kl = extract.extract_orb(left, orb, seed)
        kr = extract.extract_orb(right, orb, seed)
        m, ur0 = frame._stereo_match(kl, kr, cfg)
        out += [
            Program("frame._stereo_match", f"{N} x {N}", frame._stereo_match, (kl, kr, cfg)),
            Program("frame._stereo_subpixel", size, frame._stereo_subpixel,
                    (left, right, cfg, kl.xy, kl.octave, ur0, m.valid)),
        ]

    # The fused track step on a map of local_map_max_points random points
    # (the JAX tools' inputs), every last-frame keypoint a query.
    cap = cfg.capacity.local_map_max_points
    K = camera.intrinsics_array(cfg.camera, device)
    sf = dev(np.asarray(orb.scale_factors(), np.float32))
    sigma2 = dev(np.asarray(orb.level_sigma2(), np.float32))
    inv_s2 = 1.0 / sigma2
    T = torch.eye(3, 4, device=device)
    pt_xyz, pt_desc = rand_xyz(cap), rand_desc(cap)
    pt_normal = dev(np.tile(np.float32([0, 0, -1]), (cap, 1)))
    pt_mind = torch.full((cap,), 0.1, device=device)
    pt_maxd = torch.full((cap,), 100.0, device=device)
    pt_valid = torch.ones(cap, dtype=torch.bool, device=device)
    ids = torch.arange(cap, dtype=torch.int32, device=device)
    out.append(Program(
        "tracking._full_track_step", f"{N} queries, local map {cap}", tracking._full_track_step,
        (cfg, T, ids[:N], f.octave, f.desc, torch.zeros(N, 3, device=device),
         torch.zeros(N, dtype=torch.bool, device=device), ids,
         pt_xyz, pt_normal, pt_mind, pt_maxd, pt_desc, pt_valid, f, K, inv_s2, sf)))

    uv = dev(rng.uniform(0, [cfg.camera.width, cfg.camera.height], (cap, 2)).astype(np.float32))
    radii = torch.full((cap,), 10.0, device=device)
    lo = torch.zeros(cap, dtype=torch.int32, device=device)
    hi = torch.full((cap,), orb.n_levels - 1, dtype=torch.int32, device=device)
    for q in (cap, N):
        out.append(Program(
            "match.search_by_projection", f"{q} x {N}", match.search_by_projection,
            (uv[:q], radii[:q], pt_desc[:q], pt_valid[:q], f.xy, f.octave, f.desc, f.valid,
             lo[:q], hi[:q]), dict(max_dist=100, nn_ratio=0.8)))

    obs = torch.cat([f.xy, torch.zeros(N, 1, device=device)], dim=1)
    opt = cfg.optimizer
    out.append(Program(
        "tracking._optimize", f"{N} points, {opt.pose_opt_rounds} x {opt.pose_opt_its}",
        tracking._optimize,
        (cfg, T, rand_xyz(N), obs, inv_s2[f.octave.long()],
         torch.zeros(N, dtype=torch.bool, device=device), f.valid, K)))

    # The mapper's batches: the new keyframe against each of its neighbours
    # (P rows: the mapper's most), and the fuse at its cap of pairs, over a
    # keyframe table of the frame seen from P + 1 poses.
    P = (cfg.mapping.triangulation_neighbors_stereo if stereo
         else cfg.mapping.triangulation_neighbors_mono)
    n_kf = max(P, cfg.capacity.fuse_max_pairs) + 1
    kf_pose = T.repeat(n_kf, 1, 1)
    kf_pose[:, 0, 3] = torch.arange(n_kf, device=device) * -0.05
    kf_xy, kf_oct, kf_desc, kf_valid = (t.expand(n_kf, *t.shape).contiguous()
                                        for t in (f.xy, f.octave, f.desc, f.valid))
    out.append(Program(
        "mapping._triangulate_pairs_batch", f"{P} pairs x {N} x {N}",
        mapping._triangulate_pairs_batch,
        (cfg, 0, torch.arange(1, P + 1, dtype=torch.int32, device=device), f.valid,
         kf_valid[1:P + 1], torch.ones(P, dtype=torch.bool, device=device),
         kf_pose, kf_xy, kf_oct, kf_desc, K, sigma2)))
    B = cfg.capacity.fuse_max_pairs
    out.append(Program(
        "mapping._fuse_pairs_batch", f"{B} pairs x {N} points x {N}", mapping._fuse_pairs_batch,
        (cfg, torch.arange(1, B + 1, dtype=torch.int32, device=device),
         dev(rng.integers(0, cap, (B, N), dtype=np.int32)), kf_pose, kf_xy, kf_oct, kf_desc,
         kf_valid, pt_xyz, pt_normal, pt_mind, pt_maxd, pt_desc, pt_valid, K, sf)))

    # The local BA at its full bucket (the JAX tool's random problem).
    c = cfg.capacity
    C, Pp, O = c.local_ba_max_kfs * 2, c.local_ba_max_points, c.local_ba_max_obs
    cam_fixed = torch.zeros(C, dtype=torch.bool, device=device)
    cam_fixed[0] = True
    problem = ba.BAProblem(
        cam_T=T.repeat(C, 1, 1), cam_fixed=cam_fixed,
        cam_valid=torch.ones(C, dtype=torch.bool, device=device),
        points=rand_xyz(Pp), point_valid=torch.ones(Pp, dtype=torch.bool, device=device),
        obs_cam=dev(rng.integers(0, C, O, dtype=np.int32)),
        obs_pt=dev(rng.integers(0, Pp, O, dtype=np.int32)),
        obs_uv=dev(rng.uniform(0, cfg.camera.width, (O, 3)).astype(np.float32)),
        obs_stereo=torch.zeros(O, dtype=torch.bool, device=device),
        obs_inv_sigma2=torch.ones(O, device=device),
        obs_valid=torch.ones(O, dtype=torch.bool, device=device),
        K=K, bf=torch.tensor(float(cfg.camera.bf), device=device))
    out.append(Program("ba.bundle_adjust", f"{C} cameras x {Pp} points x {O} observations",
                       ba.bundle_adjust, (problem,), mapping.local_ba_options(cfg)))

    # match.match at 2048 x 2048, alone (5% of the pairs allowed) and
    # batched x 20 (profile_latency.py's shapes).
    n, b = 2048, 20
    ones = torch.ones(n, dtype=torch.bool, device=device)
    out += [
        Program("match.match", f"{n} x {n}", match.match,
                (rand_desc(n), rand_desc(n), ones, ones, dev(rng.random((n, n)) < 0.05)),
                dict(max_dist=50, nn_ratio=0.8)),
        Program("match.match", f"{b} x {n} x {n}", match.match,
                (rand_desc(b, n), rand_desc(b, n)), dict(max_dist=50, nn_ratio=0.8)),
    ]
    return out


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def per_call_ms(fn, n, device) -> float:
    """CUDA-event ms of n back-to-back calls over n."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / n
    if not ms > 0:
        raise RuntimeError(f"a CUDA event pair read {ms} ms")
    return ms


def measure(fn, device) -> dict:
    """host_ms, device_ms, kernel_ms, launches and copies of fn() (see the
    module docstring); device fields None off a card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from c_orb_slam_tpu_torch.tools.profile_stages import device_records

    def host_run(n):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        _sync(device)
        return (time.perf_counter() - t0) * 1000 / n

    host_run(1)  # first-call costs
    n = max(1, min(50, int(RUN_S * 1000 / host_run(1))))
    out = dict(host_ms=round(statistics.median(host_run(n) for _ in range(REPEATS)), 4),
               device_ms=None, kernel_ms=None, launches=None, copies=None,
               profile_sessions=None)
    if device.type != "cuda":
        return out
    out["device_ms"] = round(statistics.median(per_call_ms(fn, n, device)
                                               for _ in range(REPEATS)), 4)
    for session in range(1, PROFILE_SESSIONS + 1):
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize(device)
        kernels, copies = device_records(prof)
        if kernels:
            break
    else:
        raise RuntimeError(f"the profiler recorded no CUDA kernel in a call, "
                           f"in each of {PROFILE_SESSIONS} sessions")
    out.update(kernel_ms=round(sum(e - s for _, s, e in kernels) / 1000, 4),
               launches=len(kernels), copies=copies, profile_sessions=session)
    return out


def floors(device) -> dict:
    """empty_launch_ms and op_ms (see the module docstring); None off a
    card."""
    import torch

    from c_orb_slam_tpu_torch.ops import window_top2

    if device.type != "cuda":
        return dict(empty_launch_ms=None, op_ms=None)
    x = torch.zeros(1, device=device)
    calls = (lambda: window_top2.empty_launch(device), lambda: x.add_(1))
    for call in calls:
        per_call_ms(call, 20, device)  # warm-up (the kernel library's build and load)
    return {k: round(statistics.median(per_call_ms(call, 20, device) for _ in range(7)), 5)
            for k, call in zip(("empty_launch_ms", "op_ms"), calls)}


_MAPPER = (("_triangulate_dispatch", "_pending_tri"), ("_fuse_dispatch", "_pending_fuse"),
           ("_ba_dispatch", "_pending_ba"))


def mapper_dispatches(name, device) -> list:
    """(Program, split) of each of the mapper's three dispatches, on a
    System after the configuration's warm-up frames: the dispatch and its
    readback as one call, and the median enqueue, ready and fetch ms."""
    from c_orb_slam_tpu_torch.tools import bench

    entry, cfg, frames, _ = bench.load(name, n_frames=bench.CONFIGS[name]["warmup"])
    sysm, _ = bench.start(entry, cfg, frames, device)
    sysm.tracker.flush_pending()
    lm = sysm.local_mapping
    lm.drain()
    out = []
    for method, pending in _MAPPER:
        dispatch = getattr(lm, method)

        def call(kf, dispatch=dispatch, pending=pending):
            dispatch(kf)
            rec = getattr(lm, pending)
            setattr(lm, pending, None)
            return rec and rec[-1]

        kf = next((k for k in reversed(sysm.map.live_keyframes()) if call(k) is not None), None)
        if kf is None:
            raise RuntimeError(f"LocalMapping.{method} dispatched on no keyframe")
        split = []
        for _ in range(MAPPER_TRIALS):
            t0 = time.perf_counter()
            fut = call(kf)
            t1 = time.perf_counter()
            _sync(device)
            t2 = time.perf_counter()
            fut.result()
            split.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
        out.append((
            Program(f"LocalMapping.{method}", f"keyframe {kf}",
                    lambda kf=kf, call=call: call(kf).result(), ()),
            {k: round(statistics.median(s[i] for s in split) * 1000, 4)
             for i, k in enumerate(("enqueue_ms", "ready_ms", "fetch_ms"))}))
    return out


def main(argv=None):
    from c_orb_slam_tpu_torch.examples.common import add_device_arg, pick_device
    from c_orb_slam_tpu_torch.tools import bench

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=bench.HEADLINE, choices=list(bench.CONFIGS))
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = pick_device(args.device)

    head = dict(tool="profile_kernels", config=args.config, **bench.card(device),
                **floors(device))
    rows = [(p, {}) for p in programs(args.config, device)] + mapper_dispatches(args.config,
                                                                             device)
    for prog, extra in rows:
        rec = dict(head, program=prog.name, shape=prog.shape, **measure(prog, device), **extra)
        if device.type == "cuda":
            rec["launch_floor_ms"] = round(rec["launches"] * head["empty_launch_ms"], 4)
            rec["op_floor_ms"] = round(rec["launches"] * head["op_ms"], 4)
        else:
            rec["launch_floor_ms"] = rec["op_floor_ms"] = None
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
