"""Where a frame's time goes: the per-stage breakdown of one benchmark
configuration, the fused tracking step's sub-stages, and on a card a
torch.profiler window of the device's busy share and its operations.

Counterpart of tools/profile_stages.py (the per-stage breakdown of the
bench scenario; its ``--tum30`` is ``--config mono_tum30`` here, the
default, and its 10 Hz scene ``mono_fast10``) and of
tools/profile_track_fine.py (the sub-stages of the fused tracking step,
read from ``Tracking.stage_ms`` in the real code path).

    python3 -m c_orb_slam_tpu_torch.tools.profile_stages [--config NAME] [--frames N] [--trace K] [--device cuda|cpu]

The configuration is one of the benchmark's (tools/bench.py ``CONFIGS``),
run as the benchmark runs it: System(cfg, device) with loop closing on,
System.warmup() and the configuration's warm-up frames, then the timed
frames (``--frames N`` cuts the configuration to N frames in all), the
clock closed by a synchronize on a card. It prints one JSON line: the card
and its power limit; ``fps`` and ``frame_ms_{median,mean,max}`` (host ms
of each ``track_*`` call) over the timed frames; ``stages``, the host ms a
frame of each stage of ``System.metrics``; ``track_substages``, the host
ms a frame of each sub-stage of the fused tracking step (select, prep,
flush, upload, dispatch, prefetch, fetch) plus ``tracking_other``, the
rest of the ``tracking`` stage (postprocess, recovery, the keyframe
decision).

``--trace K`` runs K more frames, after the timed ones so that the numbers
above are taken with tracing off, inside ``torch.profiler.profile``
(activities CPU and CUDA) and adds ``trace``: its own ``ms_per_frame``
(the cost of tracing shows against the untraced frames), and from the
card's kernel records ``device_busy_share`` and ``device_idle_share`` of
the window's wall time (the union of the kernel intervals),
``launches_per_frame``, ``copies_per_frame`` (memcpy and memset) and
``top_ops``, the 15 device operations with the most total time (name,
calls, total ms, share of all kernel time). A window on the card that
records no kernel ends the run with an error: there is no fallback to host
clocks. With ``--device cpu`` every device field is null. ``--device``
defaults to cuda and exits nonzero without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

SUBSTAGES = ("select", "prep", "flush", "upload", "dispatch", "prefetch", "fetch")
TOP_OPS = 15
_COPY_PREFIXES = ("Memcpy", "Memset")


def device_records(prof):
    """(kernels, copies) of a finished torch.profiler session: (name,
    start us, end us) of each CUDA kernel, and the number of memcpy and
    memset records. Reads the profiler's raw records, which prof.events()
    would first turn into Python objects, a minute's work for a window of
    a few frames."""
    from torch.autograd import DeviceType

    kernels, copies = [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        if name.startswith(_COPY_PREFIXES):
            copies += 1
        else:
            kernels.append((name, e.start_ns() / 1e3, e.end_ns() / 1e3))
    return kernels, copies


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def top_ops(kernels, n: int = TOP_OPS) -> list:
    """The n kernel names with the most total device time: name, calls,
    total ms and share of all kernel time."""
    by_name: dict = {}
    for name, s, e in kernels:
        calls_us = by_name.setdefault(name, [0, 0.0])
        calls_us[0] += 1
        calls_us[1] += e - s
    total = sum(us for _, us in by_name.values()) or 1.0
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:n]
    return [dict(name=name[:200], calls=calls, total_ms=round(us / 1000, 3),
                 share=round(us / total, 4)) for name, (calls, us) in ranked]


def window_fields(kernels, copies: int, wall_s: float, n_frames: int) -> dict:
    """The device fields of a traced window of n_frames frames that took
    wall_s seconds on the host's clock."""
    if not kernels:
        raise RuntimeError("the profiler recorded no CUDA kernel in the traced window")
    busy = busy_us((s, e) for _, s, e in kernels) / (wall_s * 1e6)
    return dict(device_busy_share=round(busy, 4), device_idle_share=round(1.0 - busy, 4),
                launches_per_frame=round(len(kernels) / n_frames, 1),
                copies_per_frame=round(copies / n_frames, 1), top_ops=top_ops(kernels))


def trace_window(track, first: int, n_frames: int, device) -> dict:
    """Frames first .. first + n_frames - 1 under torch.profiler: the
    window's host ms a frame and, on a card, its device fields."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(first, first + n_frames):
            track(i)
        if cuda:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    out = dict(frames=n_frames, ms_per_frame=round(wall * 1000 / n_frames, 3))
    if not cuda:
        return dict(out, device_busy_share=None, device_idle_share=None,
                    launches_per_frame=None, copies_per_frame=None, top_ops=None)
    t0 = time.perf_counter()
    kernels, copies = device_records(prof)
    out.update(window_fields(kernels, copies, wall, n_frames))
    out["processing_s"] = round(time.perf_counter() - t0, 1)
    return out


def substages_per_frame(stage_ms: dict, tracking_ms: float, n: int) -> dict:
    """stage_ms per frame, with tracking_other: the tracking stage's host
    ms that no sub-stage covers."""
    out = {k: round(v / n, 3) for k, v in stage_ms.items()}
    out["tracking_other"] = round((tracking_ms - sum(stage_ms.values())) / n, 3)
    return out


def profile(name, device, n_frames=None, trace=0) -> dict:
    """The record of one configuration (see the module docstring)."""
    import torch

    from c_orb_slam_tpu_torch.tools import bench

    entry = bench.CONFIGS[name]
    total = n_frames or entry["n_frames"]
    entry, cfg, frames, _ = bench.load(name, n_frames=total + trace)
    sysm, track = bench.start(entry, cfg, frames, device)
    sysm.metrics.reset()
    sysm.tracker.stage_ms = {}
    host_ms = []
    t0 = time.perf_counter()
    for i in range(entry["warmup"], total):
        t1 = time.perf_counter()
        track(i)
        host_ms.append((time.perf_counter() - t1) * 1000.0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    n = len(host_ms)
    stages = {k: ms for k, (ms, _) in sorted(sysm.metrics.stage_totals.items())}
    rec = {
        "tool": "profile_stages",
        "config": name,
        **bench.card(device),
        "timed_frames": n,
        "fps": round(n / dt, 3),
        "ms_per_frame": round(dt * 1000.0 / n, 3),
        "frame_ms_median": round(statistics.median(host_ms), 3),
        "frame_ms_mean": round(statistics.mean(host_ms), 3),
        "frame_ms_max": round(max(host_ms), 3),
        "stages": {k: round(ms / n, 3) for k, ms in stages.items()},
        "track_substages": substages_per_frame(sysm.tracker.stage_ms,
                                               stages.get("tracking", 0.0), n),
    }
    rec["trace"] = trace_window(track, total, trace, device) if trace else None
    sysm.shutdown()
    return rec


def main(argv=None):
    from c_orb_slam_tpu_torch.examples.common import add_device_arg, pick_device
    from c_orb_slam_tpu_torch.tools import bench

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=bench.HEADLINE, choices=list(bench.CONFIGS))
    ap.add_argument("--frames", type=int, default=None,
                    help="frames in all, warm-up included (default: the configuration's)")
    ap.add_argument("--trace", type=int, default=0, help="frames in the profiler window")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.frames is not None and args.frames <= bench.CONFIGS[args.config]["warmup"]:
        ap.error(f"--frames must exceed the configuration's "
                 f"{bench.CONFIGS[args.config]['warmup']} warm-up frames")
    device = pick_device(args.device)
    print(json.dumps(profile(args.config, device, args.frames, args.trace)), flush=True)


if __name__ == "__main__":
    main()
