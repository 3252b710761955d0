"""Reduction of a torch.profiler session to what the per-layer metrics and
the breakdown read: the CUDA kernels' intervals, the host's launch calls,
and the host stages open while the device sat idle.

The reading of raw records and the union of intervals are the arithmetic
of the port's ``tools/profile_stages.py`` (the profiler's raw records, which
``prof.events()`` would first turn into Python objects: a minute's work
for a window of a few frames), copied.
"""

from __future__ import annotations

import numpy as np

COPY_PREFIXES = ("Memcpy", "Memset")
# Host calls that put work on the device: one graph launch counts one.
LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
    "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch",
))
STAGE_PREFIX = "stage:"
# Words in the names of cuBLAS's and CUTLASS's matrix-product kernels, and
# in those of their TF32 tensor-core ones (s1688, s16816: TF32's mma shapes).
GEMM_WORDS = ("gemm", "gemv", "xmma", "cutlass", "tensorop", "dot_kernel")
TF32_WORDS = ("tf32", "s1688", "s16816")
OUTSIDE = "between_stages"


def raw_events(prof):
    """(device events, host events) of a finished session, each a list of
    (name, start us, end us)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
        (dev if e.device_type() == DeviceType.CUDA else host).append(rec)
    return dev, host


def kernels_of(dev_events):
    """The kernels among the device records: no memcpy or memset, and not
    the device-side copies of the harness's own ``stage:NAME`` ranges."""
    return [k for k in dev_events if not k[0].startswith(COPY_PREFIXES + (STAGE_PREFIX,))]


def launches(host_events) -> int:
    return sum(1 for name, _, _ in host_events if name in LAUNCH_CALLS)


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    return float(sum(e - s for s, e in merged(intervals)))


def merged(intervals):
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def top_ops(kernels, n: int = 10) -> list:
    """[name, seconds] of the n kernel names with the most device time."""
    by_name: dict = {}
    for name, s, e in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:200], us / 1e6] for name, us in ranked]


def gemms(kernels) -> dict:
    """{name: [launches, seconds]} of the matrix-product kernels (a name
    that holds GEMM_WORDS, in any case), the most time first; the TF32
    ones hold one of TF32_WORDS."""
    by_name: dict = {}
    for name, s, e in kernels:
        if any(w in name.lower() for w in GEMM_WORDS):
            n_us = by_name.setdefault(name[:200], [0, 0.0])
            n_us[0] += 1
            n_us[1] += e - s
    return {k: [n, us / 1e6] for k, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])}


def idle_by_stage(kernels, host_events, span, n: int = 10) -> list:
    """[stage, seconds] of the device's idle time inside `span` (start us,
    end us), each gap between kernels charged to the innermost host stage
    (a ``stage:NAME`` range) open at its midpoint, or to OUTSIDE."""
    busy = merged((s, e) for _, s, e in kernels)
    edges = [span[0]] + [x for iv in busy for x in iv] + [span[1]]
    starts = np.asarray(edges[0::2], np.float64)
    ends = np.asarray(edges[1::2], np.float64)
    keep = ends > starts
    starts, ends = starts[keep], ends[keep]
    mids = 0.5 * (starts + ends)
    order = np.argsort(mids)
    mids, lengths = mids[order], (ends - starts)[order]
    label = np.full(len(mids), -1)
    stages = sorted((s, e, name[len(STAGE_PREFIX):]) for name, s, e in host_events
                    if name.startswith(STAGE_PREFIX))
    names = [name for _, _, name in stages]
    for j, (s, e, _) in enumerate(stages):  # a later start is an inner range
        a, b = np.searchsorted(mids, [s, e])
        label[a:b] = j
    totals: dict = {}
    for j, us in zip(label.tolist(), lengths.tolist()):
        key = names[j] if j >= 0 else OUTSIDE
        totals[key] = totals.get(key, 0.0) + us
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
    return [[name, us / 1e6] for name, us in ranked]
