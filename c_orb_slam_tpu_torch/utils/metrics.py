"""Structured per-frame metrics and stage timing.

The reference's observability is cout prints plus per-frame wall times
computed in the example mains (reference: Examples/Stereo/stereo_kitti.cc:
80-122 chrono timing + median/mean report; event prints like "Loop
detected!" LoopClosing.cc:404). Here observability is first-class
(SURVEY.md §5): every tracked frame appends one structured record, stage
timers aggregate per-stage wall time. While a torch.profiler session
records, each stage is also a ``stage:NAME`` profiler range, so a trace
shows which stage the host was in at each point of the device's timeline.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

_NO_SPAN = contextlib.nullcontext()


def no_span(name: str):
    """The span argument's default: times and records nothing."""
    return _NO_SPAN


@dataclass
class FrameRecord:
    frame_id: int
    timestamp: float
    state: int
    n_inliers: int
    n_keyframes: int
    n_points: int
    is_keyframe: bool
    total_ms: float
    stages_ms: dict


@dataclass
class Metrics:
    records: list = field(default_factory=list)
    stage_totals: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    _open_stages: dict = field(default_factory=dict)
    # Host ms of the span that closed last (Tracking.stage_ms adds it up).
    last_ms: float = 0.0

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time a span of the host's work under `name`. While a
        torch.profiler session records, the span is also the profiler
        range ``stage:NAME``; otherwise no range is entered (an enter and
        exit costs some 15 us of host time, the check well under 1 us)."""
        t0 = time.perf_counter()
        if torch._C._autograd._profiler_enabled():
            with torch.profiler.record_function("stage:" + name):
                yield
        else:
            yield
        dt = (time.perf_counter() - t0) * 1000.0
        self.last_ms = dt
        self._open_stages[name] = self._open_stages.get(name, 0.0) + dt
        tot = self.stage_totals.setdefault(name, [0.0, 0])
        tot[0] += dt
        tot[1] += 1

    def reset(self):
        self.records = []
        self.stage_totals = {}
        self.counters = {}
        self._open_stages = {}

    def count(self, name: str, n: int = 1):
        self.counters[name] = self.counters.get(name, 0) + n

    def end_frame(self, frame_id, timestamp, state, n_inliers,
                  n_keyframes, n_points, is_keyframe, total_ms):
        self.records.append(
            FrameRecord(
                frame_id=int(frame_id),
                timestamp=float(timestamp),
                state=int(state),
                n_inliers=int(n_inliers),
                n_keyframes=int(n_keyframes),
                n_points=int(n_points),
                is_keyframe=bool(is_keyframe),
                total_ms=float(total_ms),
                stages_ms={k: round(v, 3) for k, v in self._open_stages.items()},
            )
        )
        self._open_stages = {}

    # -- reporting ---------------------------------------------------------
    def summary(self) -> dict:
        """Median/mean per-frame time + per-stage totals (the reference
        prints median/mean tracking time at exit, stereo_kitti.cc:121)."""
        import numpy as np

        times = np.asarray([r.total_ms for r in self.records], np.float64)
        out = {
            "frames": len(self.records),
            "median_ms": float(np.median(times)) if len(times) else 0.0,
            "mean_ms": float(times.mean()) if len(times) else 0.0,
            "fps": 1000.0 / float(times.mean()) if len(times) else 0.0,
            "stages": {
                k: {"total_ms": round(v[0], 1), "calls": v[1]}
                for k, v in sorted(self.stage_totals.items())
            },
            "counters": dict(self.counters),
        }
        return out
