"""The port's spans (Metrics.stage) inside the frame build and the fused
tracking step, on one small stereo System on the CPU (320x240 pairs, 400
features, 4 levels, loop closing off): 4 frames with no profiler, then 2
blank pairs inside one torch.profiler session. The first blank pair is
dispatched on the fused step; the second finds it failed, with its wide
retry, and the tracker lost with few keyframes, and System resets
itself.

- Every span is in System.metrics' totals, each at most its parent's.
- Tracking.stage_ms keeps the JAX package's seven keys, each the sum of
  its span (prep: with track.vo's), across the reset.
- The profiler's host events hold a ``stage:NAME`` range for every span,
  each inside a range of its parent's.
- With no profiler recording, no profiler range is entered.
- The reset keeps the metrics: auto_resets reads 1 and the totals count
  every frame.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from c_orb_slam_tpu_torch import config as tcfg
from c_orb_slam_tpu_torch.slam_map.mapstate import MapState
from c_orb_slam_tpu_torch.system import System
from c_orb_slam_tpu_torch.tools.profile_stages import SUBSTAGES
from c_orb_slam_tpu_torch.tracking import Tracking
from c_orb_slam_tpu_torch.utils.metrics import Metrics

from synthetic import blob_world, render_stereo_pair, smooth_trajectory

torch.set_num_threads(1)

W, H, F, BASELINE = 320, 240, 250.0, 0.2
CPU = torch.device("cpu")
FRAMES, BLANK = 4, 2

# Each span and the span it runs inside.
PARENT = {
    "frame.extract": "frame_build",
    "frame.pyramid": "frame.extract",
    "frame.detect": "frame.extract",
    "frame.orient": "frame.extract",
    "frame.describe": "frame.extract",
    "frame.stereo_match": "frame_build",
    "frame.stereo_sad": "frame_build",
    "track.vo": "tracking",
    **{"track." + k: "tracking" for k in SUBSTAGES},
    "track.motion_search": "track.dispatch",
    "track.motion_pose": "track.dispatch",
    "track.local_search": "track.dispatch",
    "track.local_pose": "track.dispatch",
    "track.retry": "tracking",
}


def _cfg():
    cam = tcfg.CameraConfig(fx=F, fy=F, cx=W / 2, cy=H / 2, width=W, height=H, fps=10,
                            bf=F * BASELINE)
    return tcfg.SlamConfig(
        sensor=tcfg.Sensor.STEREO, camera=cam, orb=tcfg.OrbConfig(n_features=400, n_levels=4),
        tracking=tcfg.TrackingConfig(min_stereo_init_points=60, velocity_rotation_fraction=0.5,
                                     max_frames_between_kf=10),
    )


@pytest.fixture(scope="module")
def run():
    xw, inten, size = blob_world(400, seed=5)
    pairs = [render_stereo_pair(xw, inten, size, T, (F, F, W / 2, H / 2), BASELINE, h=H, w=W)
             for T in smooth_trajectory(FRAMES)]
    blank = np.zeros((H, W), np.float32)
    pairs += [(blank, blank)] * BLANK
    sysm = System(_cfg(), CPU, enable_loop_closing=False)
    entered = []
    real = torch.profiler.record_function
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function",
                   lambda name: entered.append(name) or real(name))
        for i in range(FRAMES):
            sysm.track_stereo(*pairs[i], i * 0.1)
        untraced = list(entered)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(FRAMES, len(pairs)):
                sysm.track_stereo(*pairs[i], i * 0.1)
    host = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU]
    ranges = {}
    for name, s, e in host:
        if name.startswith("stage:"):
            ranges.setdefault(name[len("stage:"):], []).append((s, e))
    return dict(sysm=sysm, untraced=untraced, traced=entered[len(untraced):], ranges=ranges)


@pytest.mark.parametrize("name", sorted(PARENT))
def test_span_is_timed_and_traced_inside_its_parent(run, name):
    totals = run["sysm"].metrics.stage_totals
    parent = PARENT[name]
    assert name in totals
    assert totals[name][0] <= totals[parent][0]
    ranges = run["ranges"]
    assert ranges.get(name), f"no stage:{name} range in the profiler session"
    for s, e in ranges[name]:
        assert any(ps <= s and e <= pe for ps, pe in ranges[parent]), (name, s, e)


def test_stage_ms_keeps_its_keys_and_the_spans_sums(run):
    sysm = run["sysm"]
    totals, stage_ms = sysm.metrics.stage_totals, sysm.tracker.stage_ms
    assert set(stage_ms) == set(SUBSTAGES)
    for k in SUBSTAGES:
        want = totals["track." + k][0] + (totals["track.vo"][0] if k == "prep" else 0.0)
        assert stage_ms[k] == pytest.approx(want, rel=1e-12), k
    assert sum(stage_ms.values()) <= totals["tracking"][0]


def test_no_profiler_no_range(run):
    assert run["untraced"] == []
    assert run["traced"] and all(n.startswith("stage:") for n in run["traced"])


def test_reset_keeps_the_metrics(run):
    sysm = run["sysm"]
    assert sysm.metrics.counters["auto_resets"] == 1
    assert sysm.tracker.metrics is sysm.metrics and sysm.local_mapping.metrics is sysm.metrics
    n = FRAMES + BLANK
    assert sysm.metrics.stage_totals["frame_build"][1] == n
    assert sysm.metrics.stage_totals["frame.extract"][1] == 2 * n


def test_tracker_alone_has_its_own_metrics():
    cfg = _cfg()
    tracker = Tracking(cfg, MapState(cfg, compute_device=CPU), CPU)
    assert isinstance(tracker.metrics, Metrics) and tracker.metrics.stage_totals == {}
