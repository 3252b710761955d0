"""The port's profiling entry points: the tracker's sub-stage timers against
the JAX package's, and tools/profile_stages.py and profile_kernels.py on
the CPU.

- Tracking.stage_ms: after the same 8 frames of a 320x240 RGB-D sequence
  (400 features, 4 levels; both Systems with loop closing off, the JAX
  one on its CPU path) both trackers time the same seven sub-stages of the
  fused step; every value is >= 0 and their sum is at most the tracking
  stage's total.
- profile_stages on the CPU, cut to 14 frames (12 warm-up, 2 timed) and a
  1-frame trace window, prints one record with every field, its device
  fields null.
- profile_kernels' program table calls the package's own functions, each
  of which runs on the table's inputs; measured on the CPU its device
  fields are null.
- The trace window's arithmetic (the union of kernel intervals, the
  ranking of operations, a window with no kernel) on made-up records.
- Either tool with --device cuda and no visible card exits nonzero and
  prints nothing on standard output.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from c_orb_slam_tpu import config as jcfg
from c_orb_slam_tpu.system import System as JaxSystem
from c_orb_slam_tpu_torch import config as tcfg
from c_orb_slam_tpu_torch import mapping, tracking
from c_orb_slam_tpu_torch.frontend import frame
from c_orb_slam_tpu_torch.ops import extract, match, pyramid
from c_orb_slam_tpu_torch.optim import ba
from c_orb_slam_tpu_torch.system import System as TorchSystem
from c_orb_slam_tpu_torch.tools import profile_kernels, profile_stages

from synthetic import blob_world, render_depth, render_scene, smooth_trajectory

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, F = 320, 240, 250.0
K4 = (F, F, W / 2, H / 2)
CPU = torch.device("cpu")


def small_cfg(mod):
    """320x240 RGB-D at half the TUM focal length, 400 features, 4 levels."""
    cam = mod.CameraConfig(fx=F, fy=F, cx=W / 2, cy=H / 2, width=W, height=H, fps=10,
                           bf=F * 0.2)
    return mod.SlamConfig(
        sensor=mod.Sensor.RGBD, camera=cam, orb=mod.OrbConfig(n_features=400, n_levels=4),
        tracking=mod.TrackingConfig(min_stereo_init_points=60, velocity_rotation_fraction=0.5,
                                    max_frames_between_kf=10),
    )


def _stage_ms(sysm, frames):
    for i, (img, depth) in enumerate(frames):
        sysm.track_rgbd(img, depth, i * 0.1)
    return dict(sysm.tracker.stage_ms), sysm.metrics.stage_totals["tracking"][0]


def test_stage_ms_matches_jax_keys():
    xw, inten, size = blob_world(400, seed=5)
    frames = [(render_scene(xw, inten, size, T, K4, h=H, w=W),
               render_depth(xw, size, T, K4, h=H, w=W)) for T in smooth_trajectory(8)]
    j_ms, j_tracking = _stage_ms(JaxSystem(small_cfg(jcfg), enable_loop_closing=False), frames)
    t_ms, t_tracking = _stage_ms(
        TorchSystem(small_cfg(tcfg), CPU, enable_loop_closing=False), frames)
    assert set(t_ms) == set(j_ms) == set(profile_stages.SUBSTAGES)
    for ms, total in ((t_ms, t_tracking), (j_ms, j_tracking)):
        assert min(ms.values()) >= 0
        assert sum(ms.values()) <= total


def test_profile_stages_cpu_record(capsys):
    profile_stages.main(["--device", "cpu", "--config", "mono_fast10", "--frames", "14",
                         "--trace", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["tool"] == "profile_stages" and rec["config"] == "mono_fast10"
    assert rec["device"] == "cpu" and rec["power_limit_w"] is None
    assert rec["timed_frames"] == 2
    for key in ("fps", "ms_per_frame", "frame_ms_median", "frame_ms_mean", "frame_ms_max"):
        assert rec[key] > 0, key
    assert {"frame_build", "tracking", "mapping_stage"} <= set(rec["stages"])
    sub = rec["track_substages"]
    assert set(sub) == {*profile_stages.SUBSTAGES, "tracking_other"}
    assert min(sub.values()) >= 0
    assert sum(sub.values()) == pytest.approx(rec["stages"]["tracking"], abs=0.01)
    trace = rec["trace"]
    assert trace["frames"] == 1 and trace["ms_per_frame"] > 0
    for key in ("device_busy_share", "device_idle_share", "launches_per_frame",
                "copies_per_frame", "top_ops"):
        assert trace[key] is None, key


def test_profile_kernels_table_is_the_package():
    progs = profile_kernels.programs("mono_fast10", CPU)
    fns = {}
    for p in progs:
        fns.setdefault(p.name, set()).add(p.fn)
    want = {
        "frame.build_mono": frame.build_mono,
        "pyramid.build_pyramid": pyramid.build_pyramid,
        "extract.detect_levels": extract.detect_levels,
        "extract.select_levels": extract.select_levels,
        "extract.orient_levels": extract.orient_levels,
        "extract.describe_levels": extract.describe_levels,
        "tracking._full_track_step": tracking._full_track_step,
        "match.search_by_projection": match.search_by_projection,
        "tracking._optimize": tracking._optimize,
        "mapping._triangulate_pairs_batch": mapping._triangulate_pairs_batch,
        "mapping._fuse_pairs_batch": mapping._fuse_pairs_batch,
        "ba.bundle_adjust": ba.bundle_adjust,
        "match.match": match.match,
    }
    assert set(fns) == set(want)
    for name, fn in want.items():
        assert fns[name] == {fn}, name
    assert [p.shape for p in progs if p.name == "match.search_by_projection"] == [
        "8192 x 1000", "1000 x 1000"]
    for p in progs:
        assert p() is not None, p.name
    rec = profile_kernels.measure(progs[1], CPU)
    assert rec["host_ms"] > 0
    assert rec["device_ms"] is rec["kernel_ms"] is rec["launches"] is rec["copies"] is None
    assert rec["profile_sessions"] is None
    assert profile_kernels.floors(CPU) == dict(empty_launch_ms=None, op_ms=None)


def _event(name, start_us, end_us, device_type=DeviceType.CUDA):
    """A raw profiler record as a finished session lists it."""
    return SimpleNamespace(name=lambda: name, device_type=lambda: device_type,
                           start_ns=lambda: start_us * 1000, end_ns=lambda: end_us * 1000)


@pytest.mark.parametrize("intervals, want", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 20)], 20.0),
    ([(30, 40), (0, 10), (10, 15)], 25.0),
    ([(0, 100), (10, 20), (30, 40)], 100.0),
])
def test_busy_us_is_the_union(intervals, want):
    assert profile_stages.busy_us(intervals) == want


def test_window_fields_from_kernel_records():
    events = [_event("k_a", 0, 10), _event("k_b", 5, 25), _event("k_a", 40, 50),
              _event("Memcpy HtoD (Pageable -> Device)", 60, 61),
              _event("Memset (Device)", 61, 62), _event("aten::add", 0, 100, DeviceType.CPU)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    kernels, copies = profile_stages.device_records(prof)
    assert [k[0] for k in kernels] == ["k_a", "k_b", "k_a"] and copies == 2
    got = profile_stages.window_fields(kernels, copies, wall_s=100e-6, n_frames=2)
    assert got["device_busy_share"] == 0.35 and got["device_idle_share"] == 0.65
    assert got["launches_per_frame"] == 1.5 and got["copies_per_frame"] == 1.0
    assert got["top_ops"] == [dict(name="k_a", calls=2, total_ms=0.02, share=0.5),
                              dict(name="k_b", calls=1, total_ms=0.02, share=0.5)]
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        profile_stages.window_fields([], copies, wall_s=1.0, n_frames=1)


def test_substages_per_frame_keeps_the_rest():
    got = profile_stages.substages_per_frame({"select": 2.0, "fetch": 4.0}, 10.0, 2)
    assert got == {"select": 1.0, "fetch": 2.0, "tracking_other": 2.0}


@pytest.mark.parametrize("tool", ["profile_stages", "profile_kernels"])
def test_cuda_without_a_card_exits_nonzero(tool):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", f"c_orb_slam_tpu_torch.tools.{tool}",
                        "--device", "cuda", "--config", "mono_fast10"],
                       capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "no CUDA device" in r.stderr
