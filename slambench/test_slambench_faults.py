"""A run of the harness on the CPU at a test size, past its look for a
card: sound, it comes out correct; with the timed path broken underneath,
``correct`` comes out false, once for each fault a tracking cell can have:
a step that returns its state unchanged, an answer altered where it is
produced, and the mapper's local BA answered in a lower precision. (A cell
of one camera on one chip has no batch to halve and no exchange between
chips to leave out.) The window ends on its clock, or on the supply's last
frame where the program outruns the sensor."""

import contextlib
import copy
import json
import os
import shutil

import pytest

from slambench import faults, harness

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SEED = 2**31 + 4242
SECONDS = 12.0
BA_GAP = 1.5e-4
# The numbers that each fault fails at this size.
FAILS = {"state_unchanged": {"ate_m", "ate_seg_m"}, "answer_altered": {"ate_m", "ate_seg_m"},
         "ba_rounded": {"ba_gap"}}


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """A checkout root with one throwaway cell: tum_mono at half the
    resolution on 4 levels, under the explore mix."""
    root = tmp_path_factory.mktemp("small")
    shutil.copytree(HERE, root / "slambench", ignore=shutil.ignore_patterns("__pycache__"))
    cfg = harness.load_json(os.path.join(HERE, "configs", "tum_mono.json"))
    st = cfg["settings"]
    for k in ("Camera.fx", "Camera.fy", "Camera.cx", "Camera.cy"):
        st[k] /= 2
    st.update({"Camera.width": 320, "Camera.height": 240, "ORBextractor.nFeatures": 500,
               "ORBextractor.nLevels": 4})
    # This size's own limits, set from its own readings on the CPU over some
    # 20 window frames: sound, ATE 0.0047 m; the state left unchanged,
    # 0.051; the answer altered, 0.034. Each second aligned on its own
    # (ate_seg_m): sound 0.0043-0.0051 m, the state left unchanged
    # 0.0513-0.0561, the answer altered 0.0304-0.0328; limit 0.012, near
    # the middle on a log scale. The map's reprojection (reproj_px): sound
    # 0.58-0.68 sigma over 7 runs, the state left unchanged 9.40-9.46;
    # limit 2.4 (the answer altered reads 0.59-0.68 on this seed: ATE's to
    # catch). A window of some 20 frames at 30 Hz holds no pair of frames a
    # second apart, so rpe_rot_deg reads nothing here and has no limit.
    # The last local BA's gap to its float64 optimum (ba_gap, chi2 an
    # observation): sound 3.8e-11 to 2.6e-5 over 21 runs on 10 seeds (17-26
    # window frames; 2.6e-5 where the port's float32 BA stalls), the BA's
    # answer rounded to a 10-bit mantissa 5.6e-4 to 1.7e-2 over 15 runs on
    # 7 seeds; limit 1.5e-4, 5.8x over the one and 3.7x under the other.
    # ba_move_rel overlaps (sound up to 5.7e-4, rounded from 1.1e-5).
    cfg["correct"] = dict(unresolved=0, lost=0, loops_closed=0, ate_m=0.015, ate_seg_m=0.012,
                          reproj_px=2.4, ba_gap=BA_GAP)
    (root / "slambench" / "configs" / "small.json").write_text(json.dumps(cfg))
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    bench["configs"].append(dict(name="small", source="test", file="slambench/configs/small.json",
                                 reduced=[], why="test size"))
    bench["workloads"].append(dict(name="small.explore", config="small", traffic="explore",
                                   chips=1, why="test size"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def run_with(root, fault=None, cell="small.explore", seconds=SECONDS, trace=False):
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with faults.planted(fault) if fault else contextlib.nullcontext():
            return harness.run(cell, SEED, seconds, trace, device="cpu", root=root)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sound(small_root):
    return run_with(small_root)


def slow_sensor(root, rate):
    """small.explore's spec with the camera at `rate` Hz and the mix's
    speeds and periods scaled with it, so that the path is the same frame
    for frame: a sensor that the CPU outruns."""
    spec = harness.load_spec("small.explore", root=root)
    spec = dict(spec, config=copy.deepcopy(spec["config"]), mix=copy.deepcopy(spec["mix"]))
    st, mix = spec["config"]["settings"], spec["mix"]
    f = rate / st["Camera.fps"]
    st["Camera.fps"] = rate
    mix["speed_m_s"] *= f
    mix["angular_deg_s"] *= f
    mix["path"]["cross_period_s"] /= f
    return spec


def test_sound_run_is_correct(sound):
    out = sound
    assert out["result"]["correct"], out["checks"]
    window = out["detail"]["readings"]["ba_window"]
    assert window["free"] >= 2 and window["observations"] > 500
    assert out["detail"]["window_frames"] > faults.ALTERED_FRAME - faults.WARMUP
    assert out["result"]["attempted"] == out["detail"]["window_frames"]


def test_clock_ends_the_window(sound, small_root):
    """At the sensor's own rate the CPU falls behind: the clock ends the
    window, and the frames handed in are the supply's first ones in order,
    out of a supply of the same size."""
    d, warm = sound["detail"], faults.WARMUP
    mix = harness.load_spec("small.explore", root=small_root)["mix"]
    assert d["window_end"] == "clock"
    assert d["frames_rendered"] == harness.frame_budget(mix, 30.0, SECONDS, False)
    assert d["supply_frames"] == d["frames_rendered"] - warm
    assert 0 < d["window_frames"] < d["supply_frames"]
    assert d["judged"] == list(range(warm, warm + d["window_frames"]))
    assert d["window_s"] >= SECONDS


@pytest.mark.parametrize("trace", [False, True])
def test_supply_ends_the_window(small_root, trace, capfd):
    """A sensor slower than the CPU's pace: the window ends at the supply's
    last frame, long before its clock, without an error; `fps` is its
    frames over its seconds, and the profiler's frames, kept apart from the
    supply of the window, still run."""
    rate, seconds = 0.25, 40.0
    spec = slow_sensor(small_root, rate)
    out = run_with(small_root, cell=spec, seconds=seconds, trace=trace)
    d, warm = out["detail"], faults.WARMUP
    supply = harness.frame_budget(spec["mix"], rate, seconds, False) - warm
    assert d["window_end"] == "supply" and "the supply's last frame" in capfd.readouterr().err
    assert d["supply_frames"] == d["window_frames"] == supply == 10
    assert d["window_s"] < seconds
    assert d["e2e"]["fps"] == pytest.approx(d["window_frames"] / d["window_s"], rel=1e-12)
    assert out["result"]["failed"] == 0
    n_trace = harness.trace_frames(rate) if trace else 0
    assert d["judged"] == list(range(warm, warm + supply + n_trace))
    assert out["result"]["attempted"] == supply + n_trace
    assert ("breakdown" in out["result"]) is trace
    if trace:
        assert len(d["trace_sessions"]) == 1  # the CPU records no kernel to retry for
        assert out["result"]["device"]["window_s"] > 0


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_not_correct(small_root, fault):
    out = run_with(small_root, fault)
    assert not out["result"]["correct"]
    failed = {c[0] for c in out["checks"] if not c[3]}
    assert FAILS[fault] <= failed, out["checks"]
