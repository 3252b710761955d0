"""The readers of the program's spans inside the frame build and the fused
tracking step (layers/pose_solve_ms.py, orb_detect_ms.py, stereo_sad_ms.py):
window ms a frame on a made-up context, and nothing where the program has
no such span."""

import os

import pytest

from slambench import harness

HERE = os.path.dirname(os.path.abspath(__file__))


def reader(name):
    return harness.load_module(os.path.join(HERE, "layers", name + ".py"), "spans_" + name)


STAGES = {"frame_build": 1500.0, "frame.detect": 600.0, "frame.stereo_sad": 90.0,
          "tracking": 2000.0, "track.dispatch": 1800.0, "track.motion_pose": 700.0,
          "track.local_pose": 900.0}


@pytest.mark.parametrize("name,stages,want", [
    ("pose_solve_ms", STAGES, 160.0),
    ("pose_solve_ms", {"track.local_pose": 900.0}, 90.0),
    ("pose_solve_ms", {"tracking": 2000.0, "track.dispatch": 1800.0}, None),
    ("orb_detect_ms", STAGES, 60.0),
    ("orb_detect_ms", {"frame_build": 1500.0}, None),
    ("stereo_sad_ms", STAGES, 9.0),
    ("stereo_sad_ms", {"frame_build": 1500.0}, None),
])
def test_window_ms_per_frame(name, stages, want):
    ctx = dict(frames=10, stages=stages, track_stage_ms={}, local_ba=0, trace=None)
    got = reader(name).read(ctx)
    assert got == (None if want is None else pytest.approx(want))


def test_readers_import_nothing_of_the_program():
    for name in ("pose_solve_ms", "orb_detect_ms", "stereo_sad_ms"):
        src = open(os.path.join(HERE, "layers", name + ".py")).read()
        assert "import" not in src, name
