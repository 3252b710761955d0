"""The mixes stay in range over the largest frame supply, move at their
published pace, and the seed alone makes their inputs."""

import json
import math
import os

import numpy as np
import pytest

from slambench import harness, reference
from slambench.traffic import corridor

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 2**31 + 12345
# (mix, sensor rate): each mix at the rate of the cell that runs it.
MIXES = [("survey", 10.0), ("explore", 30.0), ("drive", 10.0)]


def load(name):
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def yaw_of(P):
    return np.arctan2(P[:, 2, 0], P[:, 0, 0])  # R_cw[2, 0] = sin(yaw)


@pytest.mark.parametrize("name,rate", MIXES)
def test_mix_in_range_over_full_supply(name, rate):
    mix = load(name)
    w, p = mix["world"], mix["path"]
    n = harness.frame_budget(mix, rate, 51, trace=True)
    assert n >= mix["warmup_frames"] + 51 * rate
    g = corridor.generate(SEED, mix, n, rate)
    P = g["poses"].astype(np.float64)
    c = reference.centers(P)
    along, cross = corridor.axes(w["track_deg"])
    a, x = c @ along, c @ cross
    step = corridor.pace(mix, rate)
    assert np.allclose(np.diff(a), step["m_per_frame"], atol=1e-4)
    assert x.min() >= p["cross_m"][0] - 1e-4 and x.max() <= p["cross_m"][1] + 1e-4
    assert np.abs(c[:, 1]).max() <= p["wobble_y_m"] + 1e-6
    # The published pace: the mean speed, and the mean turn where the yaw is a sine.
    speed = np.linalg.norm(np.diff(c, axis=0), axis=1).mean() * rate
    assert math.isclose(speed, mix["speed_m_s"], rel_tol=0.02)
    yaw = yaw_of(P)
    if p["yaw"] == "sine":
        lo, hi = p["yaw_rad"]
        assert yaw.min() >= lo - 1e-5 and yaw.max() <= hi + 1e-5
        whole = int(step["yaw_period"] * (n // step["yaw_period"]))  # whole periods
        turn = np.degrees(np.abs(np.diff(yaw[:whole + 1])).mean()) * rate
        assert math.isclose(turn, mix["angular_deg_s"], rel_tol=0.03)
    else:  # the heading follows the track
        v = np.diff(c, axis=0)
        assert np.allclose(yaw[:-1], np.arctan2(v[:, 0], v[:, 2]), atol=2e-3)
    # The world reaches its margins beyond both ends at its density.
    wa = g["xw"].astype(np.float64) @ along
    assert wa.min() >= -w["behind_m"] - 1e-3 and wa.max() <= a[-1] + w["ahead_m"] + 1e-3
    assert math.isclose(len(wa) / (a[-1] + w["behind_m"] + w["ahead_m"]), w["blobs_per_m"],
                        rel_tol=0.01)
    # Every frame looks at the corridor: many blobs in view, none inside
    # the renderer's near plane in front of the camera.
    for f in (0, n // 2, n - 1):
        xc = g["xw"] @ P[f, :, :3].T + P[f, :, 3]
        front = xc[:, 2] > 0
        inside = front & (np.abs(xc[:, 0]) < xc[:, 2]) & (np.abs(xc[:, 1]) < xc[:, 2])
        assert inside.sum() > 100
        if p["yaw"] == "sine":  # a panning camera: nothing inside the near plane
            assert xc[inside, 2].min() > 1.2


@pytest.mark.parametrize("name,rate", MIXES)
def test_seed_makes_the_inputs(name, rate):
    mix = load(name)
    a = corridor.generate(SEED, mix, 50, rate)
    b = corridor.generate(SEED, mix, 50, rate)
    c = corridor.generate(SEED + 1, mix, 50, rate)
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert not np.array_equal(a["xw"], c["xw"])
    assert not np.array_equal(a["poses"], c["poses"])  # the phases of the sines
