"""The torch renderer against the frozen numpy copy of the test suite's."""

import json
import os

import numpy as np
import pytest
import torch

from slambench import render, render_np
from slambench.traffic import corridor

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def world():
    with open(os.path.join(HERE, "traffic", "explore.json")) as f:
        mix = json.load(f)
    return corridor.generate(2**31 + 99, mix, 120, 30.0)


@pytest.mark.parametrize("frame", [0, 41, 119])
@pytest.mark.parametrize("baseline", [None, 0.3])
def test_render_equals_numpy(world, frame, baseline):
    K4, h, w = (259.0, 258.2, 159.3, 127.6), 240, 320
    T = world["poses"][frame]
    wd = {k: torch.as_tensor(world[k]) for k in ("xw", "intensity", "size", "tiles")}
    Tt = torch.as_tensor(T)
    if baseline is not None:
        Tt = render.right_pose(Tt, baseline)
        T = Tt.numpy()
    got = render.render(wd, Tt, K4, h, w).numpy()
    want = render_np.render_scene(world["xw"], world["intensity"], world["size"],
                                  world["tiles"], T, K4, h=h, w=w)
    assert np.array_equal(got, want)
    assert (want != render.BG).mean() > 0.05  # the view holds blobs, not only background


def test_render_sequence_is_uint8_on_host(world):
    frames = render.render_sequence(world, world["poses"][:3], (259.0, 258.2, 159.3, 127.6),
                                    240, 320, torch.device("cpu"), baseline=0.3)
    assert frames.shape == (3, 2, 240, 320) and frames.dtype == np.uint8
    assert not np.array_equal(frames[0, 0], frames[0, 1])
