"""The mapper's schedule does not follow its readbacks (ROADMAP.md queue 3
item r): with no readback ever reporting that it landed, a keyframe maps
in a fixed number of frames. On the CPU each of its three apply halves
(triangulation, fuse, local BA) defers exactly one frame, the JAX
package's CPU rule, so it maps in four; on a card each waits for its
readback in the frame of its dispatch, so it maps in one.
The card's schedule is forced here on the CPU through the mapper's
``_defer`` flag. When the card polled its readbacks instead, this count
followed the host's load, and so did whether a thin frame found the
mapper behind.
"""

import pytest
import torch

from c_orb_slam_tpu_torch import config as tcfg
from c_orb_slam_tpu_torch.system import System
from c_orb_slam_tpu_torch.utils import host

from synthetic import blob_world, render_depth, render_scene, smooth_trajectory

torch.set_num_threads(1)


@pytest.mark.parametrize("defer, frames", [(True, 4), (False, 1)])
def test_a_keyframe_maps_in_a_fixed_number_of_frames(defer, frames, monkeypatch):
    monkeypatch.setattr(host.Fetch, "done", lambda self: False)
    cam = tcfg.CameraConfig(fx=250, fy=250, cx=160, cy=120, width=320, height=240, fps=10,
                            bf=50.0)
    cfg = tcfg.SlamConfig(sensor=tcfg.Sensor.RGBD, camera=cam,
                          orb=tcfg.OrbConfig(n_features=400, n_levels=4),
                          tracking=tcfg.TrackingConfig(min_stereo_init_points=60,
                                                       max_frames_between_kf=2))
    xw, inten, size = blob_world(400, seed=5)
    K4 = (250.0, 250.0, 160.0, 120.0)
    sysm = System(cfg, torch.device("cpu"), enable_loop_closing=False)
    for i, T in enumerate(smooth_trajectory(10, speed=1.0)):
        sysm.track_rgbd(render_scene(xw, inten, size, T, K4, h=240, w=320),
                        render_depth(xw, size, T, K4, h=240, w=320), i * 0.1)
    sysm.local_mapping.drain()
    live = sysm.map.live_keyframes()
    assert len(live) >= 3  # a local BA runs, and triangulation has neighbours
    k = int(live[sysm.map.kf_serial[live].argmax()])
    mapper = sysm.local_mapping
    assert mapper._defer  # the CPU's own schedule
    mapper._defer = defer
    mapper.insert_keyframe(k)
    steps = 0
    while not mapper.idle():
        mapper.step()
        steps += 1
        assert steps <= 10
    assert steps == frames
