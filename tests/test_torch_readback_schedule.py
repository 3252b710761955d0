"""One readback schedule on every device (ROADMAP.md queue 3 item h): the
tracker and the loop closer take each readback at the first poll after its
dispatch and wait for it, whether or not ``Fetch.done()`` says it landed.

The card's setting is forced here on the CPU: ``Fetch.done()`` always
reports a readback in flight, as the JAX package's accelerator setting
(pipeline depth 3) is given in the configuration. The run must then apply
every in-flight frame at the next ``track()`` (lag 1), leave no detection
pending after a frame, and give the trajectory that the CPU's own setting
gives, bit for bit. When the card polled ``done()`` instead, the lag and the
detection's frame followed the host's load, and so did the trajectory.
"""

import collections

import pytest
import torch

from c_orb_slam_tpu_torch import config as tcfg
from c_orb_slam_tpu_torch.loop_closing import LoopClosing
from c_orb_slam_tpu_torch.system import System
from c_orb_slam_tpu_torch.io.trajectory import sha256
from c_orb_slam_tpu_torch.utils import host

from synthetic import blob_world, render_depth, render_scene, smooth_trajectory

torch.set_num_threads(1)

K4 = (250.0, 250.0, 160.0, 120.0)


def _run(depth: int):
    """12 RGB-D frames at 320x240 with loop closing on; the apply lag of
    every in-flight frame, the frames that ended with a detection still
    pending, the detections dispatched, and the trajectory."""
    cam = tcfg.CameraConfig(fx=250, fy=250, cx=160, cy=120, width=320, height=240, fps=10,
                            bf=50.0)
    cfg = tcfg.SlamConfig(sensor=tcfg.Sensor.RGBD, camera=cam,
                          orb=tcfg.OrbConfig(n_features=400, n_levels=4),
                          tracking=tcfg.TrackingConfig(min_stereo_init_points=60,
                                                       max_frames_between_kf=2,
                                                       pipeline_depth=depth))
    xw, inten, size = blob_world(400, seed=5)
    sysm = System(cfg, torch.device("cpu"))
    lags, held, dispatched = collections.Counter(), 0, 0
    tracker, loop = sysm.tracker, sysm.loop_closing
    at = {}  # in-flight frame -> the frame of its dispatch
    for i, T in enumerate(smooth_trajectory(12, speed=1.0)):
        n_disp = loop.n_dispatched
        sysm.track_rgbd(render_scene(xw, inten, size, T, K4, h=240, w=320),
                        render_depth(xw, size, T, K4, h=240, w=320), i * 0.1)
        now = {id(p[0]) for p in tracker._pending}
        for f in [f for f in at if f not in now]:
            lags[i - at.pop(f)] += 1
        for f in now:
            at.setdefault(f, i)
        held += loop._pending_detect is not None
        dispatched += loop.n_dispatched - n_disp
    return lags, held, dispatched, sha256(*sysm.frame_poses())


@pytest.fixture
def counted(monkeypatch):
    """Count LoopClosing._dispatch calls (detections scored)."""
    dispatch = LoopClosing._dispatch

    def counting(self, kf):
        self.n_dispatched += 1
        return dispatch(self, kf)

    monkeypatch.setattr(LoopClosing, "n_dispatched", 0, raising=False)
    monkeypatch.setattr(LoopClosing, "_dispatch", counting)


def test_the_cards_schedule_is_the_cpus(counted, monkeypatch):
    lags_cpu, held_cpu, disp_cpu, sha_cpu = _run(depth=1)
    monkeypatch.setattr(host.Fetch, "done", lambda self: False)
    lags, held, disp, sha = _run(depth=3)
    assert set(lags) == {1} and sum(lags.values()) >= 5  # steady frames, each applied next frame
    assert lags == lags_cpu
    assert disp >= 2 and held == 0  # every detection applied in the frame of its dispatch
    assert (held_cpu, disp_cpu) == (held, disp)
    assert sha == sha_cpu

