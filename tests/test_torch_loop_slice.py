"""The loop path end to end through both packages on the CPU: the
240-frame outward-facing orbit of tests/e2e_loop_debug.py (1400 blobs),
which revisits its start sector after frame 200, from the same rendered
frames, with loop closing on and each package's own copy of the shipped
vocabulary. One sensor per file, so that the two runs go to different
test processes: stereo (fixed scale) here, monocular (free scale) in
tests/test_torch_loop_slice_mono.py. Each file runs its orbit once.

Size: half the orbit's resolution (320x240, fx = fy = 250), its 800
features and 4 levels. 240 frames cannot be cut (the loop closes after
frame 200); half resolution is the smallest size at which both packages
were seen to close the loop for both sensors, and a quarter of the
pixels to render and extract.

The RANSAC streams of the two packages cannot match, so the runs are
held on outcomes, with the gates of tests/test_e2e_loop.py: more than
90% of the frames tracked, a loop closed, the background global BA
applied, ATE under 0.4 m, and the port's ATE within a factor 4 of the
JAX run's or under 0.1 m (one seed's ATE spreads several-fold on either
side: the JAX package's own record is 0.04-0.25 m).
"""

from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

import e2e_loop_debug
from c_orb_slam_tpu import config as jcfg
from c_orb_slam_tpu.io import trajectory as jtraj
from c_orb_slam_tpu.system import System as JaxSystem
from c_orb_slam_tpu_torch import config as tcfg
from c_orb_slam_tpu_torch.io import trajectory as ttraj
from c_orb_slam_tpu_torch.system import System as TorchSystem

from synthetic import render_scene, render_stereo_pair

N_FRAMES = 240
SCALE = 0.5

# One intra-op thread: the test processes run side by side.
torch.set_num_threads(1)


def _cfg(mod, mono):
    """tests/e2e_loop_debug.py's configuration at SCALE."""
    cam = mod.CameraConfig(
        fx=500 * SCALE, fy=500 * SCALE, cx=320 * SCALE, cy=240 * SCALE,
        width=int(640 * SCALE), height=int(480 * SCALE), fps=10,
        bf=0.0 if mono else 500.0 * SCALE * e2e_loop_debug.BASELINE,
    )
    return mod.SlamConfig(
        sensor=mod.Sensor.MONOCULAR if mono else mod.Sensor.STEREO,
        camera=cam,
        orb=mod.OrbConfig(n_features=800, n_levels=4),
        tracking=mod.TrackingConfig(
            min_stereo_init_points=60, velocity_rotation_fraction=0.5,
            max_frames_between_kf=10,
        ),
        # Half the default local-BA window (32 keyframes, 8192 points,
        # 16384 observations): the dense Schur solve of the full window is
        # most of a CPU run's time, and grows with (6C)^2 * 3P.
        capacity=mod.CapacityConfig(
            local_ba_max_kfs=16, local_ba_max_points=4096, local_ba_max_obs=8192,
        ),
    )


def _frames(mono):
    cam = _cfg(tcfg, mono).camera
    K4 = (cam.fx, cam.fy, cam.cx, cam.cy)
    xw, inten, size = e2e_loop_debug.orbit_world(n=1400, seed=7)
    traj = e2e_loop_debug.orbit_trajectory(N_FRAMES)
    h, w = cam.height, cam.width
    if mono:
        return traj, [render_scene(xw, inten, size, T, K4, h=h, w=w) for T in traj]
    return traj, [
        render_stereo_pair(xw, inten, size, T, K4, e2e_loop_debug.BASELINE, h=h, w=w)
        for T in traj
    ]


def _run(sysm, frames, traj, traj_io, mono):
    lc = sysm.loop_closing
    loop_at = gba_at = None
    for i, fr in enumerate(frames):
        if mono:
            sysm.track_monocular(fr, i * 0.1)
        else:
            sysm.track_stereo(fr[0], fr[1], i * 0.1)
        if loop_at is None and lc.n_loops_closed:
            loop_at = i
        if gba_at is None and lc.n_gba_applied:
            gba_at = i
    sysm.shutdown()
    poses, stamps = sysm.frame_poses()
    ids = [int(round(t * 10)) for t in stamps]
    return dict(
        n_ok=len(poses), ate=traj_io.ate_rmse(poses, traj[ids], with_scale=mono),
        loops=lc.n_loops_closed, gba=lc.n_gba_applied, loop_at=loop_at, gba_at=gba_at,
        idle=lc.idle(), paused=sysm.local_mapping.paused,
    )


def run_both(mono):
    """The orbit through the JAX System and through the port's, side by
    side: the JAX run in a second thread (each system is driven by one
    thread only, and both spend their time outside the interpreter lock),
    the port's in this one, where torch.set_num_threads applies."""
    traj, frames = _frames(mono)
    with ThreadPoolExecutor(1) as pool:
        j = pool.submit(_run, JaxSystem(_cfg(jcfg, mono)), frames, traj, jtraj, mono)
        t_sys = TorchSystem(_cfg(tcfg, mono), torch.device("cpu"), enable_loop_closing=True)
        n_words = t_sys.loop_closing.voc.n_words
        t = _run(t_sys, frames, traj, ttraj, mono)
        return dict(jax=j.result(), torch=t, n_words=n_words)


class OrbitChecks:
    """One orbit run per class (both packages), held by three tests."""

    mono = False

    @pytest.fixture(scope="class")
    def runs(self, request):
        return run_both(request.cls.mono)

    def test_port_closes_the_loop_within_the_gates(self, runs):
        """The gates of tests/test_e2e_loop.py on the port's run, with its
        own copy of the shipped vocabulary, and the loop closed on the
        return to the start sector, not before."""
        t = runs["torch"]
        assert runs["n_words"] == 10**5
        assert t["n_ok"] > 0.9 * N_FRAMES, f"tracked only {t['n_ok']}/{N_FRAMES}: {t}"
        assert t["loops"] >= 1, t
        assert t["loop_at"] >= 195, t
        assert t["gba"] >= 1, t
        assert t["ate"] < 0.4, t

    def test_port_spreads_the_correction_and_ends_idle(self, runs):
        """Applied during the run, the global BA lands well after the loop
        event: one chunk of the correction and of the solve per frame.
        (Near the sequence's end it lands in the shutdown drain instead.)
        Nothing is left in flight and the mapper is released."""
        t = runs["torch"]
        assert t["gba_at"] is None or t["gba_at"] - t["loop_at"] >= 5, t
        assert t["idle"] and not t["paused"], t

    def test_port_against_the_jax_run(self, runs):
        """The JAX package passes the same gates on the same frames, and
        the port's ATE is within a factor 4 of its ATE, or under 0.1 m."""
        t, j = runs["torch"], runs["jax"]
        assert j["n_ok"] > 0.9 * N_FRAMES and j["loops"] >= 1 and j["gba"] >= 1, j
        assert j["ate"] < 0.4, j
        assert t["ate"] < max(4.0 * j["ate"], 0.1), (t, j)


class TestStereoOrbit(OrbitChecks):
    mono = False
