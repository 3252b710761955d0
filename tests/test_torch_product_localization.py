"""Localization from a saved map, across the packages, on the CPU.

One short RGB-D run shared by the module: both Systems (loop closing on,
the shipped vocabulary) map the first 20 frames of a 320x240 rendering of
tests/synthetic.py's blob world (fx = 250, 400 features, 4 levels), the
JAX one in a second thread, and each saves its map. Then:

- each package starts from the OTHER's saved map with from_saved_map,
  relocalizes on the first frame and tracks frames 14-19 (inside the
  mapped region) in localization mode; neither grows the map; camera
  centres agree with the run that made the map within 0.05 m (the gate of
  tests/test_checkpoint.py: the same map, so the same frame);
- the port goes on past the mapped region (frames 20-43): it enters VO
  mode (fewer than 10 map matches, the pose carried by the last frame's
  depth points) and tracks every frame within 0.05 m of the ground truth;
  the JAX package, past the same region, is LOST on the frame after it
  enters VO mode (ROADMAP.md queue 3 item l: its dispatch gate counts map
  matches only);
- with loop closing off, the port relocalizes into its own saved map from
  the 10 newest keyframes (no BoW index);
- reset() and from_saved_map() re-wire the pipeline (tests/test_reset.py);
- the viz drawers draw the shared run, FrameDrawer equal to the JAX one on
  the same keypoints and map, and the AR plane fit and cube overlay equal
  to the JAX ones.
"""

import threading

import numpy as np
import pytest
import torch

from c_orb_slam_tpu import config as jcfg
from c_orb_slam_tpu.system import System as JaxSystem
from c_orb_slam_tpu.tracking import TrackState as JaxTrackState
from c_orb_slam_tpu.viz import FrameDrawer as JaxFrameDrawer, ar as jar
from c_orb_slam_tpu_torch import config as tcfg
from c_orb_slam_tpu_torch.system import System as TorchSystem
from c_orb_slam_tpu_torch.tracking import TrackState
from c_orb_slam_tpu_torch.utils.host import fetch
from c_orb_slam_tpu_torch.viz import FrameDrawer, MapDrawer, Viewer, ar

from synthetic import blob_world, render_depth, render_scene, smooth_trajectory
from test_torch_product_track import K4, H, W, small_cfg

torch.set_num_threads(1)
CPU = torch.device("cpu")
N_MAP, N_ALL = 20, 44
OVERLAP = range(14, N_MAP)


def _centre(T):
    return -T[:, :3].T @ T[:, 3]


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    d = tmp_path_factory.mktemp("maps")
    xw, inten, size = blob_world(400, seed=5)
    traj = smooth_trajectory(N_ALL)
    frames = [(render_scene(xw, inten, size, T, K4, h=H, w=W),
               render_depth(xw, size, T, K4, h=H, w=W)) for T in traj]
    paths = {"jax": str(d / "jax_map.npz"), "port": str(d / "port_map.npz")}
    systems = {"jax": JaxSystem(small_cfg(jcfg)), "port": TorchSystem(small_cfg(tcfg), CPU)}
    errors = []

    def map_run(side):
        try:
            sysm = systems[side]
            for i in range(N_MAP):
                sysm.track_rgbd(frames[i][0], frames[i][1], i * 0.1)
            sysm.save_map(paths[side])  # drains every pipeline first
        except BaseException as e:  # re-raised in the main thread
            errors.append(e)

    jax_thread = threading.Thread(target=map_run, args=("jax",))
    jax_thread.start()
    map_run("port")
    jax_thread.join(timeout=900)
    assert not jax_thread.is_alive(), "the JAX mapping run did not finish"
    if errors:
        raise errors[0]
    refs = {}
    for side, sysm in systems.items():
        poses, stamps = sysm.frame_poses()
        assert len(poses) == N_MAP, f"{side} mapped only {len(poses)}/{N_MAP} frames"
        refs[side] = {int(round(t * 10)): p for t, p in zip(stamps, poses)}
    return dict(traj=traj, frames=frames, paths=paths, systems=systems, refs=refs)


def _localize(sysm, frames, ids):
    """Track frames `ids`; per frame (pose or None, VO mode, map matches)."""
    out = {}
    for i in ids:
        pose = sysm.track_rgbd(frames[i][0], frames[i][1], i * 0.1)
        out[i] = (pose, sysm.tracker._vo_mode, int((sysm.tracker.last_mp >= 0).sum()))
    return out


def _map_size(sysm):
    return len(sysm.map.live_keyframes()), int(sysm.map.pt_valid.sum())


def _assert_matches_mapping_run(run, ref):
    assert run[OVERLAP[0]][0] is not None, "no relocalization on the first frame"
    ok = [i for i in OVERLAP if run[i][0] is not None]
    assert len(ok) >= len(OVERLAP) - 1, f"tracked only {len(ok)}/{len(OVERLAP)} mapped frames"
    for i in ok:
        gap = np.linalg.norm(_centre(run[i][0]) - _centre(ref[i]))
        assert gap < 0.05, (i, gap)


def test_port_localizes_in_jax_map_and_enters_vo_mode(shared):
    loc = TorchSystem.from_saved_map(shared["paths"]["jax"], small_cfg(tcfg), CPU)
    size0 = _map_size(loc)
    run = _localize(loc, shared["frames"], range(OVERLAP[0], N_ALL))
    assert loc.tracker.last_reloc_frame_id == 0  # the first frame relocalized
    _assert_matches_mapping_run(run, shared["refs"]["jax"])
    assert _map_size(loc) == size0, "localization mode grew the map"
    assert loc.tracked_map_points().shape[1] == 3
    assert loc.tracked_keypoints().shape[1] == 2
    past = range(N_MAP, N_ALL)
    vo = [i for i in past if run[i][1]]
    assert len(vo) >= 5, f"VO mode on frames {vo} only; map matches {[run[i][2] for i in past]}"
    lost = [i for i in past if run[i][0] is None]
    assert not lost, f"lost frames {lost} past the mapped region"
    err = max(np.linalg.norm(_centre(run[i][0]) - _centre(shared["traj"][i])) for i in past)
    assert err < 0.05, f"camera centre {err:.4f} m from the ground truth past the map"
    assert loc.tracking_state() == TrackState.OK
    loc.deactivate_localization_mode()
    assert not loc.localization_only and not loc.tracker.only_tracking


def test_jax_localizes_in_port_map(shared):
    loc = JaxSystem.from_saved_map(shared["paths"]["port"], small_cfg(jcfg))
    size0 = _map_size(loc)
    run = _localize(loc, shared["frames"], OVERLAP)
    _assert_matches_mapping_run(run, shared["refs"]["port"])
    assert _map_size(loc) == size0, "localization mode grew the map"
    # Past the map the JAX package enters VO mode and is LOST on the next
    # frame (ROADMAP.md queue 3 item l): its dispatch gate counts the last
    # frame's map matches only, and VO mode starts when they fall below
    # the same 10. The port counts the VO rows too and tracks every frame
    # past the map (test_port_localizes_in_jax_map_and_enters_vo_mode).
    first_vo = None
    for i in range(N_MAP, N_ALL):
        run.update(_localize(loc, shared["frames"], [i]))
        if first_vo is None and run[i][1]:
            first_vo = i
            assert run[i][0] is not None and run[i][2] < 10, run[i]
        elif first_vo is not None:
            break
    assert first_vo is not None, f"no VO mode; map matches {[run[i][2] for i in run]}"
    assert run[first_vo + 1][0] is None, "the JAX package tracked the frame after VO mode began"
    assert loc.tracking_state() == JaxTrackState.LOST


def test_port_relocalizes_with_loop_closing_off(shared):
    loc = TorchSystem.from_saved_map(shared["paths"]["port"], small_cfg(tcfg), CPU,
                                     enable_loop_closing=False)
    assert loc.loop_closing is None and loc.tracker.state == TrackState.LOST
    size0 = _map_size(loc)
    run = _localize(loc, shared["frames"], OVERLAP)
    _assert_matches_mapping_run(run, shared["refs"]["port"])
    assert _map_size(loc) == size0


def _assert_wired(sysm):
    assert sysm.tracker.mapper is sysm.local_mapping
    assert sysm.local_mapping.on_keyframe_done is not None
    assert sysm.tracker.reloc_provider is sysm.loop_closing
    assert sysm.loop_closing.on_pose_correction is not None
    assert sysm.loop_closing.on_before_correction == sysm.tracker.flush_pending


def test_reset_and_from_saved_map_rewire(shared):
    loaded = TorchSystem.from_saved_map(shared["paths"]["jax"], small_cfg(tcfg), CPU,
                                        localization_only=False)
    _assert_wired(loaded)
    assert not loaded.localization_only
    # The BoW index holds every loaded keyframe.
    live = loaded.map.live_keyframes()
    assert loaded.loop_closing.db.valid[live].all()
    loaded.reset()
    _assert_wired(loaded)
    fed = []
    loaded.loop_closing.process_keyframe = fed.append
    loaded.local_mapping.on_keyframe_done(7)
    assert fed == [7]


def test_viz_draws_the_shared_run(shared, tmp_path):
    j_sys = shared["systems"]["jax"]
    loc = TorchSystem.from_saved_map(shared["paths"]["jax"], small_cfg(tcfg), CPU)
    _localize(loc, shared["frames"], OVERLAP)
    image = shared["frames"][OVERLAP[-1]][0]
    xy, mp = fetch(loc.tracker.last_frame.xy), loc.tracker.last_mp
    assert (mp >= 0).sum() > 50
    drawn = []
    for drawer in (FrameDrawer(loc), JaxFrameDrawer(j_sys)):
        drawer.update(image, frame_xy=xy, cur_mp=mp)
        drawn.append(drawer.draw_frame())
    assert drawn[0].shape == (H + 22, W, 3) and drawn[0].dtype == np.uint8
    # Same keypoints on the same map: the same frame (status bars differ:
    # LOCALIZATION against SLAM).
    np.testing.assert_array_equal(drawn[0][:H], drawn[1][:H])
    assert (drawn[0][:H, :, 1].astype(int) - drawn[0][:H, :, 0].astype(int) > 100).any()
    fd = FrameDrawer(loc)
    fd.update(image)  # the tracker's own last frame, fetched from the device
    assert fd.draw_frame().shape == drawn[0].shape
    out = tmp_path / "map.png"
    MapDrawer(loc).save(str(out), mode="xz", current_pose=loc.tracker.last_pose)
    assert out.stat().st_size > 1000
    v = Viewer(loc, str(tmp_path / "report"), every_n=2)
    for i in OVERLAP[-3:]:
        v.update(shared["frames"][i][0])
    v.finish()
    assert (tmp_path / "report" / "index.html").exists()
    assert (tmp_path / "report" / "trajectory.png").exists()

    # AR: the plane fit over the shared map's points and over a wall of
    # them, and the cube overlay under the tracked pose, equal to the JAX
    # package's.
    pts = loc.map.pt_xyz[loc.map.pt_valid]
    wall = pts.copy()
    wall[: int(0.7 * len(wall)), 2] = 6.0
    for xyz in (pts, wall):
        t_res, j_res = ar.detect_plane(xyz, seed=1), jar.detect_plane(xyz, seed=1)
        assert (t_res is None) == (j_res is None)
        if t_res is not None:
            for a, b in zip(t_res, j_res):
                np.testing.assert_array_equal(a, b)
    origin, normal, inl = ar.detect_plane(wall, seed=1)
    assert abs(abs(normal[2]) - 1.0) < 1e-3 and inl.mean() > 0.6
    T_wp = ar.plane_basis(origin, normal)
    K4a = np.asarray(K4)
    rgb = np.zeros((H, W, 3), np.uint8)
    t_img = ar.draw_cube_overlay(rgb, loc.tracker.last_pose, K4a, T_wp, size=0.5)
    np.testing.assert_array_equal(
        t_img, jar.draw_cube_overlay(rgb, loc.tracker.last_pose, K4a, T_wp, size=0.5))
    assert (t_img[..., 0] == 255).any()
