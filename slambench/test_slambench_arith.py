"""The metrics' arithmetic on made-up records: the percentile, the union of
kernel intervals, the launch count and the idle time by host stage."""

import math

import numpy as np
import pytest

from slambench import harness, readings, reference, trace

# A 10 Hz camera (10 frames to a second) with TUM1's pinhole and pyramid.
SETTINGS = {"Camera.fps": 10.0, "Camera.fx": 517.3, "Camera.fy": 516.5, "Camera.cx": 318.6,
            "Camera.cy": 255.3, "ORBextractor.scaleFactor": 1.2}


def test_p90_nearest_rank():
    assert harness.p90(range(1, 101)) == 90
    assert harness.p90([5.0]) == 5.0
    assert harness.p90(list(range(10, 0, -1))) == 9
    assert harness.p90(range(1, 12)) == 10  # ceil(9.9) = 10th of 11


def test_union_and_merge():
    iv = [(0, 10), (5, 12), (20, 25), (25, 26), (30, 31)]
    assert trace.union_us(iv) == 12 + 6 + 1
    assert trace.merged(iv) == [[0, 12], [20, 26], [30, 31]]
    assert trace.union_us([]) == 0.0


def test_launches_and_top_ops():
    host = [("cudaLaunchKernel", 0, 1)] * 5 + [("cudaGraphLaunch", 2, 3),
                                               ("cudaMemcpyAsync", 3, 4), ("aten::add", 0, 9)]
    assert trace.launches(host) == 6
    k = [("a", 0, 2e6), ("b", 0, 1e6), ("a", 3e6, 4e6)]
    assert trace.top_ops(k) == [["a", 3.0], ["b", 1.0]]
    dev = k + [("Memcpy HtoD", 0, 1), ("stage:tracking", 0, 9e6)]
    assert trace.kernels_of(dev) == k


def test_idle_by_stage():
    kernels = [("k", 10, 20), ("k", 40, 50)]
    host = [("stage:tracking", 0, 45), ("stage:map.ba", 25, 35), ("stage:loop", 55, 100),
            ("aten::mm", 0, 100)]
    got = dict(trace.idle_by_stage(kernels, host, (0, 100)))
    # gaps: [0,10] tracking, [20,40] map.ba (inner), [50,100] mid 75 loop
    assert got == pytest.approx({"tracking": 10e-6, "map.ba": 20e-6, "loop": 50e-6})
    got = dict(trace.idle_by_stage(kernels, [], (0, 100)))
    assert got == pytest.approx({trace.OUTSIDE: 80e-6})


def test_off_surface_blocks():
    rng = np.random.default_rng(1)
    xw = np.c_[rng.uniform(0, 200, 3000), rng.uniform(-3, 3, 3000), rng.uniform(3, 9, 3000)]
    size = rng.uniform(0.05, 0.3, 3000)
    pts = np.r_[xw[:700] + rng.normal(0, 0.05, (700, 3)), rng.uniform(-10, 210, (900, 3))]
    d = np.sqrt(((pts[:, None] - xw[None]) ** 2).sum(-1)) - math.sqrt(2) * size[None]
    got = readings.off_surface(pts, xw, size, block=128)
    assert np.array_equal(got, d.min(axis=1) > 0)
    assert 0 < got.mean() < 1


def test_reference_alignment_and_readings():
    rng = np.random.default_rng(0)
    n = 40
    gt = np.zeros((n, 3, 4))
    gt[:, :, :3] = np.eye(3)
    gt[:, :, 3] = -np.c_[np.arange(n) * 0.06, 0.02 * np.sin(np.arange(n)), np.zeros(n)]
    world = dict(xw=rng.uniform(-1, 3, (50, 3)), size=np.full(50, 0.1))
    # A similarity away from the truth: the monocular gauge.
    s, ang = 0.37, 0.3
    R = np.array([[math.cos(ang), -math.sin(ang), 0], [math.sin(ang), math.cos(ang), 0],
                  [0, 0, 1]])
    t = np.array([1.0, -2.0, 0.5])
    c_gt = reference.centers(gt)
    c_est = (c_gt - t) @ R / s  # gt = s R est + t
    est = np.zeros_like(gt)
    est[:, :, :3] = R  # R_est = R_gt R
    est[:, :, 3] = -c_est @ R.T
    answers = {i: (est[i], True, 0.0) for i in range(n)}
    pts = (world["xw"][:10] - t) @ R / s
    v = reference.readings(answers, list(range(n)), gt, 0, rigid=False, settings=SETTINGS,
                           final_map=exact_map(), ba_map=exact_map())
    assert v["ate_m"] < 1e-9
    assert v["ba_gap"] < 1e-12 and v["ba_move_rel"] < 1e-9 and v["ba_window"]["free"] == 2
    # The readings' diagnostics from the same answers, as a detail record.
    detail = dict(tracked=[True] * n, judged=list(range(n)),
                  poses=[est[i].ravel().tolist() for i in range(n)],
                  map_xyz=pts.ravel().tolist())
    diag = readings.diagnostics(detail, dict(world, poses=gt), rigid=False, final_map=exact_map(),
                                settings=SETTINGS)
    assert diag["ate_max_m"] < 1e-9 and diag["map_off_share"] == 0.0
    assert diag["reproj_max"] < 1e-9 and diag["reproj_n"] == 4 * 59
    assert diag["rot_err_deg"] < 1e-6 and diag["scale_drift"] < 1e-9
    assert v["unresolved"] == 0 and v["lost"] == 0
    v = reference.readings(answers, list(range(n)), gt, 0, rigid=True, settings=SETTINGS,
                           final_map=exact_map(), ba_map=None)
    assert v["ate_m"] > 0.1  # a stereo rig owes the metric scale
    assert v["ba_gap"] == v["ba_move_rel"] == math.inf and v["ba_window"] is None
    del answers[3]
    answers[4] = (est[4], False, 0.0)
    v = reference.readings(answers, list(range(n + 2)), gt, 1, rigid=False, settings=SETTINGS,
                           final_map=exact_map(), ba_map=exact_map())
    assert (v["unresolved"], v["lost"], v["loops_closed"]) == (3, 1, 1)
    checks = reference.judge(v, dict(unresolved=0, lost=0, loops_closed=0, ate_m=0.05))
    assert [c[0] for c in checks if not c[3]] == ["unresolved", "lost", "loops_closed"]


def rot(axis: int, ang: float) -> np.ndarray:
    c, s = math.cos(ang), math.sin(ang)
    i, j = [a for a in range(3) if a != axis]
    R = np.eye(3)
    R[i, i], R[i, j], R[j, i], R[j, j] = c, -s, s, c
    return R


def path(n: int = 47) -> np.ndarray:
    """(n, 3, 4) world-to-camera poses: sideways at 0.25 m/s with a wobble,
    the camera yawing and pitching as it goes (10 frames a second)."""
    P = np.zeros((n, 3, 4))
    for f in range(n):
        R = rot(1, 0.3 * math.sin(0.2 * f)) @ rot(0, 0.05 * math.cos(0.3 * f))  # R_wc
        c = np.array([0.025 * f, 0.02 * math.sin(f), 0.1 * math.sin(0.05 * f)])
        P[f, :, :3], P[f, :, 3] = R.T, -R.T @ c
    return P


def exact_map(n_kf: int = 4, n_pts: int = 60, seed: int = 3):
    """A final map whose every observation projects exactly onto its
    keypoint: points 1.5-4.5 m in front of keyframes of `path`, seen by
    each keyframe at a random octave; one dead point, observed, and one
    empty keypoint slot, both left out."""
    rng = np.random.default_rng(seed)
    poses = path()[::10][:n_kf]
    Xw = np.c_[rng.uniform(-1, 2, n_pts), rng.uniform(-1, 1, n_pts), rng.uniform(1.5, 4.5, n_pts)]
    st = SETTINGS
    Xc = np.einsum("kij,nj->kni", poses[:, :, :3], Xw) + poses[:, None, :, 3]
    xy = np.stack([st["Camera.fx"] * Xc[..., 0] / Xc[..., 2] + st["Camera.cx"],
                   st["Camera.fy"] * Xc[..., 1] / Xc[..., 2] + st["Camera.cy"]], -1)
    mp = np.tile(np.arange(n_pts + 1), (n_kf, 1))
    mp[:, -1] = -1
    valid = np.ones(n_pts + 1, bool)
    valid[5] = False
    xy = np.concatenate([xy, np.zeros((n_kf, 1, 2))], 1)
    xy[:, 5] += 40.0  # the dead point's observations are far off, and not counted
    return dict(kf_pose=poses, kf_xy=xy,
                kf_octave=rng.integers(0, 8, (n_kf, n_pts + 1)), kf_mp=mp,
                kf_serial=np.arange(n_kf), kf_ur=np.full((n_kf, n_pts + 1), -1.0),
                pt_xyz=np.r_[Xw, np.zeros((1, 3))], pt_valid=valid)


def read(est, gt, rigid=False, final_map=None):
    answers = {i: (est[i], True, 0.0) for i in range(len(est))}
    return reference.readings(answers, list(range(len(est))), gt, 0, rigid=rigid,
                              settings=SETTINGS, final_map=final_map or exact_map(), ba_map=None)


def test_new_numbers_read_zero_on_the_exact_path():
    gt = path()
    v = read(gt.copy(), gt)
    assert v["ate_seg_m"] < 1e-12 and v["rpe_rot_deg"] < 1e-6
    assert v["reproj_px"] < 1e-9
    v = read(gt.copy(), gt, rigid=True)
    assert v["ate_seg_m"] < 1e-12


def test_segments_cut_by_seconds():
    assert reference.segments(43, 10) == [(0, 10), (10, 20), (20, 30), (30, 43)]
    assert reference.segments(47, 10) == [(0, 10), (10, 20), (20, 30), (30, 40), (40, 47)]
    assert reference.segments(45, 10) == [(0, 10), (10, 20), (20, 30), (30, 40), (40, 45)]
    assert reference.segments(4, 10) == [(0, 4)]


def test_scale_drift_leaves_the_segments():
    """A monocular path whose scale grows 5% a second: the whole window's
    one similarity sees it, each second's own does not."""
    gt = path()
    est = gt.copy()
    c = reference.centers(gt)
    scale = 1.05 ** (np.arange(len(gt)) / SETTINGS["Camera.fps"])
    # Each step between frames scaled by the scale of its own time.
    drifted = c[0] + np.r_[np.zeros((1, 3)), np.cumsum(np.diff(c, axis=0) * scale[1:, None], 0)]
    est[:, :, 3] = -np.einsum("fij,fj->fi", gt[:, :, :3], drifted)
    v = read(est, gt)
    assert v["ate_m"] > 0.01
    assert v["ate_seg_m"] < 0.1 * v["ate_m"] and v["ate_seg_m"] < 2e-3
    assert v["rpe_rot_deg"] < 1e-6  # rotations untouched


def test_segment_alignment_takes_the_roll_from_the_orientations():
    """A second of straight sideways motion, the estimate rolled about
    that line: the centres alone would align it perfectly, the whole
    poses do not."""
    n = 10
    gt = np.zeros((n, 3, 4))
    gt[:, :, :3] = np.eye(3)
    gt[:, :, 3] = -np.c_[0.025 * np.arange(n), np.zeros(n), np.zeros(n)]
    est = gt.copy()
    est[:, :, :3] = rot(0, 0.2)  # rolled about x, the line of motion; centres unchanged
    assert reference.ate_seg(est, gt, 10, rigid=False) < 1e-12
    # One frame off its line by 5 cm: the aligned centres keep the error.
    est[4, :, 3] -= est[4, :, :3] @ np.array([0.0, 0.05, 0.0])
    assert reference.ate_seg(est, gt, 10, rigid=True) > 0.01


@pytest.mark.parametrize("deg", [0.5, 3.0, 20.0])
def test_rotation_offset_reads_back(deg):
    """Frame 20's rotation off by `deg` about an axis: it is in the pairs
    (10, 20) and (20, 30), 2 of the 37 pairs a second apart."""
    gt = path()
    est = gt.copy()
    est[20, :, :3] = rot(2, math.radians(deg)) @ gt[20, :, :3]
    est[20, :, 3] = -est[20, :, :3] @ reference.centers(gt)[20]
    v = read(est, gt)
    pairs = len(gt) - 10
    assert v["rpe_rot_deg"] == pytest.approx(deg * math.sqrt(2 / pairs), rel=1e-9)
    assert v["ate_m"] < 1e-12  # the centres are untouched


@pytest.mark.parametrize("octave", [0, 1, 3, 7])
@pytest.mark.parametrize("d", [1.0, 2.5])
def test_reprojection_in_sigma_of_the_level(d, octave):
    """One observation shifted by d pixels at octave o reads back as
    d / 1.2**o over the observations' RMS."""
    m = exact_map()
    m["kf_octave"][2, 9] = octave
    m["kf_xy"][2, 9] += d * np.array([0.6, 0.8])
    n_obs = 4 * 59  # 4 keyframes, 60 points of which one is dead
    v = read(path(), path(), final_map=m)
    assert v["reproj_px"] == pytest.approx(d / 1.2 ** octave / math.sqrt(n_obs), rel=1e-6)
    # Alone, it reads d / 1.2**o itself.
    m["kf_mp"][:, :9] = -1
    m["kf_mp"][:, 10:] = -1
    m["kf_mp"][[0, 1, 3], 9] = -1
    v = read(path(), path(), final_map=m)
    assert v["reproj_px"] == pytest.approx(d / 1.2 ** octave, rel=1e-6)


# A stereo rig's bf for the BA window's tests (a 0.077 m baseline at TUM1's fx).
BA_SETTINGS = dict(SETTINGS, **{"Camera.bf": 40.0})


def noisy_map(stereo: bool, n_kf: int = 6, n_pts: int = 120, seed: int = 5, noise: float = 0.5):
    """A final map of `n_kf` keyframes along `path` seeing points 1.5-4.5 m
    deep, each keypoint `noise` px off its projection, 30% of them unseen,
    octaves 0-2; a stereo rig's right u too, as noisy."""
    rng = np.random.default_rng(seed)
    poses = path()[::4][:n_kf]
    Xw = np.c_[rng.uniform(-1, 2, n_pts), rng.uniform(-1, 1, n_pts), rng.uniform(1.5, 4.5, n_pts)]
    st = BA_SETTINGS
    Xc = np.einsum("kij,nj->kni", poses[:, :, :3], Xw) + poses[:, None, :, 3]
    xy = np.stack([st["Camera.fx"] * Xc[..., 0] / Xc[..., 2] + st["Camera.cx"],
                   st["Camera.fy"] * Xc[..., 1] / Xc[..., 2] + st["Camera.cy"]], -1)
    xy += rng.normal(0, noise, xy.shape)
    mp = np.tile(np.arange(n_pts), (n_kf, 1))
    mp[rng.random((n_kf, n_pts)) < 0.3] = -1
    ur = np.full((n_kf, n_pts), -1.0)
    if stereo:
        ur = xy[..., 0] - st["Camera.bf"] / Xc[..., 2] + rng.normal(0, noise, (n_kf, n_pts))
    return dict(kf_pose=poses, kf_xy=xy, kf_octave=rng.integers(0, 3, (n_kf, n_pts)), kf_mp=mp,
                kf_ur=ur, kf_serial=np.arange(n_kf), pt_xyz=Xw, pt_valid=np.ones(n_pts, bool))


def at_optimum(m: dict, stereo: bool) -> dict:
    """`m` with the window's poses and points at the reference's optimum."""
    sol = reference.ba_solve(m, BA_SETTINGS, monocular=not stereo)
    m = {k: np.array(v, copy=True) for k, v in m.items()}
    m["kf_pose"][sol["cams"]] = sol["T"]
    m["pt_xyz"][sol["points"]] = sol["X"]
    return m


def moved(m: dict, s: float, R: np.ndarray, t: np.ndarray) -> dict:
    """`m` under the similarity X -> s R X + t of its world."""
    m = dict(m)
    Rc = m["kf_pose"][:, :, :3] @ R.T
    m["kf_pose"] = np.concatenate(
        [Rc, (s * m["kf_pose"][:, :, 3] - np.einsum("kij,j->ki", Rc, t))[:, :, None]], 2)
    m["pt_xyz"] = s * m["pt_xyz"] @ R.T + t
    return m


def ba(m: dict, stereo: bool) -> dict:
    return reference.local_ba(m, BA_SETTINGS, monocular=not stereo)


@pytest.mark.parametrize("stereo", [False, True])
def test_ba_readings_are_zero_at_the_optimum(stereo):
    m = noisy_map(stereo)
    before = ba(m, stereo)
    assert before["ba_gap"] > 0.05 and before["ba_move_rel"] > 1e-4
    v = ba(at_optimum(m, stereo), stereo)
    assert v["ba_gap"] < 1e-9 and v["ba_move_rel"] < 1e-7
    w = v["window"]
    assert w["observations"] > 400 and w["free"] == (4 if not stereo else 5)
    # A stereo keypoint whose right u falls off the image counts as monocular.
    assert (w["stereo"] > 0.9 * w["observations"]) if stereo else w["stereo"] == 0


@pytest.mark.parametrize("stereo", [False, True])
def test_ba_readings_are_free_of_the_maps_frame_and_scale(stereo):
    """A monocular map under a similarity, a stereo one under a rigid
    motion (its scale is the rig's): the same readings."""
    m = noisy_map(stereo)
    s = 1.0 if stereo else 3.7
    a, b = ba(m, stereo), ba(moved(m, s, rot(1, 0.4) @ rot(0, 0.2), np.array([1.0, -2.0, 3.0])),
                             stereo)
    assert b["ba_gap"] == pytest.approx(a["ba_gap"], rel=1e-6)
    assert b["ba_move_rel"] == pytest.approx(a["ba_move_rel"], rel=1e-5)
    assert b["window"]["median_depth"] == pytest.approx(s * a["window"]["median_depth"])


@pytest.mark.parametrize("stereo", [False, True])
def test_ba_readings_rise_with_the_map_moved(stereo):
    """Points shaken off the optimum: the gap rises with the shake, and
    while no observation is shaken over its gate (which would change the
    problem) the keyframes' optimum stays where it was. Keyframes' centres
    shaken: both rise."""
    m = at_optimum(noisy_map(stereo), stereo)
    rng = np.random.default_rng(1)
    shake = rng.normal(0, 1, m["pt_xyz"].shape)
    steps = (1e-3, 3e-3, 1e-2)
    got = [ba(dict(m, pt_xyz=m["pt_xyz"] + eps * shake), stereo) for eps in steps]
    assert 1e-3 < got[0]["ba_gap"] < got[1]["ba_gap"] < got[2]["ba_gap"]
    assert got[0]["window"]["gated_out"] == 0 and got[0]["ba_move_rel"] < 1e-7
    shift = rng.normal(0, 1, (len(m["kf_pose"]), 3))
    got = []
    for eps in steps:
        T = m["kf_pose"].copy()
        T[:, :, 3] -= eps * np.einsum("kij,kj->ki", T[:, :, :3], shift)  # centres + eps * shift
        got.append(ba(dict(m, kf_pose=T), stereo))
    assert 1e-3 < got[0]["ba_gap"] < got[1]["ba_gap"] < got[2]["ba_gap"]
    assert 1e-4 < got[0]["ba_move_rel"] < got[1]["ba_move_rel"] < got[2]["ba_move_rel"]


def window_map(frontier: bool) -> dict:
    """Seven keyframe slots, their serials not in slot order; slot 2 the
    newest. It shares 10 valid points with slot 0, 15 with slot 3, 3 with
    slot 4, 1 with slot 6 (point 19, which slot 6 also sees, is dead);
    slot 3 also sees point 22, which the newest does not; slot 5 sees only
    points 25-29; slot 1 sees those, and point 22 where `frontier`."""
    sees = {2: range(0, 20), 0: range(0, 10), 3: list(range(0, 15)) + [22], 4: range(15, 18),
            6: [18, 19], 5: range(25, 30), 1: list(range(25, 30)) + ([22] if frontier else [])}
    mp = np.full((7, 30), -1)
    for k, pts in sees.items():
        for j, p in enumerate(pts):
            mp[k, j] = p
    valid = np.ones(30, bool)
    valid[19] = False
    return dict(kf_mp=mp, kf_serial=np.array([5, 0, 6, 2, 3, 1, 4]), pt_valid=valid)


def test_ba_window_follows_the_mappers_rule(monkeypatch):
    win = reference.ba_window(window_map(frontier=True), monocular=True)
    # The newest, then its covisible keyframes by weight; the frontier after.
    assert win["cams"].tolist() == [2, 3, 0, 4, 6, 1]
    assert win["fixed"].tolist() == [False] * 5 + [True]
    assert win["points"].tolist() == list(range(19)) + [22]
    # A point's observers, by their keyframes' serials.
    assert win["obs_kf"][win["obs_pt"] == 5].tolist() == [3, 0, 2]
    assert win["obs_kf"][win["obs_pt"] == 19].tolist() == [1, 3]  # point 22, the 20th
    assert np.all(np.diff(win["obs_pt"]) >= 0)
    assert len(win["obs_pt"]) == 19 + 10 + 16 + 3 + 1 + 1  # slot 6's point 19 is dead
    # The caps: three local keyframes, the next two covisible ones fixed.
    monkeypatch.setattr(reference, "BA_MAX_KFS", 3)
    win = reference.ba_window(window_map(frontier=True), monocular=True)
    assert win["cams"].tolist() == [2, 3, 0, 1, 4, 6]
    assert win["fixed"].tolist() == [False] * 3 + [True] * 3
    # The observation cap cuts point 2's three short: it is left out.
    monkeypatch.setattr(reference, "BA_MAX_OBS", 7)
    win = reference.ba_window(window_map(frontier=True), monocular=True)
    assert win["obs_pt"].tolist() == [0, 0, 0, 1, 1, 1]


@pytest.mark.parametrize("monocular", [True, False])
def test_ba_window_gauge_without_a_frontier(monocular):
    """No frontier: the oldest local keyframe is fixed (slot 3, serial 2),
    and for a monocular camera the second oldest too (slot 4, serial 3)."""
    win = reference.ba_window(window_map(frontier=False), monocular)
    assert win["cams"].tolist() == [2, 3, 0, 4, 6]
    fixed = {int(k) for k, f in zip(win["cams"], win["fixed"]) if f}
    assert fixed == ({3, 4} if monocular else {3})
    assert reference.ba_window(dict(window_map(False), kf_mp=np.full((2, 3), -1),
                                    kf_serial=np.arange(2)), monocular) is None
