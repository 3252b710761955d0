"""The metrics' arithmetic on made-up records: the percentile, the union of
kernel intervals, the launch count and the idle time by host stage."""

import math

import numpy as np
import pytest

from slambench import harness, readings, reference, trace


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
    v = reference.readings(answers, list(range(n)), gt, 0, rigid=False)
    assert v["ate_m"] < 1e-9
    # The readings' diagnostics from the same answers, as a detail record.
    detail = dict(tracked=[True] * n, judged=list(range(n)),
                  poses=[est[i].ravel().tolist() for i in range(n)],
                  map_xyz=pts.ravel().tolist())
    diag = readings.diagnostics(detail, dict(world, poses=gt), rigid=False)
    assert diag["ate_max_m"] < 1e-9 and diag["map_off_share"] == 0.0
    assert diag["rot_err_deg"] < 1e-6 and diag["scale_drift"] < 1e-9
    assert v["unresolved"] == 0 and v["lost"] == 0
    v = reference.readings(answers, list(range(n)), gt, 0, rigid=True)
    assert v["ate_m"] > 0.1  # a stereo rig owes the metric scale
    del answers[3]
    answers[4] = (est[4], False, 0.0)
    v = reference.readings(answers, list(range(n + 2)), gt, 1, rigid=False)
    assert (v["unresolved"], v["lost"], v["loops_closed"]) == (3, 1, 1)
    checks = reference.judge(v, dict(unresolved=0, lost=0, loops_closed=0, ate_m=0.05))
    assert [c[0] for c in checks if not c[3]] == ["unresolved", "lost", "loops_closed"]
