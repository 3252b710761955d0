"""The port's map-sharded BA and edge-sharded pose graph against the JAX
package, on the CPU.

The twins of tests/test_sharded_ba.py: the same seeded problems go to the
JAX solvers on the 8 virtual CPU devices of tests/conftest.py and to the
port on an 8-shard in-process CPU mesh. The host partition and the edge
padding are equal array for array; the solves agree with the port's own
single-device solvers at the JAX tests' tolerances and with the JAX
solves at twice the measured gap. The mesh's collective counts stand in
for the JAX test's reading of the compiled HLO.
"""

import jax
import numpy as np
import pytest
import torch

from c_orb_slam_tpu.optim import ba as jba
from c_orb_slam_tpu.parallel import dpose_graph as jdpg
from c_orb_slam_tpu.parallel import sharded_ba as jsba
from c_orb_slam_tpu_torch.optim import ba as tba
from c_orb_slam_tpu_torch.optim import pose_graph as tpg
from c_orb_slam_tpu_torch.parallel import dpose_graph as tdpg
from c_orb_slam_tpu_torch.parallel import sharded_ba as tsba
from c_orb_slam_tpu_torch.parallel.mesh import Mesh

from test_parallel import _make_problem
from test_sharded_ba import _drifted_loop_problem
from test_torch_parallel import constrained_points, to_torch

torch.set_num_threads(1)

# Port against JAX, measured on these problems: cam_T 5.3e-6, points seen
# from two cameras or more 6.7e-5, mean chi2 1.5e-7; pose-graph vertices
# 3.8e-6. Twice that, rounded up.
CAM_TOL_JAX, PTS_TOL_JAX, CHI2_TOL_JAX, PG_TOL_JAX = 1.1e-5, 1.4e-4, 3e-7, 8e-6


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jsba.make_mesh(np.asarray(jax.devices()[:8]))


@pytest.mark.parametrize("C,Pn,O,n", [(5, 80, 397, 8), (6, 83, 401, 8), (4, 64, 256, 4),
                                      (6, 83, 401, 3)])
def test_partition_equals_jax(C, Pn, O, n):
    jp, _ = _make_problem(C=C, Pn=Pn, O=O)
    jpp = jsba.partition_problem(jp, n)
    tpp = tsba.partition_problem(to_torch(jp), n)
    for f, a, b in zip(jba.BAProblem._fields, jpp, tpp):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def test_partition_preserves_ownership():
    p, _ = _make_problem(C=5, Pn=80, O=397)
    pp = tsba.partition_problem(to_torch(p), 8)
    O = pp.obs_cam.shape[0]
    assert O % 8 == 0
    slab, Ps = O // 8, pp.points.shape[0] // 8
    owner = pp.obs_pt // Ps
    for d in range(8):
        assert (owner[d * slab:(d + 1) * slab] == d).all()


def test_map_sharded_matches_single_and_jax(jmesh):
    jp, pts_gt = _make_problem(C=6, Pn=83, O=401)  # nothing divides 8
    tp = to_torch(jp)
    kw = dict(iters_first=5, iters_second=5, pcg_iters=30)
    mesh = Mesh(["cpu"] * 8)
    (cam_T, points, inlier, chi2), pp = tsba.sharded_bundle_adjust(tp, mesh, **kw)
    (jc, jx, ji, jchi2), _ = jsba.sharded_bundle_adjust(jp, jmesh, **kw)
    single = tba.bundle_adjust(tp, schur="pcg", **kw)
    C0, P0 = tp.cam_T.shape[0], tp.points.shape[0]
    np.testing.assert_allclose(cam_T.numpy()[:C0], single.cam_T.numpy(), atol=2e-4)
    err = np.linalg.norm(points.numpy()[:P0] - pts_gt, axis=1)
    assert np.median(err) < 5e-3
    assert np.isfinite(float(chi2))
    # Every real observation survived partitioning exactly once.
    assert int(pp.obs_valid.sum()) == int(tp.obs_valid.sum())

    np.testing.assert_allclose(cam_T.numpy(), np.asarray(jc), atol=CAM_TOL_JAX)
    seen = constrained_points(tp, P0)
    np.testing.assert_allclose(points.numpy()[:P0][seen], np.asarray(jx)[:P0][seen],
                               atol=PTS_TOL_JAX)
    # The inlier mask comes back in slab order, as the JAX body un-sorts it.
    assert inlier.shape == np.asarray(ji).shape == pp.obs_valid.shape
    np.testing.assert_array_equal(inlier.numpy(), np.asarray(ji))
    assert abs(float(chi2) - float(jchi2)) < CHI2_TOL_JAX


def _counts(C, Pn, O, pcg_iters):
    p, _ = _make_problem(C=C, Pn=Pn, O=O)
    mesh = Mesh(["cpu"] * 8)
    tsba.sharded_bundle_adjust(to_torch(p), mesh, iters_first=2, iters_second=2,
                               pcg_iters=pcg_iters)
    return mesh.counts


def test_sharded_point_side_is_local():
    """Per PCG iteration the collectives move camera-sized data only: one
    all_gather and one psum_scatter of 6·C elements and two scalar psums
    (the twin of tests/test_sharded_ba.py's HLO check); the whole solve's
    collectives do not grow with the points or the observations."""
    C = 8  # 6 cameras, padded to a multiple of the 8 shards
    base = _counts(6, 160, 800, 5)
    more = _counts(6, 160, 800, 6)
    lm_iters = 2 + 2
    per_pcg = {op: [(more[op][k] - base[op][k]) / lm_iters for k in (0, 1)] for op in base}
    assert per_pcg == {"all_gather": [1, 6 * C], "psum_scatter": [1, 6 * C], "psum": [2, 2]}
    # The largest collective of the solve is the camera system's (C, 42)
    # reduce-scatter; doubling points and observations changes nothing.
    assert _counts(6, 320, 1600, 5) == base


@pytest.mark.parametrize("multiple", [8, 3, 16])
def test_pad_edges_equals_jax(multiple):
    jp = _drifted_loop_problem()
    jpe = jdpg.pad_edges(jp, multiple)
    tpe = tdpg.pad_edges(tpg.PoseGraphProblem(*(torch.from_numpy(np.array(x)) for x in jp)),
                         multiple)
    for f, a, b in zip(tpg.PoseGraphProblem._fields, jpe, tpe):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and a.shape == tuple(b.shape), f
        np.testing.assert_array_equal(b.numpy(), a, err_msg=f)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_distributed_pose_graph_matches_single_and_jax(fix_scale):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    jp = _drifted_loop_problem()
    tp = tpg.PoseGraphProblem(*(torch.from_numpy(np.array(x)) for x in jp))
    kw = dict(iters=25, pcg_iters=40, fix_scale=fix_scale)
    mesh = Mesh(["cpu"] * 8)
    dist = tdpg.distributed_pose_graph(tp, mesh, **kw)
    single = tpg.optimize_pose_graph(tp, **kw)
    jd = jdpg.distributed_pose_graph(jp, jdpg.make_mesh(np.asarray(jax.devices()[:8])), **kw)
    np.testing.assert_allclose(dist.numpy(), single.numpy(), atol=1e-4)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jd), atol=PG_TOL_JAX)
    # Gradient, preconditioner and every matvec: one psum each of a
    # vertex-sized tensor (K x 7, K x 49), nothing edge-sized.
    K = tp.vertices.shape[0]
    its = kw["iters"]
    assert mesh.counts == {"psum": [its * (kw["pcg_iters"] + 3),
                                    its * (K * 7 * (kw["pcg_iters"] + 2) + K * 49)]}


def test_weak_scaling_tool_counts_match_the_analytic_volume(capsys):
    """tools/weak_scaling at a toy size: for every mesh size the mesh's
    counters read the analytic collective volume per LM iteration, which
    depends on the cameras only, in process and over a gloo group."""
    import json

    from c_orb_slam_tpu_torch.tools import weak_scaling

    for backing, shards in (("inprocess", ["1", "2", "4"]), ("gloo", ["2"])):
        assert weak_scaling.main(["--device", "cpu", "--backing", backing, "--shards", *shards,
                                  "--obs-per-shard", "256", "--pts-per-shard", "64",
                                  "--cams", "8", "--reps", "1", "--timeout", "120"]) == 0
        lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
        rows, summary = lines[:-1], lines[-1]
        assert [r["shards"] for r in rows] == [int(s) for s in shards]
        for r in rows:
            assert r["collective_elements_per_lm_iter"] == r["analytic_elements_per_lm_iter"]
            assert r["backing"] == backing and r["step_ms"] > 0
        assert len({r["analytic_elements_per_lm_iter"] for r in rows}) == 1
        assert "note" in summary
