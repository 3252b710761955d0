"""Every dense solve and inverse of the port on a singular input, against
its twin in the JAX package, on the CPU. The port calls the `_ex` forms of
torch.linalg, which do not check `info` (no device sync, no exception):
each case shows that what such a call returns on a singular input is what
the JAX package returns there, or, for the dense-Schur Cholesky, that the
port turns the failed factorization into JAX's NaN step
(tests/test_torch_optim.py, the unobserved-camera cases).

Where the function's own arguments can make its matrix exactly singular,
the case drives the function (the PCG local-BA step and the sharded
global-BA step at zero damping beside a camera with no valid observation,
the pose solve at zero damping with no valid match, the homography score
of a rank-2 hypothesis). Elsewhere the matrix is damped or built so that
no argument makes it singular (the pose graph's preconditioner blocks
carry 1e-5 I, the Sim3 polish 1e-6 I, the camera matrix has fx, fy > 0,
the normalization matrices are clamped, Sim3 log's W is regular for
rotations up to pi): those cases feed the call itself a matrix of the
site's shape and dtype with an exactly zero pivot (chip_smoke.singular_ops,
which chip_smoke's phase 6 runs on the card against its record of the JAX
result, SINGULAR_JAX, held to JAX here).

An exactly singular input (a zero pivot in exact arithmetic) gives the
same NaN and infinity pattern in both packages, and equal finite entries.
A matrix that is singular only after rounding gives each package's
rounding: neither is held to the other there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from c_orb_slam_tpu.ops import twoview as jtv
from c_orb_slam_tpu.optim import ba as jba, pose_opt as jpo
from c_orb_slam_tpu_torch.ops import twoview as ttv
from c_orb_slam_tpu_torch.optim import ba as tba, pose_opt as tpo
from c_orb_slam_tpu_torch.parallel import sharded_ba as tsba
from c_orb_slam_tpu_torch.parallel.mesh import Mesh

from test_torch_optim import K, _ba_problem


def _same(got, want):
    """Equal NaN and +-inf patterns, equal finite entries."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    for pred in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(pred(got), pred(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


def _unobserved_free_camera():
    """_ba_problem (mono) with camera 5 free and none of its observations
    valid: at zero damping its Hcc block is exactly zero."""
    arrs = _ba_problem(stereo=False)
    arrs["obs_valid"] &= arrs["obs_cam"] != 5
    return arrs


def _problems(arrs):
    """The same problem in both packages, observations sorted by point."""
    return (jba.sort_by_point(jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrs.items()})),
            tba.sort_by_point(tba.BAProblem(**{k: torch.from_numpy(np.array(v))
                                               for k, v in arrs.items()})))


def _pcg_step_at_zero_damping():
    arrs = _unobserved_free_camera()
    jp, tp = _problems(arrs)
    j = jba.lm_step(jp, jnp.float32(0.0), jba.stage_error(jp), schur="pcg")
    t = tba.lm_step(tp, torch.tensor(0.0), tba.stage_error(tp), schur="pcg")
    # The singular preconditioner block makes the step NaN: rejected by
    # both, every output as it came in.
    for got, want, start in zip(t[:2], j[:2], (arrs["cam_T"], np.asarray(jp.points))):
        np.testing.assert_array_equal(np.asarray(want), start)
        np.testing.assert_array_equal(got.numpy(), start)
    assert float(t[2]) == float(j[2]) == 0.0
    np.testing.assert_allclose(float(t[3]), float(j[3]), rtol=1e-5)


def _sharded_step_at_zero_damping():
    """parallel/sharded_ba's block-Jacobi inverse: the sharded global-BA
    iteration on two CPU shards, started at zero damping, rejects the step
    as the JAX package's single-device step does (_pcg_step_at_zero_damping)."""
    arrs = _unobserved_free_camera()
    tp = tba.BAProblem(**{k: torch.from_numpy(np.array(v)) for k, v in arrs.items()})
    solve, pp = tsba.map_sharded_solve(tp, Mesh(["cpu"] * 2))
    solve.lm_lambda0 = 0.0
    solve.step()
    jp, _ = _problems(arrs)
    j = jba.lm_step(jp, jnp.float32(0.0), jba.stage_error(jp), schur="pcg")
    np.testing.assert_array_equal(np.asarray(j[0]), arrs["cam_T"])
    np.testing.assert_array_equal(solve.cam_T[0].numpy()[: len(arrs["cam_T"])], arrs["cam_T"])
    np.testing.assert_array_equal(solve.mesh.gather_local(solve.points).numpy(),
                                  np.asarray(pp.points))
    assert float(solve.lam[0]) == float(j[2]) == 0.0


def _pose_solve_at_zero_damping():
    """optim/pose_opt's 6x6 solve_ex: no valid match and no damping, H = 0."""
    rng = np.random.default_rng(0)
    n = 50
    xw = (rng.normal(size=(n, 3)) + [0, 0, 6]).astype(np.float32)
    args = (np.eye(3, 4, dtype=np.float32), xw, rng.uniform(0, 400, (n, 3)).astype(np.float32),
            np.ones(n, np.float32), np.zeros(n, bool), np.zeros(n, bool), K)
    j = jpo.optimize_pose(*(jnp.asarray(a) for a in args), 0.0, damping=0.0)
    t = tpo.optimize_pose(*(torch.from_numpy(np.array(a)) for a in args), 0.0, damping=0.0)
    _same(t.pose.numpy(), np.asarray(j.pose))
    assert np.isnan(t.pose.numpy()).all()
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))


def _homography_score_rank2():
    """ops/twoview._score_h's inv_ex: a batch of homography hypotheses,
    the first of rank 2 (its last row zero)."""
    rng = np.random.default_rng(3)
    H = (np.eye(3) + rng.normal(0, 1e-4, (4, 3, 3))).astype(np.float32)
    H[0, 2] = 0
    uv1 = rng.uniform(0, 640, (120, 2)).astype(np.float32)
    uv2 = (uv1 + rng.normal(0, 1, uv1.shape)).astype(np.float32)
    valid = rng.random(120) > 0.1
    args = (H, uv1, uv2, valid)
    js, ji = jtv._score_h(*(jnp.asarray(a) for a in args), 1.0)
    ts, ti = ttv._score_h(*(torch.from_numpy(a) for a in args), 1.0)
    _same(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def _op(site, op, a):
    """chip_smoke.singular_ops' call of `site` on the CPU against the JAX
    package's call at its twin, and chip_smoke's record of JAX's result
    (which phase 6 holds the card to) against JAX."""
    def case():
        if op == "inv":
            want = np.asarray(jnp.linalg.inv(jnp.asarray(a)))
        else:
            b = np.random.default_rng(1).normal(size=a.shape[:-1] + (1,)).astype(np.float32)
            want = np.asarray(jnp.linalg.solve(jnp.asarray(a), jnp.asarray(b)))
        _same(chip_smoke.singular_op(op, a, "cpu"), want)
        w = want[0]
        assert chip_smoke.SINGULAR_JAX[site] == tuple(
            int(f(w).sum()) for f in (np.isnan, np.isposinf, np.isneginf))
        assert np.isfinite(want[1:]).all()
    return case


CASES = {
    "optim/ba.py _solve_cameras PCG inv_ex": _pcg_step_at_zero_damping,
    "parallel/sharded_ba.py _iteration inv_ex": _sharded_step_at_zero_damping,
    "optim/pose_opt.py optimize_pose solve_ex": _pose_solve_at_zero_damping,
    "ops/twoview.py _score_h inv_ex": _homography_score_rank2,
    # The call as written at the site, on a matrix of its shape and dtype.
    **{site: _op(site, op, a) for site, op, a in chip_smoke.singular_ops()},
}


@pytest.mark.parametrize("site", list(CASES))
def test_singular_input_gives_the_jax_result(site):
    CASES[site]()
