"""Parity of the port's solvers (optim.pose_opt.optimize_pose and the
dense-Schur optim.ba.bundle_adjust) with the JAX package's, on synthetic
problems made from a seed with numpy, on the CPU.

Tolerances: the solvers iterate float32 Gauss-Newton / LM steps whose
normal equations are summed and solved in another order on each side
(XLA reductions and LU vs PyTorch's), so poses agree to 1e-4 (rotation
radians, translation metres) and BA points to 1e-3 m. Inlier sets are
compared exactly: no synthetic residual sits on a chi2 gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_orb_slam_tpu.geometry import camera as jcam, se3 as jse3, so3 as jso3
from c_orb_slam_tpu.optim import ba as jba, pose_opt as jpo
from c_orb_slam_tpu_torch.optim import ba as tba, pose_opt as tpo

from synthetic import random_scene, smooth_trajectory

K = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
BF = 40.0


def _pose(w, t):
    R = np.asarray(jso3.exp(jnp.asarray(w, jnp.float32)))
    return np.concatenate([R, np.asarray(t, np.float32)[:, None]], axis=1)


def _project(T, xw, stereo):
    xc = jse3.apply(jnp.asarray(T), jnp.asarray(xw))
    return np.asarray(jcam.project_stereo(xc, jnp.asarray(K), BF if stereo else 0.0))


@pytest.mark.parametrize("stereo", [False, True])
def test_optimize_pose_matches_jax(stereo):
    rng = np.random.default_rng(0)
    n = 200
    xw = random_scene(n, seed=0)
    T_true = _pose([0.03, -0.02, 0.01], [0.2, -0.1, 0.15])
    obs = _project(T_true, xw, stereo) + rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    out = rng.choice(n, n // 5, replace=False)
    obs[out, :2] += rng.uniform(20, 80, (len(out), 2)).astype(np.float32)
    isig = (1.0 / 1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
    is_stereo = np.full(n, stereo)
    valid = rng.random(n) > 0.05
    args = (np.eye(3, 4, dtype=np.float32), xw, obs.astype(np.float32), isig, is_stereo, valid, K)
    j = jpo.optimize_pose(*(jnp.asarray(a) for a in args), BF)
    t = tpo.optimize_pose(*(torch.from_numpy(np.array(a)) for a in args), BF)
    np.testing.assert_allclose(t.pose.numpy(), np.asarray(j.pose), atol=1e-4)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert int(t.n_inliers) == int(j.n_inliers) > 140


def _ba_problem(stereo, n_cams=6, n_pts=300, seed=0, outliers=False):
    """The tests/test_optim.py BA problem, plus padding slots (a dead
    camera, dead points, invalid observations) like a local-BA bucket."""
    rng = np.random.default_rng(seed)
    xw_true = random_scene(n_pts, depth_range=(5, 12), spread=5, seed=seed)
    traj = smooth_trajectory(n_cams)
    obs_cam = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    obs_pt = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    uv = np.concatenate([_project(traj[c], xw_true, stereo) for c in range(n_cams)])
    uv = (uv + rng.normal(0, 0.3, uv.shape)).astype(np.float32)
    if outliers:
        out = rng.choice(len(uv), len(uv) // 10, replace=False)
        uv[out, :2] += rng.uniform(30, 90, (len(out), 2)).astype(np.float32)
    n_fixed = 1 if stereo else 2
    cam_T = traj.copy()
    for c in range(n_fixed, n_cams):
        dxi = rng.normal(0, 0.02, 6).astype(np.float32)
        cam_T[c] = np.asarray(jse3.compose(jse3.exp(jnp.asarray(dxi)), jnp.asarray(traj[c])))
    pts = (xw_true + rng.normal(0, 0.05, xw_true.shape)).astype(np.float32)
    C, P, O = n_cams + 1, n_pts + 4, len(uv) + 8
    pad = lambda a, n, v=0: np.concatenate([a, np.full((n - len(a),) + a.shape[1:], v, a.dtype)])
    return dict(
        cam_T=pad(cam_T, C, 0) + pad(np.zeros_like(cam_T), C, 0) + np.eye(3, 4, dtype=np.float32) * (np.arange(C) >= n_cams)[:, None, None],
        cam_fixed=np.arange(C) < n_fixed,
        cam_valid=np.arange(C) < n_cams,
        points=pad(pts, P, 1.0),
        point_valid=np.arange(P) < n_pts,
        obs_cam=pad(obs_cam, O), obs_pt=pad(obs_pt, O), obs_uv=pad(uv, O),
        obs_stereo=np.full(O, stereo), obs_inv_sigma2=np.ones(O, np.float32),
        obs_valid=np.arange(O) < len(uv),
        K=K, bf=np.float32(BF if stereo else 0.0),
    )


def _unobserved_camera_problem():
    """_ba_problem (mono) as the clean LM stage sees it after the Huber
    stage classified out every observation of a badly posed free camera
    (camera 5, 0.3 rad off): its pivot in the reduced system is the damping
    alone. 20 points were seen by it and by camera 4 only, so camera 4
    now holds them alone: their Hpp is rank 2 plus the damping, and in
    float32 the Schur complement of camera 4 cancels to a non-positive
    pivot, so S fails Cholesky."""
    arrs = _ba_problem(stereo=False)
    single = np.random.default_rng(1).choice(300, 20, replace=False)
    keep = ~np.isin(arrs["obs_pt"], single) | np.isin(arrs["obs_cam"], [4, 5])
    arrs["obs_valid"] &= keep & (arrs["obs_cam"] != 5)
    arrs["cam_T"][5] = _pose([0.0, 0.3, 0.0], [0, 0, 0]) @ np.vstack([arrs["cam_T"][5], [0, 0, 0, 1]])
    return arrs


@pytest.mark.parametrize("case", ["mono", "stereo", "mono_outliers",
                                  "mono_unobserved_camera_lm4", "mono_unobserved_camera_lm8"])
def test_bundle_adjust_matches_jax_dense_schur(case):
    if "unobserved_camera" in case:
        # One LM iteration at the damping of the clean stage after 4 or 8
        # accepted steps: the float32 factorization fails in both
        # packages, and the step is rejected as JAX's NaN step is: cameras
        # and points unchanged, the damping times 4, the same error.
        arrs = _unobserved_camera_problem()
        lam = 1e-4 * 0.5 ** int(case[-1])
        jp = jba.sort_by_point(jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrs.items()}))
        tp = tba.sort_by_point(tba.BAProblem(**{k: torch.from_numpy(np.array(v)) for k, v in arrs.items()}))
        j = jba.lm_step(jp, jnp.float32(lam), jba.stage_error(jp, use_huber=False), use_huber=False,
                        schur="dense")
        tba.reset_failed_factorizations()
        t = tba.lm_step(tp, torch.tensor(lam), tba.stage_error(tp, use_huber=False), use_huber=False)
        assert tba.failed_factorizations("cpu") == 1
        for got, want, start in zip(t[:2], j[:2], (arrs["cam_T"], np.asarray(jp.points))):
            np.testing.assert_array_equal(np.asarray(want), start)
            np.testing.assert_array_equal(got.numpy(), start)
        assert float(t[2]) == float(j[2]) == np.float32(lam) * 4
        np.testing.assert_allclose(float(t[3]), float(j[3]), rtol=1e-5)
        return
    arrs = _ba_problem(stereo=case == "stereo", outliers=case.endswith("outliers"))
    j = jba.bundle_adjust(jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrs.items()}), schur="dense")
    t = tba.bundle_adjust(tba.BAProblem(**{k: torch.from_numpy(np.array(v)) for k, v in arrs.items()}))
    np.testing.assert_allclose(t.cam_T.numpy(), np.asarray(j.cam_T), atol=1e-4)
    np.testing.assert_array_equal(t.obs_inlier.numpy(), np.asarray(j.obs_inlier))
    # Points with an observation classified out are held by fewer rays
    # through a Huber-weighted first stage; their LM paths may part (up to
    # decimetres on 10% gross outliers), so the 1e-3 m gate covers the
    # points whose every observation is an inlier.
    bad = arrs["obs_pt"][arrs["obs_valid"] & ~np.asarray(j.obs_inlier)]
    held = arrs["point_valid"].copy()
    held[bad] = False
    assert held.sum() > 0.4 * arrs["point_valid"].sum()
    np.testing.assert_allclose(t.points.numpy()[held], np.asarray(j.points)[held], atol=1e-3)
    np.testing.assert_allclose(float(t.final_chi2), float(j.final_chi2), rtol=1e-3)
    # Fixed and dead cameras do not move.
    fixed = arrs["cam_fixed"] | ~arrs["cam_valid"]
    np.testing.assert_array_equal(t.cam_T.numpy()[fixed], arrs["cam_T"][fixed])
