"""Parity of the port's PnP RANSAC (ops/pnp.py) and batched pose
optimization with the JAX package's, on the problems of
tests/test_solvers.py, on the CPU.

solve_pnp_ransac gets the JAX package's first-round draw injected
(jax.random.choice with the same key and arguments); its LO-RANSAC second
round draws from the port's own generator (hazard e). Gates:
- 30% outliers, 150 points: both ok, poses within 1e-3 of each other and
  within the 0.01 (se3 log) that tests/test_solvers.py holds the JAX side
  to against the truth, outliers rejected.
- garbage correspondences: both refuse.
- 30 points at 50% inliers: all 10 trials as in tests/test_solvers.py
  agree (same ok, poses within 1e-3, inliers equal); at 40% the port meets
  the JAX test's own bar (>= 5 of 10 within 0.05 of the truth), and where
  both succeed their poses agree within 1e-3. A 40% trial may be won by
  the second round, whose draws differ, so ok is not held per trial there.

_dlt_pose is a float32 DLT through AtA, whose error against the truth
reaches 1e-2 on exact data (measured on both sides): it is held in
float64 to the truth within 1e-4, and in float32 to the JAX function by
the median over 256 clean draws (<= 1e-3). The batched optimize_pose is
held to a loop of single solves within 1e-6, and a single solve is what
tests/test_torch_optim.py holds to the JAX function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_orb_slam_tpu.geometry import se3 as jse3, so3 as jso3
from c_orb_slam_tpu.ops import pnp as jpnp
from c_orb_slam_tpu_torch.geometry import camera as tcam, se3 as tse3, so3 as tso3
from c_orb_slam_tpu_torch.ops import pnp as tpnp
from c_orb_slam_tpu_torch.optim import pose_opt as tpo

from synthetic import random_scene

K = np.array([500.0, 500.0, 320.0, 240.0], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _project(T, xw):
    xc = xw @ T[:, :3].T + T[:, 3]
    return np.stack([K[0] * xc[:, 0] / xc[:, 2] + K[2], K[1] * xc[:, 1] / xc[:, 2] + K[3]], 1)


def _solve_both(xw, uv, key_seed, **kw):
    m = len(xw)
    args = (xw, uv, np.ones(m, bool), np.ones(m, np.float32), K)
    key = jax.random.PRNGKey(key_seed)
    j = jpnp.solve_pnp_ransac(*(jnp.asarray(a) for a in args), key, **kw)
    idx = jax.random.choice(key, m, shape=(kw.get("n_hypotheses", 256), 6), replace=True,
                            p=jnp.full(m, 1.0 / m))
    t = tpnp.solve_pnp_ransac(*(_t(a) for a in args), generator=torch.Generator().manual_seed(0),
                              idx=_t(idx), **kw)
    return j, t


def test_pnp_with_outliers_matches_jax():
    rng = np.random.default_rng(0)
    n = 150
    xw = random_scene(n, seed=0).astype(np.float32)
    T_true = np.asarray(jse3.make(jso3.exp(jnp.array([0.1, -0.2, 0.05])), jnp.array([0.4, -0.3, 0.6])))
    uv = _project(T_true, xw) + rng.normal(0, 0.5, (n, 2))
    out = rng.choice(n, int(n * 0.3), replace=False)
    uv[out] += rng.uniform(25, 120, (len(out), 2))
    j, t = _solve_both(xw, uv.astype(np.float32), 0)
    assert bool(j.ok) and bool(t.ok)
    np.testing.assert_allclose(t.pose.numpy(), np.asarray(j.pose), atol=1e-3)
    err = tse3.log(tse3.compose(t.pose, tse3.inverse(_t(T_true))))
    assert float(err.abs().max()) < 0.01
    assert t.inliers.numpy()[out].mean() < 0.1
    assert int(t.n_inliers) == int(j.n_inliers)


def test_pnp_rejects_garbage_like_jax():
    rng = np.random.default_rng(1)
    xw = random_scene(100, seed=1).astype(np.float32)
    uv = rng.uniform(0, 640, size=(100, 2)).astype(np.float32)
    j, t = _solve_both(xw, uv, 1, min_inliers=30)
    assert not bool(j.ok) and not bool(t.ok)


def _low_inlier_trials(frac):
    """The 10 trials of tests/test_solvers.py::test_pnp_low_inlier_ratio at
    inlier fraction `frac` (same generator sequence)."""
    rng = np.random.default_rng(0)
    trials = []
    for f in (0.5, 0.4):
        for t in range(10):
            M = 30
            xw = np.c_[rng.uniform(-3, 3, (M, 2)), rng.uniform(4, 9, M)].astype(np.float32)
            T = np.eye(3, 4, dtype=np.float32)
            T[0, 3], T[1, 3] = 0.3, -0.1
            uv = _project(T, xw) + rng.normal(0, 0.5, (M, 2))
            oi = rng.choice(M, int(M * (1 - f)), replace=False)
            uv[oi] = rng.uniform([0, 0], [640, 480], (len(oi), 2))
            if f == frac:
                trials.append((xw, uv.astype(np.float32), T, 100 + t))
    return trials


@pytest.mark.parametrize("frac", [0.5, 0.4])
def test_pnp_low_inlier_ratio_matches_jax(frac):
    good = 0
    for xw, uv, T, seed in _low_inlier_trials(frac):
        j, t = _solve_both(xw, uv, seed, n_hypotheses=512, min_inliers=8)
        if frac == 0.5:
            assert bool(t.ok) == bool(j.ok)
            np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
        if bool(t.ok) and bool(j.ok):
            np.testing.assert_allclose(t.pose.numpy(), np.asarray(j.pose), atol=1e-3)
        good += bool(t.ok) and np.abs(t.pose.numpy() - T).max() < 0.05
    assert good >= (8 if frac == 0.5 else 5), f"{good}/10 at inlier fraction {frac}"


def test_dlt_pose_matches_jax():
    rng = np.random.default_rng(0)
    xw = random_scene(150, seed=0).astype(np.float32)
    T = np.eye(3, 4, dtype=np.float32)
    T[:, 3] = [0.4, -0.3, 0.6]
    xc = xw @ T[:, :3].T + T[:, 3]
    xn = (xc[:, :2] / xc[:, 2:]).astype(np.float32)
    idx = np.stack([rng.choice(150, 6, replace=False) for _ in range(256)])
    t64 = tpnp._dlt_pose(_t(xw[idx]).double(), _t(xn[idx]).double()).numpy()
    assert np.abs(t64 - T).max() < 1e-4
    j = np.asarray(jax.vmap(jpnp._dlt_pose)(jnp.asarray(xw[idx]), jnp.asarray(xn[idx])))
    t = tpnp._dlt_pose(_t(xw[idx]), _t(xn[idx])).numpy()
    assert np.median(np.abs(t - j).reshape(256, -1).max(1)) <= 1e-3
    R = t[..., :3]
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape), atol=1e-5)


def test_batched_optimize_pose_matches_single_solves():
    rng = np.random.default_rng(0)
    n, B = 200, 6
    xw = _t(random_scene(n, seed=0))
    Kt = _t(K)
    T_true = tse3.make(tso3.exp(torch.tensor([0.03, -0.02, 0.01])), torch.tensor([0.2, -0.1, 0.15]))
    obs = tcam.project_stereo(tse3.apply(T_true, xw), Kt, 40.0) + _t(
        rng.normal(0, 0.5, (n, 3)).astype(np.float32))
    obs[:20, :2] += 40.0  # outliers
    isig = _t((1.0 / 1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32))
    stereo = _t(rng.random(n) > 0.5)
    valid = _t(rng.random(n) > 0.05)
    T0 = tse3.compose(tse3.exp(_t(rng.normal(0, 0.02, (B, 6)).astype(np.float32))),
                      torch.eye(3, 4).expand(B, 3, 4))
    batched = tpo.optimize_pose(T0, xw.expand(B, n, 3), obs.expand(B, n, 3), isig, stereo, valid,
                                Kt, 40.0)
    for b in range(B):
        single = tpo.optimize_pose(T0[b], xw, obs, isig, stereo, valid, Kt, 40.0)
        np.testing.assert_allclose(batched.pose[b].numpy(), single.pose.numpy(), atol=1e-6)
        np.testing.assert_array_equal(batched.inliers[b].numpy(), single.inliers.numpy())
        assert int(batched.n_inliers[b]) == int(single.n_inliers)
