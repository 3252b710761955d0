"""Parity of the port's Sim(3) stack with the JAX package's, float32 on
the CPU, from the same numpy inputs: geometry/sim3.py (every function,
each branch of ``_calc_W``), ops/sim3solve.py (``horn_sim3``,
``solve_sim3_ransac`` under the JAX draw) and optim/sim3_opt.py.

Tolerances. geometry: 2e-6 absolute; both sides evaluate the same
float32 formulas. horn_sim3: 2e-5 — the port diagonalizes the 4x4 matrix
in float64, the JAX package in float32. solve_sim3_ransac: equal inlier
sets, S12 to 2e-5. optimize_sim3: 5e-5 on S12 after 10 GN iterations of
7x7 solves; equal inlier sets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_orb_slam_tpu.geometry import sim3 as jsim3
from c_orb_slam_tpu.ops import sim3solve as jsolve
from c_orb_slam_tpu.optim import sim3_opt as jopt
from c_orb_slam_tpu_torch.geometry import sim3 as tsim3
from c_orb_slam_tpu_torch.ops import sim3solve as tsolve
from c_orb_slam_tpu_torch.optim import sim3_opt as topt

ATOL = 2e-6
K4 = np.array([500.0, 500.0, 320.0, 240.0], np.float32)


def _t(*arrays):
    out = tuple(torch.from_numpy(np.array(a)) for a in arrays)
    return out if len(out) != 1 else out[0]


def _xi(n=40, seed=0, scale=0.4):
    return (np.random.default_rng(seed).normal(size=(n, 7)) * scale).astype(np.float32)


def _S(n=40, seed=0):
    return np.asarray(jax.vmap(jsim3.exp)(jnp.asarray(_xi(n, seed))))


def _pts(n=40, seed=1):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32) * 3


def _se3(n=40, seed=2):
    from c_orb_slam_tpu.geometry import se3 as jse3

    xi = np.random.default_rng(seed).normal(size=(n, 6)).astype(np.float32)
    return np.asarray(jax.vmap(jse3.exp)(jnp.asarray(xi)))


_UNARY = ["quat", "translation", "scale", "rotation", "inverse", "to_se3", "log"]


@pytest.mark.parametrize("name", _UNARY)
def test_unary_matches_jax(name):
    S = _S()
    want = np.asarray(jax.vmap(getattr(jsim3, name))(jnp.asarray(S)))
    got = getattr(tsim3, name)(_t(S)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


def test_make_and_identity():
    S = _S()
    q, t, s = S[:, :4] * 2.0, S[:, 4:7], np.exp(S[:, 7])  # un-normalized quats
    want = np.asarray(jsim3.make(jnp.asarray(q), jnp.asarray(t), jnp.asarray(s)))
    np.testing.assert_allclose(tsim3.make(*_t(q, t, s)).numpy(), want, atol=ATOL)
    np.testing.assert_array_equal(tsim3.identity().numpy(), np.asarray(jsim3.identity()))


def test_compose_matches_jax():
    A, B = _S(seed=3), _S(seed=4)
    want = np.asarray(jax.vmap(jsim3.compose)(jnp.asarray(A), jnp.asarray(B)))
    np.testing.assert_allclose(tsim3.compose(*_t(A, B)).numpy(), want, atol=ATOL, rtol=1e-5)


def test_apply_matches_jax_both_layouts():
    S, x = _S(), _pts()
    want = np.asarray(jax.vmap(jsim3.apply)(jnp.asarray(S), jnp.asarray(x)))
    np.testing.assert_allclose(tsim3.apply(*_t(S, x)).numpy(), want, atol=1e-5, rtol=1e-5)
    # (N, 3) points against a single transform
    want1 = np.asarray(jsim3.apply(jnp.asarray(S[0]), jnp.asarray(x)))
    np.testing.assert_allclose(tsim3.apply(*_t(S[0], x)).numpy(), want1, atol=1e-5, rtol=1e-5)


def test_from_se3_matches_jax():
    T = _se3()
    s = np.linspace(0.5, 2.0, len(T)).astype(np.float32)
    want = np.asarray(jax.vmap(jsim3.from_se3)(jnp.asarray(T), jnp.asarray(s)))
    np.testing.assert_allclose(tsim3.from_se3(*_t(T, s)).numpy(), want, atol=ATOL)
    want1 = np.asarray(jsim3.from_se3(jnp.asarray(T)))
    np.testing.assert_allclose(tsim3.from_se3(_t(T)).numpy(), want1, atol=ATOL)


# One case per regime of _calc_W: (theta, sigma) general, theta -> 0,
# sigma -> 0, both -> 0.
_W_CASES = {
    "general": (0.7, 0.3),
    "small_theta": (1e-5, 0.3),
    "small_sigma": (0.7, 1e-5),
    "both_small": (1e-5, 1e-5),
    "zero": (0.0, 0.0),
}


@pytest.mark.parametrize("case", list(_W_CASES))
def test_calc_W_branch_matches_jax(case):
    theta, sigma = _W_CASES[case]
    d = np.random.default_rng(5).normal(size=(16, 3)).astype(np.float32)
    phi = (d / np.linalg.norm(d, axis=1, keepdims=True) * theta).astype(np.float32)
    sig = np.full(16, sigma, np.float32)
    want = np.asarray(jax.vmap(jsim3._calc_W)(jnp.asarray(phi), jnp.asarray(sig)))
    got = tsim3._calc_W(*_t(phi, sig)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("case", list(_W_CASES))
def test_exp_log_roundtrip_and_gradient_finite(case):
    theta, sigma = _W_CASES[case]
    xi = np.array([0.3, -0.2, 0.5, theta, 0.0, 0.0, sigma], np.float32)
    want = np.asarray(jsim3.exp(jnp.asarray(xi)))
    S = tsim3.exp(_t(xi))
    np.testing.assert_allclose(S.numpy(), want, atol=ATOL)
    # exp(log(S)) == S
    np.testing.assert_allclose(tsim3.exp(tsim3.log(S)).numpy(), S.numpy(), atol=5e-6)
    # The guarded denominators keep reverse-mode derivatives finite in
    # every regime (the pose graph differentiates through exp and log).
    J = torch.func.jacrev(lambda v: tsim3.log(tsim3.exp(v)))(_t(xi))
    Jj = np.asarray(jax.jacrev(lambda v: jsim3.log(jsim3.exp(v)))(jnp.asarray(xi)))
    assert torch.isfinite(J).all()
    np.testing.assert_allclose(J.numpy(), Jj, atol=2e-4)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_sim3_matches_jax(fix_scale):
    rng = np.random.default_rng(6)
    p2 = rng.normal(size=(32, 3, 3)).astype(np.float32) * 2
    S = _S(32, seed=7)
    p1 = np.asarray(jax.vmap(jsim3.apply)(jnp.asarray(S), jnp.asarray(p2)))
    p1 = p1 + rng.normal(size=p1.shape).astype(np.float32) * 0.01
    want = np.asarray(
        jax.vmap(lambda a, b: jsolve.horn_sim3(a, b, fix_scale))(jnp.asarray(p1), jnp.asarray(p2))
    )
    got = tsolve.horn_sim3(*_t(p1, p2), fix_scale).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    if fix_scale:
        np.testing.assert_array_equal(got[:, 7], 0.0)


def _loop_pairs(M=120, seed=8, noise=0.4):
    """Matched points of two cameras related by a Sim3, with pixel noise
    and a tenth of the pairs invalid."""
    rng = np.random.default_rng(seed)
    x2 = np.c_[rng.uniform(-2, 2, (M, 2)), rng.uniform(4, 9, M)].astype(np.float32)
    S_gt = np.asarray(jsim3.exp(jnp.asarray([0.3, -0.2, 0.1, 0.05, -0.08, 0.03, 0.1], jnp.float32)))
    x1 = np.asarray(jsim3.apply(jnp.asarray(S_gt), jnp.asarray(x2)))

    def proj(x):
        return np.stack(
            [K4[0] * x[:, 0] / x[:, 2] + K4[2], K4[1] * x[:, 1] / x[:, 2] + K4[3]], 1
        ).astype(np.float32)

    uv1 = proj(x1) + rng.normal(size=(M, 2)).astype(np.float32) * noise
    uv2 = proj(x2) + rng.normal(size=(M, 2)).astype(np.float32) * noise
    x1 = x1 + rng.normal(size=(M, 3)).astype(np.float32) * 0.01
    valid = np.ones(M, bool)
    valid[::10] = False
    return x1, x2, uv1, uv2, valid, S_gt


@pytest.mark.parametrize("fix_scale", [False, True])
def test_solve_sim3_ransac_matches_jax_under_injected_draw(fix_scale):
    x1, x2, uv1, uv2, valid, _ = _loop_pairs()
    M = len(x1)
    gate = np.full(M, 9.21, np.float32)
    key = jax.random.PRNGKey(11)
    # The draw solve_sim3_ransac makes from this key (sim3solve.py:100-102).
    probs = valid.astype(np.float32) / max(valid.sum(), 1.0)
    idx = np.asarray(
        jax.random.choice(key, M, shape=(256, 3), replace=True, p=jnp.asarray(probs))
    )
    want = jsolve.solve_sim3_ransac(
        *map(jnp.asarray, (x1, x2, uv1, uv2, valid, gate, gate, K4, K4)), key,
        fix_scale=fix_scale, n_hypotheses=256,
    )
    got = tsolve.solve_sim3_ransac(
        *_t(x1, x2, uv1, uv2, valid, gate, gate, K4, K4),
        fix_scale=fix_scale, idx=_t(idx),
    )
    assert bool(got.ok) == bool(want.ok)
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    np.testing.assert_allclose(got.S12.numpy(), np.asarray(want.S12), atol=2e-5)


def test_solve_sim3_ransac_own_draw_is_seeded_and_finds_the_model():
    x1, x2, uv1, uv2, valid, S_gt = _loop_pairs(noise=0.2)
    gate = np.full(len(x1), 9.21, np.float32)
    args = _t(x1, x2, uv1, uv2, valid, gate, gate, K4, K4)
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(3)
        outs.append(tsolve.solve_sim3_ransac(*args, generator=g))
    np.testing.assert_array_equal(outs[0].S12.numpy(), outs[1].S12.numpy())
    assert bool(outs[0].ok) and int(outs[0].n_inliers) > 0.7 * valid.sum()
    assert not outs[0].inliers.numpy()[~valid].any()
    err = tsim3.log(tsim3.compose(outs[0].S12, tsim3.inverse(_t(S_gt)))).abs().max()
    assert float(err) < 0.05


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_matches_jax(fix_scale):
    x1, x2, uv1, uv2, valid, S_gt = _loop_pairs(seed=9)
    M = len(x1)
    uv1[:8] += 40.0  # outliers for the stage-1 pruning
    S0 = np.asarray(
        jsim3.compose(
            jsim3.exp(jnp.asarray([0.05, -0.04, 0.02, 0.01, 0.02, -0.01, 0.0], jnp.float32)),
            jnp.asarray(S_gt),
        )
    )
    w1 = np.random.default_rng(1).choice([1.0, 0.69, 0.48], M).astype(np.float32)
    w2 = np.ones(M, np.float32)
    want = jopt.optimize_sim3(
        *map(jnp.asarray, (S0, x1, x2, uv1, uv2, w1, w2, valid, K4, K4)), fix_scale=fix_scale
    )
    got = topt.optimize_sim3(*_t(S0, x1, x2, uv1, uv2, w1, w2, valid, K4, K4), fix_scale=fix_scale)
    np.testing.assert_allclose(got.S12.numpy(), np.asarray(want.S12), atol=5e-5)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers)
    assert not got.inliers.numpy()[:8].any()
