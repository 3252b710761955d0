"""Parity of the port's Sim(3) pose graph (optim/pose_graph.py) with the
JAX package's, on the CPU, from the same numpy inputs.

Tolerances. Edge Jacobians (torch.func.jacrev against jax.jacrev): 1e-4,
float32 reverse-mode through exp, compose and log. One gn_step is 50 PCG
iterations on float32 scatter-adds, which amplify summation-order noise;
the bound is taken from a float64 evaluation of the port's own step on
the same problem: both packages must lie within 20x the float32-float64
gap of the port (and no further than 5e-3) of the float64 result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_orb_slam_tpu.geometry import sim3 as jsim3
from c_orb_slam_tpu.optim import pose_graph as jpg
from c_orb_slam_tpu_torch.geometry import sim3 as tsim3
from c_orb_slam_tpu_torch.optim import pose_graph as tpg

from test_loop_optim import _circle_poses


def _exp(xi):
    return np.asarray(jax.vmap(jsim3.exp)(jnp.asarray(xi, jnp.float32)))


def _ring_problem(K=14, seed=0, noise=0.02):
    """A ring of vertices with chain, skip and loop edges whose
    measurements are the true relatives perturbed by `noise`; a dead
    vertex and an invalid edge ride along."""
    rng = np.random.default_rng(seed)
    gt = _exp(rng.normal(size=(K, 7)) * 0.3)
    ei = np.concatenate([np.arange(K - 1), np.arange(K - 2), [0]])
    ej = np.concatenate([np.arange(1, K), np.arange(2, K), [K - 1]])
    E = len(ei)
    rel = jax.vmap(lambda a, b: jsim3.compose(b, jsim3.inverse(a)))(
        jnp.asarray(gt[ei]), jnp.asarray(gt[ej])
    )
    meas = np.asarray(
        jax.vmap(jsim3.compose)(jnp.asarray(_exp(rng.normal(size=(E, 7)) * noise)), rel)
    )
    verts = np.array(
        jax.vmap(jsim3.compose)(jnp.asarray(_exp(rng.normal(size=(K, 7)) * 0.05)), jnp.asarray(gt))
    )
    verts[0] = gt[0]
    v_valid = np.ones(K, bool)
    v_valid[K - 3] = False
    e_valid = np.ones(E, bool)
    e_valid[3] = False
    e_valid[(ei == K - 3) | (ej == K - 3)] = False
    return dict(
        vertices=verts.astype(np.float32), v_fixed=np.arange(K) == 0, v_valid=v_valid,
        edge_i=ei.astype(np.int32), edge_j=ej.astype(np.int32), edge_Sji=meas.astype(np.float32),
        edge_weight=rng.uniform(0.5, 2.0, E).astype(np.float32), edge_valid=e_valid,
    )


def _jp(a):
    return jpg.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in a.items()})


def _tp(a, dtype=torch.float32):
    out = {}
    for k, v in a.items():
        t = torch.from_numpy(np.array(v))
        out[k] = t.to(dtype) if t.is_floating_point() else t
    return tpg.PoseGraphProblem(**out)


def test_edge_jacobians_match_jax_jacrev():
    a = _ring_problem()
    zero = jnp.zeros(7, jnp.float32)
    S_i, S_j, S_ji = (jnp.asarray(a["vertices"][a["edge_i"]]),
                      jnp.asarray(a["vertices"][a["edge_j"]]), jnp.asarray(a["edge_Sji"]))
    dims = (None, None, 0, 0, 0)
    rj = jax.vmap(jpg._edge_residual, in_axes=dims)(zero, zero, S_i, S_j, S_ji)
    Jij = jax.vmap(jax.jacrev(jpg._edge_residual, argnums=0), in_axes=dims)(zero, zero, S_i, S_j, S_ji)
    Jjj = jax.vmap(jax.jacrev(jpg._edge_residual, argnums=1), in_axes=dims)(zero, zero, S_i, S_j, S_ji)
    p = _tp(a)
    r, Ji, Jj = tpg.edge_jacobians(
        p.vertices[p.edge_i.long()], p.vertices[p.edge_j.long()], p.edge_Sji
    )
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), atol=1e-5)
    np.testing.assert_allclose(Ji.numpy(), np.asarray(Jij), atol=1e-4)
    np.testing.assert_allclose(Jj.numpy(), np.asarray(Jjj), atol=1e-4)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_gn_step_matches_jax_within_float64_bound(fix_scale):
    a = _ring_problem()
    p32, p64 = _tp(a), _tp(a, torch.float64)
    ref = tpg.gn_step(p64, p64.vertices, pcg_iters=50, fix_scale=fix_scale).numpy()
    got = tpg.gn_step(p32, p32.vertices, pcg_iters=50, fix_scale=fix_scale).numpy()
    jp = _jp(a)
    want = np.asarray(jpg.gn_step(jp, jp.vertices, pcg_iters=50, fix_scale=fix_scale))
    gap = np.abs(got - ref).max()
    bound = min(max(20 * gap, 1e-5), 5e-3)
    assert gap < 5e-3, gap
    assert np.abs(want - ref).max() < bound, (np.abs(want - ref).max(), bound)
    assert np.abs(got - want).max() < bound
    # The step moved the free vertices and nothing else.
    moved = np.abs(got - a["vertices"]).max(axis=1) > 1e-6
    frozen = a["v_fixed"] | ~a["v_valid"]
    assert not moved[frozen].any() and moved[~frozen].all()
    if fix_scale:
        np.testing.assert_array_equal(got[:, 7], a["vertices"][:, 7])


def test_pose_graph_closes_drifted_loop():
    """The drifted loop of tests/test_loop_optim.py, through both
    packages: the far vertex snaps back, the port lands where the JAX
    package does, and the chunked gn_step path equals the one-shot solve."""
    Kn = 16
    gt = [jsim3.from_se3(jnp.asarray(T)) for T in _circle_poses(Kn)]
    drift = jsim3.exp(jnp.asarray([0.02, 0.0, 0.01, 0.0, 0.015, 0.0, 0.006]))
    est = [gt[0]]
    for k in range(1, Kn):
        rel_gt = jsim3.compose(gt[k], jsim3.inverse(gt[k - 1]))
        est.append(jsim3.compose(jsim3.compose(drift, rel_gt), est[k - 1]))
    edges = [(k - 1, k, jsim3.compose(est[k], jsim3.inverse(est[k - 1]))) for k in range(1, Kn)]
    edges.append((0, Kn - 1, jsim3.compose(gt[Kn - 1], jsim3.inverse(gt[0]))))
    E = len(edges)
    a = dict(
        vertices=np.stack([np.asarray(e) for e in est]),
        v_fixed=np.arange(Kn) == 0, v_valid=np.ones(Kn, bool),
        edge_i=np.array([e[0] for e in edges], np.int32),
        edge_j=np.array([e[1] for e in edges], np.int32),
        edge_Sji=np.stack([np.asarray(e[2]) for e in edges]),
        edge_weight=np.ones(E, np.float32), edge_valid=np.ones(E, bool),
    )
    want = np.asarray(jpg.optimize_pose_graph(_jp(a), iters=25, pcg_iters=40))
    p = _tp(a)
    got = tpg.optimize_pose_graph(p, iters=25, pcg_iters=40)

    def err(S, k):
        d = tsim3.log(tsim3.compose(S, tsim3.inverse(torch.from_numpy(np.array(gt[k])))))
        return float(d.abs().max())

    far = Kn - 1
    err0, err1 = err(p.vertices[far], far), err(got[far], far)
    assert err0 > 0.05 and err1 < 0.02, (err0, err1)
    # 25 GN iterations from the same start: the two float32 paths end
    # within 1e-3 of each other (both converged; the bound is the
    # convergence basin's width, not one step's rounding).
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    verts = p.vertices
    for _ in range(25):
        verts = tpg.gn_step(p, verts, pcg_iters=40)
    np.testing.assert_array_equal(verts.numpy(), got.numpy())


def test_recover_se3_matches_jax():
    S = _exp(np.random.default_rng(2).normal(size=(9, 7)) * 0.4)
    Tj, sj = jpg.recover_se3(jnp.asarray(S))
    Tt, st = tpg.recover_se3(torch.from_numpy(S))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=2e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)
