"""The port's ordered segment sums (c_orb_slam_tpu_torch/ops/segment.py)
against the JAX package's ``jax.ops.segment_sum``, on the same seeded numpy
inputs with heavy duplicate ids, and on the local BA's normal sums
(``_normal_sums`` and ``_w_blocks``) against the JAX package's ``_assemble``
and its W-block segment sum.

Tolerances. The two sides add the same float32 rows in possibly different
orders (the JAX package's camera side is a one-hot matmul), so a sum of n
rows of magnitude m agrees to n · m · 2^-23 at most: the generic sums (rows
of standard normals, up to 4,000 a segment) are held to rtol 1e-5 and atol
1e-4, the BA blocks (Hcc, gc, Hpp, gp, W) to rtol 1e-5 and atol 1e-5 of their
largest entry. On
the CPU the ordered sum adds each segment in row order from zero, as
``index_add_`` does there: equal bit for bit, which keeps every CPU parity
test of the solvers where it was.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_orb_slam_tpu.optim import ba as jba
from c_orb_slam_tpu_torch.ops import segment
from c_orb_slam_tpu_torch.optim import ba as tba

from test_torch_optim import _ba_problem

# (rows, segments, row shape, ids sorted, share of segments left empty)
CASES = [
    (4000, 1, (), False, 0.0),  # one segment takes every row
    (4000, 5, (6, 6), False, 0.4),  # a camera-side sum: few segments, long runs
    (20000, 3000, (3,), True, 0.5),  # a point-side sum: sorted, many empty
    (5000, 64, (42,), False, 0.0),
    (0, 7, (3,), False, 0.0),  # no rows
]


def _inputs(n_rows, n_seg, shape, sort, empty, seed=0):
    rng = np.random.default_rng(seed)
    live = np.sort(rng.choice(n_seg, max(1, int(round(n_seg * (1 - empty)))), replace=False))
    ids = live[rng.integers(0, len(live), n_rows)].astype(np.int32)
    if sort:
        ids = np.sort(ids)
    return rng.normal(size=(n_rows, *shape)).astype(np.float32), ids


@pytest.mark.parametrize("n_rows, n_seg, shape, sort, empty", CASES)
def test_segment_sum_matches_jax(n_rows, n_seg, shape, sort, empty):
    x, ids = _inputs(n_rows, n_seg, shape, sort, empty)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(ids), num_segments=n_seg,
                                          indices_are_sorted=sort))
    got = segment.segment_sum(torch.from_numpy(x), torch.from_numpy(ids), n_seg)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    # Precomputed Segments give the same sums as the ids.
    seg = segment.segments(torch.from_numpy(ids), n_seg)
    assert torch.equal(segment.segment_sum(torch.from_numpy(x), seg), got)


@pytest.mark.parametrize("n_rows, n_seg, shape, sort, empty", CASES)
def test_segment_sum_equals_index_add_on_the_cpu(n_rows, n_seg, shape, sort, empty):
    x, ids = _inputs(n_rows, n_seg, shape, sort, empty, seed=1)
    xt, it = torch.from_numpy(x), torch.from_numpy(ids).long()
    want = torch.zeros((n_seg, *shape)).index_add_(0, it, xt)
    assert torch.equal(segment.segment_sum(xt, it, n_seg), want)


def _terms(case, seed):
    """A local-BA problem with its observations shuffled (no sorted ids),
    and the JAX package's residuals, Jacobians and weights of it."""
    arrs = _ba_problem(stereo=case == "stereo", outliers=case == "mono_outliers")
    perm = np.random.default_rng(seed).permutation(len(arrs["obs_cam"]))
    for k in ("obs_cam", "obs_pt", "obs_uv", "obs_stereo", "obs_inv_sigma2", "obs_valid"):
        arrs[k] = arrs[k][perm]
    jp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrs.items()})
    tp = tba.BAProblem(**{k: torch.from_numpy(np.array(v)) for k, v in arrs.items()})
    r, Jc, Jp, w, _ = jba._obs_terms(jp, jp.cam_T, jp.points, True, 5.991, 7.815)
    return jp, tp, (r, Jc, Jp, w), tuple(torch.from_numpy(np.array(a)) for a in (r, Jc, Jp, w))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(want).max()), 1.0))


@pytest.mark.parametrize("case", ["mono", "stereo", "mono_outliers"])
def test_normal_sums_and_w_blocks_match_jax(case):
    jp, tp, jt, tt = _terms(case, seed=2)
    lam = 1e-4
    Hcc_j, _, gc_j, gp_j = jba._assemble(jp, *jt, jnp.float32(lam))
    Hcc, gc, Hpp, gp = tba._normal_sums(tp, *tt)
    Hcc_d, _ = tba._damp(tp, Hcc, Hpp, torch.tensor(lam))
    for got, want in ((Hcc_d, Hcc_j), (gc, gc_j), (gp, gp_j)):
        _close(got, want)
    # Hpp before _assemble damps and inverts it (the inverse is no sum: it
    # multiplies the rounding by Hpp's condition number), summed as there.
    C, P = tp.cam_T.shape[0], tp.points.shape[0]
    r, Jc, Jp, w = jt
    Hpp_j = jax.ops.segment_sum(jnp.einsum("nij,nik,n->njk", Jp, Jp, w).reshape(-1, 9),
                                jp.obs_pt, num_segments=P)
    _close(Hpp.reshape(P, 9), Hpp_j)
    # W blocks by the flat (point, camera) key, as _solve_cameras_dense sums them.
    B = jnp.einsum("nij,nik,n->njk", Jc, Jp, w)
    W_j = jax.ops.segment_sum(B.reshape(-1, 18), jp.obs_pt * C + jp.obs_cam, num_segments=P * C)
    W = tba._w_blocks(tp, *tt[1:])
    _close(W, W_j)
    # The same sums with the problem's Segs built once, as lm_solve builds them.
    segs = tba.segs_of(tp)
    assert all(torch.equal(a, b) for a, b in zip(tba._normal_sums(tp, *tt, segs),
                                                 (Hcc, gc, Hpp, gp)))
    assert torch.equal(tba._w_blocks(tp, *tt[1:], segs), W)
