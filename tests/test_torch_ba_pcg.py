"""The implicit-Schur PCG route of the port's optim/ba.py: against the JAX
package's (its default route), and against the port's own dense route.

Tolerances. The PCG solves S dc = rhs to the accuracy 40 float32
iterations reach, not exactly, so one lm_step agrees with the JAX
package's to 1e-4 in the poses and 1e-3 m in the points (the gates of
tests/test_torch_optim.py), and PCG agrees with the dense Cholesky route
to 2e-4 / 2e-3 on one well-conditioned step. Error totals agree to 1e-3
relative. The implicit matvec is held to the dense S in float64 at 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_orb_slam_tpu.optim import ba as jba
from c_orb_slam_tpu_torch.optim import ba as tba
from c_orb_slam_tpu_torch.parallel.mesh import Mesh

from test_torch_optim import _ba_problem


def _jp(arrs):
    return jba.sort_by_point(jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrs.items()}))


def _tp(arrs, dtype=torch.float32):
    out = {}
    for k, v in arrs.items():
        t = torch.from_numpy(np.array(v))
        out[k] = t.to(dtype) if t.is_floating_point() else t
    return tba.sort_by_point(tba.BAProblem(**out))


CASES = ["mono", "stereo", "mono_outliers"]


def _arrs(case):
    return _ba_problem(stereo=case == "stereo", outliers=case.endswith("outliers"))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("use_huber", [True, False])
def test_lm_step_pcg_matches_jax(case, use_huber):
    arrs = _arrs(case)
    jp, tp = _jp(arrs), _tp(arrs)
    ej = jba.stage_error(jp, use_huber=use_huber)
    et = tba.stage_error(tp, use_huber=use_huber)
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-4)
    lam = 1e-4
    Tj, xj, lj, e1j = jba.lm_step(jp, jnp.float32(lam), ej, use_huber=use_huber, pcg_iters=40)
    Tt, xt, lt, e1t = tba.lm_step(
        tp, torch.tensor(lam), et, use_huber=use_huber, pcg_iters=40, schur="pcg"
    )
    assert float(lt) == float(lj)  # both accepted (or both rejected) the step
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-3)
    np.testing.assert_allclose(float(e1t), float(e1j), rtol=1e-3)
    assert float(e1t) <= float(et)  # equal when both rejected the step
    fixed = arrs["cam_fixed"] | ~arrs["cam_valid"]
    np.testing.assert_array_equal(Tt.numpy()[fixed], arrs["cam_T"][fixed])


@pytest.mark.parametrize("case", CASES)
def test_pcg_route_agrees_with_dense_route(case):
    tp = _tp(_arrs(case))
    err = tba.stage_error(tp)
    lam = torch.tensor(1e-4)
    Td, xd, _, ed = tba.lm_step(tp, lam, err, schur="dense")
    Tp, xp, _, ep = tba.lm_step(tp, lam, err, pcg_iters=40, schur="pcg")
    np.testing.assert_allclose(Tp.numpy(), Td.numpy(), atol=2e-4)
    np.testing.assert_allclose(xp.numpy(), xd.numpy(), atol=2e-3)
    np.testing.assert_allclose(float(ep), float(ed), rtol=1e-3)


def test_schur_matvec_equals_dense_schur_in_float64():
    """S @ x from two gathers and two index_adds equals the explicit
    S = Hcc - W Hpp^-1 Wt applied to x."""
    tp = _tp(_arrs("stereo"), torch.float64)
    r, Jc, Jp, w, _ = tba._obs_terms(tp, tp.cam_T, tp.points, True, 5.991, 7.815)
    mesh = Mesh([torch.device("cpu")])  # the solvers' one-shard mesh
    nrm = tba._normal(mesh, [tp], [(r, Jc, Jp, w)], [torch.tensor(1e-4)], dense=False)[0]
    Hcc, Hpp_inv, free = nrm.Hcc, nrm.Hpp_inv, nrm.free
    C, P = tp.cam_T.shape[0], tp.points.shape[0]
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(C, 6)))
    got = tba._schur_matvec(mesh, [tp], [(r, Jc, Jp, w)], [nrm], [x])[0]
    B = (Jc * w[:, None, None]).transpose(1, 2) @ Jp
    W = torch.zeros(C, P, 6, 3, dtype=torch.float64)
    W.index_put_((tp.obs_cam.long(), tp.obs_pt.long()), B, accumulate=True)
    xf = x * free[:, None]
    Wt_x = torch.einsum("cpij,ci->pj", W, xf)
    want = (Hcc @ xf[..., None])[..., 0] - torch.einsum(
        "cpij,pj->ci", W, (Hpp_inv @ Wt_x[..., None])[..., 0]
    )
    np.testing.assert_allclose(got.numpy(), (want * free[:, None]).numpy(), atol=1e-9)


@pytest.mark.parametrize("case", ["mono", "stereo"])
def test_bundle_adjust_pcg_matches_jax_default_route(case):
    arrs = _arrs(case)
    j = jba.bundle_adjust(jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrs.items()}))
    t = tba.bundle_adjust(
        tba.BAProblem(**{k: torch.from_numpy(np.array(v)) for k, v in arrs.items()}),
        schur="pcg",
    )
    np.testing.assert_allclose(t.cam_T.numpy(), np.asarray(j.cam_T), atol=1e-4)
    np.testing.assert_array_equal(t.obs_inlier.numpy(), np.asarray(j.obs_inlier))
    np.testing.assert_allclose(t.points.numpy(), np.asarray(j.points), atol=1e-3)
    np.testing.assert_allclose(float(t.final_chi2), float(j.final_chi2), rtol=1e-3)
