"""Public functions of the JAX package that the port had no counterpart for:
each against the JAX package's, on the same seeded numpy inputs, on the CPU.

- ``ops/fast.fast_response``: an integer-valued image, so every circle
  difference and score is exact in float32: equal;
- ``ops/hamming.mutual_best``: integer distances with ties (lowest index
  first): equal;
- ``optim/residuals.transform_points``: within 1e-5 m;
- ``optim/ba.ba_iteration``, one damped step on both Schur routes: poses
  within 1e-4 and points within 1e-3 m (the gates of tests/test_torch_optim.py
  and tests/test_torch_ba_pcg.py), the camera steps dc within 1e-4 and the
  point steps dp within 1e-3 m;
- ``ops/extract.Keypoints.capacity`` and ``count()``: equal, on the keypoints
  of one rendered frame.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_orb_slam_tpu.config import OrbConfig as JOrb
from c_orb_slam_tpu.geometry import se3 as jse3
from c_orb_slam_tpu.ops import extract as jext, fast as jfast, hamming as jham
from c_orb_slam_tpu.optim import ba as jba, residuals as jres
from c_orb_slam_tpu_torch.config import OrbConfig as TOrb
from c_orb_slam_tpu_torch.ops import extract as text, fast as tfast, hamming as tham
from c_orb_slam_tpu_torch.optim import ba as tba, residuals as tres

from synthetic import blob_world, render_scene, smooth_trajectory
from test_torch_optim import _ba_problem

torch.set_num_threads(1)


@pytest.mark.parametrize("threshold", [7.0, 20.0])
def test_fast_response_matches_jax(threshold):
    img = np.random.default_rng(0).integers(0, 256, (60, 80)).astype(np.float32)
    cj, sj = jfast.fast_response(jnp.asarray(img), threshold)
    ct, st = tfast.fast_response(torch.from_numpy(img), threshold)
    assert np.asarray(cj).any()
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("shape", [(50, 70), (70, 50)])
def test_mutual_best_matches_jax(shape):
    d = np.random.default_rng(1).integers(0, 40, shape).astype(np.int32)  # many ties
    rj, mj = jham.mutual_best(jnp.asarray(d))
    rt, mt = tham.mutual_best(torch.from_numpy(d))
    assert rt.dtype == torch.int32 and np.asarray(mj).any()
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def test_transform_points_matches_jax():
    rng = np.random.default_rng(2)
    T = np.array(jse3.exp(jnp.asarray(rng.normal(0, 0.5, 6).astype(np.float32))))
    xw = rng.normal(0, 5, (100, 3)).astype(np.float32)
    want = np.asarray(jres.transform_points(jnp.asarray(T), jnp.asarray(xw)))
    got = tres.transform_points(torch.from_numpy(T), torch.from_numpy(xw))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("schur", ["dense", "pcg"])
@pytest.mark.parametrize("stereo", [False, True])
def test_ba_iteration_matches_jax(schur, stereo):
    arrs = _ba_problem(stereo=stereo)
    jp = jba.sort_by_point(jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrs.items()}))
    tp = tba.sort_by_point(tba.BAProblem(**{k: torch.from_numpy(np.array(v))
                                            for k, v in arrs.items()}))
    want = jba.ba_iteration(jp, jnp.float32(1e-4), True, 5.991, 7.815, 40, schur=schur,
                            obs_pt_sorted=True)
    got = tba.ba_iteration(tp, 1e-4, True, 5.991, 7.815, 40, schur=schur, obs_pt_sorted=True)
    for g, w, tol in zip(got, want, (1e-4, 1e-3, 1e-4, 1e-3)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol)
    fixed = arrs["cam_fixed"] | ~arrs["cam_valid"]
    np.testing.assert_array_equal(got[0].numpy()[fixed], arrs["cam_T"][fixed])


def test_keypoints_capacity_and_count_match_jax():
    xw, inten, size = blob_world(400, seed=5)
    img = render_scene(xw, inten, size, smooth_trajectory(2)[0], (250.0, 250.0, 160.0, 120.0),
                       h=240, w=320).astype(np.float32)
    kj = jext.extract_orb(jnp.asarray(img), JOrb(n_features=400, n_levels=4))
    kt = text.extract_orb(torch.from_numpy(img), TOrb(n_features=400, n_levels=4))
    assert kt.capacity == kj.capacity == kt.xy.shape[0]
    n = kt.count()
    assert n.dtype == torch.int32 and 0 < int(n) <= kt.capacity
    assert int(n) == int(kj.count())
