"""Parity of the port's two-view initialization (ops/twoview.initialize)
and its matcher (match.search_for_initialization) with the JAX package's,
on the CPU.

initialize runs on the four problems of tests/test_twoview.py with the
JAX package's hypothesis draw injected (idx from twoview._sample_indices
with the same key), so both sides score the same 256 sample sets. Gates:
the same ok and used_homography, T21 within 3e-4, and the good masks
equal on at least 99% of rows (a point whose reprojection error or
parallax sits on a gate may flip). T21 cannot be held to 1e-4: with the
same inlier sets the refit F agrees to 6e-6, but E = KᵀFK scales F's
small pixel-space entries by fx*fy, and each side's motion then lies up
to 1.3e-4 from a float64 evaluation of the same function (measured on
these four problems), so two float32 evaluations part by up to twice
that. search_for_initialization is held exact on two rendered
frames: it is integer Hamming arithmetic and masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_orb_slam_tpu import config as jcfg
from c_orb_slam_tpu.frontend import frame as jframe
from c_orb_slam_tpu.geometry import so3 as jso3
from c_orb_slam_tpu.ops import match as jmatch, twoview as jtv
from c_orb_slam_tpu_torch.ops import match as tmatch, twoview as ttv

from synthetic import blob_world, render_scene, smooth_trajectory
from test_twoview import two_view_obs

K = np.array([500.0, 500.0, 320.0, 240.0], np.float32)


def _rot(w):
    return np.asarray(jso3.exp(jnp.asarray(w, jnp.float32)))


def _general(seed=1, n=300):
    rng = np.random.default_rng(seed)
    return np.c_[rng.uniform(-3, 3, size=(n, 2)), rng.uniform(4, 12, size=n)].astype(np.float32)


def _case(name):
    """(uv1, uv2, valid, key) of each tests/test_twoview.py problem."""
    if name == "general_f":
        uv1, uv2, _ = two_view_obs(_general(1), _rot([0.02, -0.04, 0.01]),
                                   np.array([-0.4, 0.05, 0.02], np.float32), seed=1)
        return uv1, uv2, np.ones(300, bool), 0
    if name == "planar_h":
        rng = np.random.default_rng(2)
        xy = rng.uniform(-3, 3, size=(300, 2))
        xw = np.c_[xy, 6.0 + 0.3 * xy[:, 0] + 0.2 * xy[:, 1]].astype(np.float32)
        uv1, uv2, _ = two_view_obs(xw, _rot([0.03, -0.02, 0.01]),
                                   np.array([-0.5, 0.1, 0.05], np.float32),
                                   noise=0.3, outlier_frac=0.05, seed=2)
        return uv1, uv2, np.ones(300, bool), 1
    if name == "pure_rotation":
        uv1, uv2, _ = two_view_obs(_general(3, 200), _rot([0.0, 0.05, 0.0]), np.zeros(3, np.float32),
                                   noise=0.3, outlier_frac=0.0, seed=3)
        return uv1, uv2, np.ones(200, bool), 2
    uv1, uv2, _ = two_view_obs(_general(4, 200), _rot([0.02, -0.04, 0.01]),
                               np.array([-0.4, 0.05, 0.02], np.float32), outlier_frac=0.0, seed=4)
    uv2 = uv2.at[:100].add(500.0)
    return uv1, uv2, np.arange(200) >= 100, 3


@pytest.mark.parametrize("name", ["general_f", "planar_h", "pure_rotation", "masked"])
def test_initialize_matches_jax(name):
    uv1, uv2, valid, seed = _case(name)
    key = jax.random.PRNGKey(seed)
    j = jtv.initialize(uv1, uv2, jnp.asarray(valid), jnp.asarray(K), key)
    idx = np.array(jtv._sample_indices(key, 256, len(valid), jnp.asarray(valid)), copy=True)
    t = ttv.initialize(
        *(torch.from_numpy(np.array(a)) for a in (uv1, uv2, valid, K)), idx=torch.from_numpy(idx)
    )
    assert bool(t.ok) == bool(j.ok) == (name != "pure_rotation")
    assert bool(t.used_homography) == bool(j.used_homography)
    if name in ("general_f", "planar_h"):
        assert bool(t.used_homography) == (name == "planar_h")
    # The chosen model's score; the other one may rest on a degenerate fit
    # (F of a planar scene) whose inlier set flips points on the gate.
    chosen = "score_h" if bool(j.used_homography) else "score_f"
    np.testing.assert_allclose(float(getattr(t, chosen)), float(getattr(j, chosen)), rtol=1e-3)
    if bool(j.ok):
        np.testing.assert_allclose(t.T21.numpy(), np.asarray(j.T21), atol=3e-4)
        assert (t.good.numpy() == np.asarray(j.good)).mean() >= 0.99
        assert not t.good.numpy()[~valid].any()


def test_search_for_initialization_matches_jax():
    cfg = jcfg.SlamConfig(camera=jcfg.CameraConfig(), orb=jcfg.OrbConfig(n_features=800, n_levels=4))
    xw, inten, size = blob_world(400, seed=5)
    traj = smooth_trajectory(30)
    f0, f1 = (
        jframe.FrameData(*(np.asarray(x) for x in jframe.build_mono(
            jnp.asarray(render_scene(xw, inten, size, traj[i], tuple(K))), cfg)))
        for i in (0, 3)
    )
    args = (f0.xy, f0.desc, f0.valid, f0.angle, f1.xy, f1.desc, f1.valid, f1.angle)
    for octave in (np.zeros_like(f1.octave), f1.octave):  # the tracker's and the full gate
        j = jmatch.search_for_initialization(*(jnp.asarray(a) for a in args), jnp.asarray(octave),
                                             window=100.0, max_dist=50, nn_ratio=0.9)
        t = tmatch.search_for_initialization(
            *(torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
              for a in args + (octave,)),
            window=100.0, max_dist=50, nn_ratio=0.9,
        )
        for got, want in zip(t, j):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(j.valid.sum()) > 100
