"""The four device programs of the port's loop_closing.py against the JAX
package's, on the CPU, from the same numpy inputs (a small synthetic map:
keyframes on an arc seeing a shared point cloud).

Tolerances: transforms and moved points 2e-5 (float32 Sim3 chains:
from_se3 -> compose -> inverse -> apply); match indices and masks equal.
``_pg_finalize_program`` gets inputs on which the two candidate rules for
a point's reference vertex agree (every point's reference keyframe is
the keyframe that moved it), so that test pins the remap formula, not a
choice of reference; test_pg_finalize_remaps_propagated_points_once pins
the choice, where the port parts from the JAX package on purpose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from c_orb_slam_tpu import loop_closing as jlc
from c_orb_slam_tpu.geometry import sim3 as jsim3
from c_orb_slam_tpu_torch import loop_closing as tlc

K4 = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
NK, NP, NF = 6, 90, 64  # keyframes, points, features per keyframe


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    xyz = np.c_[rng.uniform(-2, 2, (NP, 2)), rng.uniform(5, 9, NP)].astype(np.float32)
    pt_desc = rng.integers(0, 2**32, (NP, 8), dtype=np.uint64).astype(np.uint32)
    poses = np.tile(np.eye(3, 4, dtype=np.float32), (NK, 1, 1))
    for k in range(NK):
        a = 0.03 * k
        poses[k, :, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        poses[k, :, 3] = [0.15 * k, 0.0, 0.05 * k]
    kf_xy = np.zeros((NK, NF, 2), np.float32)
    kf_desc = np.zeros((NK, NF, 8), np.uint32)
    kf_valid = np.zeros((NK, NF), bool)
    kf_mp = np.full((NK, NF), -1, np.int64)
    for k in range(NK):
        sel = rng.permutation(NP)[:NF]
        xc = xyz[sel] @ poses[k, :, :3].T + poses[k, :, 3]
        kf_xy[k] = np.stack([500 * xc[:, 0] / xc[:, 2] + 320, 500 * xc[:, 1] / xc[:, 2] + 240], 1)
        kf_xy[k] += rng.normal(size=(NF, 2)).astype(np.float32) * 0.5
        d = pt_desc[sel].copy()
        d[:, 0] ^= (1 << rng.integers(0, 32, NF)).astype(np.uint32)  # one bit of noise
        kf_desc[k] = d
        kf_valid[k] = rng.random(NF) > 0.1
        kf_mp[k] = sel
    pt_valid = rng.random(NP) > 0.05
    return dict(xyz=xyz, pt_desc=pt_desc, pt_valid=pt_valid, poses=poses,
                kf_xy=kf_xy, kf_desc=kf_desc, kf_valid=kf_valid, kf_mp=kf_mp)


def _S_cl():
    return np.asarray(jsim3.exp(jnp.asarray([0.1, -0.05, 0.08, 0.01, 0.03, -0.02, 0.04], jnp.float32)))


def test_propagate_program_matches_jax():
    s = _scene()
    g_idx = np.array([5, 4, 3], np.int64)
    rng = np.random.default_rng(1)
    sel = np.sort(rng.permutation(NP)[:40]).astype(np.int64)
    owner = rng.integers(0, len(g_idx), len(sel)).astype(np.int64)
    want = jlc._propagate_program(
        jnp.asarray(s["poses"]), jnp.asarray(s["xyz"]), jnp.asarray(_S_cl()),
        jnp.int32(0), jnp.int32(5), jnp.asarray(g_idx, jnp.int32),
        jnp.asarray(owner, jnp.int32), jnp.asarray(sel),
    )
    got = tlc._propagate_program(
        _t(s["poses"]), _t(s["xyz"]), _t(_S_cl()), 0, 5, _t(g_idx), _t(owner), _t(sel)
    )
    for name, g, w in zip(("S_all", "S_g_corr", "T_g_new", "x_new", "S_cw_corr"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, err_msg=name)
    # The current keyframe's corrected pose is S_cl ∘ S_loop.
    np.testing.assert_allclose(got[1][0].numpy(), got[4].numpy(), atol=2e-5)


def test_fuse_block_program_matches_jax():
    s = _scene()
    gb = np.array([1, 2, 4, 4], np.int64)  # a short block repeats its last slot
    pts = np.arange(0, NP, 2).astype(np.int64)
    mask = np.ones(len(pts), bool)
    mask[-3:] = False
    want = jlc._fuse_block_program(
        *(jnp.asarray(s[k]) for k in ("poses", "kf_desc", "kf_valid", "kf_xy", "xyz", "pt_desc", "pt_valid")),
        jnp.asarray(gb), jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(K4), max_dist=50,
    )
    got = tlc._fuse_block_program(
        *(_t(s[k]) for k in ("poses", "kf_desc", "kf_valid", "kf_xy", "xyz", "pt_desc", "pt_valid")),
        _t(gb), _t(pts), _t(mask), _t(K4), max_dist=50,
    )
    wv = np.asarray(want[1])
    np.testing.assert_array_equal(got[1].numpy(), wv)
    np.testing.assert_array_equal(got[0].numpy()[wv], np.asarray(want[0])[wv])
    assert wv.sum() > 40 and not wv[:, -3:].any()


def test_sim3_widen_program_matches_jax():
    s = _scene()
    kf1, kf2 = 0, 3
    T1 = np.vstack([s["poses"][kf1], [0, 0, 0, 1]])
    T2 = np.vstack([s["poses"][kf2], [0, 0, 0, 1]])
    T12 = (T1 @ np.linalg.inv(T2))[:3].astype(np.float32)
    S12 = np.asarray(jsim3.from_se3(jnp.asarray(T12)))
    p1, p2 = s["kf_mp"][kf1], s["kf_mp"][kf2]
    v1 = s["kf_valid"][kf1] & s["pt_valid"][p1]
    v2 = s["kf_valid"][kf2] & s["pt_valid"][p2]
    keys = ("poses", "kf_desc", "kf_valid", "kf_xy", "xyz", "pt_desc")
    want = jlc._sim3_widen_program(
        *(jnp.asarray(s[k]) for k in keys), jnp.asarray(S12), jnp.int32(kf1), jnp.int32(kf2),
        jnp.asarray(p1), jnp.asarray(v1), jnp.asarray(p2), jnp.asarray(v2),
        jnp.asarray(K4), max_dist=100,
    )
    got = tlc._sim3_widen_program(
        *(_t(s[k]) for k in keys), _t(S12), kf1, kf2, _t(p1), _t(v1), _t(p2), _t(v2),
        _t(K4), max_dist=100,
    )
    for i in (1, 3):
        wv = np.asarray(want[i])
        np.testing.assert_array_equal(got[i].numpy(), wv)
        np.testing.assert_array_equal(got[i - 1].numpy()[wv], np.asarray(want[i - 1])[wv])
        assert wv.sum() > 10


def test_pg_finalize_program_matches_jax():
    rng = np.random.default_rng(2)
    S_old = np.asarray(jax.vmap(jsim3.exp)(jnp.asarray(rng.normal(size=(NK, 7)) * 0.3, jnp.float32)))
    d = np.asarray(jax.vmap(jsim3.exp)(jnp.asarray(rng.normal(size=(NK, 7)) * 0.05, jnp.float32)))
    S_new = np.asarray(jax.vmap(jsim3.compose)(jnp.asarray(d), jnp.asarray(S_old)))
    xyz = rng.normal(size=(NP, 3)).astype(np.float32) * 3
    ref = rng.integers(0, NK, NP).astype(np.int64)
    want = jlc._pg_finalize_program(*(jnp.asarray(a) for a in (S_old, S_new, ref, xyz)))
    got = tlc._pg_finalize_program(*(_t(a) for a in (S_old, S_new, ref, xyz)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=2e-5)
    # A point keeps its coordinates in its reference keyframe's camera
    # (up to the scale change): S_new x' == S_old x.
    lhs = np.asarray(jax.vmap(jsim3.apply)(jnp.asarray(S_new[ref]), jnp.asarray(got[0].numpy())))
    rhs = np.asarray(jax.vmap(jsim3.apply)(jnp.asarray(S_old[ref]), jnp.asarray(xyz)))
    np.testing.assert_allclose(lhs, rhs, atol=5e-5)


def test_pg_finalize_remaps_propagated_points_once():
    """ROADMAP queue 3 g, a reference fault the port does not copy. The Sim3
    propagation moves the points of the group keyframes; the remap after
    the essential graph must then go through the group keyframe that moved
    each (ORB-SLAM2 Optimizer.cc:1021-1027, mnCorrectedReference), not
    through its reference keyframe: one outside the group applies its own
    correction a second time. The JAX package remaps every point through
    its reference keyframe (its loop_closing.py:1376); the port's
    _pg_finalize_refs takes the mover. Here half of the moved points are
    referenced outside the group: the port remaps every point once,
    x' = S_new[k]^-1 S_before[k] x for the keyframe k that corrects it, and
    JAX differs from the port on exactly the moved points referenced
    outside the group."""
    s = _scene()
    g_idx = np.array([5, 4, 3], np.int64)  # the current keyframe and its covisibles
    rng = np.random.default_rng(4)
    sel = np.sort(rng.permutation(NP)[:40]).astype(np.int64)  # points the group sees
    owner = rng.integers(0, len(g_idx), len(sel)).astype(np.int64)
    mover = g_idx[owner]
    ref_kf = rng.integers(0, 3, NP).astype(np.int64)  # outside the group ...
    inside = rng.random(len(sel)) < 0.5
    ref_kf[sel[inside]] = mover[inside]  # ... or the group keyframe that moves the point
    S_all, S_g_corr, _, x_new, _ = tlc._propagate_program(
        _t(s["poses"]), _t(s["xyz"]), _t(_S_cl()), 0, 5, _t(g_idx), _t(owner), _t(sel))
    xyz = s["xyz"].copy()
    xyz[sel] = x_new.numpy()
    # The essential graph's start (every keyframe's Sim3, the group's
    # corrected) and an optimized graph near it.
    verts_old = S_all.numpy().copy()
    verts_old[g_idx] = S_g_corr.numpy()
    delta = jax.vmap(jsim3.exp)(jnp.asarray(rng.normal(size=(NK, 7)) * 0.05, jnp.float32))
    verts_new = np.asarray(jax.vmap(jsim3.compose)(delta, jnp.asarray(verts_old)))

    moved_by = np.full(NP, -1, np.int64)
    moved_by[sel] = mover
    ref_t = tlc._pg_finalize_refs(ref_kf, moved_by, np.ones(NK, bool), 0)
    got = tlc._pg_finalize_program(*(_t(a) for a in (verts_old, verts_new, ref_t, xyz)))
    want = jlc._pg_finalize_program(*(jnp.asarray(a) for a in (verts_old, verts_new, ref_kf, xyz)))

    # Expected: each point corrected once, by the keyframe that corrects it.
    k = np.where(moved_by >= 0, moved_by, ref_kf)
    S_before = S_all.numpy()
    once = np.asarray(jax.vmap(jsim3.apply)(
        jax.vmap(jsim3.inverse)(jnp.asarray(verts_new[k])),
        jax.vmap(jsim3.apply)(jnp.asarray(S_before[k]), jnp.asarray(s["xyz"]))))
    np.testing.assert_allclose(got[0].numpy(), once, atol=5e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=2e-5)

    twice = np.zeros(NP, bool)
    twice[sel[~inside]] = True
    gap = np.abs(got[0].numpy() - np.asarray(want[0])).max(1)
    assert twice.sum() >= 10 and (gap[twice] > 1e-2).all(), gap[twice]
    assert (gap[~twice] < 2e-5).all(), gap[~twice].max()
