"""Parity of the port's matching (c_orb_slam_tpu_torch.ops.hamming, .match,
.window_top2) with the JAX package's, on the CPU, exact.

Exact because everything here is integer: Hamming distances (float32
products of 0/1 bits summing to <= 256, exact in float32), masks from the
same float32 subtractions and comparisons, argmin with lowest-index ties
on both sides. The JAX side of search_by_projection is its XLA branch
(the CPU suite's reference); window_top2's plain version is also held
against the Pallas kernel in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_orb_slam_tpu.ops import hamming as jham, match as jmatch, pallas_match
from c_orb_slam_tpu_torch.ops import hamming as tham, match as tmatch, window_top2 as tw2

# Input generators shared with the GPU tests (a module free of jax).
from test_torch_cuda import EDGE_CASES, SEARCH_CASES, _desc, _t, _window_case


def test_pack_unpack_and_popcount_match_jax():
    rng = np.random.default_rng(1)
    words = _desc(rng, (64,))
    bits = np.asarray(jham.unpack_bits(jnp.asarray(words)))
    np.testing.assert_array_equal(tham.unpack_bits(_t(words)).numpy(), bits)
    np.testing.assert_array_equal(
        tham.pack_bits(torch.from_numpy(bits.copy())).numpy().view(np.uint32), words
    )
    np.testing.assert_array_equal(tham.popcount(_t(words)).numpy(), bits.sum(-1))


@pytest.mark.parametrize("masked", [False, True])
def test_distance_matrix_and_best_two_match_jax(masked):
    rng = np.random.default_rng(2)
    a, b = _desc(rng, (70,)), _desc(rng, (90,), pool=None)
    va, vb = rng.random(70) > 0.2, rng.random(90) > 0.2
    pm = rng.random((70, 90)) > 0.5
    args = (a, b, va, vb, pm) if masked else (a, b)
    d_j = jham.masked_distance_matrix(*(jnp.asarray(x) for x in args))
    d_t = tham.masked_distance_matrix(*(_t(x) for x in args))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    for t, j in zip(tham.best_two(d_t), jham.best_two(d_j, axis=1)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("ratio", ["none", "plain", "same_octave"])
def test_match_matches_jax(ratio):
    rng = np.random.default_rng(3)
    Q, T = 150, 120
    td = _desc(rng, (T,))
    # Queries: noisy copies of targets (a few bits flipped), so true
    # matches, ratio failures and octave cases all occur.
    flips = (rng.random((Q, 8, 32)) < 0.04) << np.arange(32, dtype=np.uint64)
    qd = td[rng.integers(0, T, Q)] ^ flips.sum(-1).astype(np.uint32)
    td[rng.integers(0, T, 40)] = td[rng.integers(0, T, 40)]  # duplicate targets
    qv, tv = rng.random(Q) > 0.1, rng.random(T) > 0.1
    pm = rng.random((Q, T)) > 0.3
    toct = rng.integers(0, 4, T).astype(np.int32)
    kw = dict(max_dist=120, nn_ratio=1.0 if ratio == "none" else 0.8)
    j = jmatch.match(*(jnp.asarray(x) for x in (qd, td, qv, tv, pm)), **kw,
                     ratio_octave_t=jnp.asarray(toct) if ratio == "same_octave" else None)
    t = tmatch.match(*(_t(x) for x in (qd, td, qv, tv, pm)), **kw,
                     ratio_octave_t=_t(toct) if ratio == "same_octave" else None)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert t.valid.any() and not t.valid.all()


def test_rotation_consistency_matches_jax():
    rng = np.random.default_rng(4)
    aq = rng.uniform(-np.pi, np.pi, 200).astype(np.float32)
    at = (aq + rng.normal(0, 0.05, 200) + np.where(rng.random(200) < 0.3, 2.0, 0.0)).astype(np.float32)
    v = rng.random(200) > 0.1
    want = jmatch.rotation_consistency(jnp.asarray(aq), jnp.asarray(at), jnp.asarray(v))
    got = tmatch.rotation_consistency(_t(aq), _t(at), _t(v))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_epipolar_mask_matches_jax():
    rng = np.random.default_rng(5)
    F = rng.normal(size=(3, 3)).astype(np.float32) * np.array([1e-6, 1e-6, 1e-3], np.float32)
    xy1 = rng.uniform(0, 640, (50, 2)).astype(np.float32)
    xy2 = rng.uniform(0, 640, (60, 2)).astype(np.float32)
    s2 = (1.2 ** (2 * np.arange(4))).astype(np.float32)
    o2 = rng.integers(0, 4, 60).astype(np.int32)
    want = np.asarray(jmatch.epipolar_mask(*(jnp.asarray(x) for x in (F, xy1, xy2, s2, o2))))
    got = tmatch.epipolar_mask(*(_t(x) for x in (F, xy1, xy2, s2, o2))).numpy()
    # Same float32 formula; a pair may flip only where the chi2 sits on
    # the threshold to within rounding.
    assert (got != want).mean() < 1e-3




@pytest.mark.parametrize("nn_ratio", [1.0, 0.8])
@pytest.mark.parametrize("case", sorted(SEARCH_CASES) + sorted(EDGE_CASES))
def test_search_by_projection_matches_jax_xla_branch(case, nn_ratio):
    c = _window_case(7, **{**SEARCH_CASES, **EDGE_CASES}[case])
    order = ("q_uv", "q_radius", "q_desc", "q_valid", "t_xy", "t_octave", "t_desc",
             "t_valid", "q_lo", "q_hi")
    kw = dict(max_dist=100, nn_ratio=nn_ratio)
    assert not jmatch._want_pallas(c["q_desc"].shape[0], c["t_desc"].shape[0])
    j = jmatch.search_by_projection(*(jnp.asarray(c[k]) for k in order), **kw)
    t = tmatch.search_by_projection(*(_t(c[k]) for k in order), **kw)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if case.startswith(("motion", "local", "unaligned")):
        assert t.valid.any()


def _idx2_rule(d: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """The lowest-index minimum over j != idx (idx2 of match.match)."""
    d2 = d.astype(np.int64).copy()
    d2[np.arange(len(idx)), idx] = 1 << 20
    return np.argmin(d2, axis=1)


@pytest.mark.parametrize("case", sorted(SEARCH_CASES) + ["batch_4x100x100"])
def test_window_top2_plain_matches_pallas_interpret(case):
    """The plain version against the TPU kernel (Pallas, interpret mode
    on the CPU) on best/idx/second, and idx2 against its rule on the JAX
    distance matrix."""
    batched = case.startswith("batch")
    spec = dict(Q=100, T=100, batch=4) if batched else SEARCH_CASES[case]
    c = _window_case(11, **spec)
    got = [x.numpy() for x in tw2.window_top2(**{k: _t(v) for k, v in c.items()})]
    for b in range(spec.get("batch") or 1):
        cb = {k: (v[b] if batched else v) for k, v in c.items()}
        want = pallas_match.window_top2(*(jnp.asarray(cb[k]) for k in (
            "q_desc", "q_uv", "q_radius", "q_lo", "q_hi", "q_valid",
            "t_desc", "t_xy", "t_octave", "t_valid")))
        gb = [g[b] if batched else g for g in got]
        for name, g, w in zip(("best", "idx", "second"), gb, want):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
        mask = jmatch.window_mask(jnp.asarray(cb["q_uv"]), jnp.asarray(cb["q_radius"]),
                                  jnp.asarray(cb["t_xy"])) & jmatch.octave_mask(
            jnp.asarray(cb["t_octave"]), jnp.asarray(cb["q_lo"]), jnp.asarray(cb["q_hi"]))
        d = np.asarray(jham.masked_distance_matrix(
            jnp.asarray(cb["q_desc"]), jnp.asarray(cb["t_desc"]),
            jnp.asarray(cb["q_valid"]), jnp.asarray(cb["t_valid"]), mask))
        np.testing.assert_array_equal(gb[3], _idx2_rule(d, gb[1]))


def test_window_top2_edge_rules():
    """Fully masked rows give (512, 0, 512, 1); a single target gives
    idx2 = 0 and second = 512."""
    c = _window_case(13, Q=8, T=5)
    c["q_valid"][:] = False
    best, idx, second, idx2 = (x.numpy() for x in tw2.window_top2(**{k: _t(v) for k, v in c.items()}))
    assert (best == 512).all() and (idx == 0).all() and (second == 512).all() and (idx2 == 1).all()
    c = _window_case(13, Q=8, T=1)
    _, idx, second, idx2 = (x.numpy() for x in tw2.window_top2(**{k: _t(v) for k, v in c.items()}))
    assert (idx == 0).all() and (idx2 == 0).all() and (second == 512).all()


def test_window_top2_wrapper_validates_and_counts_only_launches():
    c = {k: _t(v) for k, v in _window_case(17, Q=16, T=20).items()}
    before = tw2.launches
    tw2.window_top2(**c)
    assert tw2.launches == before  # the CPU path is the plain version
    with pytest.raises(TypeError):
        tw2.window_top2(**{**c, "q_radius": c["q_radius"].double()})
    with pytest.raises(ValueError):
        tw2.window_top2(**{**c, "t_xy": c["t_xy"].t().contiguous().t()})
    with pytest.raises(ValueError):
        tw2.window_top2(**{**c, "q_lo": c["q_lo"][:-1]})
