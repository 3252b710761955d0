"""Parity of the port's bag-of-words stack (bow/vocab.py, bow/database.py)
with the JAX package's, on the CPU, from the same numpy inputs.

Integer outputs (word ids, node ids, shared-word counts, candidate lists)
must be equal. idf weights are gathered, so equal too. Aggregated tf-idf
rows and scores are float32 sums whose order differs between the two
sides: 1e-6 absolute (values are <= 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_orb_slam_tpu.bow import database as jdb
from c_orb_slam_tpu.bow import vocab as jvoc
from c_orb_slam_tpu_torch.bow import database as tdb
from c_orb_slam_tpu_torch.bow import vocab as tvoc

ATOL = 1e-6


def _rand_descs(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _td(d):
    """uint32 descriptors -> the port's int32 tensor (same bits)."""
    return torch.from_numpy(np.ascontiguousarray(d).view(np.int32).copy())


def _tb(v):
    return torch.from_numpy(np.asarray(v, bool).copy())


@pytest.fixture(scope="module")
def shipped():
    pj, pt = jvoc.builtin_vocabulary_path(), tvoc.builtin_vocabulary_path()
    assert pj and pt and pj != pt, "each package ships its own copy"
    return jvoc.load(pj), tvoc.load(pt)


@pytest.fixture(scope="module")
def small():
    """A small vocabulary trained by each package's own trainer from the
    same descriptors and seed."""
    rng = np.random.default_rng(0)
    images = [_rand_descs(rng, 120) for _ in range(12)]
    return (
        jvoc.train_vocabulary(images, k=8, L=3, levels_up=1, seed=1),
        tvoc.train_vocabulary(images, k=8, L=3, levels_up=1, seed=1),
    )


def _assert_same_voc(vj, vt):
    assert (vj.k, vj.L, vj.levels_up) == (vt.k, vt.L, vt.levels_up)
    for l in range(vj.L):
        np.testing.assert_array_equal(
            np.asarray(vj.levels[l]), vt.levels[l].numpy().view(np.uint32)
        )
        np.testing.assert_array_equal(np.asarray(vj.valid[l]), vt.valid[l].numpy())
    np.testing.assert_array_equal(np.asarray(vj.word_weight), vt.word_weight.numpy())


def test_shipped_vocabulary_is_the_same_tree(shipped):
    vj, vt = shipped
    assert vt.n_words == 10**5 and vt.node_level() == vj.node_level()
    _assert_same_voc(vj, vt)


def test_trainer_matches_jax(small):
    _assert_same_voc(*small)


def _transform_both(vj, vt, d, valid):
    fj = jvoc.transform(vj, jnp.asarray(d), jnp.asarray(valid))
    ft = tvoc.transform(vt, _td(d), _tb(valid))
    return fj, ft


@pytest.mark.parametrize("which", ["shipped", "small"])
def test_transform_matches_jax(which, request):
    vj, vt = request.getfixturevalue(which)
    rng = np.random.default_rng(3)
    # Random descriptors, plus copies of tree nodes with a few bits
    # flipped (realistic near-word queries, where distance ties between
    # children are common).
    d = _rand_descs(rng, 300)
    leaves = np.asarray(vj.levels[-1])
    near = leaves[rng.integers(0, len(leaves), 300)].copy()
    near[:, rng.integers(0, 8)] ^= np.uint32(1 << 7)
    d = np.concatenate([d, near])
    valid = np.ones(len(d), bool)
    valid[::9] = False
    fj, ft = _transform_both(vj, vt, d, valid)
    np.testing.assert_array_equal(ft.word.numpy(), np.asarray(fj.word))
    np.testing.assert_array_equal(ft.node.numpy(), np.asarray(fj.node))
    np.testing.assert_array_equal(ft.weight.numpy(), np.asarray(fj.weight))
    assert (ft.word.numpy()[~valid] == -1).all()


def test_transform_takes_the_first_child_on_a_tie():
    """Two children at equal distance: the lower slot wins at every level
    (jnp.argmin's rule), whatever follows below it."""
    k, L = 3, 2
    lv0 = np.zeros((3, 8), np.uint32)
    lv0[1, 0] = 0b11  # distance 2 from the zero query
    lv0[2, 0] = 0b00  # ties with child 0 at distance 0
    lv1 = np.zeros((9, 8), np.uint32)
    lv1[0, 0] = 0b1
    lv1[1, 0] = 0b1  # children 0 and 1 of node 0 tie at distance 1
    lv1[2, 0] = 0b111
    voc = tvoc._from_numpy(k, L, [lv0, lv1], [np.ones(3, bool), np.ones(9, bool)],
                           np.arange(9, dtype=np.float32), 1, "cpu")
    fb = tvoc.transform(voc, torch.zeros(1, 8, dtype=torch.int32), torch.ones(1, dtype=torch.bool))
    assert int(fb.node[0]) == 0 and int(fb.word[0]) == 0


def _frame_bows(vj, vt, n_frames=10, n=150, seed=4):
    """Per-frame descriptor sets that share words: each frame perturbs a
    common pool, so BoW scores are far from zero."""
    rng = np.random.default_rng(seed)
    pools = [_rand_descs(rng, n) for _ in range(3)]
    out = []
    for i in range(n_frames):
        d = pools[i % 3].copy()
        flip = rng.integers(0, n, n // 4)
        d[flip] = _rand_descs(rng, len(flip))
        valid = np.ones(n, bool)
        valid[rng.integers(0, n, 5)] = False
        out.append((d, valid) + _transform_both(vj, vt, d, valid))
    return out


def test_aggregate_bow_dev_matches_host_and_jax(small):
    vj, vt = small
    for d, valid, fj, ft in _frame_bows(vj, vt, 3):
        cap = 160
        wj, aj = jdb.aggregate_bow_dev(fj.word, fj.weight, cap)
        wt, at = tdb.aggregate_bow_dev(ft.word, ft.weight, cap)
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=ATOL)
        host = tdb.aggregate_bow(ft, cap)
        np.testing.assert_array_equal(wt.numpy(), host.word)
        np.testing.assert_allclose(at.numpy(), host.weight, atol=ATOL)
        hj = jdb.aggregate_bow(fj, cap)
        np.testing.assert_array_equal(host.word, hj.word)
        assert host.n == hj.n


def test_aggregate_bow_dev_overflow_goes_to_the_spare_slot(small):
    """More unique words than the capacity: the first `cap` words survive
    (as with the JAX scatter's dropped writes) and nothing is written out
    of range."""
    _, vt = small
    rng = np.random.default_rng(5)
    d = _rand_descs(rng, 200)
    ft = tvoc.transform(vt, _td(d), torch.ones(200, dtype=torch.bool))
    cap = 16
    w, a = tdb.aggregate_bow_dev(ft.word, ft.weight, cap)
    uniq = np.unique(ft.word.numpy())
    np.testing.assert_array_equal(w.numpy(), uniq[:cap])
    assert abs(float(a.sum()) - 1.0) < 1e-5


def _databases(vj, vt, frames, cap=160, n_slots=16):
    dj = jdb.KeyFrameDatabase(vj, n_slots, cap)
    dt = tdb.KeyFrameDatabase(vt, n_slots, cap)
    for k, (d, valid, fj, ft) in enumerate(frames):
        dj.add_dev(k, *jdb.aggregate_bow_dev(fj.word, fj.weight, cap))
        dt.add_dev(k, *tdb.aggregate_bow_dev(ft.word, ft.weight, cap))
    return dj, dt


def test_score_all_matches_jax(small):
    vj, vt = small
    frames = _frame_bows(vj, vt)
    dj, dt = _databases(vj, vt, frames[:-1])
    _, _, fj, ft = frames[-1]
    qj = jdb.aggregate_bow_dev(fj.word, fj.weight, 160)
    qt = tdb.aggregate_bow_dev(ft.word, ft.weight, 160)
    sj, nj = dj.scores_dev(*qj, exclude=(2,))
    st, nt = dt.scores_dev(*qt, exclude=(2,))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=ATOL)
    assert st[2] == -1.0 and (st[len(frames) - 1:] == -1.0).all()
    assert float(st.max()) > 0.3  # the shared pool scores high


class _Covis:
    """Stand-in for MapState.covisible_keyframes: ring neighbours."""

    def __init__(self, n):
        self.n = n

    def covisible_keyframes(self, k, n=10, min_weight=15):
        return [(k - 1) % self.n, (k + 1) % self.n]


def test_candidate_lists_match_jax(small):
    vj, vt = small
    frames = _frame_bows(vj, vt, 13)
    dj, dt = _databases(vj, vt, frames[:-1])
    _, _, fj, ft = frames[-1]
    bj, bt = jdb.aggregate_bow(fj, 160), tdb.aggregate_bow(ft, 160)
    ms = _Covis(12)
    loop_j = dj.detect_loop_candidates(bj, 0.05, [11], ms, 12)
    loop_t = dt.detect_loop_candidates(bt, 0.05, [11], ms, 12)
    assert loop_t == loop_j and len(loop_t) >= 1
    reloc_j = dj.detect_reloc_candidates(bj, ms)
    reloc_t = dt.detect_reloc_candidates(bt, ms)
    assert reloc_t == reloc_j and len(reloc_t) >= 1
    dj.erase(loop_j[0])
    dt.erase(loop_t[0])
    assert dt.detect_reloc_candidates(bt, ms) == dj.detect_reloc_candidates(bj, ms)


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_npz_saved_by_either_package_loads_in_the_other(small, tmp_path, saver):
    vj, vt = small
    p = str(tmp_path / "voc.npz")
    (jvoc.save(vj, p) if saver == "jax" else tvoc.save(vt, p))
    _assert_same_voc(jvoc.load(p), tvoc.load(p))


def _write_dbow2_text(path, rng):
    """A ragged k=3, L=3 DBoW2 text vocabulary: one depth-1 leaf, one
    depth-2 leaf, the rest full depth."""
    lines = ["3 3 0 0"]
    nid = 0

    def node(parent, leaf, w):
        nonlocal nid
        nid += 1
        d = " ".join(str(int(b)) for b in rng.integers(0, 256, 32))
        lines.append(f"{parent} {int(leaf)} {d} {w}")
        return nid

    a = node(0, False, 0.0)
    node(0, True, 1.5)  # leaf above depth L
    c = node(0, False, 0.0)
    for top in (a, c):
        for j in range(3):
            if top == a and j == 1:
                node(top, True, 2.5)  # depth-2 leaf
                continue
            mid = node(top, False, 0.0)
            for _ in range(2):
                node(mid, True, float(rng.uniform(0.5, 3.0)))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def test_load_dbow2_text_matches_jax_and_round_trips(tmp_path):
    p = str(tmp_path / "voc.txt")
    _write_dbow2_text(p, np.random.default_rng(7))
    vj, vt = jvoc.load_dbow2_text(p, levels_up=1), tvoc.load_dbow2_text(p, levels_up=1)
    _assert_same_voc(vj, vt)
    assert float(vt.word_weight.max()) > 0
    q = str(tmp_path / "voc.npz")
    tvoc.save(vt, q)
    _assert_same_voc(vj, tvoc.load(q))
    d = _rand_descs(np.random.default_rng(8), 64)
    fj, ft = _transform_both(vj, vt, d, np.ones(64, bool))
    np.testing.assert_array_equal(ft.word.numpy(), np.asarray(fj.word))
