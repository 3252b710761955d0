"""Hierarchical binary-descriptor vocabulary: dense-array k^L tree.

Counterpart of c_orb_slam_tpu/bow/vocab.py (reference:
Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h — HKmeansStep training
(:648-749), greedy per-descriptor descent transform (:1218-1259), tf-idf
weighting (:799-827), text (de)serialization (:1338-1424); FORB.cpp —
popcount distance (:81), bitwise-majority meanValue (:28-77)).

The tree is stored level-major as one (k^l, 8) descriptor array per level,
children of node i at level l-1 occupying slots [i*k, (i+1)*k) at level l.
The transform of a whole frame's descriptors is L iterations of
gather -> batched popcount -> argmin over all descriptors at once.
Descriptor words are int32 carrying the uint32 bit pattern; files hold
uint32, so an npz saved by either package loads in the other.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from c_orb_slam_tpu_torch.ops import hamming


class Vocabulary(NamedTuple):
    """Dense k^L vocabulary tree.

    levels[l] has shape (k^(l+1), 8) int32: the node descriptors at tree
    depth l+1 (the root stores no descriptor). valid[l] marks live nodes
    (the tree need not be complete). word_weight (k^L,) are idf weights.
    """

    k: int
    L: int
    levels: tuple  # tuple of (k^(l+1), 8) int32 tensors
    valid: tuple  # tuple of (k^(l+1),) bool tensors
    word_weight: torch.Tensor  # (k^L,) float32 idf
    levels_up: int  # feature-vector grouping depth from the leaves

    @property
    def n_words(self) -> int:
        return self.k**self.L

    @property
    def device(self) -> torch.device:
        return self.word_weight.device

    def node_level(self) -> int:
        """Tree depth whose node ids group features for matching
        (reference: levelsup=4 from L=6, Frame.cc:400)."""
        return max(self.L - self.levels_up, 1)

    def to(self, device) -> "Vocabulary":
        return self._replace(
            levels=tuple(d.to(device) for d in self.levels),
            valid=tuple(v.to(device) for v in self.valid),
            word_weight=self.word_weight.to(device),
        )


class FrameBow(NamedTuple):
    word: torch.Tensor  # (N,) int32 leaf word id (-1 for invalid descriptor)
    node: torch.Tensor  # (N,) int32 node id at node_level (matching gate)
    weight: torch.Tensor  # (N,) float32 idf of the word


def transform(voc: Vocabulary, desc: torch.Tensor, d_valid: torch.Tensor) -> FrameBow:
    """(word_id, node_id, idf weight) per descriptor: the batched greedy
    descent of all descriptors through the tree.

    Reference: TemplatedVocabulary::transform(features, BowVec, FeatVec)
    TemplatedVocabulary.h:1127-1194; here the BowVec/FeatVec sparse maps
    are the per-descriptor arrays (aggregation happens in the database).
    """
    k, L, node_level = voc.k, voc.L, voc.node_level()
    n = desc.shape[0]
    child = torch.arange(k, device=desc.device)
    cur = torch.zeros(n, dtype=torch.int64, device=desc.device)
    node_at = cur
    for l in range(L):
        slots = (cur * k)[:, None] + child  # (N, k)
        dist = hamming.distance(desc[:, None, :], voc.levels[l][slots])
        dist = torch.where(
            voc.valid[l][slots], dist, torch.full_like(dist, hamming.INVALID_DIST)
        )
        # Lowest distance, ties to the lowest child: the minimum of
        # dist * k + child is unique, whatever the reduction order.
        best = (dist.to(torch.int64) * k + child).amin(dim=1) % k
        cur = cur * k + best
        if l + 1 == node_level:
            node_at = cur
    w = voc.word_weight[cur]
    minus = torch.full((n,), -1, dtype=torch.int32, device=desc.device)
    return FrameBow(
        word=torch.where(d_valid, cur.to(torch.int32), minus),
        node=torch.where(d_valid, node_at.to(torch.int32), minus),
        weight=torch.where(d_valid, w, torch.zeros_like(w)),
    )


# ---------------------------------------------------------------------------
# Training (host-side, offline tool — the reference ships a pre-trained
# 140MB ORBvoc.txt; small vocabularies are trained from sampled descriptors).
# ---------------------------------------------------------------------------


def _as_u32(descs: np.ndarray) -> np.ndarray:
    descs = np.ascontiguousarray(descs)
    return descs.view(np.uint32) if descs.dtype == np.int32 else descs


def _unpack(descs: np.ndarray) -> np.ndarray:
    """(N, 8) uint32 -> (N, 256) uint8 bits."""
    b = _as_u32(descs).view(np.uint8).reshape(len(descs), 32)
    return np.unpackbits(b, axis=1, bitorder="little")


def _pack(bits: np.ndarray) -> np.ndarray:
    return np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little").view(
        np.uint32
    )


def _hamming_np(a_bits: np.ndarray, b_bits: np.ndarray) -> np.ndarray:
    """(Na, 256) x (Nb, 256) -> (Na, Nb) int distances via bit matmul."""
    # XOR popcount = |a| + |b| - 2 a.b on 0/1 vectors.
    dots = a_bits.astype(np.int32) @ b_bits.astype(np.int32).T
    na = a_bits.sum(axis=1, dtype=np.int32)[:, None]
    nb = b_bits.sum(axis=1, dtype=np.int32)[None, :]
    return na + nb - 2 * dots


def _kmedians(bits: np.ndarray, k: int, rng: np.random.Generator, iters: int = 8):
    """Binary k-means with bitwise-majority centroids (reference:
    FORB::meanValue, FORB.cpp:28-77; HKmeansStep TemplatedVocabulary.h:648).

    Returns (centroids (k, 256) or fewer, assignment (N,))."""
    n = len(bits)
    kk = min(k, n)
    sel = rng.choice(n, size=kk, replace=False)
    cent = bits[sel].copy()
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = _hamming_np(bits, cent)
        new_assign = d.argmin(axis=1)
        if (new_assign == assign).all():
            assign = new_assign
            break
        assign = new_assign
        for c in range(kk):
            members = bits[assign == c]
            if len(members) == 0:
                # re-seed dead cluster at the farthest descriptor
                far = d.min(axis=1).argmax()
                cent[c] = bits[far]
            else:
                cent[c] = (members.mean(axis=0) > 0.5).astype(np.uint8)
    return cent, assign


def _from_numpy(k, L, levels_desc, levels_valid, word_weight, levels_up, device):
    """Host arrays (descriptors as (n, 8) uint32) -> Vocabulary on `device`."""
    return Vocabulary(
        k=k, L=L,
        levels=tuple(
            torch.from_numpy(np.ascontiguousarray(d).view(np.int32).copy()).to(device)
            for d in levels_desc
        ),
        valid=tuple(
            torch.from_numpy(np.asarray(v, bool).copy()).to(device) for v in levels_valid
        ),
        word_weight=torch.from_numpy(
            np.asarray(word_weight, np.float32).copy()
        ).to(device),
        levels_up=levels_up,
    )


def train_vocabulary(
    descriptors: Sequence[np.ndarray],
    k: int = 10,
    L: int = 4,
    levels_up: int = 2,
    seed: int = 42,
    device="cpu",
) -> Vocabulary:
    """Train a (k, L) tree from per-image descriptor arrays ((Ni, 8) uint32
    each). Weights are idf over the training images (reference:
    TemplatedVocabulary::setNodeWeights, TemplatedVocabulary.h:799-827).
    """
    rng = np.random.default_rng(seed)
    descriptors = [_as_u32(np.asarray(d)) for d in descriptors]
    pool = np.concatenate([d for d in descriptors if len(d)], axis=0)
    bits = _unpack(pool)

    levels_desc = []
    levels_valid = []
    # groups[i] = descriptor indices under node i at the current level.
    groups = [np.arange(len(bits))]
    for l in range(L):
        n_nodes = k ** (l + 1)
        ld = np.full((n_nodes, 256), 0, np.uint8)
        lv = np.zeros(n_nodes, bool)
        next_groups = [np.empty(0, np.int64)] * n_nodes
        for i, g in enumerate(groups):
            if len(g) == 0:
                continue
            cent, assign = _kmedians(bits[g], k, rng)
            for c in range(len(cent)):
                slot = i * k + c
                members = g[assign == c]
                if len(members) == 0:
                    continue
                ld[slot] = cent[c]
                lv[slot] = True
                next_groups[slot] = members
        levels_desc.append(_pack(ld))
        levels_valid.append(lv)
        groups = next_groups

    # idf: count training images touching each word.
    n_words = k**L
    n_images = len(descriptors)
    doc_count = np.zeros(n_words, np.int64)
    voc0 = _from_numpy(
        k, L, levels_desc, levels_valid, np.ones(n_words, np.float32), levels_up,
        device,
    )
    for d in descriptors:
        if len(d) == 0:
            continue
        dd = torch.from_numpy(d.view(np.int32).copy()).to(device)
        fb = transform(voc0, dd, torch.ones(len(d), dtype=torch.bool, device=device))
        doc_count[np.unique(fb.word.cpu().numpy())] += 1
    idf = np.log(max(n_images, 1) / np.maximum(doc_count, 1e-9))
    idf[doc_count == 0] = 0.0
    return voc0._replace(
        word_weight=torch.from_numpy(idf.astype(np.float32)).to(device)
    )


# ---------------------------------------------------------------------------
# Serialization: native npz + DBoW2-text conversion.
# ---------------------------------------------------------------------------


def builtin_vocabulary_path() -> Optional[str]:
    """Path of the shipped pretrained vocabulary artifact (k=10, L=5, the
    stand-in for the reference's ORBvoc.txt), or None if not packaged."""
    p = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "assets",
        "vocab_k10_L5.npz",
    )
    p = os.path.normpath(p)
    return p if os.path.exists(p) else None


def save(voc: Vocabulary, path: str):
    np.savez_compressed(
        path,
        k=voc.k, L=voc.L, levels_up=voc.levels_up,
        word_weight=voc.word_weight.cpu().numpy(),
        **{
            f"level_{l}": d.cpu().numpy().view(np.uint32)
            for l, d in enumerate(voc.levels)
        },
        **{f"valid_{l}": v.cpu().numpy() for l, v in enumerate(voc.valid)},
    )


def load(path: str, device="cpu") -> Vocabulary:
    z = np.load(path)
    k, L = int(z["k"]), int(z["L"])
    return _from_numpy(
        k, L,
        [_as_u32(z[f"level_{l}"]) for l in range(L)],
        [z[f"valid_{l}"] for l in range(L)],
        z["word_weight"], int(z["levels_up"]), device,
    )


def load_dbow2_text(path: str, levels_up: int = 4, device="cpu") -> Vocabulary:
    """Convert a DBoW2 text vocabulary (the ORBvoc.txt format; reference
    parser TemplatedVocabulary.h:1338-1424) into the dense level-major
    layout. Line 1: `k L scoring weighting`; then one node per line:
    `parent_id is_leaf d0 .. d31 weight` in tree-creation order.
    """
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        # DBoW2 node ids are assigned in file order starting at 1 (0=root).
        # Rebuild parent->children, then map onto the complete-tree layout.
        nodes = []  # (parent, is_leaf, desc(32 bytes), weight)
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parent = int(parts[0])
            is_leaf = bool(int(parts[1]))
            d = np.array([int(x) for x in parts[2:34]], np.uint8)
            w = float(parts[34])
            nodes.append((parent, is_leaf, d, w))

    children: dict[int, list[int]] = {}
    for nid, (parent, _, _, _) in enumerate(nodes, start=1):
        children.setdefault(parent, []).append(nid)

    levels_desc = [np.zeros((k ** (l + 1), 32), np.uint8) for l in range(L)]
    levels_valid = [np.zeros(k ** (l + 1), bool) for l in range(L)]
    n_words = k**L
    word_weight = np.zeros(n_words, np.float32)

    # BFS mapping: dense slot of child c of dense-node i at level l is
    # i*k + c. DBoW2 trees can be ragged (legal per the format; the real
    # ORBvoc is ragged): a leaf may terminate ABOVE depth L. The
    # fixed-depth batched descent always walks L levels, so a shallow leaf
    # is virtualized as a single-child descriptor chain down to depth L —
    # the descent then lands on a unique word slot carrying the leaf's
    # weight.
    stack = [(0, 0, 0)]  # (dbow_node_id, level, dense_index)
    while stack:
        nid, level, dense = stack.pop()
        for c, child in enumerate(children.get(nid, [])[:k]):
            slot = dense * k + c
            parent, is_leaf, d, w = nodes[child - 1]
            levels_desc[level][slot] = d
            levels_valid[level][slot] = True
            if is_leaf or level + 1 == L:
                s = slot
                for lv in range(level + 1, L):
                    s = s * k  # child 0 all the way down (no real
                    levels_desc[lv][s] = d  # children exist: it's a leaf)
                    levels_valid[lv][s] = True
                word_weight[s] = w
            else:
                stack.append((child, level + 1, slot))

    return _from_numpy(
        k, L,
        [d.view(np.uint32).reshape(-1, 8) for d in levels_desc],
        levels_valid, word_weight, levels_up, device,
    )
