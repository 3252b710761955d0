"""Batched descriptor matching — counterpart of c_orb_slam_tpu/ops/match.py.

Every correspondence search reduces to one primitive: a masked (Q, T)
Hamming distance matrix + best/second-best reduction (reference:
src/ORBmatcher.cc). The projection-guided search runs on the
window_top2 kernel instead (ops/window_top2.py). All functions take
optional leading batch dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from c_orb_slam_tpu_torch.ops import hamming, window_top2

TWO_PI = 6.283185307179586


class Matches(NamedTuple):
    """Per-query match result (fixed capacity = number of queries)."""

    idx: torch.Tensor  # (Q,) int32 index into targets
    dist: torch.Tensor  # (Q,) int32 Hamming distance
    valid: torch.Tensor  # (Q,) bool

    def count(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)


def _ratio_ok(best, second, idx, idx2, nn_ratio, ratio_octave_t):
    """NN-ratio test; with target octaves it rejects only when best and
    second-best share an octave (ORBmatcher.cc:115-121)."""
    ratio_fail = ~(best.to(torch.float32) < nn_ratio * second.to(torch.float32))
    if ratio_octave_t is not None:
        o1 = ratio_octave_t.gather(-1, idx.long())
        o2 = ratio_octave_t.gather(-1, idx2.long())
        ratio_fail = ratio_fail & (o1 == o2)
    return ~ratio_fail


def match(
    desc_q: torch.Tensor,
    desc_t: torch.Tensor,
    valid_q: torch.Tensor | None = None,
    valid_t: torch.Tensor | None = None,
    pair_mask: torch.Tensor | None = None,
    max_dist: int = 100,
    nn_ratio: float = 1.0,
    unique_targets: bool = True,
    ratio_octave_t: torch.Tensor | None = None,
) -> Matches:
    """Best match per query with distance threshold + NN-ratio test;
    unique_targets keeps each target's lowest-distance claimant."""
    d = hamming.masked_distance_matrix(desc_q, desc_t, valid_q, valid_t, pair_mask)
    best, idx, second = hamming.best_two(d)
    ok = best <= max_dist
    if nn_ratio < 1.0:
        idx2 = second_index(d, idx) if ratio_octave_t is not None else idx
        ok = ok & _ratio_ok(best, second, idx, idx2, nn_ratio, ratio_octave_t)
    if unique_targets:
        ok = ok & _is_target_winner(idx, best, ok, d.shape[-1])
    return Matches(idx=idx, dist=best, valid=ok)


def second_index(d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Index of the second best along the last dim: the lowest-index
    minimum over all j != idx (int32)."""
    t = torch.arange(d.shape[-1], device=d.device)
    d2 = torch.where(t == idx.unsqueeze(-1), torch.full_like(d, 1 << 20), d)
    return torch.argmin(d2, dim=-1).to(torch.int32)


def _is_target_winner(
    idx: torch.Tensor, dist: torch.Tensor, ok: torch.Tensor, n_targets: int
) -> torch.Tensor:
    """True for queries that win their claimed target (min distance, ties
    broken by lowest query index). Keys stay int32 (dist*4096 + q fits)."""
    big = 1 << 20
    q = torch.arange(idx.shape[-1], dtype=torch.int32, device=idx.device)
    key = torch.where(ok, dist.to(torch.int32) * 4096 + q, big)
    per_target = torch.full(
        (*idx.shape[:-1], n_targets), big, dtype=torch.int32, device=idx.device
    )
    li = idx.long()
    per_target = per_target.scatter_reduce(-1, li, key, reduce="amin")
    return ok & (per_target.gather(-1, li) == key)


def _top_k_stable(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last dim, lowest index first on
    ties (jax.lax.top_k's order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def rotation_consistency(
    angle_q: torch.Tensor,
    angle_t_matched: torch.Tensor,
    valid: torch.Tensor,
    histo_length: int = 30,
    keep_bins: int = 3,
) -> torch.Tensor:
    """Keep only matches whose q-t angle difference falls in the top-k
    histogram bins (reference: ORBmatcher.cc:1601-1642)."""
    rot = torch.remainder(angle_q - angle_t_matched, TWO_PI)
    bins = torch.floor(rot / TWO_PI * histo_length).to(torch.int64) % histo_length
    counts = torch.zeros(histo_length, dtype=torch.int32, device=bins.device)
    counts = counts.index_add(0, bins, valid.to(torch.int32))
    top = _top_k_stable(counts, keep_bins)
    in_top = (bins.unsqueeze(-1) == top).any(-1)
    return valid & in_top


def window_mask(centers, radii, xy_t) -> torch.Tensor:
    """(..., Q, T) mask: target keypoint within per-query search radius."""
    dx = centers[..., 0].unsqueeze(-1) - xy_t[..., 0].unsqueeze(-2)
    dy = centers[..., 1].unsqueeze(-1) - xy_t[..., 1].unsqueeze(-2)
    return torch.maximum(dx.abs(), dy.abs()) <= radii.unsqueeze(-1)


def octave_mask(octave_t, lo, hi) -> torch.Tensor:
    """(..., Q, T) mask: target octave within [lo, hi] per query."""
    o = octave_t.unsqueeze(-2)
    return (o >= lo.unsqueeze(-1)) & (o <= hi.unsqueeze(-1))


def epipolar_mask(
    F12: torch.Tensor,
    xy1: torch.Tensor,
    xy2: torch.Tensor,
    level_sigma2_2: torch.Tensor,
    octave2: torch.Tensor,
    thresh_chi2: float = 3.84,
) -> torch.Tensor:
    """(..., N1, N2) mask: kp2 close to the epipolar line of kp1 under F12
    (reference: ORBmatcher.cc:140-157 CheckDistEpipolarLine)."""
    ones = torch.ones(*xy1.shape[:-1], 1, dtype=xy1.dtype, device=xy1.device)
    p1 = torch.cat([xy1, ones], dim=-1)  # (..., N1, 3)
    lines = p1 @ F12.transpose(-1, -2)  # (..., N1, 3): a, b, c
    a, b, c = lines[..., 0:1], lines[..., 1:2], lines[..., 2:3]
    num = a * xy2[..., None, :, 0] + b * xy2[..., None, :, 1] + c
    den = a * a + b * b
    dsqr = (num * num) / torch.clamp(den, min=1e-12)
    sigma2 = level_sigma2_2[octave2.long()].unsqueeze(-2)
    return dsqr < thresh_chi2 * sigma2


def search_by_projection(
    proj_uv: torch.Tensor,
    radii: torch.Tensor,
    desc_q: torch.Tensor,
    valid_q: torch.Tensor,
    xy_t: torch.Tensor,
    octave_t: torch.Tensor,
    desc_t: torch.Tensor,
    valid_t: torch.Tensor,
    octave_lo: torch.Tensor,
    octave_hi: torch.Tensor,
    max_dist: int = 100,
    nn_ratio: float = 1.0,
) -> Matches:
    """Projection-guided matching: map points (queries) against frame
    keypoints (targets), gated by window + octave, on the window_top2
    kernel. Then max_dist, the same-octave ratio rule and target
    uniqueness, exactly as the JAX package's XLA branch applies them.

    Covers reference SearchByProjection variants (ORBmatcher.cc:45-129
    local-map points; :1328-1470 motion model)."""
    best, idx, second, idx2 = window_top2.window_top2(
        desc_q.contiguous(), proj_uv.contiguous(), radii.contiguous(),
        octave_lo.to(torch.int32).contiguous(),
        octave_hi.to(torch.int32).contiguous(), valid_q.contiguous(),
        desc_t.contiguous(), xy_t.contiguous(),
        octave_t.to(torch.int32).contiguous(), valid_t.contiguous(),
    )
    ok = best <= max_dist
    if nn_ratio < 1.0:
        ok = ok & _ratio_ok(best, second, idx, idx2, nn_ratio, octave_t)
    ok = ok & _is_target_winner(idx, best, ok, desc_t.shape[-2])
    return Matches(idx=idx, dist=best, valid=ok)


def search_for_initialization(
    kp1_xy: torch.Tensor,
    kp1_desc: torch.Tensor,
    kp1_valid: torch.Tensor,
    kp1_angle: torch.Tensor,
    kp2_xy: torch.Tensor,
    kp2_desc: torch.Tensor,
    kp2_valid: torch.Tensor,
    kp2_angle: torch.Tensor,
    kp2_octave: torch.Tensor,
    window: float = 100.0,
    max_dist: int = 50,
    nn_ratio: float = 0.9,
    check_rotation: bool = True,
) -> Matches:
    """Two-view matching for monocular initialization, targets of octave 0
    of kp2_octave only (reference: ORBmatcher.cc:405-520)."""
    radii = torch.full(kp1_xy.shape[:1], window, dtype=torch.float32, device=kp1_xy.device)
    mask = window_mask(kp1_xy, radii, kp2_xy) & (kp2_octave == 0).unsqueeze(-2)
    m = match(kp1_desc, kp2_desc, kp1_valid, kp2_valid, pair_mask=mask,
              max_dist=max_dist, nn_ratio=nn_ratio)
    if check_rotation:
        m = m._replace(valid=rotation_consistency(kp1_angle, kp2_angle[m.idx.long()], m.valid))
    return m
