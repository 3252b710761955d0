"""Batched Hamming distance over 256-bit ORB descriptors.

Counterpart of c_orb_slam_tpu/ops/hamming.py (reference:
src/ORBmatcher.cc:1647-1663 DescriptorDistance). Descriptors are (N, 8)
int32 holding the same bit pattern as the JAX package's uint32 words
(convert at the boundary with numpy ``.view``); every function here takes
optional leading batch dimensions.
"""

from __future__ import annotations

import torch

# Distance returned for masked-out candidates — larger than the 256 max.
INVALID_DIST = 512


def _shifts(device, dtype) -> torch.Tensor:
    return torch.arange(32, device=device, dtype=dtype)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) {0,1} -> (..., 8) int32, little-endian within words."""
    b = bits.to(torch.int64).reshape(*bits.shape[:-1], 8, 32)
    v = (b << _shifts(bits.device, torch.int64)).sum(-1)
    # Words are uint32 bit patterns: wrap the top half into int32.
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 -> (..., 256) {0,1} uint8."""
    bits = (words.unsqueeze(-1) >> _shifts(words.device, torch.int32)) & 1
    return bits.reshape(*words.shape[:-1], 256).to(torch.uint8)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """(..., 8) -> (...,) int32 number of set bits."""
    return unpack_bits(words).sum(-1, dtype=torch.int32)


def distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamming distance between (..., 8) descriptors."""
    return popcount(torch.bitwise_xor(a, b))


def distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N1, 8) x (..., N2, 8) -> (..., N1, N2) int32 distances,
    as d(a, b) = |a| + |b| - 2 a.b over the unpacked bits. The float32
    products are exact: sums stay <= 256, far below 2^24 (TF32 is off,
    see the package __init__)."""
    bits_a = unpack_bits(a).to(torch.float32)
    bits_b = unpack_bits(b).to(torch.float32)
    cross = (bits_a @ bits_b.transpose(-1, -2)).to(torch.int32)
    return popcount(a).unsqueeze(-1) + popcount(b).unsqueeze(-2) - 2 * cross


def masked_distance_matrix(
    a: torch.Tensor,
    b: torch.Tensor,
    valid_a: torch.Tensor | None = None,
    valid_b: torch.Tensor | None = None,
    pair_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Distance matrix with INVALID_DIST where masked out."""
    d = distance_matrix(a, b)
    inval = torch.tensor(INVALID_DIST, dtype=d.dtype, device=d.device)
    if valid_a is not None:
        d = torch.where(valid_a.unsqueeze(-1), d, inval)
    if valid_b is not None:
        d = torch.where(valid_b.unsqueeze(-2), d, inval)
    if pair_mask is not None:
        d = torch.where(pair_mask, d, inval)
    return d


def best_two(d: torch.Tensor):
    """Top-2 smallest along the last dim: (best_dist, best_idx int32,
    second_dist). Ties go to the lowest index (argmin's first
    occurrence, as jnp.argmin)."""
    best_idx = torch.argmin(d, dim=-1)
    best = d.gather(-1, best_idx.unsqueeze(-1)).squeeze(-1)
    one = torch.nn.functional.one_hot(best_idx, d.shape[-1]).to(torch.bool)
    d2 = torch.where(one, torch.full_like(d, INVALID_DIST), d)
    return best, best_idx.to(torch.int32), d2.amin(dim=-1)


def mutual_best(d: torch.Tensor):
    """Mutual nearest-neighbour test on a (N1, N2) distance matrix:
    (best_idx_rows (N1,) int32, mutual (N1,) bool). Ties go to the lowest
    index, as jnp.argmin."""
    row_best = torch.argmin(d, dim=1)
    col_best = torch.argmin(d, dim=0)
    mutual = col_best[row_best] == torch.arange(d.shape[0], device=d.device)
    return row_best.to(torch.int32), mutual
