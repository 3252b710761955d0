"""FAST-9/16 corner detection as a whole-image batched pass.

Counterpart of c_orb_slam_tpu/ops/fast.py (reference:
src/ORBextractor.cc:765-853 cv::FAST per 30x30 cell with the 20 -> 7
threshold fallback). One pass tests every pixel: the 16 circle neighbours
as a (16, H, W) stack, bit-packed arc test, per-cell threshold blend, 3x3
non-maximum suppression. The circle differences are held in bfloat16, as
in the JAX package (fast.py:135-136), so marginal corners on the resized
levels flip the same way in both.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 — the 16 (dy, dx) offsets of the FAST segment
# test, clockwise from 12 o'clock.
CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LEN = 9  # contiguous run required for FAST-9


def _circle_stack(image: torch.Tensor) -> torch.Tensor:
    """(16, H, W): the circle neighbours of every pixel (edge-padded)."""
    h, w = image.shape
    rows = torch.arange(-3, h + 3, device=image.device).clamp(0, h - 1)
    cols = torch.arange(-3, w + 3, device=image.device).clamp(0, w - 1)
    padded = image[rows][:, cols]
    return torch.stack(
        [padded[3 + int(dy) : 3 + int(dy) + h, 3 + int(dx) : 3 + int(dx) + w]
         for dy, dx in CIRCLE]
    )


def _arc_mask_any(bits: torch.Tensor) -> torch.Tensor:
    """bits: (H, W) int64 with 16 circle flags in the low bits. True where
    any 9 contiguous (circular) bits are all set."""
    wrapped = bits | (bits << 16)  # circular: duplicate into high half
    full = (1 << ARC_LEN) - 1
    out = torch.zeros(bits.shape, dtype=torch.bool, device=bits.device)
    for k in range(16):
        out = out | (((wrapped >> k) & full) == full)
    return out


def _segment_test(diff: torch.Tensor, threshold: float):
    """Corner mask + score from a (16, H, W) circle-difference stack."""
    brighter = diff > threshold
    darker = diff < -threshold
    shifts = torch.arange(16, device=diff.device, dtype=torch.int64)[:, None, None]
    bright_bits = (brighter.to(torch.int64) << shifts).sum(0)
    dark_bits = (darker.to(torch.int64) << shifts).sum(0)
    corner = _arc_mask_any(bright_bits) | _arc_mask_any(dark_bits)

    df = diff.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=diff.device)
    score_b = torch.where(brighter, df - threshold, zero).sum(0)
    score_d = torch.where(darker, -df - threshold, zero).sum(0)
    score = torch.maximum(score_b, score_d)
    return corner, torch.where(corner, score, zero)


def fast_response(image: torch.Tensor, threshold: float):
    """Segment test + score for every pixel (single-threshold entry):
    (corner (H, W) bool, score (H, W) float32)."""
    diff = _circle_stack(image) - image[None]
    return _segment_test(diff, threshold)


def _cell_any(mask: torch.Tensor, cell: int) -> torch.Tensor:
    """Per-pixel: does this pixel's cell contain any True? (H, W) bool."""
    h, w = mask.shape
    ph, pw = (-h) % cell, (-w) % cell
    m = F.pad(mask, (0, pw, 0, ph))
    grid = m.reshape((h + ph) // cell, cell, (w + pw) // cell, cell)
    cell_any = grid.any(dim=3).any(dim=1)
    up = cell_any.repeat_interleave(cell, 0).repeat_interleave(cell, 1)
    return up[:h, :w]


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression: keep local maxima (ties kept)."""
    mx = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where((score >= mx) & (score > 0), score, torch.zeros_like(score))


def detect(
    image: torch.Tensor,
    ini_threshold: float,
    min_threshold: float,
    border: int,
    cell: int = 30,
) -> torch.Tensor:
    """Full FAST stage for one pyramid level -> NMS'd score map (H, W).

    Cells with at least one high-threshold corner keep only those; empty
    cells fall back to the low threshold (ORBextractor.cc:809-835)."""
    img = image.to(torch.bfloat16)
    diff = _circle_stack(img) - img[None]
    corner_hi, score_hi = _segment_test(diff, ini_threshold)
    corner_lo, score_lo = _segment_test(diff, min_threshold)
    score = torch.where(_cell_any(corner_hi, cell), score_hi, score_lo)

    # Exclude the EDGE_THRESHOLD border (reference: ORBextractor.cc:74,774).
    h, w = image.shape
    ys = torch.arange(h, device=image.device)[:, None]
    xs = torch.arange(w, device=image.device)[None, :]
    inb = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    return nms3(torch.where(inb, score, torch.zeros_like(score)))
