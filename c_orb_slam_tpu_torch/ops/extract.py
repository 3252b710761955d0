"""Full ORB extraction: pyramid -> FAST -> spatial top-k -> orientation ->
rBRIEF, producing a fixed-capacity keypoint batch.

Counterpart of c_orb_slam_tpu/ops/extract.py (reference:
src/ORBextractor.cc:1043-1105). Spatial balancing is per-cell top-k on
the NMS'd score map, then a global top-N per level. Top-k here is a
stable descending sort, so ties go to the lowest index as with
jax.lax.top_k. Output coordinates are level-0 pixels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from c_orb_slam_tpu_torch.config import OrbConfig
from c_orb_slam_tpu_torch.ops import brief, fast, orient, pyramid


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint batch (SoA). Invalid slots: valid=False."""

    xy: torch.Tensor  # (N, 2) float32, level-0 pixel coords (x, y)
    response: torch.Tensor  # (N,) float32 FAST score
    octave: torch.Tensor  # (N,) int32 pyramid level
    angle: torch.Tensor  # (N,) float32 radians
    desc: torch.Tensor  # (N, 8) int32 packed 256-bit
    valid: torch.Tensor  # (N,) bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]

    def count(self) -> torch.Tensor:
        """The live keypoints, as a () int32 tensor on the batch's device."""
        return self.valid.sum(dtype=torch.int32)


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, lowest index
    first among equal values (jax.lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_keypoints(score: torch.Tensor, budget: int, cell: int, k_per_cell: int = 4):
    """Spatially-balanced top-`budget` selection from an NMS'd score map.
    Returns (yx (budget, 2) int32, response (budget,), valid (budget,))."""
    h, w = score.shape
    ph, pw = (-h) % cell, (-w) % cell
    padded = F.pad(score, (0, pw, 0, ph))
    ncy, ncx = (h + ph) // cell, (w + pw) // cell
    grid = padded.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3)
    grid = grid.reshape(ncy * ncx, cell * cell)

    vals, idx = _top_k(grid, k_per_cell)
    cell_ids = torch.arange(ncy * ncx, device=score.device)
    cy = (cell_ids // ncx)[:, None] * cell + idx // cell
    cx = (cell_ids % ncx)[:, None] * cell + idx % cell

    flat_vals, flat_y, flat_x = vals.reshape(-1), cy.reshape(-1), cx.reshape(-1)
    if flat_vals.shape[0] < budget:  # tiny images: pad the candidate pool
        pad = budget - flat_vals.shape[0]
        flat_vals = F.pad(flat_vals, (0, pad))
        flat_y = F.pad(flat_y, (0, pad))
        flat_x = F.pad(flat_x, (0, pad))

    top_vals, sel = _top_k(flat_vals, budget)
    yx = torch.stack([flat_y[sel], flat_x[sel]], dim=-1).to(torch.int32)
    return yx, top_vals, top_vals > 0.0


def subpixel_refine(score: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """Parabolic subpixel offsets (dy, dx) in [-0.5, 0.5] of NMS maxima
    over the 3x3 score neighbourhood."""
    patches = orient.gather_patches(score, yx, 1)
    c = patches[:, 1, 1]

    def axis_offset(m, p):
        denom = 2.0 * c - m - p
        denom = torch.where(denom.abs() < 1e-6, torch.full_like(denom, 1e-6), denom)
        return torch.clamp(0.5 * (p - m) / denom, -0.5, 0.5)

    dy = axis_offset(patches[:, 0, 1], patches[:, 2, 1])
    dx = axis_offset(patches[:, 1, 0], patches[:, 1, 2])
    return torch.stack([dy, dx], dim=-1)


def detect_levels(levels: list, cfg: OrbConfig) -> list:
    """FAST score map of each pyramid level."""
    return [fast.detect(img, float(cfg.ini_th_fast), float(cfg.min_th_fast),
                        border=cfg.edge_threshold - 3, cell=cfg.cell_size)
            for img in levels]


def select_levels(scores: list, cfg: OrbConfig) -> list:
    """(yx, response, valid, subpixel offset) of each level's keypoints,
    taken from its score map within the level's feature budget."""
    out = []
    for score, budget in zip(scores, cfg.features_per_level()):
        yx, resp, valid = select_keypoints(score, budget, cfg.cell_size)
        out.append((yx, resp, valid, subpixel_refine(score, yx)))
    return out


def orient_levels(levels: list, picks: list, cfg: OrbConfig) -> list:
    """Intensity-centroid angle of each level's keypoints."""
    return [orient.ic_angle(img, pick[0], cfg.half_patch) for img, pick in zip(levels, picks)]


def describe_levels(levels: list, picks: list, angles: list, seed: int) -> list:
    """Steered BRIEF descriptors of each level's keypoints, sampled on
    the blurred level."""
    return [brief.compute_descriptors(pyramid.gaussian_blur(img), pick[0], ang, seed)
            for img, pick, ang in zip(levels, picks, angles)]


def extract_orb(image: torch.Tensor, cfg: OrbConfig, seed: int = 7) -> Keypoints:
    """ORB keypoints + descriptors of a grayscale (H, W) float32 image in
    [0, 255]; every level runs detection, selection, orientation, blur
    and description (one function each, over all levels)."""
    levels = pyramid.build_pyramid(image, cfg.n_levels, cfg.scale_factor)
    picks = select_levels(detect_levels(levels, cfg), cfg)
    angles = orient_levels(levels, picks, cfg)
    descs = describe_levels(levels, picks, angles, seed)
    budgets = cfg.features_per_level()
    scales = cfg.scale_factors()

    parts = []
    for lvl, ((yx, resp, valid, sub), ang, desc) in enumerate(zip(picks, angles, descs)):
        yx_f = yx.to(torch.float32) + sub
        parts.append(
            Keypoints(
                xy=yx_f.flip(-1) * scales[lvl],  # (x, y) level-0
                response=resp,
                octave=torch.full((budgets[lvl],), lvl, dtype=torch.int32, device=image.device),
                angle=ang,
                desc=desc,
                valid=valid,
            )
        )
    return Keypoints(*(torch.cat([getattr(p, f) for p in parts]) for f in Keypoints._fields))
