"""Frame construction: extraction + undistortion (+ stereo/RGB-D depth).

Counterpart of c_orb_slam_tpu/frontend/frame.py (reference: src/Frame.cc —
the stereo :61, RGB-D :119 and mono :174 constructors, keypoint
undistortion :404, stereo matching :466). Stereo input is assumed
rectified, as in the JAX package: the stereo drivers rectify raw pairs
first (frontend/rectify.py, used by examples/stereo_euroc.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from c_orb_slam_tpu_torch.config import SlamConfig
from c_orb_slam_tpu_torch.geometry import camera
from c_orb_slam_tpu_torch.ops import extract, match, orient, pyramid


class FrameData(NamedTuple):
    """Per-frame fixed-capacity data (tensors on the frame's device)."""

    xy: torch.Tensor  # (N, 2) undistorted level-0 coords
    xy_raw: torch.Tensor  # (N, 2) raw (distorted) coords
    octave: torch.Tensor  # (N,) int32
    angle: torch.Tensor  # (N,)
    desc: torch.Tensor  # (N, 8) int32 (uint32 bit pattern)
    valid: torch.Tensor  # (N,) bool
    ur: torch.Tensor  # (N,) right-image u coordinate (-1 = mono/no match)
    depth: torch.Tensor  # (N,) depth (-1 = none)


def build_mono(image: torch.Tensor, cfg: SlamConfig) -> FrameData:
    kps = extract.extract_orb(image, cfg.orb, cfg.vocabulary.seed)
    K = camera.intrinsics_array(cfg.camera, image.device)
    dist = camera.distortion_array(cfg.camera, image.device)
    minus_one = torch.full_like(kps.response, -1.0)
    return FrameData(
        xy=camera.undistort_points(kps.xy, K, dist),
        xy_raw=kps.xy,
        octave=kps.octave,
        angle=kps.angle,
        desc=kps.desc,
        valid=kps.valid,
        ur=minus_one,
        depth=minus_one,
    )


def build_rgbd(image: torch.Tensor, depth_map: torch.Tensor, cfg: SlamConfig) -> FrameData:
    """RGB-D: read depth at keypoint locations, synthesize the virtual
    right coordinate ur = u - bf/d (reference: Frame.cc:643-664)."""
    f = build_mono(image, cfg)
    h, w = depth_map.shape
    y = torch.clamp(torch.round(f.xy_raw[:, 1]).long(), 0, h - 1)
    x = torch.clamp(torch.round(f.xy_raw[:, 0]).long(), 0, w - 1)
    d = depth_map[y, x] * (1.0 / cfg.tracking.depth_map_factor)
    has = d > 0
    ur = torch.where(has, f.xy[:, 0] - cfg.camera.bf / torch.clamp(d, min=1e-6), -1.0)
    return f._replace(depth=torch.where(has, d, -1.0), ur=ur)


def _stereo_subpixel(left, right, cfg: SlamConfig, xy_raw, octave, ur, has):
    """SAD parabola refinement of the matched right coordinate at each
    keypoint's pyramid level (reference: Frame.cc:552-618): an 11x11
    centre-normalized window slides +-5 px in the scaled right image; the
    parabola through the best three SADs gives the subpixel correction.
    Returns (refined ur, keep mask, best SAD per keypoint)."""
    W = 5  # reference w = 5 (Frame.cc:554)
    sfs = cfg.orb.scale_factors()
    levels_l = pyramid.build_pyramid(left, cfg.orb.n_levels, cfg.orb.scale_factor)
    levels_r = pyramid.build_pyramid(right, cfg.orb.n_levels, cfg.orb.scale_factor)
    ur_out = ur
    keep = torch.zeros_like(has)
    sad_out = torch.full_like(ur, float("inf"))
    for lvl, (il, irm) in enumerate(zip(levels_l, levels_r)):
        inv = 1.0 / sfs[lvl]
        uL = torch.round(xy_raw[:, 0] * inv).to(torch.int32)
        vL = torch.round(xy_raw[:, 1] * inv).to(torch.int32)
        uR0 = torch.round(ur * inv).to(torch.int32)
        pl = orient.gather_patches(il, torch.stack([vL, uL], 1), W)  # (N, 11, 11)
        pr = orient.gather_patches(irm, torch.stack([vL, uR0], 1), 2 * W)[:, W : 3 * W + 1, :]
        pl_n = pl - pl[:, W : W + 1, W : W + 1]
        sads = []
        for inc in range(2 * W + 1):
            win = pr[:, :, inc : inc + 2 * W + 1]  # (N, 11, 11)
            sads.append((pl_n - (win - win[:, W : W + 1, W : W + 1])).abs().sum(dim=(1, 2)))
        D = torch.stack(sads, dim=1)  # (N, 11)
        bi = torch.argmin(D, dim=1)
        bs = torch.clamp(bi, 1, 2 * W - 1)
        d1, d2, d3 = (D.gather(1, (bs + o)[:, None])[:, 0] for o in (-1, 0, 1))
        denom = 2.0 * (d1 + d3 - 2.0 * d2)
        delta = (d1 - d3) / torch.where(denom.abs() < 1e-6, 1e-6, denom)
        ok_lvl = (bi > 0) & (bi < 2 * W) & (delta.abs() <= 1.0)
        ur_lvl = sfs[lvl] * (uR0.to(torch.float32) + (bi - W).to(torch.float32) + delta)
        sel = (octave == lvl) & has & ok_lvl
        ur_out = torch.where(sel, ur_lvl, ur_out)
        keep = keep | sel
        sad_out = torch.where(sel, d2, sad_out)
    return ur_out, keep, sad_out


def build_stereo(left: torch.Tensor, right: torch.Tensor, cfg: SlamConfig) -> FrameData:
    """Stereo: extract on both images, row-banded Hamming match, SAD
    subpixel disparity -> depth (reference: Frame.cc:466-640
    ComputeStereoMatches). The reference's per-row candidate tables become
    one masked (L, R) distance matrix with a row-band, disparity and
    octave mask; the SAD refinement and the median-SAD outlier trim
    (:626-639) run over all matches at once."""
    kl = extract.extract_orb(left, cfg.orb, cfg.vocabulary.seed)
    kr = extract.extract_orb(right, cfg.orb, cfg.vocabulary.seed)
    # Rectified input: keypoints are used as they are (Frame.cc:407-411).
    xy_u = kl.xy
    # Row band |vL - vR| <= 2 * scale(octave); disparity in (0, fx], i.e.
    # minZ = baseline (Frame.cc:470-473); octaves at most one apart.
    sf = torch.tensor(cfg.orb.scale_factors(), dtype=torch.float32, device=left.device)
    band_ok = (kl.xy[:, 1:2] - kr.xy[None, :, 1]).abs() <= (2.0 * sf[kl.octave.long()])[:, None]
    disp = kl.xy[:, 0:1] - kr.xy[None, :, 0]
    disp_ok = (disp > 0.0) & (disp <= cfg.camera.fx)
    oct_ok = (kl.octave[:, None] - kr.octave[None, :]).abs() <= 1
    m = match.match(
        kl.desc, kr.desc, kl.valid, kr.valid, pair_mask=band_ok & disp_ok & oct_ok,
        max_dist=cfg.matcher.th_high, nn_ratio=1.0, unique_targets=False,
    )
    ur0 = torch.where(m.valid, kr.xy[m.idx.long(), 0], -1.0)
    ur, keep, sad = _stereo_subpixel(left, right, cfg, kl.xy, kl.octave, ur0, m.valid)
    good = m.valid & keep
    # Median-SAD trim: drop SAD >= 1.5 * 1.4 * median; the median is the
    # element (cnt - 1) // 2 of the inf-padded sort.
    srt = torch.sort(torch.where(good, sad, float("inf"))).values
    cnt = good.sum()
    med = srt[torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), min=0)]
    good = good & (sad < 1.5 * 1.4 * torch.clamp(med, min=1e-6))
    depth = torch.where(good, cfg.camera.bf / torch.clamp(xy_u[:, 0] - ur, min=0.01), -1.0)
    good = good & (depth > 0)
    return FrameData(
        xy=xy_u,
        xy_raw=kl.xy,
        octave=kl.octave,
        angle=kl.angle,
        desc=kl.desc,
        valid=kl.valid,
        ur=torch.where(good, ur, -1.0),
        depth=torch.where(good, depth, -1.0),
    )
