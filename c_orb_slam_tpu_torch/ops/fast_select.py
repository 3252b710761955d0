"""FAST detection and keypoint selection over all of one image's pyramid
levels: the hand-written Hopper kernel (csrc/fast_select.cu) and its plain
PyTorch version, ops/extract.py's select_levels(detect_levels(levels, cfg),
cfg).

Replaces no TPU kernel: the JAX package leaves FAST and the per-cell top-k
to XLA. Eagerly, the plain version launches about 3,200 small kernels an
image, and the host's time to enqueue them was the largest part of a
stereo frame's build. The kernel does the same work in three launches (a
block a cell for the scores, a block a cell for NMS and each cell's best 4,
a block a level for the level's budget and the subpixel offsets) and
returns what the plain version returns, bit for bit: the source file says
how, what bounds it and what its design does about that.

Dispatch is by where the tensors live, as ops/window_top2.py's: CPU
tensors run the plain version; CUDA tensors launch the kernel or raise.
There is no fallback between the two. The kernel adapts to its input: the
level shapes and the OrbConfig's budgets, thresholds, border and cell size.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from c_orb_slam_tpu_torch.config import OrbConfig
from c_orb_slam_tpu_torch.utils import nvcc

# Kernel launches since the last reset (the plain version never counts):
# three a call.
launches = 0
LAUNCHES_PER_CALL = 3
# The kernel's limits (csrc/fast_select.cu): levels in its table, the cell
# size its shared memory holds, one level's candidates (4 a cell, or the
# budget if larger) that its sort holds, and each level's least side (the
# subpixel patch is 3 x 3).
MAX_LEVELS = 16
MAX_CELL = 64
MAX_POOL = 16384
MIN_SIDE = 3
PER_CELL = 4  # extract.select_keypoints' k_per_cell
_TABLE_INTS = 9
_SIGNATURES = {
    "fast_select_launch": ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                           + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9),
}


def reset_launches():
    global launches
    launches = 0


def load():
    """The kernel's library (csrc/fast_select.cu for sm_90a, built at first
    use)."""
    return nvcc.load("fast_select", _SIGNATURES)


def detect_and_select_reference(levels: list, cfg: OrbConfig) -> list:
    """The plain version: what detect_and_select runs on CPU tensors, and
    what the card's tests hold the kernel to."""
    from c_orb_slam_tpu_torch.ops import extract  # extract imports this module

    return extract.select_levels(extract.detect_levels(levels, cfg), cfg)


def _check(levels, cfg: OrbConfig):
    """What the kernel takes: cfg.n_levels 2-D float32 tensors, rows back to
    back, on one device."""
    if len(levels) != cfg.n_levels:
        raise ValueError(f"{len(levels)} levels, expected cfg.n_levels = {cfg.n_levels}")
    device = levels[0].device
    for i, lv in enumerate(levels):
        if lv.dim() != 2:
            raise ValueError(f"level {i}: shape {tuple(lv.shape)}, expected (H, W)")
        if lv.dtype != torch.float32:
            raise TypeError(f"level {i}: dtype {lv.dtype}, expected torch.float32")
        if not lv.is_contiguous():
            raise ValueError(f"level {i} is not contiguous (strides {tuple(lv.stride())})")
        if lv.device != device:
            raise ValueError(f"level {i} is on {lv.device}, expected {device} (level 0's)")


class _Plan(NamedTuple):
    table: ctypes.Array  # _TABLE_INTS ints a level, as the launcher reads them
    budgets: list
    cells: int
    pixels: int
    max_pool: int


@functools.lru_cache(maxsize=16)
def _plan(shapes: tuple, cfg: OrbConfig) -> _Plan:
    """The kernel's level table for these level shapes and cfg, or raise
    where it exceeds the kernel's limits."""
    cell = cfg.cell_size
    if len(shapes) > MAX_LEVELS:
        raise ValueError(f"{len(shapes)} levels: the kernel's table holds {MAX_LEVELS}")
    if not 2 <= cell <= MAX_CELL:
        raise ValueError(f"cell_size {cell}: the kernel takes 2 to {MAX_CELL}")
    budgets = cfg.features_per_level()
    rows, cells, pixels, out = [], 0, 0, 0
    for lvl, ((h, w), budget) in enumerate(zip(shapes, budgets)):
        if min(h, w) < MIN_SIDE:
            raise ValueError(f"level {lvl}: shape {(h, w)}, the kernel takes sides of at least "
                             f"{MIN_SIDE}")
        ncy, ncx = -(-h // cell), -(-w // cell)
        pool = max(PER_CELL * ncy * ncx, budget)
        if pool > MAX_POOL:
            raise ValueError(f"level {lvl}: {pool} candidates ({ncy} x {ncx} cells of {cell}, "
                             f"budget {budget}); the kernel's sort holds {MAX_POOL}")
        rows += [h, w, ncy, ncx, cells, pixels, budget, out, pool]
        cells, pixels, out = cells + ncy * ncx, pixels + h * w, out + budget
    max_pool = max(rows[_TABLE_INTS - 1::_TABLE_INTS])
    return _Plan((ctypes.c_int * len(rows))(*rows), budgets, cells, pixels, max_pool)


def detect_and_select(levels: list, cfg: OrbConfig) -> list:
    """FAST scores, per-cell top-4 and the per-level top-budget of one
    image's pyramid levels: for each level (yx (budget, 2) int32, response
    (budget,) float32, valid (budget,) bool, subpixel offset (budget, 2)
    float32), as extract.select_levels returns them.

    CPU tensors run detect_and_select_reference; CUDA tensors launch the
    kernel on the current stream (three launches, one output buffer whose
    per-level views are returned), or raise."""
    _check(levels, cfg)
    device = levels[0].device
    if device.type == "cpu":
        return detect_and_select_reference(levels, cfg)
    if device.type != "cuda":
        raise ValueError(f"detect_and_select runs on cpu or cuda, not {device}")
    plan = _plan(tuple(tuple(lv.shape) for lv in levels), cfg)
    n_out = sum(plan.budgets)
    yx = torch.empty((n_out, 2), dtype=torch.int32, device=device)
    response = torch.empty(n_out, dtype=torch.float32, device=device)
    valid = torch.empty(n_out, dtype=torch.bool, device=device)
    sub = torch.empty((n_out, 2), dtype=torch.float32, device=device)
    maps = torch.empty((2, plan.pixels), dtype=torch.float32, device=device)
    cand_val = torch.empty(PER_CELL * plan.cells, dtype=torch.float32, device=device)
    cand_yx = torch.empty((PER_CELL * plan.cells, 2), dtype=torch.int32, device=device)
    images = (ctypes.c_void_p * len(levels))(*(lv.data_ptr() for lv in levels))
    lib = load()
    with torch.cuda.device(device):
        err = lib.fast_select_launch(
            images, plan.table, len(levels), cfg.cell_size, cfg.edge_threshold - 3,
            float(cfg.ini_th_fast), float(cfg.min_th_fast), plan.cells, plan.max_pool,
            maps[0].data_ptr(), maps[1].data_ptr(), cand_val.data_ptr(), cand_yx.data_ptr(),
            yx.data_ptr(), response.data_ptr(), valid.data_ptr(), sub.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fast_select launch failed: cudaError {err}")
    global launches
    launches += LAUNCHES_PER_CALL
    b = plan.budgets
    return list(zip(yx.split(b), response.split(b), valid.split(b), sub.split(b)))
