"""Segment sums whose order of addition does not depend on the run.

The JAX package forms its normal-equation, pose-graph and BoW sums with
``jax.ops.segment_sum`` and ``.at[].add`` (optim/ba.py, optim/pose_graph.py,
bow/database.py there), which come out the same every run on its device.
``index_add`` on CUDA adds with float atomics, in an order that changes from
run to run, so the same input gave different trajectories on a card. Here
the rows are stably sorted by segment id once (``segments``), and each
segment is summed in that order, from zero, by ``torch.segment_reduce``: on
either device one thread a (segment, column) walks its segment in order, so
every run gives the same bits, and on the CPU the bits ``index_add`` gives
there (it adds in row order).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Union

import torch


class Segments(NamedTuple):
    """The summing order of a segment-id vector, reusable while the ids
    stay the same (a solve's observations, a pose graph's edges)."""

    order: torch.Tensor  # (N,) int64: rows stably sorted by segment id
    offsets: torch.Tensor  # (n + 1,) int64: segment s is order[offsets[s]:offsets[s + 1]]


def segments(ids: torch.Tensor, n: int) -> Segments:
    """The order and offsets of `ids` (N,) in [0, n), on their device, with
    no readback."""
    ids = ids.long()
    order = torch.argsort(ids, stable=True)
    bounds = torch.arange(n + 1, dtype=torch.int64, device=ids.device)
    return Segments(order, torch.searchsorted(ids[order], bounds))


def segment_sum(x: torch.Tensor, seg: Union[Segments, torch.Tensor],
                n: int = None) -> torch.Tensor:
    """out[s] = the sum of the rows x[i] whose id is s, added in the order of
    i; `seg` is a ``Segments``, or the ids themselves with their count `n`
    (jax.ops.segment_sum(x, ids, num_segments=n))."""
    if not isinstance(seg, Segments):
        seg = segments(seg, n)
    # 2-D rows: the per-(segment, column) sequential kernel on CUDA, never
    # CUB's tree-ordered 1-D segmented reduction.
    rows = x[seg.order].reshape(x.shape[0], math.prod(x.shape[1:]))
    out = torch.segment_reduce(rows, "sum", offsets=seg.offsets, axis=0, unsafe=True)
    return out.reshape(len(seg.offsets) - 1, *x.shape[1:])
