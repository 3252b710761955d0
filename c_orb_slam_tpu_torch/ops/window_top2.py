"""Projection-window masked top-2 Hamming search: the hand-written Hopper
kernel (csrc/window_top2.cu) and its plain PyTorch version.

Replaces the Pallas TPU kernel c_orb_slam_tpu/ops/pallas_match.py
(window_top2, kernel body _kernel), but computes the semantics of the
XLA branch of match.search_by_projection, which the JAX package runs
everywhere but on a TPU at Q*T >= 3e7: for each query, the best and
second-best distance over targets ranked by (distance, index) with masked
pairs at hamming.INVALID_DIST, the best index, and the index of the second
best (idx2), which the same-octave ratio rule needs.

What bounds the kernel on the H100: operations, not bytes. At Q = 8192 x
T = 1000 the inputs and outputs are 0.6 MB, the window and octave test of
8.2e6 pairs is about 1.5 us of the integer/float pipes, and popcounts are
owed only to the few pairs inside a window, so the kernel lives near the
time of a launch. Its design (the source file has the detail): a warp
owns a query and its lanes take interleaved targets, so the grid fills
the card at every shape of the main path; the window test reads one
16-byte record per target, and only in-window pairs, compacted by a
ballot, reach XOR + popcount; lanes merge their top-2 as packed
(distance, index) keys by shuffles, and the ranks of the masked pairs,
which are never visited, are filled in closed form.

Dispatch is by where the tensors live: CPU tensors take the plain version,
CUDA tensors launch the kernel or raise. There is no fallback between the
two.
"""

from __future__ import annotations

import ctypes

import torch

from c_orb_slam_tpu_torch.ops import hamming, match
from c_orb_slam_tpu_torch.utils import nvcc

# Kernel launches since the last reset (the plain version never counts),
# and how many of them had each shape (B, Q, T).
launches = 0
launch_shapes: dict[tuple[int, int, int], int] = {}
# The kernel packs (distance, index) into 32 bits: 9 for the distance.
MAX_TARGETS = 1 << 23
_SIGNATURES = {
    "window_top2_launch": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5,
    "window_top2_empty_launch": [ctypes.c_void_p],
}


def reset_launches():
    global launches
    launches = 0
    launch_shapes.clear()


def load():
    """The kernel's library (csrc/window_top2.cu for sm_90a, built at
    first use)."""
    return nvcc.load("window_top2", _SIGNATURES)


def empty_launch(device):
    """Launch an empty kernel on the device's current stream through the
    same ctypes route as window_top2: the time no design goes under."""
    lib = load()
    with torch.cuda.device(device):
        err = lib.window_top2_empty_launch(torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty launch failed: cudaError {err}")


def window_top2_reference(
    q_desc, q_uv, q_radius, q_lo, q_hi, q_valid,
    t_desc, t_xy, t_octave, t_valid,
):
    """Plain PyTorch version: the dense path of the JAX package's XLA
    branch (window + octave mask, hamming.masked_distance_matrix,
    best_two, and the idx2 argmin of match.match). Takes (Q, .) or
    (B, Q, .) queries with matching (T, .) or (B, T, .) targets.
    Returns (best, idx, second, idx2), int32."""
    mask = match.window_mask(q_uv, q_radius, t_xy) & match.octave_mask(
        t_octave, q_lo, q_hi
    )
    dist = hamming.masked_distance_matrix(q_desc, t_desc, q_valid, t_valid, mask)
    best, idx, second = hamming.best_two(dist)
    return best, idx, second, match.second_index(dist, idx)


_QUERY_SPEC = (("q_desc", torch.int32, (8,)), ("q_uv", torch.float32, (2,)),
               ("q_radius", torch.float32, ()), ("q_lo", torch.int32, ()),
               ("q_hi", torch.int32, ()), ("q_valid", torch.bool, ()))
_TARGET_SPEC = (("t_desc", torch.int32, (8,)), ("t_xy", torch.float32, (2,)),
                ("t_octave", torch.int32, ()), ("t_valid", torch.bool, ()))
# Bytes the kernel's vector loads need a tensor's first element aligned to.
_ALIGN = {"q_desc": 16, "t_desc": 16, "q_uv": 8, "t_xy": 8}


def _check(args: dict, device):
    """Shapes (B?, Q, ...) / (B?, T, ...), dtypes, device and contiguity
    the kernel takes; returns (B, Q, T, batched)."""
    batched = args["q_desc"].dim() == 3
    lead = 1 if batched else 0
    B = args["q_desc"].shape[0] if batched else 1
    Q = args["q_desc"].shape[lead]
    T = args["t_desc"].shape[lead]
    for spec, n in ((_QUERY_SPEC, Q), (_TARGET_SPEC, T)):
        for name, dtype, tail in spec:
            x = args[name]
            want = ((B,) if batched else ()) + (n,) + tail
            if tuple(x.shape) != want:
                raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {want}")
            if x.dtype != dtype:
                raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
            if x.device != device:
                raise ValueError(f"{name} is on {x.device}, expected {device}")
            if not x.is_contiguous():
                raise ValueError(f"{name} is not contiguous")
    if T < 1:
        raise ValueError("window_top2 needs at least one target")
    return B, Q, T, batched


def _check_kernel_limits(args: dict, T: int):
    """What the CUDA kernel asks beyond _check, and the plain version does
    not: targets a packed key can index, and the alignment of its vector
    loads."""
    if T > MAX_TARGETS:
        raise ValueError(f"the window_top2 kernel takes up to {MAX_TARGETS} targets, not {T}")
    for name, align in _ALIGN.items():
        if args[name].data_ptr() % align:
            raise ValueError(f"{name} is not aligned to {align} bytes")


def window_top2(
    q_desc, q_uv, q_radius, q_lo, q_hi, q_valid,
    t_desc, t_xy, t_octave, t_valid,
):
    """(best, idx, second, idx2) int32 per query; see the module doc.

    Queries (Q, .) against targets (T, .), or a batch (B, Q, .) against
    (B, T, .). CPU tensors run window_top2_reference; CUDA tensors launch
    the kernel on the current stream, or raise."""
    args = dict(
        q_desc=q_desc, q_uv=q_uv, q_radius=q_radius, q_lo=q_lo, q_hi=q_hi,
        q_valid=q_valid, t_desc=t_desc, t_xy=t_xy, t_octave=t_octave,
        t_valid=t_valid,
    )
    device = q_desc.device
    B, Q, T, batched = _check(args, device)
    if device.type == "cpu":
        return window_top2_reference(**args)
    if device.type != "cuda":
        raise ValueError(f"window_top2 runs on cpu or cuda, not {device}")
    _check_kernel_limits(args, T)
    global launches
    shape = (B, Q) if batched else (Q,)
    outs = torch.empty((4, *shape), dtype=torch.int32, device=device).unbind(0)
    if B * Q == 0:
        return outs
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.window_top2_launch(
            *(args[n].data_ptr() for n, _, _ in _QUERY_SPEC + _TARGET_SPEC),
            B, Q, T, *(o.data_ptr() for o in outs), stream,
        )
    if err != 0:
        raise RuntimeError(f"window_top2 launch failed: cudaError {err}")
    launches += 1
    launch_shapes[(B, Q, T)] = launch_shapes.get((B, Q, T), 0) + 1
    return outs
