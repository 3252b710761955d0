"""Motion-only pose optimization (the per-frame hot solver).

Counterpart of c_orb_slam_tpu/optim/pose_opt.py (reference:
src/Optimizer.cc:239-451 PoseOptimization): 4 rounds x 10 Gauss-Newton
iterations on the 6x6 normal system, inlier reclassification at
chi2 = 5.991 / 7.815 between rounds, Huber kernel for rounds 0-1.
Everything stays on the device: no value is read back inside the loop.

Dispatch is by where the tensors live, as ops/window_top2.py's: CPU
tensors run the plain version (optimize_pose_reference, the loop of
PyTorch ops); CUDA tensors launch the hand-written kernel
csrc/pose_gn.cu, the whole solve in one launch, or raise. There is no
fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from c_orb_slam_tpu_torch.geometry import se3
from c_orb_slam_tpu_torch.optim import residuals as res
from c_orb_slam_tpu_torch.utils import nvcc

# Kernel launches since the last reset (the plain version never counts).
launches = 0
# The kernel's largest block; a block has a warp for each 32 rows up to it.
MAX_THREADS = 512
_SIGNATURES = {
    "pose_gn_launch": ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 4),
}


class PoseOptResult(NamedTuple):
    pose: torch.Tensor  # (..., 3, 4) optimized Tcw
    inliers: torch.Tensor  # (..., N) bool
    n_inliers: torch.Tensor  # (...) int32


def reset_launches():
    global launches
    launches = 0


def load():
    """The kernel's library (csrc/pose_gn.cu for sm_90a, built at first
    use)."""
    return nvcc.load("pose_gn", _SIGNATURES)


def block_threads(n_rows: int) -> int:
    """Threads of the kernel's block for a problem of n_rows rows: a warp
    per 32 rows, at least one, at most MAX_THREADS. The block's sums are
    taken in an order fixed by this number, so by the shape alone."""
    return min(MAX_THREADS, max(32, -(-n_rows // 32) * 32))


_ROWS = (("xw", torch.float32, (3,)), ("obs", torch.float32, (3,)),
         ("inv_sigma2", torch.float32, ()), ("is_stereo", torch.bool, ()),
         ("valid", torch.bool, ()))


def _check(args: dict):
    """Shapes, dtypes, devices and layouts the kernel takes: T0 (3, 4) with
    xw and obs (N, 3), or a batch T0 (B, 3, 4) with (B, N, 3); the per-row
    inv_sigma2, is_stereo and valid (N,) or (B, N); K (4,), contiguous. Rows are
    contiguous within a problem; a batch may stride over problems in any
    step, 0 for rows shared by all (an expand). Returns (B, N, batched,
    {name: the (B, N, ...) view})."""
    T0, K = args["T0"], args["K"]
    device = args["xw"].device
    for name, x in args.items():
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device} (xw's)")
    if T0.dim() not in (2, 3) or tuple(T0.shape[-2:]) != (3, 4):
        raise ValueError(f"T0: shape {tuple(T0.shape)}, expected (3, 4) or (B, 3, 4)")
    batched = T0.dim() == 3
    B = T0.shape[0] if batched else 1
    if args["xw"].dim() != T0.dim():
        raise ValueError(f"xw: shape {tuple(args['xw'].shape)} against T0 {tuple(T0.shape)}")
    N = args["xw"].shape[-2]
    if tuple(K.shape) != (4,):
        raise ValueError(f"K: shape {tuple(K.shape)}, expected (4,)")
    if K.stride(0) != 1:
        raise ValueError(f"K is not contiguous (stride {K.stride(0)})")
    for name, x in (("T0", T0), ("K", K)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {x.dtype}, expected torch.float32")
    views = {}
    for name, dtype, tail in _ROWS:
        x = args[name]
        if x.dtype != dtype:
            raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
        want = (B, N) + tail
        if tuple(x.shape) not in ((N,) + tail, ((B,) if batched else ()) + (N,) + tail):
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                             f"{((B,) if batched else ()) + (N,) + tail} or {(N,) + tail}")
        v = x.expand(want)
        row_strides = (3, 1) if tail else (1,)
        if any(n > 1 and s != want_s
               for n, s, want_s in zip(v.shape[1:], v.stride()[1:], row_strides)):
            raise ValueError(f"{name}: rows are not contiguous (strides {tuple(x.stride())})")
        views[name] = v
    return B, N, batched, views


def optimize_pose(
    T0: torch.Tensor,
    xw: torch.Tensor,
    obs: torch.Tensor,
    inv_sigma2: torch.Tensor,
    is_stereo: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    bf: float = 0.0,
    rounds: int = 4,
    iters: int = 10,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    damping: float = 1e-5,
) -> PoseOptResult:
    """Optimize a camera pose against fixed 3D points.

    xw: (N, 3) world points; obs: (N, 3) (u, v, ur) with ur ignored for
    mono rows; valid: initial match mask. A leading batch dimension on T0
    (B, 3, 4) and xw/obs (B, N, 3) solves that many independent problems
    at once (the JAX package vmaps this function); the per-observation
    arrays are (B, N) or (N,), shared by every problem. bf, the chi2 gates
    and the damping are Python numbers.

    CPU tensors run optimize_pose_reference; CUDA tensors launch the
    kernel on the current stream, or raise."""
    args = dict(T0=T0, xw=xw, obs=obs, inv_sigma2=inv_sigma2, is_stereo=is_stereo,
                valid=valid, K=K)
    B, N, batched, views = _check(args)
    device = xw.device
    if device.type == "cpu":
        return optimize_pose_reference(T0, xw, obs, inv_sigma2, is_stereo, valid, K, bf,
                                       rounds, iters, chi2_mono, chi2_stereo, damping)
    if device.type != "cuda":
        raise ValueError(f"optimize_pose runs on cpu or cuda, not {device}")
    scalars = dict(bf=bf, chi2_mono=chi2_mono, chi2_stereo=chi2_stereo, damping=damping)
    for name, x in scalars.items():
        if isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a Python number on the kernel path, not a tensor")
    global launches
    lead = (B,) if batched else ()
    pose = torch.empty(lead + (3, 4), dtype=torch.float32, device=device)
    inliers = torch.empty(lead + (N,), dtype=torch.bool, device=device)
    n_inliers = torch.empty(lead, dtype=torch.int32, device=device)
    if B == 0:
        return PoseOptResult(pose, inliers, n_inliers)
    T0 = T0.contiguous()
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pose_gn_launch(
            T0.data_ptr(), *(views[n].data_ptr() for n, _, _ in _ROWS), K.data_ptr(),
            *(views[n].stride(0) for n, _, _ in _ROWS), B, N, int(rounds), int(iters),
            *(float(scalars[n]) for n in ("bf", "chi2_mono", "chi2_stereo", "damping")),
            block_threads(N), pose.data_ptr(), inliers.data_ptr(), n_inliers.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"pose_gn launch failed: cudaError {err}")
    launches += 1
    return PoseOptResult(pose, inliers, n_inliers)


def optimize_pose_reference(
    T0: torch.Tensor,
    xw: torch.Tensor,
    obs: torch.Tensor,
    inv_sigma2: torch.Tensor,
    is_stereo: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    bf: float = 0.0,
    rounds: int = 4,
    iters: int = 10,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    damping: float = 1e-5,
) -> PoseOptResult:
    """The plain version of optimize_pose: the Gauss-Newton loop as PyTorch
    ops, whose arithmetic the kernel repeats; what optimize_pose runs on
    CPU tensors, and what the card's tests hold the kernel to."""
    chi2_th = torch.where(
        is_stereo, torch.tensor(chi2_stereo, device=xw.device),
        torch.tensor(chi2_mono, device=xw.device),
    )
    eye6 = damping * torch.eye(6, dtype=xw.dtype, device=xw.device)
    T = T0
    inlier_mask = valid
    for rnd in range(rounds):
        weight_mask = inlier_mask.to(torch.float32)
        for _ in range(iters):
            r, J, _ = res.residual_and_jacobians(T, xw, obs, K, bf, is_stereo)
            w = inv_sigma2 * weight_mask
            if rnd < 2:  # the reference drops the kernel from round 3
                w = w * res.huber_weight(res.chi2(r, inv_sigma2), chi2_th)
            Jw = J * w[..., None, None]
            H = torch.einsum("...nij,...nik->...jk", Jw, J) + eye6
            b = torch.einsum("...nij,...ni->...j", Jw, r)
            # r = obs - pred; J = d r / d xi  =>  normal eq H dx = -b.
            # solve_ex: no error check, so no device sync per iteration.
            dx = torch.linalg.solve_ex(H, -b)[0]
            T = se3.compose(se3.exp(dx), T)
        r, _, _ = res.residual_and_jacobians(T, xw, obs, K, bf, is_stereo)
        inlier_mask = valid & (res.chi2(r, inv_sigma2) <= chi2_th)
    return PoseOptResult(
        pose=T, inliers=inlier_mask, n_inliers=inlier_mask.sum(-1, dtype=torch.int32)
    )
