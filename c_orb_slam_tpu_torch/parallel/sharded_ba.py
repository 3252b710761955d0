"""Map-sharded distributed bundle adjustment (keyframe-block scale-out).

Counterpart of c_orb_slam_tpu/parallel/sharded_ba.py (``partition_problem``
:59, the SPMD body :139-386, ``sharded_bundle_adjust`` :451). The map
itself is partitioned across the mesh, not only the observation list
(parallel/dba.py does that):

* points and their observations are sharded: observations are grouped
  into equal slabs so that every observation lives on the shard that owns
  its point, and all point-side work (Hpp, its inverse, gp, the
  back-substitution) is local, with no communication;
* camera poses are replicated;
* the reduced camera (Schur) system is sharded over camera blocks: each
  shard's contribution to Hcc, gc and every Schur matvec is
  reduce-scattered (``psum_scatter``), so PCG runs on (C/D, 6) shards
  with one all_gather(6C), one psum_scatter(6C) and two scalar psums per
  iteration, whatever the observation count.

The same two-stage robust LM schedule as optim/ba.bundle_adjust
(``ba.TwoStage``) over its own iteration; only the partitioning differs. Left behind from the JAX body: the one-hot matmul
camera scatter (a TPU workaround; an ordered segment sum here) and the in-body
argsort (the segment sums need no sorted ids, so the inlier mask is in
slab order as it is). ``lower_solve``, which exists to show HLO to the
JAX weak-scaling tool, has no twin: the mesh's collective counts
(parallel/mesh.py) take its place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from c_orb_slam_tpu_torch.geometry import se3
from c_orb_slam_tpu_torch.optim import ba
from c_orb_slam_tpu_torch.parallel.mesh import Mesh, make_mesh, pcg

__all__ = ["make_mesh", "partition_problem", "map_sharded_solve", "sharded_bundle_adjust"]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# Host-side partitioning: points into D contiguous blocks, observations
# slab-partitioned to follow their point's block.
# ---------------------------------------------------------------------------


def partition_problem(p: ba.BAProblem, n_devices: int) -> ba.BAProblem:
    """Reorder/pad a BAProblem so dim-0 shards align with point ownership.

    Returns a problem of numpy arrays whose `points` axis is padded to a
    multiple of n_devices (block d owns points [d*Ps, (d+1)*Ps)) and whose
    observation arrays are grouped into D equal-size slabs such that slab d
    only references points owned by block d. Cameras are padded to a
    multiple of n_devices so the Schur system can be reduce-scattered over
    camera blocks. All padding slots are masked invalid. Array for array
    the JAX package's partition.
    """
    p = ba.BAProblem(*(_np(x) for x in p))
    C0 = p.cam_T.shape[0]
    P0 = p.points.shape[0]

    pad_c = (-C0) % n_devices
    pad_p = (-P0) % n_devices
    Pn = P0 + pad_p

    cam_T = np.concatenate(
        [p.cam_T, np.tile(np.eye(3, 4, dtype=p.cam_T.dtype), (pad_c, 1, 1))]
    )
    cam_fixed = np.concatenate([p.cam_fixed, np.ones(pad_c, bool)])
    cam_valid = np.concatenate([p.cam_valid, np.zeros(pad_c, bool)])
    points = np.concatenate([p.points, np.zeros((pad_p, 3), p.points.dtype)])
    point_valid = np.concatenate([p.point_valid, np.zeros(pad_p, bool)])

    # Point ids stay in place (block = contiguous range): callers index
    # results by the original ids.
    Ps = Pn // n_devices
    owner = p.obs_pt // Ps  # (O,) shard owning each observation

    # Group observations by owner; pad every slab to the longest.
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=n_devices)
    slab = max(int(counts.max()) if counts.size else 1, 1)
    O_new = slab * n_devices

    def gather_pad(x, fill=0):
        out = np.full((O_new,) + x.shape[1:], fill, x.dtype)
        off = 0
        for d in range(n_devices):
            sel = order[off: off + counts[d]]
            out[d * slab: d * slab + counts[d]] = x[sel]
            off += counts[d]
        return out

    obs_valid = gather_pad(p.obs_valid, False)
    # Padding observations point at the owning block's first point and
    # camera 0: in-range indices, masked out by obs_valid=False.
    obs_pt = gather_pad(p.obs_pt)
    obs_cam = gather_pad(p.obs_cam)
    for d in range(n_devices):
        lo, hi = d * slab + counts[d], (d + 1) * slab
        obs_pt[lo:hi] = d * Ps
        obs_cam[lo:hi] = 0

    return ba.BAProblem(
        cam_T=cam_T,
        cam_fixed=cam_fixed,
        cam_valid=cam_valid,
        points=points,
        point_valid=point_valid,
        obs_cam=obs_cam,
        obs_pt=obs_pt,
        obs_uv=gather_pad(p.obs_uv),
        obs_stereo=gather_pad(p.obs_stereo, False),
        obs_inv_sigma2=gather_pad(p.obs_inv_sigma2, 1),
        obs_valid=obs_valid,
        K=p.K,
        bf=p.bf,
    )


# ---------------------------------------------------------------------------
# The SPMD body over this process's shards. A shard is a BAProblem whose
# points / point_valid are its point block and whose obs_pt is LOCAL
# (0..P_loc), so point gathers never leave the shard; cam_T, cam_fixed,
# cam_valid, K and bf are replicated.
# ---------------------------------------------------------------------------


def _shards(pp: ba.BAProblem, mesh: Mesh) -> list:
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    P_loc = pp.points.shape[0] // mesh.size
    obs_pt = [o - mesh.axis_index(i) * P_loc
              for i, o in enumerate(mesh.shard(t(pp.obs_pt)))]
    sharded = {f: mesh.shard(t(getattr(pp, f))) for f in (
        "points", "point_valid", "obs_cam", "obs_uv", "obs_stereo", "obs_inv_sigma2",
        "obs_valid")}
    rep = {f: mesh.replicate(t(getattr(pp, f))) for f in ("cam_T", "cam_fixed", "cam_valid", "K")}
    rep["bf"] = mesh.replicate(torch.tensor(float(pp.bf), dtype=torch.float32))
    return [ba.BAProblem(obs_pt=obs_pt[i], **{f: v[i] for f, v in {**sharded, **rep}.items()})
            for i in range(mesh.n_local)]


class _Blocks(NamedTuple):
    """One shard's damped normal system of an LM iteration."""

    Hcc_s: torch.Tensor  # (C/D, 6, 6) this shard's camera block rows
    gc_s: torch.Tensor  # (C/D, 6)
    Hpp_inv: torch.Tensor  # (P_loc, 3, 3) this shard's points
    gp: torch.Tensor  # (P_loc, 3)


def _iteration(mesh, ps, cam_T, points, lam, use_huber, chi2_mono, chi2_stereo, pcg_iters,
               segs):
    """One damped GN step, camera Schur system sharded over camera blocks;
    `segs` holds each shard's ``ba.Segs``."""
    C = ps[0].cam_T.shape[0]
    Cs = C // mesh.size
    terms = mesh.per_shard(
        lambda p, T, X, sg: (*ba._obs_terms(p, T, X, use_huber, chi2_mono, chi2_stereo)[:4], sg),
        ps, cam_T, points, segs,
    )
    sums = mesh.per_shard(lambda p, t: ba._normal_sums(p, *t), ps, terms)

    # Camera side: local (C, 42) partial -> reduce-scatter to (C/D, 42).
    cam_acc = mesh.psum_scatter([torch.cat([s[0].reshape(C, 36), s[1]], 1) for s in sums])
    # Point side: purely local.
    free_cam = mesh.replicated(lambda p: (p.cam_valid & ~p.cam_fixed).to(p.points.dtype), ps)
    free_s = [f[mesh.axis_index(i) * Cs:(mesh.axis_index(i) + 1) * Cs][:, None]
              for i, f in enumerate(free_cam)]

    def damp(p, acc, s, fs, l):
        dt, dev = acc.dtype, acc.device
        eye6 = torch.eye(6, dtype=dt, device=dev)
        eye3 = torch.eye(3, dtype=dt, device=dev)
        Hcc_s = acc[:, :36].reshape(-1, 6, 6) + l * eye6 + (1.0 - fs)[..., None] * eye6
        live = p.point_valid.to(dt)[:, None, None]
        Hpp_inv = ba._inv3x3(s[2] + l * eye3 + (1.0 - live) * eye3)
        return _Blocks(Hcc_s, acc[:, 36:], Hpp_inv, s[3])

    blk = mesh.per_shard(damp, ps, cam_acc, sums, free_s, lam)

    def w_times_local(p, t, b, y):  # W Hpp^-1 y on the shard, full (C, 6)
        return ba._w_times(p, *t[1:4], (b.Hpp_inv @ y[..., None])[..., 0], t[4])

    def matvec(x_s):
        """S @ x with x sharded (C/D, 6): all_gather(6C) + psum_scatter(6C)."""
        x_s = mesh.per_shard(lambda x, fs: x * fs, x_s, free_s)
        x = mesh.all_gather(x_s)
        z_part = mesh.per_shard(
            lambda p, t, b, x_: w_times_local(p, t, b, ba._wt_times(p, *t[1:4], x_, t[4])),
            ps, terms, blk, x)
        z_s = mesh.psum_scatter(z_part)
        return mesh.per_shard(
            lambda b, x_, z_, fs: ((b.Hcc_s @ x_[..., None])[..., 0] - z_) * fs,
            blk, x_s, z_s, free_s)

    # Schur RHS: -(gc - W Hpp^-1 gp), sharded.
    Wy_s = mesh.psum_scatter(mesh.per_shard(lambda p, t, b: w_times_local(p, t, b, b.gp),
                                            ps, terms, blk))
    rhs_s = mesh.per_shard(lambda b, wy, fs: -(b.gc_s - wy) * fs, blk, Wy_s, free_s)
    Hcc_inv_s = mesh.per_shard(lambda b: torch.linalg.inv_ex(b.Hcc_s)[0], blk)
    precond = lambda v: mesh.per_shard(  # noqa: E731
        lambda hi, v_, fs: (hi @ v_[..., None])[..., 0] * fs, Hcc_inv_s, v, free_s)
    pdot = lambda a, b: mesh.psum(mesh.per_shard(lambda a_, b_: (a_ * b_).sum(), a, b))  # noqa: E731
    dc_s = pcg(matvec, precond, pdot, mesh.per_shard, rhs_s, pcg_iters)
    dc = mesh.all_gather(mesh.per_shard(lambda d, fs: d * fs, dc_s, free_s))  # (C, 6)

    # Back-substitute point updates: purely local.
    def points_update(p, t, b, d, X):
        Wt_dc = ba._wt_times(p, *t[1:4], d, t[4])
        dp = (b.Hpp_inv @ (-b.gp - Wt_dc)[..., None])[..., 0]
        return X + dp * p.point_valid.to(dp.dtype)[:, None]

    new_X = mesh.per_shard(points_update, ps, terms, blk, dc, points)
    new_T = mesh.replicated(
        lambda d, T, f: torch.where(f[:, None, None] > 0, se3.compose(se3.exp(d), T), T),
        dc, cam_T, free_cam)
    return new_T, new_X


def map_sharded_solve(p: ba.BAProblem, mesh: Mesh, iters_first: int = 5,
                      iters_second: int = 10, pcg_iters: int = 40, chi2_mono: float = 5.991,
                      chi2_stereo: float = 7.815):
    """The two-stage solve of `p` with the map sharded over `mesh`, not
    yet stepped (``ba.TwoStage`` over this body: LoopClosing's
    _ShardedGbaJob steps it once per tracked frame), and the partitioned
    problem."""
    pp = partition_problem(p, mesh.size)
    ps = _shards(pp, mesh)
    segs = mesh.per_shard(lambda p_: ba.segs_of(p_, w_blocks=False), ps)  # no W formed

    def iteration(ps_, T, X, lam, use_huber):
        return _iteration(mesh, ps_, T, X, lam, use_huber, chi2_mono, chi2_stereo, pcg_iters,
                          segs)

    return ba.TwoStage(mesh, ps, [q.cam_T for q in ps], [q.points for q in ps], iteration,
                       mesh.per_shard, iters_first, iters_second, chi2_mono, chi2_stereo), pp


def sharded_bundle_adjust(
    p: ba.BAProblem,
    mesh: Mesh | None = None,
    iters_first: int = 5,
    iters_second: int = 10,
    pcg_iters: int = 40,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
):
    """Two-stage robust BA with the map sharded over `mesh` (default: the
    ``make_mesh`` of the problem's device type).

    Returns ``(cam_T (C',3,4), points, obs_inlier, mean_chi2),
    partitioned_problem``: cam_T and mean_chi2 replicated, points and
    obs_inlier this process's blocks in order (every block on an
    in-process mesh: (P', 3) and (O',) in slab order), all on the first
    local shard's device. Point ids are preserved (padding only appended),
    so ``points[:P0]`` lines up with the input problem.
    """
    mesh = mesh if mesh is not None else make_mesh(device_type=p.points.device.type)
    solve, pp = map_sharded_solve(p, mesh, iters_first, iters_second, pcg_iters, chi2_mono,
                                  chi2_stereo)
    cam_T, points, inlier, mean_chi2 = solve.run().result()
    return (cam_T[0], mesh.gather_local(points), mesh.gather_local(inlier), mean_chi2), pp
