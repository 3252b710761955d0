"""Distributed bundle adjustment: the observation axis sharded.

Counterpart of c_orb_slam_tpu/parallel/dba.py (``make_mesh`` :30,
``shard_problem`` :35, ``distributed_bundle_adjust`` :62,
``pad_observations`` :106). The observations of a BA problem are split
into equal slabs over the mesh; camera poses and points are replicated.
JAX gets the collectives from GSPMD; here they are written out, in the
one body of optim/ba.py (``ba.lm_solve``; ``ba.bundle_adjust`` runs it on
one shard). Each shard computes residuals, Jacobians and robust weights
over its own observations and segment-sums its partial Hcc, gc, Hpp and
gp (and, for ``schur="dense"``, the (P*C, 18) W blocks); one ``psum``
joins them. The dense Cholesky solve and the damping then run
replicated; the point back-substitution takes one more psum of a (P, 3)
partial, as does each side of every PCG matvec on the ``schur="pcg"``
route. The LM accept test reads the psum of the robust error. The
local-BA scale-out twin of parallel/sharded_ba: LocalMapping sends
full-bucket windows here when its mesh has more than one shard
(mapping.py ``_solve_local_ba``).
"""

from __future__ import annotations

import torch

from c_orb_slam_tpu_torch.optim import ba
from c_orb_slam_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["make_mesh", "shard_problem", "distributed_bundle_adjust", "pad_observations"]

_OBS = ("obs_cam", "obs_pt", "obs_uv", "obs_stereo", "obs_inv_sigma2", "obs_valid")
_REP = ("cam_T", "cam_fixed", "cam_valid", "points", "point_valid", "K", "bf")


def shard_problem(p: ba.BAProblem, mesh: Mesh) -> list:
    """This process's shards of `p`: observation slabs, everything else
    replicated. The observation count must divide the mesh size (pad
    with pad_observations first)."""
    obs = {f: mesh.shard(getattr(p, f)) for f in _OBS}
    rep = {f: mesh.replicate(getattr(p, f)) for f in _REP}
    return [ba.BAProblem(**{f: v[i] for f, v in {**obs, **rep}.items()})
            for i in range(mesh.n_local)]


def distributed_bundle_adjust(
    p: ba.BAProblem,
    mesh: Mesh,
    iters_first: int = 5,
    iters_second: int = 10,
    pcg_iters: int = 40,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    schur: str = "pcg",
) -> ba.BAResult:
    """Two-stage BA with observations sharded across the mesh
    (``ba.lm_solve``, the body ``ba.bundle_adjust`` runs on one shard).
    Returns replicated poses and points on the first local shard's device,
    and this process's observations' inlier flags (all of them on an
    in-process mesh)."""
    cam_T, points, inlier, mean_chi2 = ba.lm_solve(
        mesh, shard_problem(p, mesh), iters_first, iters_second, chi2_mono, chi2_stereo,
        pcg_iters, schur).run().result()
    return ba.BAResult(cam_T=cam_T[0], points=points[0], obs_inlier=mesh.gather_local(inlier),
                       final_chi2=mean_chi2)


def pad_observations(p: ba.BAProblem, multiple: int) -> ba.BAProblem:
    """Pad the observation axis so it divides the shard count: appended
    slots with obs_inv_sigma2 = 1 and obs_valid = False."""
    O = p.obs_cam.shape[0]
    pad = (-O) % multiple
    if pad == 0:
        return p

    def z(x, fill=0):
        return torch.cat([x, torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)])

    return p._replace(
        obs_cam=z(p.obs_cam),
        obs_pt=z(p.obs_pt),
        obs_uv=z(p.obs_uv),
        obs_stereo=z(p.obs_stereo),
        obs_inv_sigma2=z(p.obs_inv_sigma2, 1),
        obs_valid=z(p.obs_valid),
    )
