"""Sim(3) pose-graph optimization: the essential-graph loop corrector.

Counterpart of c_orb_slam_tpu/optim/pose_graph.py (reference:
src/Optimizer.cc OptimizeEssentialGraph (:781-1044) — vertices are ALL
keyframes as Sim3 (scale locked for stereo/RGB-D), edges are new loop
connections, spanning-tree edges, prior loop edges and strong covisibility
edges; afterwards poses are recovered as SE3 with the scale divided out
(:991-1010)).

Vertices are (K, 8) packed Sim3, edges fixed-shape index arrays. Each GN
iteration: ``torch.func.jacrev`` under ``vmap`` of the 7-dof relative-log
residual wrt both endpoint tangents -> per-edge (7, 7) Jacobian blocks;
the normal system is never materialized — PCG runs on an implicit matvec
built from two gathers and an ``index_add``, with the block-diagonal
(7x7 per vertex) inverse as preconditioner.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacrev, vmap

from c_orb_slam_tpu_torch.geometry import sim3


class PoseGraphProblem(NamedTuple):
    vertices: torch.Tensor  # (K, 8) Sim3 world->cam
    v_fixed: torch.Tensor  # (K,) bool
    v_valid: torch.Tensor  # (K,) bool
    edge_i: torch.Tensor  # (E,) int
    edge_j: torch.Tensor  # (E,) int
    edge_Sji: torch.Tensor  # (E, 8) measured Sim3 cam_i -> cam_j
    edge_weight: torch.Tensor  # (E,) float32 information scale
    edge_valid: torch.Tensor  # (E,) bool


def _edge_residual(xi_i, xi_j, S_i, S_j, S_ji):
    """r = log(S_ji_meas ∘ (exp(xi_i) S_i) ∘ (exp(xi_j) S_j)^-1) — zero when
    the relative pose matches the measurement (g2o EdgeSim3 error,
    types_seven_dof_expmap.h:99)."""
    Si = sim3.compose(sim3.exp(xi_i), S_i)
    Sj = sim3.compose(sim3.exp(xi_j), S_j)
    return sim3.log(sim3.compose(S_ji, sim3.compose(Si, sim3.inverse(Sj))))


def edge_jacobians(S_i, S_j, S_ji):
    """(r (E, 7), Ji (E, 7, 7), Jj (E, 7, 7)) of every edge at zero tangent."""
    zero = torch.zeros(7, dtype=S_i.dtype, device=S_i.device)
    dims = (None, None, 0, 0, 0)
    r = vmap(_edge_residual, in_dims=dims)(zero, zero, S_i, S_j, S_ji)
    Ji, Jj = vmap(jacrev(_edge_residual, argnums=(0, 1)), in_dims=dims)(
        zero, zero, S_i, S_j, S_ji
    )
    return r, Ji, Jj


def gn_step(
    p: PoseGraphProblem,
    verts: torch.Tensor,
    pcg_iters: int = 50,
    fix_scale: bool = False,
) -> torch.Tensor:
    """ONE Gauss-Newton iteration on the Sim3 pose graph.

    The chunking unit for LoopClosing's background essential-graph job:
    one step dispatched per tracked frame, so the solve interleaves with
    tracking on the device instead of stalling the correction frame (the
    reference runs OptimizeEssentialGraph on its loop thread while
    Tracking continues, src/LoopClosing.cc:567 / Tracking.cc:277)."""
    K = p.vertices.shape[0]
    dev, dt = verts.device, verts.dtype
    ei, ej = p.edge_i.long(), p.edge_j.long()

    free = (p.v_valid & ~p.v_fixed).to(dt)[:, None]  # (K, 1)
    scale_mask = torch.ones(7, dtype=dt, device=dev)
    if fix_scale:
        scale_mask[6] = 0.0
    live = free * scale_mask  # (K, 7)

    r, Ji, Jj = edge_jacobians(verts[ei], verts[ej], p.edge_Sji)
    w = (p.edge_weight * p.edge_valid).to(dt)  # (E,)

    # Gradient: g = -J^T W r, scattered to vertices.
    rw = r * w[:, None]
    gi = -torch.einsum("eab,ea->eb", Ji, rw)
    gj = -torch.einsum("eab,ea->eb", Jj, rw)
    g = torch.zeros((K, 7), dtype=dt, device=dev)
    g = g.index_add(0, ei, gi).index_add(0, ej, gj) * live

    # Block-diagonal preconditioner blocks.
    Hii = torch.einsum("eab,eac->ebc", Ji * w[:, None, None], Ji)
    Hjj = torch.einsum("eab,eac->ebc", Jj * w[:, None, None], Jj)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    Hdiag = torch.zeros((K, 7, 7), dtype=dt, device=dev)
    Hdiag = Hdiag.index_add(0, ei, Hii).index_add(0, ej, Hjj) + 1e-5 * eye7
    Hdiag_inv = torch.linalg.inv(Hdiag)

    def matvec(x):  # x: (K, 7)
        x = x * live
        y = torch.einsum("eab,eb->ea", Ji, x[ei]) + torch.einsum(
            "eab,eb->ea", Jj, x[ej]
        )  # (E, 7) residual-space
        y = y * w[:, None]
        out = torch.zeros((K, 7), dtype=dt, device=dev)
        out = out.index_add(0, ei, torch.einsum("eab,ea->eb", Ji, y))
        out = out.index_add(0, ej, torch.einsum("eab,ea->eb", Jj, y))
        out = out + 1e-5 * x  # tiny damping keeps PCG positive-definite
        return out * live

    def precond(x):
        return torch.einsum("kab,kb->ka", Hdiag_inv, x) * live

    # PCG on H dx = g: a fixed number of iterations, no early exit.
    x = torch.zeros((K, 7), dtype=dt, device=dev)
    rr = g - matvec(x)
    z = precond(rr)
    d = z
    rz = (rr * z).sum()
    for _ in range(pcg_iters):
        Hd = matvec(d)
        alpha = rz / torch.clamp((d * Hd).sum(), min=1e-20)
        x = x + alpha * d
        rr = rr - alpha * Hd
        z = precond(rr)
        rz_new = (rr * z).sum()
        beta = rz_new / torch.clamp(rz, min=1e-20)
        d = z + beta * d
        rz = rz_new
    dx = x * live

    verts_new = sim3.compose(sim3.exp(dx), verts)
    keep = (p.v_valid & ~p.v_fixed)[:, None]
    return torch.where(keep, verts_new, verts)


def optimize_pose_graph(
    p: PoseGraphProblem,
    iters: int = 20,
    pcg_iters: int = 50,
    fix_scale: bool = False,
) -> torch.Tensor:
    """Returns optimized (K, 8) Sim3 vertices (the whole solve at once: the
    unit-test surface; the live System chunks via gn_step)."""
    verts = p.vertices
    for _ in range(iters):
        verts = gn_step(p, verts, pcg_iters, fix_scale)
    return verts


def recover_se3(verts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sim3 -> (SE3 (K, 3, 4), scale (K,)): t /= s (reference:
    Optimizer.cc:991-1010)."""
    return sim3.to_se3(verts), sim3.scale(verts)
