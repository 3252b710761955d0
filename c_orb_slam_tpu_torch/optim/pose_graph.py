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
built from two gathers and a segment sum in a fixed order
(ops/segment.py; the JAX package's ``.at[].add``), with the block-diagonal
(7x7 per vertex) inverse as preconditioner. ``GraphSolve`` holds the
iteration once, over the edge shards of a mesh: one shard here,
several in parallel/dpose_graph.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import jacrev, vmap

from c_orb_slam_tpu_torch.geometry import sim3
from c_orb_slam_tpu_torch.ops import segment
from c_orb_slam_tpu_torch.parallel.mesh import Mesh, pcg


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


_EDGES = ("edge_i", "edge_j", "edge_Sji", "edge_weight", "edge_valid")


class GraphSolve:
    """Gauss-Newton on the Sim3 pose graph, written once over the shards
    of a mesh (parallel/mesh.py): each shard owns a block of edges, the
    (K, 8) vertices and (K, 7) tangents are replicated. Residuals and
    Jacobians are local to the edge shard; the gradient, the
    block-diagonal preconditioner and every PCG matvec are local
    scatter-adds followed by one psum of a vertex-sized tensor. On a
    one-shard mesh (``gn_step``) every psum is its argument; on several
    (parallel/dpose_graph) the edge count must divide the shard count
    (``dpose_graph.pad_edges``).

    ``step()`` is ONE iteration: the chunking unit for LoopClosing's
    essential-graph job, one step dispatched per tracked frame, so the
    solve interleaves with tracking on the device instead of stalling the
    correction frame (the reference runs OptimizeEssentialGraph on its
    loop thread while Tracking continues, src/LoopClosing.cc:567 /
    Tracking.cc:277)."""

    def __init__(self, p: PoseGraphProblem, mesh: Mesh, fix_scale: bool = False,
                 verts: Optional[torch.Tensor] = None):
        self.mesh = mesh
        sharded = {f: mesh.shard(getattr(p, f)) for f in _EDGES}
        self.edges = [{f: v[i] for f, v in sharded.items()} for i in range(mesh.n_local)]
        self.verts = mesh.replicate(p.vertices if verts is None else verts)
        # Every vertex sum adds the edges' i-side rows, then their j-side
        # rows, each in edge order: one order for the whole solve.
        K = self.verts[0].shape[0]
        self.segs = [segment.segments(torch.cat([e["edge_i"], e["edge_j"]]), K)
                     for e in self.edges]

        def masks(v, vf, vv):
            scale_mask = torch.ones(7, dtype=v.dtype, device=v.device)
            if fix_scale:
                scale_mask[6] = 0.0
            keep = (vv & ~vf)[:, None]
            return keep.to(v.dtype) * scale_mask, keep

        m = mesh.replicated(masks, self.verts, mesh.replicate(p.v_fixed),
                            mesh.replicate(p.v_valid))
        self.live, self.keep = [x[0] for x in m], [x[1] for x in m]

    @property
    def vertices(self) -> torch.Tensor:
        """The (K, 8) vertices on the first local shard's device."""
        return self.verts[0]

    def step(self, pcg_iters: int = 50):
        mesh, live = self.mesh, self.live

        def local(e, v):
            ei, ej = e["edge_i"].long(), e["edge_j"].long()
            r, Ji, Jj = edge_jacobians(v[ei], v[ej], e["edge_Sji"])
            w = (e["edge_weight"] * e["edge_valid"]).to(v.dtype)
            return ei, ej, r, Ji, Jj, w

        t = mesh.per_shard(local, self.edges, self.verts)

        def to_vertices(sg, at_i, at_j):  # the edges' i-side and j-side rows, summed
            return segment.segment_sum(torch.cat([at_i, at_j]), sg)

        def grad_part(tt, sg):  # g = -Jᵀ W r, scattered to vertices
            ei, ej, r, Ji, Jj, w = tt
            rw = r * w[:, None]
            return to_vertices(sg, -torch.einsum("eab,ea->eb", Ji, rw),
                               -torch.einsum("eab,ea->eb", Jj, rw))

        def hdiag_part(tt, sg):  # block-diagonal preconditioner blocks
            ei, ej, r, Ji, Jj, w = tt
            return to_vertices(sg, torch.einsum("eab,eac->ebc", Ji * w[:, None, None], Ji),
                               torch.einsum("eab,eac->ebc", Jj * w[:, None, None], Jj))

        g = mesh.replicated(lambda g_, lv: g_ * lv,
                            mesh.psum(mesh.per_shard(grad_part, t, self.segs)), live)
        Hdiag_inv = mesh.replicated(
            lambda h: torch.linalg.inv_ex(
                h + 1e-5 * torch.eye(7, dtype=h.dtype, device=h.device))[0],
            mesh.psum(mesh.per_shard(hdiag_part, t, self.segs)))

        def matvec(x):
            x = mesh.replicated(lambda x_, lv: x_ * lv, x, live)

            def part(tt, sg, x_):  # residual-space y = J x, back through Jᵀ W
                ei, ej, r, Ji, Jj, w = tt
                y = torch.einsum("eab,eb->ea", Ji, x_[ei]) + torch.einsum("eab,eb->ea", Jj, x_[ej])
                y = y * w[:, None]
                return to_vertices(sg, torch.einsum("eab,ea->eb", Ji, y),
                                   torch.einsum("eab,ea->eb", Jj, y))

            out = mesh.psum(mesh.per_shard(part, t, self.segs, x))
            # tiny damping keeps PCG positive-definite
            return mesh.replicated(lambda o, x_, lv: (o + 1e-5 * x_) * lv, out, x, live)

        precond = lambda v: mesh.replicated(  # noqa: E731
            lambda hi, v_, lv: torch.einsum("kab,kb->ka", hi, v_) * lv, Hdiag_inv, v, live)
        dot = lambda a, b: mesh.replicated(lambda a_, b_: (a_ * b_).sum(), a, b)  # noqa: E731
        # PCG on H dx = g from x = 0 (the residual starts at g - H·0): a
        # fixed number of iterations, no early exit.
        rr = mesh.replicated(lambda g_, m: g_ - m, g,
                             matvec(mesh.replicated(torch.zeros_like, g)))
        x = pcg(matvec, precond, dot, mesh.replicated, rr, pcg_iters)
        self.verts = mesh.replicated(
            lambda x_, lv, kp, v: torch.where(kp, sim3.compose(sim3.exp(x_ * lv), v), v),
            x, live, self.keep, self.verts)
        return self


def gn_step(
    p: PoseGraphProblem,
    verts: torch.Tensor,
    pcg_iters: int = 50,
    fix_scale: bool = False,
) -> torch.Tensor:
    """ONE Gauss-Newton iteration on the Sim3 pose graph, on one device
    (``GraphSolve`` on a one-shard mesh)."""
    return GraphSolve(p, Mesh([verts.device]), fix_scale, verts).step(pcg_iters).vertices


def optimize_pose_graph(
    p: PoseGraphProblem,
    iters: int = 20,
    pcg_iters: int = 50,
    fix_scale: bool = False,
) -> torch.Tensor:
    """Returns optimized (K, 8) Sim3 vertices (the whole solve at once: the
    unit-test surface; the live System steps a GraphSolve once a frame)."""
    solve = GraphSolve(p, Mesh([p.vertices.device]), fix_scale)
    for _ in range(iters):
        solve.step(pcg_iters)
    return solve.vertices


def recover_se3(verts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sim3 -> (SE3 (K, 3, 4), scale (K,)): t /= s (reference:
    Optimizer.cc:991-1010)."""
    return sim3.to_se3(verts), sim3.scale(verts)
