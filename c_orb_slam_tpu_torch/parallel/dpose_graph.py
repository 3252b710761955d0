"""Distributed Sim(3) pose-graph optimization: the edge axis sharded.

Counterpart of c_orb_slam_tpu/parallel/dpose_graph.py (``pad_edges`` :38,
``_body`` :56, ``distributed_pose_graph`` :155), the scale-out twin of
optim/pose_graph.py. Each shard owns a block of edges; the small vertex
state ((K, 8) Sim3, (K, 7) tangents) is replicated. The body is
``pose_graph.GraphSolve``, the one the single-device ``gn_step`` runs on
one shard (``pose_graph.edge_jacobians`` where JAX uses ``jacrev`` under
``vmap``):

* residuals and Jacobians: local to the edge shard, no communication;
* the gradient, the block-diagonal preconditioner and every PCG matvec:
  local scatter-adds, each followed by one ``psum`` of a vertex-sized
  tensor, so the collective volume per iteration is O(K), whatever E.
"""

from __future__ import annotations

import torch

from c_orb_slam_tpu_torch.geometry import sim3
from c_orb_slam_tpu_torch.optim.pose_graph import GraphSolve, PoseGraphProblem
from c_orb_slam_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["make_mesh", "pad_edges", "distributed_pose_graph", "graph_solve"]


def pad_edges(p: PoseGraphProblem, multiple: int) -> PoseGraphProblem:
    """Pad the edge axis so it divides the shard count: weight-0,
    valid=False self-loops at vertex 0."""
    E = p.edge_i.shape[0]
    pad = (-E) % multiple
    if pad == 0:
        return p
    dev = p.edge_Sji.device
    ident = sim3.identity(dtype=p.edge_Sji.dtype, device=dev).expand(pad, 8)
    z = torch.zeros(pad, dtype=p.edge_i.dtype, device=dev)
    return p._replace(
        edge_i=torch.cat([p.edge_i, z]),
        edge_j=torch.cat([p.edge_j, z.to(p.edge_j.dtype)]),
        edge_Sji=torch.cat([p.edge_Sji, ident]),
        edge_weight=torch.cat([p.edge_weight,
                               torch.zeros(pad, dtype=p.edge_weight.dtype, device=dev)]),
        edge_valid=torch.cat([p.edge_valid, torch.zeros(pad, dtype=torch.bool, device=dev)]),
    )


def graph_solve(p: PoseGraphProblem, mesh: Mesh, fix_scale: bool = False) -> GraphSolve:
    """The edge-sharded solve of `p` over `mesh`, not yet stepped
    (LoopClosing steps it once per tracked frame)."""
    return GraphSolve(pad_edges(p, mesh.size), mesh, fix_scale)


def distributed_pose_graph(
    p: PoseGraphProblem,
    mesh: Mesh | None = None,
    iters: int = 20,
    pcg_iters: int = 50,
    fix_scale: bool = False,
) -> torch.Tensor:
    """Edge-sharded essential-graph solve. Returns the optimized (K, 8)
    Sim3 vertices on the first local shard's device."""
    solve = graph_solve(p, mesh if mesh is not None else make_mesh(), fix_scale)
    for _ in range(iters):
        solve.step(pcg_iters)
    return solve.vertices
