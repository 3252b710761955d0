"""Subprocess runner for the port's two-process torch.distributed test.

Each process joins a gloo process group through the port's
``multihost.initialize`` (a file store: no port to race for), holds 2
local CPU shards of a 4-shard process-group mesh, and runs ONE
``sharded_bundle_adjust`` whose collectives cross the process boundary.
Every rank writes its camera poses, point blocks, inlier flags, mean chi2
and the mesh's collective counts to ``<out>.<rank>.npz``. Driven by
tests/test_torch_parallel.py::test_two_process_sharded_ba. Imports
nothing of JAX.

Usage: python torch_multihost_runner.py <rank> <world> <store file> <out prefix>
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def build_problem():
    """tests/multihost_runner.build_problem's problem (the same seeded
    numpy draws), as torch tensors, with TWO cameras fixed: with mono
    observations only, one fixed camera leaves the scale gauge free, and
    two float32 solves that sum in different orders then part by up to
    1e-2 (tests/test_parallel.py fixes two for the same reason)."""
    from c_orb_slam_tpu_torch.optim import ba

    rng = np.random.default_rng(0)
    C, Pn, O = 4, 64, 256
    cam_T = np.tile(np.eye(3, 4, dtype=np.float32), (C, 1, 1))
    for c in range(C):
        cam_T[c, 0, 3] = -0.1 * c
    pts = np.c_[rng.uniform(-2, 2, (Pn, 2)), rng.uniform(4, 8, Pn)].astype(np.float32)
    obs_cam = rng.integers(0, C, O).astype(np.int32)
    obs_pt = rng.integers(0, Pn, O).astype(np.int32)
    xc = pts[obs_pt] + cam_T[obs_cam][:, :, 3]
    uv = np.stack(
        [500 * xc[:, 0] / xc[:, 2] + 320, 500 * xc[:, 1] / xc[:, 2] + 240,
         np.zeros(O, np.float32)], axis=1,
    ).astype(np.float32)
    t = torch.from_numpy
    return ba.BAProblem(
        cam_T=t(cam_T),
        cam_fixed=torch.tensor([True, True] + [False] * (C - 2)),
        cam_valid=torch.ones(C, dtype=torch.bool),
        points=t(pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)),
        point_valid=torch.ones(Pn, dtype=torch.bool),
        obs_cam=t(obs_cam),
        obs_pt=t(obs_pt),
        obs_uv=t(uv),
        obs_stereo=torch.zeros(O, dtype=torch.bool),
        obs_inv_sigma2=torch.ones(O),
        obs_valid=torch.ones(O, dtype=torch.bool),
        K=torch.tensor([500.0, 500.0, 320.0, 240.0]),
        bf=torch.tensor(0.0),
    )


def main():
    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    import torch.distributed as dist

    from c_orb_slam_tpu_torch.parallel import multihost, sharded_ba
    from c_orb_slam_tpu_torch.parallel.mesh import make_mesh

    joined = multihost.initialize(
        coordinator_address=f"file://{store}", num_processes=world, process_id=rank,
        backend="gloo", timeout_s=60,
    )
    try:
        if not joined or dist.get_world_size() != world:
            raise RuntimeError("multihost.initialize did not join the process group")
        mesh = make_mesh(["cpu", "cpu"])
        if not (mesh.group and mesh.size == 2 * world):
            raise RuntimeError(f"not a process-group mesh of {2 * world} shards: {mesh}")
        (cam_T, points, inlier, chi2), _pp = sharded_ba.sharded_bundle_adjust(
            build_problem(), mesh, iters_first=5, iters_second=5, pcg_iters=30)
        if not torch.isfinite(cam_T).all():
            raise RuntimeError("non-finite poses")
        np.savez(f"{out}.{rank}.npz", cam_T=cam_T.numpy(), points=points.numpy(),
                 inlier=inlier.numpy(), chi2=float(chi2), primary=multihost.is_primary(),
                 counts=json.dumps(mesh.counts))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
