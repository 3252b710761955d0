"""Weak-scaling harness for the port's map-sharded BA (parallel/sharded_ba).

Counterpart of tools/weak_scaling.py. Holds the problem per shard fixed
(points and observations per shard constant) while the mesh grows, and
prints one JSON line per mesh size: the solve's ms, the collective
elements per LM iteration read from the mesh's counters, and beside them
the analytic count of the sharded body (one reduce-scatter of the (C, 42)
camera system and of the (C, 6) Schur right-hand side, then per PCG
iteration one all_gather(6C), one psum_scatter(6C) and two scalar psums,
one all_gather(6C) of the step and one scalar psum of the error), with its
bytes: the JAX tool's ``collective_bytes`` reads the same quantity from
the compiled HLO. Per LM iteration the volume grows with the cameras, not
with the observations.

Backings: ``inprocess`` puts every shard on ``--device`` in this process;
``gloo`` starts one process per shard, joined by a gloo process group (a
file store), each shard on ``--device``. With one card, every shard
shares it, so the time measures the overhead of sharding, not scaling;
the output says so.

Usage: python3 -m c_orb_slam_tpu_torch.tools.weak_scaling [--shards 1 2 4 8]
           [--obs-per-shard 4096] [--pts-per-shard 1024] [--cams 32] [--reps 3]
           [--backing inprocess|gloo] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

ITERS_FIRST, ITERS_SECOND, PCG_ITERS = 3, 3, 20


def make_problem(C, Pn, O, seed=0, device="cpu"):
    """tools/weak_scaling.py's problem (the same seeded numpy draws)."""
    import numpy as np
    import torch

    from c_orb_slam_tpu_torch.optim import ba

    rng = np.random.default_rng(seed)
    cam_T = np.tile(np.eye(3, 4, dtype=np.float32), (C, 1, 1))
    for c in range(C):
        cam_T[c, 0, 3] = -0.05 * c
    pts = np.c_[rng.uniform(-3, 3, (Pn, 2)), rng.uniform(4, 9, Pn)].astype(np.float32)
    obs_cam = rng.integers(0, C, O).astype(np.int32)
    obs_pt = rng.integers(0, Pn, O).astype(np.int32)
    xc = pts[obs_pt] + cam_T[obs_cam][:, :, 3]
    uv = np.stack([500 * xc[:, 0] / xc[:, 2] + 320, 500 * xc[:, 1] / xc[:, 2] + 240,
                   np.zeros(O, np.float32)], axis=1).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return ba.BAProblem(
        cam_T=t(cam_T), cam_fixed=t(np.arange(C) < 2), cam_valid=t(np.ones(C, bool)),
        points=t(pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)),
        point_valid=t(np.ones(Pn, bool)), obs_cam=t(obs_cam), obs_pt=t(obs_pt), obs_uv=t(uv),
        obs_stereo=t(np.zeros(O, bool)), obs_inv_sigma2=t(np.ones(O, np.float32)),
        obs_valid=t(np.ones(O, bool)), K=t(np.array([500.0, 500.0, 320.0, 240.0], np.float32)),
        bf=t(np.array(0.0, np.float32)),
    )


def analytic_elements_per_lm_iter(C: int, pcg_iters: int = PCG_ITERS) -> int:
    """Collective elements of one LM iteration of the sharded body, C the
    padded camera count."""
    return 42 * C + 6 * C + 1 + pcg_iters * (6 * C + 6 * C + 2) + 6 * C + 1


def _solve(p, mesh, device):
    import torch

    from c_orb_slam_tpu_torch.parallel import sharded_ba

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    (cam_T, *_), pp = sharded_ba.sharded_bundle_adjust(
        p, mesh, iters_first=ITERS_FIRST, iters_second=ITERS_SECOND, pcg_iters=PCG_ITERS)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1000.0, pp.cam_T.shape[0]


def measure(mesh, args, device):
    """Time the solve (after one warm-up) and read one solve's collective
    counts. Returns (sorted ms, padded C, counts)."""
    d = mesh.size
    p = make_problem(args.cams, args.pts_per_shard * d, args.obs_per_shard * d, device=device)
    _solve(p, mesh, device)
    mesh.reset_counts()
    ms, C = _solve(p, mesh, device)
    counts = {k: list(v) for k, v in mesh.counts.items()}
    ts = [ms] + [_solve(p, mesh, device)[0] for _ in range(args.reps - 1)]
    return sorted(ts), C, counts


def _gloo_rank(rank, world, store, args, queue):
    import torch
    import torch.distributed as dist

    from c_orb_slam_tpu_torch.parallel import multihost
    from c_orb_slam_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    device = torch.device(args.device)
    multihost.initialize(f"file://{store}", world, rank, backend="gloo", timeout_s=300)
    try:
        out = measure(make_mesh([device]), args, device)
        if rank == 0:
            queue.put(out)
    finally:
        dist.destroy_process_group()


def run_gloo(d, args):
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_gloo_rank, args=(r, d, os.path.join(tmp, "store"), args, queue))
                 for r in range(d)]
        for pr in procs:
            pr.start()
        try:
            out = queue.get(timeout=args.timeout)
            for pr in procs:
                pr.join(timeout=args.timeout)
        finally:
            for pr in procs:
                if pr.is_alive():
                    pr.kill()
                    pr.join()
        bad = [pr.exitcode for pr in procs if pr.exitcode != 0]
        if bad:
            raise RuntimeError(f"gloo ranks exited {bad}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--obs-per-shard", type=int, default=4096)
    ap.add_argument("--pts-per-shard", type=int, default=1024)
    ap.add_argument("--cams", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--backing", choices=("inprocess", "gloo"), default="inprocess")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds a gloo run may take")
    args = ap.parse_args(argv)

    import torch

    from c_orb_slam_tpu_torch.parallel.mesh import Mesh

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("weak_scaling: no CUDA device; pass --device cpu", file=sys.stderr)
            return 1
        where = f"{torch.cuda.get_device_name(device)} x{torch.cuda.device_count()}"
    else:
        where = "cpu"
    rows = []
    for d in args.shards:
        if args.backing == "gloo":
            ts, C, counts = run_gloo(d, args)
        else:
            ts, C, counts = measure(Mesh([device] * d), args, device)
        lm_iters = ITERS_FIRST + ITERS_SECOND
        # Per solve, beyond the LM iterations: each stage's first error
        # psum and the final chi2 psum (2 elements).
        elements = sum(v[1] for k, v in counts.items() if k != "host_staged") - (2 + 2)
        row = {
            "shards": d, "backing": args.backing, "device": where,
            "obs": args.obs_per_shard * d, "points": args.pts_per_shard * d, "cams": C,
            "step_ms": round(ts[0], 3), "step_ms_median": round(statistics.median(ts), 3),
            "collective_elements_per_lm_iter": elements / lm_iters,
            "analytic_elements_per_lm_iter": analytic_elements_per_lm_iter(C),
            "analytic_collective_bytes_per_lm_iter": 4 * analytic_elements_per_lm_iter(C),
            "counts_per_solve": counts,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    one_device = args.backing == "inprocess" or device.type == "cuda"
    print(json.dumps({
        "time_vs_1_shard": {f"{r['shards']}x": round(rows[0]["step_ms"] / r["step_ms"], 3)
                            for r in rows},
        "note": ("every shard shares one device: the time measures the overhead of sharding, "
                 "not scaling" if one_device
                 else "one CPU process per shard, sharing this host's cores"),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
