"""The readings that the limits of ``correct`` are set from: one cell's
numbers compared, over many seeds, for the program and for its control,
in one process (set-up is most of a run).

    python3 slambench/readings.py --workload <cell> --seconds <s> --seeds 1,2,3 [--arm program|tf32 ...] [--out DIR]
    python3 slambench/readings.py --config <name> --traffic <mix> --seconds <s> --seeds ...

Each run is a whole run of the cell at its own size and window (the
harness's ``run``), so it compares as many frames as a benchmark run
does. ``--config`` and ``--traffic`` name a held cell, one that
``BENCHMARK.json`` does not list: ``configs/<name>.json`` under
``traffic/<mix>.json`` on one chip, so that its limits can be set before
it is added. ``program`` is the port as it ships. ``tf32`` is the control: the
same program with TF32 switched on for its float32 matmuls and
convolutions (the package pins both off: float32 is the precision TF32
lies below). The harness sets it after importing the port, and the run
fails unless the detail record shows it in effect. ``state_unchanged``
and ``answer_altered`` are the faults of ``faults.py``. One JSON line a
run: the arm, the seed, the precision in effect, the readings, whether
each is within its limit, and diagnostics beside them that decide
nothing (``diagnostics``). With ``--out`` each run's detail record (poses, map) goes to that
directory too.
"""

import argparse
import contextlib
import json
import math
import os
import sys

for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from slambench import faults, harness, reference  # noqa: E402

ARMS = ("program", "tf32", *faults.FAULTS)


def off_surface(points: np.ndarray, xw: np.ndarray, size: np.ndarray,
                block: int = 512) -> np.ndarray:
    """Whether each point lies outside every billboard's bounding sphere
    (centre xw, radius sqrt(2) * half side): every point of a square
    billboard lies in that sphere whatever way it faces. Points go in
    blocks along the world's longest axis, each against the billboards
    whose spheres reach the block's span of that axis."""
    xw = np.asarray(xw, np.float64)
    radius = math.sqrt(2.0) * np.asarray(size, np.float64)
    axis = int(np.argmax(np.ptp(xw, axis=0)))
    order = np.argsort(xw[:, axis], kind="stable")
    xw, radius = xw[order], radius[order]
    key, reach = xw[:, axis], float(radius.max())
    pts = np.asarray(points, np.float64)
    by = np.argsort(pts[:, axis], kind="stable")
    off = np.ones(len(pts), bool)
    for a in range(0, len(pts), block):
        idx = by[a:a + block]
        p = pts[idx]
        lo, hi = np.searchsorted(key, [p[:, axis].min() - reach, p[:, axis].max() + reach])
        if hi > lo:
            d = np.sqrt(((p[:, None, :] - xw[None, lo:hi, :]) ** 2).sum(-1)) - radius[None, lo:hi]
            off[idx] = d.min(axis=1) > 0
    return off


def diagnostics(detail: dict, world: dict, rigid: bool, final_map: dict,
                settings: dict) -> dict:
    """Numbers beside the compared ones, from the detail record's poses
    and map: the widest frame's gap, the share of the map's points off
    the world, the rotation error, each frame's step error, how the
    final map's reprojection residuals spread (in sigma of their level:
    the median, the 99th percentile, the widest, the share beyond
    ORB-SLAM2's 95% gate of 5.991 on chi2 with 2 degrees of freedom, and
    the count) and, for a monocular camera, how far the scale drifts
    between the window's halves."""
    res = reference.reprojection(final_map, *reference.camera(settings))
    out = {}
    if len(res):
        out.update(reproj_p50=float(np.median(res)), reproj_p99=float(np.quantile(res, 0.99)),
                   reproj_max=float(res.max()),
                   reproj_out_share=float(np.mean(res ** 2 > 5.991)), reproj_n=int(len(res)))
    ok = [k for k, t in enumerate(detail["tracked"]) if t]
    if len(ok) < 6:
        return out
    est_cw = np.asarray([detail["poses"][k] for k in ok], np.float64).reshape(-1, 3, 4)
    gt_cw = np.asarray(world["poses"][[detail["judged"][k] for k in ok]], np.float64)
    ce, cg = reference.centers(est_cw), reference.centers(gt_cw)
    s, R, t = reference.align_umeyama(ce, cg, not rigid)
    out["ate_max_m"] = float(np.sqrt(np.sum((ce @ (s * R).T + t - cg) ** 2, axis=1)).max())
    s, R, t = reference.align_poses(est_cw, gt_cw, not rigid)
    pts = np.asarray(detail["map_xyz"], np.float64).reshape(-1, 3)
    if len(pts):
        out["map_off_share"] = float(off_surface(pts @ (s * R).T + t, world["xw"],
                                                 world["size"]).mean())
    rot = np.einsum("fji,fjk->fik", est_cw[:, :, :3], gt_cw[:, :, :3]) @ R  # R_e^T R_g R
    step = np.diff(ce, axis=0) @ (s * R).T - np.diff(cg, axis=0)
    out.update(rot_err_deg=float(np.degrees(np.sqrt(np.mean(reference.rotation_angle(rot) ** 2)))),
               step_err_m=float(np.sqrt(np.mean(np.sum(step ** 2, axis=1)))))
    if not rigid:
        half = len(ce) // 2
        s1 = reference.align_umeyama(ce[:half], cg[:half], True)[0]
        s2 = reference.align_umeyama(ce[half:], cg[half:], True)[0]
        out["scale_drift"] = float(abs(s2 / s1 - 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    cell = ap.add_mutually_exclusive_group(required=True)
    cell.add_argument("--workload", help="a cell of BENCHMARK.json")
    cell.add_argument("--config", help="a held cell's configuration (with --traffic)")
    ap.add_argument("--traffic", help="a held cell's mix (with --config)")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--arm", action="append", choices=sorted(ARMS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="directory for each run's detail record")
    args = ap.parse_args(argv)
    if (args.config is None) != (args.traffic is None):
        ap.error("--config and --traffic go together")
    spec = (harness.load_spec(args.workload) if args.workload
            else harness.held_spec(args.config, args.traffic))
    name = spec["cell"]["name"]
    rate = float(spec["config"]["settings"]["Camera.fps"])
    rigid = spec["config"]["sensor"] == "STEREO"
    for seed in (int(s) for s in args.seeds.split(",")):
        for arm in args.arm or ["program"]:
            try:
                with faults.planted(arm) if arm in faults.FAULTS else contextlib.nullcontext():
                    out = harness.run(spec, seed, args.seconds, False,
                                      device=args.device, tf32=arm == "tf32")
            except RuntimeError as e:  # a control that crashes has failed
                print(json.dumps(dict(arm=arm, seed=seed, error=str(e)[:500])), flush=True)
                continue
            d = out["detail"]
            if d["precision"]["matmul_tf32"] != (arm == "tf32"):
                raise SystemExit(f"{arm} ran with {d['precision']}")
            n = harness.frame_budget(spec["mix"], rate, args.seconds, False)
            world = spec["gen"].generate(seed, spec["mix"], n, rate)
            rec = dict(arm=arm, seed=seed, correct=out["result"]["correct"],
                       precision=d["precision"],
                       readings={k: (v if math.isfinite(v) else None)
                                 for k, v in d["readings"].items()},
                       within={c[0]: c[3] for c in out["checks"]},
                       diagnostics=diagnostics(d, world, rigid, out["final_map"],
                                               spec["config"]["settings"]),
                       frames=d["window_frames"], keyframes=d["keyframes"],
                       map_points=d["map_points"], local_ba=d["local_ba"],
                       resets=d["resets"], fps=d["e2e"]["fps"],
                       p90_ms=d["e2e"]["pose_latency_ms_p90"], stage_ms=d["stage_ms"])
            print(json.dumps(rec), flush=True)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                with open(os.path.join(args.out, f"{name}.{arm}.{seed}.json"), "w") as f:
                    json.dump(d, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
