"""The readings that the limits of ``correct`` are set from: one cell's
numbers compared, over many seeds, for the program and for its controls,
in one process (set-up is most of a run).

    python3 slambench/readings.py --workload <cell> --seconds <s> --seeds 1,2,3 [--arm program|tf32 ...] [--trace] [--to-supply-end] [--out DIR]
    python3 slambench/readings.py --config <name> --traffic <mix> --seconds <s> --seeds ...

Each run is a whole run of the cell at its own size and window (the
harness's ``run``), so it compares as many frames as a benchmark run
does. ``--to-supply-end`` keeps each window open to the last frame of
the supply of a `seconds` window, whatever its clock reads: the frames
that a program which outruns the sensor hands in. ``--config`` and
``--traffic`` name a held cell, one that ``BENCHMARK.json`` does not
list: ``configs/<name>.json`` under ``traffic/<mix>.json`` on one chip,
so that its limits can be set before it is added. The arms:

- ``program``: the port as it ships;
- ``tf32``: the control: the same program with TF32 switched on for its
  float32 matmuls and convolutions, the whole run (the package pins both
  off: float32 is the precision TF32 lies below). The harness sets it
  after importing the port, and the run fails unless the detail record
  shows it in effect;
- ``tf32_frame``, ``tf32_track``, ``tf32_mapping``, ``tf32_ba``: TF32 on
  inside one stage of the program alone (``tf32_in``): the frame build
  (``frontend.frame.build_mono``, ``build_stereo``), the tracking step
  (``Tracking.track``), the mapper's stages but its local BA
  (``LocalMapping.step``), the local BA's solve
  (``LocalMapping._solve_local_ba``). The run fails unless the detail
  record shows TF32 off outside the stage, before the window and after the
  drain, and the stage was entered with it on;
- ``state_unchanged``, ``answer_altered``, ``ba_rounded``: the faults of
  ``faults.py``.

One JSON line a run: the arm, the seed, the precision in effect, the
window's frames, wall seconds and what ended it, the readings, the first
window frame that the program lost, the final map against its capacities
(``map_capacity``), whether each is within its limit, the re-solved BA
window, the seconds after the window, the local BAs applied and the dense-Schur LM
iterations whose Cholesky failed over the run (the port's
``ba.failed_factorizations``, warm-up included: 15 LM iterations a BA),
and diagnostics beside them that decide nothing (``diagnostics``). ``--trace`` runs the harness's profiler sessions too
and adds their matrix-product kernels by name (``trace.gemms``): the TF32
kernels among them show where TF32 ran. With ``--out`` each run's detail
record (poses, map) goes to that directory too.
"""

import argparse
import contextlib
import functools
import importlib
import json
import math
import os
import sys

for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from slambench import faults, harness, reference  # noqa: E402

# The stages that TF32 can be switched on in alone: the functions that
# run each, as (module, class or None, function).
STAGES = {
    "frame": [("c_orb_slam_tpu_torch.frontend.frame", None, "build_mono"),
              ("c_orb_slam_tpu_torch.frontend.frame", None, "build_stereo")],
    "track": [("c_orb_slam_tpu_torch.tracking", "Tracking", "track")],
    "mapping": [("c_orb_slam_tpu_torch.mapping", "LocalMapping", "step")],
    "ba": [("c_orb_slam_tpu_torch.mapping", "LocalMapping", "_solve_local_ba")],
}
STAGE_ARMS = {"tf32_" + name: name for name in STAGES}
ARMS = ("program", "tf32", *STAGE_ARMS, *faults.FAULTS)


@contextlib.contextmanager
def tf32_in(stage: str):
    """Every function of ``STAGES`` wrapped, inside the context, to run
    with TF32 on for matmuls and convolutions where it is `stage`'s and
    off where it is another's, each restoring the flags it found on its
    return: so TF32 is on inside `stage` alone, also where one stage calls
    another (the mapper's step calls its local BA). Yields a dict whose
    ``entered`` counts the calls that ran with TF32 on."""
    import torch

    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    seen = {"entered": 0}

    def wrap(fn, on: bool):
        @functools.wraps(fn)
        def with_flags(*args, **kwargs):
            before = [f.allow_tf32 for f in flags]
            for f in flags:
                f.allow_tf32 = on
            seen["entered"] += on
            try:
                return fn(*args, **kwargs)
            finally:
                for f, b in zip(flags, before):
                    f.allow_tf32 = b
        return with_flags

    patched = []
    for name, targets in STAGES.items():
        for module, cls, attr in targets:
            owner = importlib.import_module(module)
            owner = getattr(owner, cls) if cls else owner
            patched.append((owner, attr, getattr(owner, attr)))
            setattr(owner, attr, wrap(patched[-1][2], name == stage))
    try:
        yield seen
    finally:
        for owner, attr, original in reversed(patched):
            setattr(owner, attr, original)


@contextlib.contextmanager
def arm_context(arm: str):
    """The context that a run of `arm` runs in; yields ``tf32_in``'s
    count, or an empty dict."""
    if arm in STAGE_ARMS:
        with tf32_in(STAGE_ARMS[arm]) as seen:
            yield seen
    elif arm in faults.FAULTS:
        with faults.planted(arm):
            yield {}
    else:
        yield {}


def check_precision(arm: str, detail: dict, seen: dict):
    """Raise unless the run's record shows TF32 where `arm` puts it: on
    throughout for ``tf32``, else off before the window and after the
    drain; a stage arm's stage entered with it on."""
    whole = arm == "tf32"
    for key in ("precision", "precision_after"):
        p = detail[key]
        if p["matmul_tf32"] != whole or p["cudnn_tf32"] != whole:
            raise SystemExit(f"{arm} ran with {key} {p}")
    if arm in STAGE_ARMS and not seen.get("entered"):
        raise SystemExit(f"{arm}: the stage never ran with TF32 on")


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
    ap.add_argument("--arm", action="append", choices=sorted(ARMS),
                    help="program (the default); tf32, the control, the whole run; tf32_frame, "
                         "tf32_track, tf32_mapping, tf32_ba, TF32 in one stage alone; "
                         "state_unchanged, answer_altered, ba_rounded, the faults (repeatable)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", action="store_true",
                    help="run the profiler sessions and record their matrix-product kernels")
    ap.add_argument("--to-supply-end", action="store_true",
                    help="run each window to the supply's last frame, whatever its clock reads")
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
            from c_orb_slam_tpu_torch.optim import ba

            ba.reset_failed_factorizations()
            try:
                with arm_context(arm) as seen:
                    out = harness.run(spec, seed, args.seconds, args.trace,
                                      device=args.device, tf32=arm == "tf32",
                                      to_supply_end=args.to_supply_end)
            except RuntimeError as e:  # a control that crashes has failed
                print(json.dumps(dict(arm=arm, seed=seed, error=str(e)[:500])), flush=True)
                continue
            d = out["detail"]
            check_precision(arm, d, seen)
            n = harness.frame_budget(spec["mix"], rate, args.seconds, args.trace)
            world = spec["gen"].generate(seed, spec["mix"], n, rate)
            values = d["readings"]
            rec = dict(arm=arm, seed=seed, correct=out["result"]["correct"],
                       precision=d["precision"], tf32_entered=seen.get("entered"),
                       readings={k: (values[k] if math.isfinite(values[k]) else None)
                                 for k in reference.NUMBERS},
                       within={c[0]: c[3] for c in out["checks"]},
                       ba_window=values["ba_window"], after_window_s=d["after_window_s"],
                       diagnostics=diagnostics(d, world, rigid, out["final_map"],
                                               spec["config"]["settings"]),
                       frames=d["window_frames"], window_s=d["window_s"],
                       window_end=d["window_end"],
                       first_lost=next((j for j, t in zip(d["judged"], d["tracked"]) if not t),
                                       None),
                       keyframes=d["keyframes"], map_points=d["map_points"],
                       map_capacity=d["map_capacity"], local_ba=d["local_ba"],
                       resets=d["resets"], fps=d["e2e"]["fps"],
                       p90_ms=d["e2e"]["pose_latency_ms_p90"], stage_ms=d["stage_ms"],
                       local_ba_applied=d["local_ba_applied"],
                       lm_failed=ba.failed_factorizations(args.device), gemms=d["trace_gemms"])
            print(json.dumps(rec), flush=True)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                with open(os.path.join(args.out, f"{name}.{arm}.{seed}.json"), "w") as f:
                    json.dump(d, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
