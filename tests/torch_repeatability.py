"""Does one benchmark configuration repeat itself? Two arms, alternated.

Runs ``tools/bench.py``'s configuration ``--repeat N`` times in a child
process per arm, arm A then arm B, ``--rounds`` times, as
``tools/bench_ab.py`` alternates its arms:

- arm A: the configuration as the package runs it;
- arm B: the same under ``torch.use_deterministic_algorithms(True,
  warn_only=True)`` with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``.

It lives outside the package because arm B sets a process-wide switch that
the package leaves to its caller. In both arms the child patches the package
from outside, without a change to it, to count two things of its schedule:

- ``apply_lag``: a histogram of the ``track()`` calls between the dispatch of
  an in-flight frame and its apply (``Tracking._apply_oldest``);
- ``detect_defers``: the ``LoopClosing.step`` calls that left a pending
  detection in place while no Sim3 or correction job held it.

Each run prints one JSON line: bench.py's record (``ate_m``, ``value``, ...)
plus ``arm``, the two counts, ``traj_sha`` (SHA-256 of the run's stamps and
poses as float32 bytes) and, in arm B, the warnings of operations with no
deterministic implementation. The last line sums up each arm: its ATEs, its
distinct trajectory hashes and its counts.

    python3 tests/torch_repeatability.py [--config mono_tum30] [--repeat 10] [--rounds 1] [--arms AB] [--device cuda]

``--arms A`` runs arm A alone: the check that the package repeats itself
with no process-wide switch.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _instrument(counts: dict):
    """Patch Tracking and LoopClosing (not their source) to count the apply
    lag and the detection defers into `counts`; and System.frame_poses to
    keep the run's trajectory."""
    from c_orb_slam_tpu_torch import loop_closing, system, tracking
    from c_orb_slam_tpu_torch.io import trajectory

    T = tracking.Tracking
    track, dispatch, apply_oldest = T.track, T._fused_dispatch, T._apply_oldest

    def track_(self, f):
        self._rep_calls = getattr(self, "_rep_calls", 0) + 1
        return track(self, f)

    def dispatch_(self, f):
        out = dispatch(self, f)
        if out is not None:
            self._rep_at = getattr(self, "_rep_at", {})
            self._rep_at[id(f)] = self._rep_calls
        return out

    def apply_oldest_(self):
        if self._pending:
            at = getattr(self, "_rep_at", {}).pop(id(self._pending[0][0]), None)
            if at is not None:
                counts["apply_lag"][self._rep_calls - at] += 1
        return apply_oldest(self)

    T.track, T._fused_dispatch, T._apply_oldest = track_, dispatch_, apply_oldest_

    L = loop_closing.LoopClosing
    step = L.step

    def step_(self, force=False):
        pd = self._pending_detect
        held = self.sim3_job is not None or self.correction_job is not None
        out = step(self, force)
        if pd is not None and not force and not held and self._pending_detect is pd:
            counts["detect_defers"] += 1
        return out

    L.step = step_

    S = system.System
    frame_poses = S.frame_poses

    def frame_poses_(self):
        out = frame_poses(self)
        counts["traj_sha"] = trajectory.sha256(*out)
        return out

    S.frame_poses = frame_poses_


def child(args):
    import torch

    from c_orb_slam_tpu_torch.tools import bench

    caught = []
    if args.child == "B":
        torch.use_deterministic_algorithms(True, warn_only=True)
        warnings.simplefilter("always")
        warnings.showwarning = lambda m, *a, **k: caught.append(str(m).split("\n")[0])
    device = torch.device(args.device)
    for _ in range(args.repeat):
        counts = {"apply_lag": collections.Counter(), "detect_defers": 0}
        _instrument(counts)
        caught.clear()
        rec = bench.run_named(args.config, device)
        rec.update(arm=args.child, apply_lag=dict(sorted(counts["apply_lag"].items())),
                   detect_defers=counts["detect_defers"], traj_sha=counts.get("traj_sha"))
        if args.child == "B":
            rec["nondeterministic_ops"] = sorted(set(caught))
        print(json.dumps(rec), flush=True)
        _restore()


_SAVED = {}


def _save():
    from c_orb_slam_tpu_torch import loop_closing, system, tracking

    T, L, S = tracking.Tracking, loop_closing.LoopClosing, system.System
    _SAVED.update({(T, n): getattr(T, n) for n in ("track", "_fused_dispatch", "_apply_oldest")})
    _SAVED[(L, "step")] = L.step
    _SAVED[(S, "frame_poses")] = S.frame_poses


def _restore():
    for (cls, name), fn in _SAVED.items():
        setattr(cls, name, fn)


def run_arm(arm: str, args) -> list:
    env = dict(os.environ)
    if arm == "B":
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    cmd = [sys.executable, os.path.abspath(__file__), "--child", arm,
           "--config", args.config, "--repeat", str(args.repeat), "--device", args.device]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=3600)
    recs = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    for r in recs:
        print(json.dumps(r), flush=True)
    if proc.returncode != 0 or len(recs) != args.repeat:
        sys.stderr.write(proc.stderr[-3000:])
        raise RuntimeError(f"arm {arm}: exit {proc.returncode}, {len(recs)} records")
    return recs


def summary(recs: list) -> dict:
    lag = collections.Counter()
    for r in recs:
        lag.update({int(k): v for k, v in r["apply_lag"].items()})
    return {
        "runs": len(recs),
        "ate_m": [r.get("ate_m") for r in recs],
        "distinct_traj_sha": len({r["traj_sha"] for r in recs}),
        "apply_lag": dict(sorted(lag.items())),
        "detect_defers": sum(r["detect_defers"] for r in recs),
        "fps": [r["value"] for r in recs],
        "errors": [r["error"] for r in recs if "error" in r],
        "nondeterministic_ops": sorted({o for r in recs for o in r.get("nondeterministic_ops", [])}),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="mono_tum30")
    ap.add_argument("--repeat", type=int, default=10, help="runs of an arm in one process")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--arms", default="AB", choices=("AB", "A", "B"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", choices=("A", "B"), default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _save()
        child(args)
        return
    arms = {arm: [] for arm in args.arms}
    for _ in range(args.rounds):
        for arm in args.arms:
            arms[arm] += run_arm(arm, args)
    print(json.dumps({arm: summary(recs) for arm, recs in arms.items()}), flush=True)


if __name__ == "__main__":
    main()
