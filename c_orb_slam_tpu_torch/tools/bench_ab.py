"""Paired A/B benchmark: alternate two bench commands and report the median
of the per-round ratios.

Counterpart of tools/bench_ab.py. The port's ms/frame on one card spreads
up to 1.9x between runs, following the load of the shared host, so two
single runs, one before and one after a change, cannot tell the change
from the host. This harness runs arm A, then arm B, ``--rounds`` times, so
that the two runs of a round see the same host, and reports each round's
ratio A/B of ``value`` (tracked frames a second) and their median. With the
same command in both arms the ratios measure the noise a claimed gain has
to exceed.

Usage:
  # The working tree against a git ref (arm B runs from a detached worktree):
  python3 -m c_orb_slam_tpu_torch.tools.bench_ab --ref-b HEAD~1 \\
      --cmd "python3 -m c_orb_slam_tpu_torch.tools.bench --config stereo_kitti" --rounds 3

  # Two commands on the same tree (an environment or flag toggle), or one
  # command in both arms (the noise):
  python3 -m c_orb_slam_tpu_torch.tools.bench_ab \\
      --cmd "python3 -m c_orb_slam_tpu_torch.tools.bench --config mono_tum30"

Each command prints a bench record (c_orb_slam_tpu_torch/tools/bench.py)
as its last JSON line, with ``value``; ``ate_m``, ``ms_per_frame`` and
``dense_schur_lm_iters_failed`` are carried beside it, so that a shift in
quality or in the local BA's numerics shows next to the speed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CARRIED = ("ate_m", "ms_per_frame", "dense_schur_lm_iters_failed")


def run_cmd(cmd: str, cwd: str) -> dict:
    """Run one bench command; parse the last JSON line of its stdout."""
    proc = subprocess.run(cmd, shell=True, cwd=cwd, capture_output=True, text=True,
                          timeout=3600)
    rec = None
    for line in proc.stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                pass
    if proc.returncode != 0 or rec is None or "value" not in rec:
        sys.stderr.write(proc.stdout[-2000:] + "\n" + proc.stderr[-2000:])
        raise RuntimeError(f"no bench record from: {cmd} (cwd {cwd}, exit {proc.returncode})")
    return rec


def make_worktree(ref: str) -> str:
    path = tempfile.mkdtemp(prefix="bench_ab_")
    os.rmdir(path)  # git worktree add creates it
    subprocess.run(["git", "worktree", "add", "--detach", path, ref],
                   cwd=REPO, check=True, capture_output=True)
    return path


def drop_worktree(path: str):
    subprocess.run(["git", "worktree", "remove", "--force", path], cwd=REPO,
                   capture_output=True)


def compare(cmd_a: str, cmd_b: str, rounds: int, cwd_a: str = REPO, cwd_b: str = REPO,
            labels=("A", "B")) -> dict:
    """Run A, B `rounds` times, printing one JSON line a round; return the
    summary: the median paired ratio A/B of "value", every round's ratio,
    and each arm's values and carried fields."""
    rounds_out = []
    for r in range(rounds):
        a = run_cmd(cmd_a, cwd_a)
        b = run_cmd(cmd_b, cwd_b)
        ratio = a["value"] / b["value"] if b["value"] else float("inf")
        row = {"round": r, "a_fps": a["value"], "b_fps": b["value"],
               "a_over_b": round(ratio, 4)}
        for key in CARRIED:
            row[f"a_{key}"], row[f"b_{key}"] = a.get(key), b.get(key)
        rounds_out.append(row)
        print(json.dumps(row), flush=True)
    ratios = [row["a_over_b"] for row in rounds_out]
    summary = {
        "label_a": labels[0], "label_b": labels[1], "cmd": cmd_a, "cmd_b": cmd_b,
        "rounds": rounds, "median_paired_ratio_a_over_b": round(statistics.median(ratios), 4),
        "paired_ratios": ratios,
        "a_fps_all": [row["a_fps"] for row in rounds_out],
        "b_fps_all": [row["b_fps"] for row in rounds_out],
    }
    for key in CARRIED:
        for arm in "ab":
            summary[f"{arm}_{key}_all"] = [row[f"{arm}_{key}"] for row in rounds_out]
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cmd", required=True, help="bench command of arm A (the working tree)")
    ap.add_argument("--cmd-b", default=None, help="bench command of arm B (default: --cmd)")
    ap.add_argument("--ref-b", default=None,
                    help="git ref for arm B; it runs from a detached worktree")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--label-a", default="A(worktree)")
    ap.add_argument("--label-b", default=None)
    args = ap.parse_args(argv)

    cmd_b = args.cmd_b or args.cmd
    label_b = args.label_b or (f"B({args.ref_b})" if args.ref_b else "B(cmd)")
    wt = make_worktree(args.ref_b) if args.ref_b else None
    try:
        summary = compare(args.cmd, cmd_b, args.rounds, REPO, wt or REPO,
                          (args.label_a, label_b))
    finally:
        if wt:
            drop_worktree(wt)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
