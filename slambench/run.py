"""Run one cell of the benchmark of c_orb_slam_tpu_torch once, on the cards
of this machine, and print its result as the last line of standard output.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer ones. The numbers that decide ``correct``
are printed beside their limits as the last lines of standard error and
under ``checks``, the line's last key. A detail file (per-frame hand-in
and resolution times, stage totals, the card) goes to
``$TMPDIR/slambench/``. There is no CPU fallback: a machine without the
cards the cell asks for ends the run with an error and no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# One host thread for the numeric libraries: the port's host work is one
# thread, and pools of helpers only add noise to the window's clock.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from slambench import harness  # noqa: E402


def finite(x):
    """x with every non-finite float as null: the line stays plain JSON."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = harness.load_spec(args.workload)["cell"]["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"slambench: {args.workload} needs {chips} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2
    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"slambench: the run loaded {', '.join(bad)}: the port must not use JAX "
              f"or the JAX package", file=sys.stderr)
        return 3
    path = harness.write_detail(out["detail"])
    print(f"slambench: detail in {path}", file=sys.stderr)
    for name, value, limit, within in out["checks"]:
        print(f"check {name} {value!r} limit {limit!r} {'ok' if within else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(out["result"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
