"""Times the solvers of chip_smoke.py's phase 10a, of one checkout, on the
card: each solver's single-device solve and its solve on a mesh of
chip_smoke.SHARDS shards of the one card, at phase 10a's sizes (the local
BA at its full bucket through dba, the map-sharded global BA, the
essential graph).

    python3 tests/torch_solver_times.py [--repo PATH] [--repeats 3]

--repo points the imports (chip_smoke.py and the package) at another
checkout, e.g. a parent commit unpacked with ``git archive``, so that two
versions can be timed in one call on one card. Each time is the median of
--repeats CUDA-event timed calls after one untimed call. Prints one JSON
line a solver, with the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

ap = argparse.ArgumentParser()
ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ap.add_argument("--repeats", type=int, default=3)
args = ap.parse_args()
repo = os.path.abspath(args.repo)
sys.path.insert(0, repo)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from c_orb_slam_tpu_torch.parallel.mesh import Mesh  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("torch_solver_times: no CUDA device")
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip().splitlines()[0]
mesh = Mesh([dev] * chip_smoke.SHARDS)
for name, what, single, sharded, *_ in chip_smoke._phase10_solvers(dev):
    single()
    sharded(mesh)
    print(json.dumps(dict(
        repo=repo, solver=name, what=what, shards=chip_smoke.SHARDS, repeats=args.repeats,
        single_ms=chip_smoke._event_ms(single, args.repeats),
        sharded_ms=chip_smoke._event_ms(lambda: sharded(mesh), args.repeats),
        card=card)), flush=True)
