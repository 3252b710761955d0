"""Import hygiene: the port imports nothing of JAX or of the JAX package.

In a child interpreter where ``import jax`` and ``import c_orb_slam_tpu``
fail (their ``sys.modules`` entries are None), every module under
c_orb_slam_tpu_torch/ (parallel/ and tools/ among them) and chip_smoke.py
must import.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "c_orb_slam_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
sys.path.insert(0, sys.argv[1])
import c_orb_slam_tpu_torch
names = ["c_orb_slam_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(c_orb_slam_tpu_torch.__path__, "c_orb_slam_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "c_orb_slam_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names), "modules;", " ".join(n for n in names if ".parallel." in n or ".tools." in n))
"""


def test_port_imports_without_jax():
    r = subprocess.run([sys.executable, "-c", CHILD, REPO], capture_output=True, text=True,
                       timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    for mod in ("parallel.mesh", "parallel.multihost", "parallel.dba", "parallel.sharded_ba",
                "parallel.dpose_graph", "tools.weak_scaling", "tools.train_vocab",
                "tools.convert_orbvoc", "tools.bench", "tools.bench_ab",
                "tools.profile_stages", "tools.profile_kernels"):
        assert f"c_orb_slam_tpu_torch.{mod}" in r.stdout, (mod, r.stdout)
