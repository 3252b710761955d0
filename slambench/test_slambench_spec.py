"""The harness finds a configuration, a mix and a metric reader by their
names in BENCHMARK.json, so adding one takes new files and new entries and
no edit; and the runs load nothing of JAX or the JAX package."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from slambench import harness

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def test_cells_resolve():
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for w in bench["workloads"]:
        spec = harness.load_spec(w["name"])
        assert spec["config"]["correct"] and spec["mix"]["generator"]
        assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s", "fps"}
        assert set(spec["readers"]) == {m["name"] for m in spec["per_layer"]}
        assert all(callable(r.read) for r in spec["readers"].values())


def test_throwaway_entries_need_only_new_files(tmp_path):
    shutil.copytree(HERE, tmp_path / "slambench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    sb = tmp_path / "slambench"
    cfg = json.loads((sb / "configs" / "tum_mono.json").read_text())
    cfg["settings"]["Camera.fps"] = 20.0
    (sb / "configs" / "throwaway.json").write_text(json.dumps(cfg))
    mix = json.loads((sb / "traffic" / "explore.json").read_text())
    mix["generator"] = "throwaway_gen"
    (sb / "traffic" / "throwaway_mix.json").write_text(json.dumps(mix))
    (sb / "traffic" / "throwaway_gen.py").write_text(
        (sb / "traffic" / "corridor.py").read_text())
    (sb / "layers" / "throwaway_metric.py").write_text("def read(ctx):\n    return 7.0\n")
    bench["configs"].append(dict(name="throwaway", source="https://example.org/throwaway",
                                 file="slambench/configs/throwaway.json", reduced=[], why="x"))
    bench["workloads"].append(dict(name="throwaway.cell", config="throwaway",
                                   traffic="throwaway_mix", chips=1, why="x"))
    bench["per_layer"].append(dict(name="throwaway_metric", unit="ms", better="lower",
                                   source="program_span", layer="tracking", moves="fps",
                                   workloads=["throwaway.cell"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = harness.load_spec("throwaway.cell", root=str(tmp_path))
    assert spec["config"]["settings"]["Camera.fps"] == 20.0
    assert spec["gen"].__name__ == "slambench_traffic_throwaway_gen"
    assert spec["readers"]["throwaway_metric"].read({}) == 7.0
    # The cells that were there resolve as before, without the new metric.
    old = harness.load_spec("kitti_stereo.survey", root=str(tmp_path))
    assert "throwaway_metric" not in old["readers"]
    assert old["config"] == harness.load_spec("kitti_stereo.survey")["config"]


def test_held_cell_needs_no_entry(tmp_path):
    """A configuration and a mix that BENCHMARK.json does not list build a
    one-chip spec with no metric readers, in a checkout without
    BENCHMARK.json at all."""
    shutil.copytree(HERE, tmp_path / "slambench", ignore=shutil.ignore_patterns("__pycache__"))
    assert not (tmp_path / "BENCHMARK.json").exists()
    spec = harness.held_spec("tum_mono", "explore", root=str(tmp_path))
    assert spec["cell"] == dict(name="tum_mono.explore", config="tum_mono", traffic="explore",
                                chips=1)
    assert spec["config"] == harness.load_json(os.path.join(HERE, "configs", "tum_mono.json"))
    assert spec["config"]["sensor"] == "MONOCULAR" and spec["mix"]["generator"] == "corridor"
    assert callable(spec["gen"].generate)
    assert spec["readers"] == {} and spec["end_to_end"] == [] and spec["per_layer"] == []
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    assert "tum_mono.explore" not in {w["name"] for w in bench["workloads"]}
    with pytest.raises(SystemExit, match="no workload"):
        harness.load_spec("tum_mono.explore")
    # The spec of a listed cell is its entry's, as load_spec gives it.
    listed = harness.load_spec("kitti_stereo.survey")
    held = harness.held_spec("kitti_stereo", "survey")
    assert listed["config"] == held["config"] and listed["mix"] == held["mix"]


def test_readings_wants_a_whole_held_cell():
    from slambench import readings

    for argv in (["--config", "tum_mono"], ["--traffic", "explore"],
                 ["--workload", "kitti_stereo.survey", "--config", "tum_mono"]):
        with pytest.raises(SystemExit):
            readings.main(argv + ["--seconds", "1", "--seeds", "1"])


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax", True),
    ("c_orb_slam_tpu", True), ("c_orb_slam_tpu.ops.match", True),
    ("c_orb_slam_tpu_torch", False), ("c_orb_slam_tpu_torch.ops", False),
    ("jaxtyping", False), ("flaxen", False),
])
def test_forbidden_modules(monkeypatch, name, bad):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, name, object())
    assert (name.split(".")[0] in harness.forbidden_modules()) is bad
    monkeypatch.delitem(sys.modules, name)
    assert harness.forbidden_modules() == before


@pytest.mark.parametrize("path", ["reference.py", "render.py", "render_np.py", "trace.py",
                                  "traffic/corridor.py"])
def test_yardstick_imports_nothing_of_the_program(path):
    tree = ast.parse(open(os.path.join(HERE, path)).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "math", "numpy", "torch", "slambench"}, names


def test_no_card_no_result(tmp_path):
    """Without a card the command fails and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "slambench/run.py", "--workload", "kitti_stereo.survey",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
