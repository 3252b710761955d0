"""The command end to end on a card: each cell, a short window, both modes;
and the control, which has to come out not correct. Marked `cuda`; they
skip, with their reason, where torch sees no card."""

import json
import os
import subprocess
import sys

import pytest

from slambench import harness

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CELLS = [w["name"] for w in harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))["workloads"]]
# The control's seed of each cell, one of those its limits were set from.
CONTROL_SEEDS = {"kitti_stereo.survey": 7000000101}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs only on a card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell, trace):
    out = subprocess.run([sys.executable, "slambench/run.py", "--workload", cell,
                          "--seed", str(2**31 + 77 + trace), "--seconds", "4",
                          "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    spec = harness.load_spec(cell)
    want = spec["per_layer"] if trace else spec["end_to_end"]
    assert set(line["metrics"]) == {m["name"] for m in want}
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"] and line["breakdown"]["idle_gaps"]


@pytest.mark.cuda
@pytest.mark.parametrize("to_supply_end", [False, True])
@pytest.mark.parametrize("cell", sorted(CONTROL_SEEDS))
def test_control_is_not_correct(card, cell, to_supply_end):
    """The control (the program with TF32 on, in effect as the run's
    record shows) at the cell's own size and window comes out not
    correct: the window its clock ends, and the whole supply's, which a
    program that outruns the sensor hands in."""
    seconds = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))["run_seconds"]
    out = subprocess.run([sys.executable, "slambench/readings.py", "--workload", cell,
                          "--seconds", str(seconds), "--seeds", str(CONTROL_SEEDS[cell]),
                          "--arm", "tf32"] + (["--to-supply-end"] if to_supply_end else []),
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["arm"] == "tf32" and rec["precision"]["matmul_tf32"], rec
    assert rec["window_end"] == "supply" or not to_supply_end, rec
    assert rec["correct"] is False, rec
