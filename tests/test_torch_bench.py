"""The port's benchmark (c_orb_slam_tpu_torch/tools/bench.py and
bench_ab.py) against bench.py.

- Its CONFIGS equal bench.py's, entry for entry.
- Parity on the CPU: stereo_kitti cut in length only (20 frames, 5 of
  them warm-up; widths, features and levels unchanged, loop closing on in
  both, as bench.py runs it) through bench.py's _run_config (JAX) and the
  port's run_config. Both pass their gates and track all 20 frames, their
  ATEs differ by at most 5 mm (both read under 2 mm; the gate is 50 mm),
  and the port's record has every key of bench.py's.
- The gate zeroes the score: a run with a gate of 1e-9 m gives
  vs_baseline 0.0 and an error.
- ``--device cuda`` without a card exits nonzero.
- bench_ab over two commands that print fixed records gives their median
  paired ratio.
"""

import json
import os
import shlex
import subprocess
import sys
import threading

import pytest
import torch

import bench
from c_orb_slam_tpu.config import Sensor as JaxSensor
from c_orb_slam_tpu_torch.tools import bench as tbench
from c_orb_slam_tpu_torch.tools import bench_ab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHORT = dict(n_frames=20, warmup=5)


@pytest.fixture
def two_threads():
    """Two intra-op threads for a run at KITTI width, restored after it: the
    test processes run side by side (the slice tests pin one), and one
    thread builds a 1241x376 stereo frame in about 5 s on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_configs_equal_bench_py():
    assert tbench.CONFIGS == bench.CONFIGS
    assert tbench.ALL == ("mono_fast10", "stereo_kitti", "stereo_kitti_long", "mono_tum30")


def test_short_stereo_kitti_matches_bench_py(two_threads):
    c = dict(bench.CONFIGS["stereo_kitti"], **SHORT)
    ref = {}

    def jax_run():
        try:
            ref["rec"] = bench._run_config("stereo_kitti", **dict(c, sensor=JaxSensor.STEREO))
        except BaseException as e:  # re-raised in the test's thread
            ref["error"] = e

    th = threading.Thread(target=jax_run)
    th.start()
    got = tbench.run_named("stereo_kitti", torch.device("cpu"), **SHORT)
    th.join()
    if "error" in ref:
        raise ref["error"]
    want = ref["rec"]
    for name, rec in (("jax", want), ("torch", got)):
        assert "error" not in rec and rec["vs_baseline"] > 0, (name, rec)
        assert rec["n_tracked"] == SHORT["n_frames"], (name, rec)
    # Both read under 2 mm here: 5 mm holds the port to the reference's
    # accuracy, where half the gate (25 mm) would pass a port ten times
    # less accurate.
    assert abs(got["ate_m"] - want["ate_m"]) <= 0.005, (got["ate_m"], want["ate_m"])
    assert set(want) <= set(got), sorted(set(want) - set(got))
    assert got["metric"] == want["metric"] and got["ate_gate_m"] == want["ate_gate_m"]
    assert got["loop_closing"] and got["loops_closed"] == 0
    assert got["timed_frames"] == 15 and got["local_ba_solves"] >= 1
    assert 0 <= got["dense_schur_lm_iters_failed"] <= got["dense_schur_lm_iters"]
    assert got["dense_schur_lm_iters"] > 0
    assert set(got["stage_ms_per_frame"]) >= {"frame_build", "tracking", "mapping_stage",
                                              "loop_stage"}
    assert got["device"] == "cpu" and got["power_limit_w"] is None


def test_gate_zeroes_the_score(two_threads):
    # Four frames: the gate, not the length, is under test.
    rec = tbench.run_named("stereo_kitti", torch.device("cpu"), n_frames=4, warmup=1,
                           ate_gate=1e-9)
    assert rec["vs_baseline"] == 0.0
    assert rec["error"].startswith("ATE ") and rec["error"].endswith("> gate 1e-09"), rec
    assert rec["value"] > 0 and rec["n_tracked"] == 4


def test_cuda_without_a_card_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "c_orb_slam_tpu_torch.tools.bench",
                        "--config", "mono_fast10", "--device", "cuda"],
                       capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and not r.stdout.strip()


@pytest.mark.parametrize("argv, names, metric", [
    (["--config", "mono_fast10", "--repeat", "2"], ["mono_fast10"] * 2,
     "tracked_frames_per_sec_1chip_mono_fast10"),
    (["--repeat", "2"], ["mono_tum30"] * 2, "tracked_frames_per_sec_1chip"),
    (["--all"], list(tbench.ALL), None),
])
def test_cli_prints_a_line_a_run(argv, names, metric, monkeypatch, capsys):
    ran = []

    def fake(name, device):
        ran.append(name)
        return {"metric": f"tracked_frames_per_sec_1chip_{name}"}

    monkeypatch.setattr(tbench, "run_named", fake)
    tbench.main(argv + ["--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert ran == names and len(lines) == len(names)
    if metric is not None:
        assert all(rec["metric"] == metric for rec in lines)
    else:  # --all: the headline keeps bench.py's name, the others their own
        assert lines[-1]["metric"] == "tracked_frames_per_sec_1chip"
        assert lines[0]["metric"] == "tracked_frames_per_sec_1chip_mono_fast10"


def test_cli_max_frames_cuts_only_longer_configurations(monkeypatch, capsys):
    ran = []

    def fake(name, device, **cut):
        ran.append((name, cut))
        return {"metric": f"tracked_frames_per_sec_1chip_{name}"}

    monkeypatch.setattr(tbench, "run_named", fake)
    tbench.main(["--all", "--max-frames", "120", "--device", "cpu"])
    assert ran == [("mono_fast10", {}), ("stereo_kitti", {}),
                   ("stereo_kitti_long", {"n_frames": 120}), ("mono_tum30", {})]
    assert len(capsys.readouterr().out.strip().splitlines()) == 4
    with pytest.raises(ValueError, match="no timed frame"):
        tbench.max_frames_cut("stereo_kitti_long", 15)


def _printer(value, ate):
    """A command that prints a log line, an empty record and then a fixed
    bench record."""
    rec = json.dumps({"value": value, "ate_m": ate, "ms_per_frame": 1000.0 / value})
    code = f"print('log line'); print('{{}}'); print({rec!r})"
    return f"{shlex.quote(sys.executable)} -c {shlex.quote(code)}"


@pytest.mark.parametrize("rounds", [1, 3])
def test_bench_ab_median_paired_ratio(rounds, capsys):
    out = bench_ab.compare(_printer(4.0, 0.01), _printer(2.0, 0.02), rounds)
    assert out["median_paired_ratio_a_over_b"] == 2.0
    assert out["paired_ratios"] == [2.0] * rounds
    assert out["a_fps_all"] == [4.0] * rounds and out["b_fps_all"] == [2.0] * rounds
    assert out["a_ate_m_all"] == [0.01] * rounds and out["b_ms_per_frame_all"] == [500.0] * rounds
    assert out["a_dense_schur_lm_iters_failed_all"] == [None] * rounds
    assert len(capsys.readouterr().out.strip().splitlines()) == rounds


def test_bench_ab_main_prints_the_summary_last(capsys):
    bench_ab.main(["--cmd", _printer(3.0, 0.01), "--cmd-b", _printer(2.0, 0.01),
                   "--rounds", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    assert summary["median_paired_ratio_a_over_b"] == 1.5 and summary["rounds"] == 2
    assert summary["label_b"] == "B(cmd)"


def test_bench_ab_fails_without_a_record():
    with pytest.raises(RuntimeError, match="no bench record"):
        bench_ab.run_cmd(f"{sys.executable} -c 'print(1)'", REPO)
