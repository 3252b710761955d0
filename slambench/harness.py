"""One run of one cell of the benchmark of ``c_orb_slam_tpu_torch``.

``run`` makes the cell's world and camera path from the seed, renders the
frames on the device, builds ``System(cfg, device)`` with loop closing on
and the shipped vocabulary, calls ``System.warmup()`` and tracks the
mix's warm-up frames: that is set-up. Then it runs the window as a closed
loop, frames handed back to back through the sensor's entry point as an
offline run over a recorded sequence feeds them, each only while the
window is open at its hand-in. The window is open for `seconds`, or until
the supply's last window frame is handed in (``frame_budget``), whichever
comes first: a program that outruns the sensor's rate ends its window on
the supply and is read over the same frames as any other that does; the
detail record's ``window_end`` says which ended it. The window closes on
the call that resolves the last frame in flight
(``Tracking.flush_pending``) and a synchronize. The window runs with
Python's garbage collector paused and one host thread for torch's own CPU
ops: the port's host work is one thread, and both are noise to its
clock. With ``trace`` it then runs one second of sensor frames (a
keyframe period of ORB-SLAM2's rule), from the supply's frames kept for
it, inside one ``torch.profiler`` session (a new session, up to
``TRACE_SESSIONS``, when one records no CUDA kernel). Last, it runs the mapper's queue to its
end (``LocalMapping.drain``) and copies the final map, then runs the
program's local BA once more on the newest keyframe's window and copies
the map as that BA applies; then, with the program's state freed, the
plain reference (``reference.py``) judges every frame handed in after the
warm-up, the final map, and that BA's answer. The seconds of the drain
with that BA, and of the reference, both after the window, go to the
detail record.

What belongs to one configuration, one mix or one per-layer metric lives
in a file of its own, found by the name in ``BENCHMARK.json``:
``configs/<config>.json``, ``traffic/<mix>.json`` (naming its generator,
``traffic/<generator>.py``) and ``layers/<metric>.py``. A held cell, a
configuration and a mix that ``BENCHMARK.json`` does not list, is found
by those two names alone (``held_spec``), for ``readings.py``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "c_orb_slam_tpu")
TRACE_S = 1.0
TRACE_SESSIONS = 3


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_spec(workload: str, root: str = ROOT) -> dict:
    """The cell's entry, configuration, mix, generator and metric readers,
    found by name under the checkout `root`."""
    here = os.path.join(root, "slambench")
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    readers = {m["name"]: load_module(os.path.join(here, "layers", m["name"] + ".py"),
                                      "slambench_layer_" + m["name"].replace(".", "_"))
               for m in bench["per_layer"] if applies(m, workload)}
    return dict(cell_spec(cell, os.path.join(root, configs[cell["config"]]["file"]), root),
                readers=readers,
                end_to_end=[m for m in bench["end_to_end"] if applies(m, workload)],
                per_layer=[m for m in bench["per_layer"] if applies(m, workload)])


def held_spec(config: str, traffic: str, root: str = ROOT) -> dict:
    """The spec of a configuration and a mix that ``BENCHMARK.json`` does
    not list (a held cell): ``configs/<config>.json`` under
    ``traffic/<traffic>.json`` on one chip, with no metric readers."""
    cell = dict(name=f"{config}.{traffic}", config=config, traffic=traffic, chips=1)
    return dict(cell_spec(cell, os.path.join(root, "slambench", "configs", config + ".json"), root),
                readers={}, end_to_end=[], per_layer=[])


def cell_spec(cell: dict, config_file: str, root: str) -> dict:
    """A cell's configuration, mix and generator."""
    here = os.path.join(root, "slambench")
    mix = load_json(os.path.join(here, "traffic", cell["traffic"] + ".json"))
    gen = load_module(os.path.join(here, "traffic", mix["generator"] + ".py"),
                      "slambench_traffic_" + mix["generator"])
    return dict(cell=cell, config=load_json(config_file), mix=mix, gen=gen)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def trace_frames(rate: float) -> int:
    """Frames of one profiler session: one second of the sensor's."""
    return math.ceil(TRACE_S * rate)


def frame_budget(mix: dict, rate: float, seconds: float, trace: bool) -> int:
    """Frames rendered: the warm-up ones, the sensor's frames of a window of
    `seconds`, and the profiler sessions' frames."""
    return (mix["warmup_frames"] + math.ceil(seconds * rate)
            + (trace_frames(rate) * TRACE_SESSIONS if trace else 0))


def p90(values) -> float:
    """Nearest-rank 90th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(0.9 * len(v)) - 1)]


def slam_config(config: dict):
    """The port's SlamConfig of a configuration file, through the port's own
    reader of ORB-SLAM2 settings files."""
    from c_orb_slam_tpu_torch.config import Sensor, load_yaml

    text = "%YAML:1.0\n" + "".join(f"{k}: {v}\n" for k, v in config["settings"].items())
    fd, path = tempfile.mkstemp(suffix=".yaml")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        return load_yaml(path, getattr(Sensor, config["sensor"]))
    finally:
        os.remove(path)


def card(device) -> dict:
    """The card's name, clocks and power limit, as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "-i", str(device.index or 0),
         "--query-gpu=name,clocks.sm,clocks.max.sm,power.limit,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return dict(nvidia_smi=out.stdout.strip(), returncode=out.returncode)


class Answers:
    """The poses the program has resolved, read from the tracker's
    per-frame log (``Tracking.trajectory``) after each call returns: the
    pose the call returned for the newest frame it resolved, the others'
    as the map held them then, each frame's tracked flag, and the time
    the caller had it."""

    def __init__(self, sysm, rate: float, ok_state: int):
        self.sysm, self.rate, self.ok = sysm, rate, ok_state
        self.tracker, self.cursor, self.resets = sysm.tracker, 0, 0
        self.by_frame: dict = {}

    def collect(self, now: float, returned=None):
        tr = self.sysm.tracker
        if tr is not self.tracker:  # System.reset() rebuilt the tracker
            self.tracker, self.cursor = tr, 0
            self.resets += 1
        log, kf_pose = tr.trajectory, self.sysm.map.kf_pose
        while self.cursor < len(log):
            _, T_cr, ref, state, stamp = log[self.cursor]
            self.cursor += 1
            pose = np.asarray(T_cr, np.float64)
            if self.cursor == len(log) and returned is not None:
                pose = np.asarray(returned, np.float64)
            elif ref >= 0:
                T_rw = np.asarray(kf_pose[ref], np.float64)
                pose = np.concatenate([pose[:, :3] @ T_rw[:, :3],
                                       (pose[:, :3] @ T_rw[:, 3] + pose[:, 3])[:, None]], 1)
            self.by_frame[int(round(stamp * self.rate))] = (pose, state == self.ok, now)


def map_arrays(m) -> dict:
    """Copies of the map's arrays that the reference reads: the live
    keyframes' in slot order, and every point slot's."""
    live = m.live_keyframes()
    return dict(kf_pose=m.kf_pose[live], kf_xy=m.kf_xy[live], kf_octave=m.kf_octave[live],
                kf_mp=m.kf_mp[live], kf_serial=m.kf_serial[live], kf_ur=m.kf_ur[live],
                pt_xyz=m.pt_xyz.copy(), pt_valid=m.pt_valid.copy())


def precision() -> dict:
    """The float32 precision in effect for matmuls and convolutions."""
    import torch

    return dict(matmul_tf32=bool(torch.backends.cuda.matmul.allow_tf32),
                cudnn_tf32=bool(torch.backends.cudnn.allow_tf32),
                float32_matmul_precision=torch.get_float32_matmul_precision())


def run(workload, seed: int, seconds: float, trace: bool, device=None,
        t_start: float | None = None, root: str = ROOT, tf32: bool = False,
        to_supply_end: bool = False) -> dict:
    """One run (see the module docstring) of the cell `workload`, a name
    in ``BENCHMARK.json`` or a spec (``held_spec``). Returns the result
    line's fields, the numbers compared, the detail record and the final
    map's arrays that the reference read (``reference.reprojection``,
    ``reference.local_ba``).

    `tf32` switches on the TF32 path that the port pins off (the control
    of ``readings.py``); it is set after the port is imported, which pins
    it, and the detail record keeps the precision in effect.
    `to_supply_end` keeps the window open until the supply's last window
    frame, whatever its clock reads (``readings.py --to-supply-end``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = workload if isinstance(workload, dict) else load_spec(workload, root)
    workload = spec["cell"]["name"]
    config, mix = spec["config"], spec["mix"]
    st = config["settings"]
    rate = float(st["Camera.fps"])
    stereo = config["sensor"] == "STEREO"
    n_trace = trace_frames(rate)
    n_total = frame_budget(mix, rate, seconds, trace)
    warm = mix["warmup_frames"]
    world = spec["gen"].generate(seed, mix, n_total, rate)

    import torch

    from slambench import reference, render, trace as tr

    device = torch.device("cuda", 0) if device in (None, "cuda") else torch.device(device)
    cuda = device.type == "cuda"
    import c_orb_slam_tpu_torch  # noqa: F401  (pins TF32 off, as every user of the port gets)
    from c_orb_slam_tpu_torch.system import System
    from c_orb_slam_tpu_torch.tracking import TrackState

    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    if cuda:
        torch.set_num_threads(1)

    K4 = (st["Camera.fx"], st["Camera.fy"], st["Camera.cx"], st["Camera.cy"])
    baseline = st["Camera.bf"] / st["Camera.fx"] if stereo else None
    images = render.render_sequence(world, world["poses"], K4, st["Camera.height"],
                                    st["Camera.width"], device, baseline)
    cfg = slam_config(config)
    sysm = System(cfg, device)
    sysm.warmup()
    in_effect = precision()

    if stereo:
        def track(i):
            return sysm.track_stereo(images[i, 0], images[i, 1], i / rate)
    else:
        def track(i):
            return sysm.track_monocular(images[i], i / rate)

    answers = Answers(sysm, rate, TrackState.OK)
    for i in range(warm):
        answers.collect(time.perf_counter(), track(i))
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    sysm.metrics.reset()
    sysm.tracker.stage_ms = {}
    ba0 = sysm.local_mapping.n_local_ba

    # The window.
    handed: dict = {}
    i, limit = warm, n_total - (n_trace * TRACE_SESSIONS if trace else 0)
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        now = t0
        while (to_supply_end or now - t0 < seconds) and i < limit:
            handed[i] = now
            pose = track(i)
            i += 1
            now = time.perf_counter()
            answers.collect(now, pose)
        window_end = "supply" if i >= limit and (to_supply_end or now - t0 < seconds) else "clock"
        sysm.tracker.flush_pending()
        if cuda:
            torch.cuda.synchronize(device)
        t_end = time.perf_counter()
    finally:
        gc.enable()
    answers.collect(t_end)
    window_s = t_end - t0
    window = sorted(handed)
    if window_end == "supply":
        print(f"slambench: the supply's last frame ended the window: {len(window)} frames in "
              f"{window_s:.3f} s ({len(window) / window_s:.4f} frames/s, the sensor's rate "
              f"{rate:g} Hz)", file=sys.stderr, flush=True)
    resolved = [j for j in window if j in answers.by_frame]
    latency_ms = [(answers.by_frame[j][2] - handed[j]) * 1e3 for j in resolved]
    ctx = dict(frames=len(window),
               stages={k: v[0] for k, v in sysm.metrics.stage_totals.items()},
               track_stage_ms=dict(sysm.tracker.stage_ms),
               local_ba=sysm.local_mapping.n_local_ba - ba0, trace=None)

    # The profiler sessions, after the window so its numbers are untraced.
    sessions = []
    judged = list(window)
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        for _ in range(TRACE_SESSIONS):
            first = judged[-1] + 1
            with profile(activities=acts) as prof:
                w0 = time.perf_counter()
                for j in range(first, first + n_trace):
                    pose = track(j)
                    answers.collect(time.perf_counter(), pose)
                sysm.tracker.flush_pending()
                if cuda:
                    torch.cuda.synchronize(device)
                w1 = time.perf_counter()
            answers.collect(w1)
            judged += list(range(first, first + n_trace))
            dev, host = tr.raw_events(prof)
            kernels = tr.kernels_of(dev)
            sessions.append(len(kernels))
            if kernels or not cuda:
                break
        if cuda and not kernels:
            raise RuntimeError(f"{TRACE_SESSIONS} profiler sessions recorded no CUDA kernel")
        span = (min(e[1] for e in dev + host), max(e[2] for e in dev + host)) if dev else None
        ctx["trace"] = dict(frames=n_trace, wall_s=w1 - w0, kernels=kernels,
                            launches=tr.launches(host),
                            busy_s=tr.union_us((s, e) for _, s, e in kernels) / 1e6,
                            sessions=sessions)
        breakdown = dict(device_ops=tr.top_ops(kernels),
                         idle_gaps=tr.idle_by_stage(kernels, host, span) if span else [])

    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    loops = sysm.loop_closing.n_loops_closed if sysm.loop_closing is not None else 0
    # After the window's clock has closed: the mapper's queue run to its
    # end, then the final map copied, then the program's local BA once
    # more on the newest keyframe's window and the map copied again as
    # that BA applies, for the reference to re-solve (``ba_map``). A
    # mapping pass culls keyframes right after its BA (the port's
    # LocalMapping._finish_keyframe, as ORB-SLAM2's), which moves the
    # window's optimum: the final map need hold no BA's answer.
    t_drain = time.perf_counter()
    mapper, m = sysm.local_mapping, sysm.map
    mapper.drain()
    map_xyz = np.asarray(m.pt_xyz[m.pt_valid], np.float64)
    final_map = map_arrays(m)
    live = m.live_keyframes()
    # The final map against its capacities: slots are used in order, then
    # culled ones reused (``MapState._allocate_kf_slot``).
    capacity = dict(keyframe_slots=int(m.n_keyframes), keyframes_added=int(m.n_added_keyframes),
                    max_keyframes=cfg.capacity.max_keyframes, point_slots=int(m.n_points),
                    points_added=int(m.n_added_points), max_points=cfg.capacity.max_points)
    ba_map = None
    if len(live) > 2 and not mapper.paused:
        mapper._ba_dispatch(int(live[np.argmax(m.kf_serial[live])]))
        while mapper._ba_apply() is not None:  # the CPU's apply defers once
            pass
        ba_map = map_arrays(m)
    if cuda:
        torch.cuda.synchronize(device)
    drain_s = time.perf_counter() - t_drain
    ba_applied = mapper.n_local_ba
    in_effect_after = precision()
    del sysm, track, mapper, m
    answers.sysm = answers.tracker = None
    if cuda:
        torch.cuda.empty_cache()

    # The reference, after the program's state is freed.
    t_ref = time.perf_counter()
    values = reference.readings(answers.by_frame, judged, world["poses"], loops, rigid=stereo,
                                settings=st, final_map=final_map, ba_map=ba_map)
    reference_s = time.perf_counter() - t_ref
    checks = reference.judge(values, config["correct"])
    e2e = dict(fps=len(resolved) / window_s,
               pose_latency_ms_p90=p90(latency_ms) if latency_ms else math.inf,
               setup_s=setup_s)
    units = {m_["name"]: m_["unit"] for m_ in spec["end_to_end"] + spec["per_layer"]}
    if trace:
        metrics = {}
        for m_ in spec["per_layer"]:
            v = spec["readers"][m_["name"]].read(ctx)
            if v is not None:
                metrics[m_["name"]] = {"value": v, "unit": units[m_["name"]]}
    else:
        metrics = {m_["name"]: {"value": e2e[m_["name"]], "unit": m_["unit"]}
                   for m_ in spec["end_to_end"]}
    device_rec = dict(platform="gpu" if cuda else device.type,
                      kind=torch.cuda.get_device_name(device) if cuda else "cpu",
                      count=spec["cell"]["chips"], memory_peak_bytes=int(memory_peak))
    if trace:
        device_rec.update(busy_s=ctx["trace"]["busy_s"], window_s=ctx["trace"]["wall_s"])
    failed = values["unresolved"] + values["lost"]
    result = dict(correct=all(c[3] for c in checks), attempted=len(judged), failed=failed,
                  metrics=metrics, device=device_rec)
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim, _ in checks}
    detail = dict(workload=workload, seed=seed, seconds=seconds, trace=bool(trace),
                  world_blobs=len(world["xw"]), frames_rendered=n_total,
                  window_frames=len(window), supply_frames=limit - warm,
                  window_end=window_end, window_s=window_s, setup_s=setup_s,
                  handed_s=[handed[j] - t0 for j in window],
                  resolved_s=[answers.by_frame[j][2] - t0 if j in answers.by_frame else None
                              for j in window],
                  stage_ms=ctx["stages"], track_stage_ms=ctx["track_stage_ms"],
                  local_ba=ctx["local_ba"], local_ba_applied=ba_applied, keyframes=len(live),
                  map_points=len(map_xyz), map_capacity=capacity,
                  resets=answers.resets, readings=values, e2e=e2e, precision=in_effect,
                  precision_after=in_effect_after,
                  after_window_s=dict(drain=drain_s, reference=reference_s),
                  trace_sessions=sessions, card=card(device) if cuda else None,
                  trace_gemms=tr.gemms(ctx["trace"]["kernels"]) if trace else None,
                  judged=judged,
                  poses=[answers.by_frame[j][0].astype(np.float32).ravel().tolist()
                         if j in answers.by_frame else None for j in judged],
                  tracked=[bool(answers.by_frame[j][1]) if j in answers.by_frame else False
                           for j in judged],
                  map_xyz=map_xyz.astype(np.float32).ravel().tolist())
    return dict(result=result, checks=checks, detail=detail, final_map=final_map, ba_map=ba_map)


def write_detail(detail: dict) -> str:
    """The run's detail file, under the temporary directory the
    environment gives (``TMPDIR``); a fixed name per cell, seed and mode."""
    d = os.path.join(tempfile.gettempdir(), "slambench")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{detail['workload']}.seed{detail['seed']}"
                           f".trace{int(detail['trace'])}.json")
    with open(path, "w") as f:
        json.dump(detail, f)
    return path
