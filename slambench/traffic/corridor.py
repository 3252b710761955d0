"""The one generator of the benchmark's traffic: a camera that travels
along a corridor of textured blobs and never comes back.

A mix (``traffic/<mix>.json``) gives the deployment's published pace and
the corridor's shape; this reads it. The corridor runs along a track in
the world's xz plane at ``track_deg`` from the camera's resting optical
axis (+z): 90 for a camera that looks across its track (a hand-held
camera panning along a room), 0 for one that looks along it (a car's
camera looking down a street). Its blobs are square billboards that fill
bands of ``cross_m`` across the track (depth in front of a panning camera,
the two sides of a street), ``y_m`` vertically (y points down), from
``behind_m`` behind the first frame to ``ahead_m`` beyond the last, at
``blobs_per_m`` per metre of track; sizes, intensities and micro-texture
tiles are those of the test suite's ``blob_world``.

The camera moves along the track at the steady pace at which its speed,
the cross-track sine included, is ``speed_m_s`` on average. It swings
across the track in a sine (``path.cross_m``, ``cross_period_s``) and
wobbles vertically as ``smooth_trajectory`` does. Its yaw is a sine that
turns at ``angular_deg_s`` on average (``"yaw": "sine"``), or follows its
own track (``"yaw": "track"``), as a car's heading does. The sines repeat,
so a longer run sees more of the same kind of view, not other views. The
seed draws the world, the tiles and the sines' phases. Everything is
float32 numpy on the host: some thousands of blobs.
"""

from __future__ import annotations

import math

import numpy as np


def pace(params: dict, rate: float) -> dict:
    """Per-frame pace from the mix's speeds and the sensor's frame rate:
    ``m_per_frame`` along the track, the amplitude (m a frame) and period
    (frames) of the cross-track sine's speed, and the yaw sine's period in
    frames (None where the yaw follows the track)."""
    p = params["path"]
    cross_period = p["cross_period_s"] * rate
    a_cross = 0.5 * (p["cross_m"][1] - p["cross_m"][0]) * 2.0 * math.pi / cross_period
    target = params["speed_m_s"] / rate
    phase = np.linspace(0.0, 2.0 * math.pi, 4096, endpoint=False)
    lo, hi = 0.0, target
    for _ in range(60):  # the mean of |(v, v_cross(t))| over a period is the speed
        v = 0.5 * (lo + hi)
        lo, hi = (v, hi) if np.mean(np.hypot(v, a_cross * np.cos(phase))) < target else (lo, v)
    yaw_period = None
    if p["yaw"] == "sine":
        y0, y1 = p["yaw_rad"]
        # A sine of amplitude A and period P turns 4A/P a frame on average.
        yaw_period = 2.0 * (y1 - y0) / (math.radians(params["angular_deg_s"]) / rate)
    return dict(m_per_frame=0.5 * (lo + hi), cross_period=cross_period, yaw_period=yaw_period)


def axes(track_deg: float):
    """Unit vectors of the track and of its cross direction in the world."""
    t = math.radians(track_deg)
    return np.array([math.sin(t), 0.0, math.cos(t)]), np.array([-math.cos(t), 0.0, math.sin(t)])


def generate(seed: int, params: dict, n_frames: int, rate: float) -> dict:
    """World and ground-truth path of `n_frames` frames at `rate` Hz.

    Returns ``xw`` (N, 3), ``intensity`` (N,), ``size`` (N,) (half the side
    of each square billboard, m), ``tiles`` (N, P, P) and ``poses`` (F, 3, 4)
    world-to-camera, all float32."""
    w, p = params["world"], params["path"]
    step = pace(params, rate)
    along, cross = axes(w["track_deg"])
    rng = np.random.default_rng(seed)
    a_lo = -w["behind_m"]
    a_hi = step["m_per_frame"] * (n_frames - 1) + w["ahead_m"]
    n = int(round(w["blobs_per_m"] * (a_hi - a_lo)))
    bands = np.asarray(w["cross_m"], np.float64)
    band = rng.integers(0, len(bands), size=n)
    a = rng.uniform(a_lo, a_hi, size=n)
    c = rng.uniform(bands[band, 0], bands[band, 1])
    y = rng.uniform(*w["y_m"], size=n)
    xw = (a[:, None] * along + c[:, None] * cross + y[:, None] * np.array([0.0, 1.0, 0.0]))
    intensity = rng.uniform(*w["intensity"], size=n).astype(np.float32)
    size = rng.uniform(*w["size_m"], size=n).astype(np.float32)
    tiles = rng.uniform(*w["tile_gain"], size=(n, w["tile"], w["tile"])).astype(np.float32)
    phase_cross, phase_yaw = rng.uniform(0.0, 2.0 * math.pi, size=2)
    return dict(xw=xw.astype(np.float32), intensity=intensity, size=size, tiles=tiles,
                poses=path(n_frames, step, p, along, cross, phase_cross, phase_yaw))


def path(n_frames: int, step: dict, p: dict, along, cross, phase_cross: float,
         phase_yaw: float) -> np.ndarray:
    """(F, 3, 4) world-to-camera poses (see the module docstring)."""
    i = np.arange(n_frames, dtype=np.float64)
    a = step["m_per_frame"] * i
    lo, hi = p["cross_m"]
    w_c = 2.0 * math.pi / step["cross_period"]
    c = 0.5 * (lo + hi) + 0.5 * (hi - lo) * np.sin(w_c * i + phase_cross)
    dc = 0.5 * (hi - lo) * w_c * np.cos(w_c * i + phase_cross)
    y = p["wobble_y_m"] * np.sin(p["wobble_y_rad_per_m"] * a)
    centre = a[:, None] * along + c[:, None] * cross + y[:, None] * np.array([0.0, 1.0, 0.0])
    if p["yaw"] == "track":
        v = step["m_per_frame"] * along + dc[:, None] * cross
        yaw = np.arctan2(v[:, 0], v[:, 2])  # the optical axis (sin yaw, 0, cos yaw) along v
    else:
        y0, y1 = p["yaw_rad"]
        yaw = 0.5 * (y0 + y1) + 0.5 * (y1 - y0) * np.sin(
            2.0 * math.pi * i / step["yaw_period"] + phase_yaw)
    return poses_of(centre, yaw)


def poses_of(t_wc: np.ndarray, yaw: np.ndarray) -> np.ndarray:
    """(F, 3, 4) float32 world-to-camera poses of cameras at centres `t_wc`
    (F, 3), turned by `yaw` (F,) about the y axis: yaw turns the optical
    axis from +z toward +x."""
    c, s = np.cos(yaw), np.sin(yaw)
    R_wc = np.zeros((len(yaw), 3, 3))
    R_wc[:, 0, 0], R_wc[:, 0, 2] = c, s
    R_wc[:, 1, 1] = 1.0
    R_wc[:, 2, 0], R_wc[:, 2, 2] = -s, c
    R_cw = np.transpose(R_wc, (0, 2, 1))
    t_cw = -np.einsum("fij,fj->fi", R_cw, t_wc)
    return np.concatenate([R_cw, t_cw[:, :, None]], axis=2).astype(np.float32)
