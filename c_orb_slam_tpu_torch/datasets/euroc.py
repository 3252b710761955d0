"""EuRoC MAV dataset indexer.

Reference: Examples/Stereo/stereo_euroc.cc LoadImages (:177-216) — per-camera
`mav0/cam{0,1}/data.csv` (`timestamp_ns,filename`) with frames in
`mav0/cam{0,1}/data/`; left/right pairs share the nanosecond timestamp.
The EuRoC stereo pair is NOT pre-rectified: the reference builds
cv::initUndistortRectifyMap from the LEFT.*/RIGHT.* YAML blocks (:72-98)
and remaps every frame — the equivalent here is frontend/rectify.py.
"""

from __future__ import annotations

import os


def _load_cam_csv(cam_dir: str):
    stamps, paths = [], []
    with open(os.path.join(cam_dir, "data.csv")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, name = line.split(",")[:2]
            stamps.append(int(ts))
            paths.append(os.path.join(cam_dir, "data", name.strip()))
    return stamps, paths


def load_euroc(mav_dir: str, stereo: bool = True):
    """-> (timestamps_sec, left_paths, right_paths|None); pairs matched by
    identical nanosecond timestamp (unmatched frames dropped)."""
    s0, p0 = _load_cam_csv(os.path.join(mav_dir, "cam0"))
    if not stereo:
        return [t * 1e-9 for t in s0], p0, None
    s1, p1 = _load_cam_csv(os.path.join(mav_dir, "cam1"))
    right_by_ts = dict(zip(s1, p1))
    stamps, left, right = [], [], []
    for t, p in zip(s0, p0):
        q = right_by_ts.get(t)
        if q is not None:
            stamps.append(t * 1e-9)
            left.append(p)
            right.append(q)
    return stamps, left, right
