"""KITTI odometry dataset indexer.

Reference: Examples/Stereo/stereo_kitti.cc LoadImages (:130-164) —
`times.txt` (one timestamp per line) plus `image_0/` (left) and
`image_1/` (right) directories of 6-digit .png frames.
"""

from __future__ import annotations

import os


def load_kitti(sequence_dir: str, stereo: bool = True):
    """-> (timestamps, left_paths, right_paths|None)."""
    with open(os.path.join(sequence_dir, "times.txt")) as f:
        stamps = [float(line) for line in f if line.strip()]
    left = [
        os.path.join(sequence_dir, "image_0", f"{i:06d}.png")
        for i in range(len(stamps))
    ]
    right = (
        [
            os.path.join(sequence_dir, "image_1", f"{i:06d}.png")
            for i in range(len(stamps))
        ]
        if stereo
        else None
    )
    return stamps, left, right
