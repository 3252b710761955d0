"""TUM RGB-D dataset indexers.

Reference: Examples/Monocular/mono_tum.cc LoadImages (:126-155) parses
rgb.txt (`timestamp path` lines after a 3-line header); Examples/RGB-D/
rgbd_tum.cc (:138-167) parses an associations file
(`t_rgb rgb_path t_depth depth_path`) produced by the TUM associate.py
tool (README.md §6).
"""

from __future__ import annotations

import os


def _parse_lines(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            yield line.split()


def load_tum_rgb(sequence_dir: str):
    """-> (timestamps, rgb_paths) from <seq>/rgb.txt."""
    stamps, paths = [], []
    for parts in _parse_lines(os.path.join(sequence_dir, "rgb.txt")):
        stamps.append(float(parts[0]))
        paths.append(os.path.join(sequence_dir, parts[1]))
    return stamps, paths


def load_tum_associations(sequence_dir: str, associations_file: str):
    """-> (timestamps, rgb_paths, depth_paths) from an associations file."""
    stamps, rgb, depth = [], [], []
    for parts in _parse_lines(associations_file):
        stamps.append(float(parts[0]))
        rgb.append(os.path.join(sequence_dir, parts[1]))
        depth.append(os.path.join(sequence_dir, parts[3]))
    return stamps, rgb, depth
