"""Map checkpoint / resume: save and load the full SLAM state.

Counterpart of c_orb_slam_tpu/io/checkpoint.py, in the same npz format:
the same field names, dtypes and scalar fields, so a map saved by either
package loads in the other. The reference never implemented this (its
`SaveMap/LoadMap` TODO, include/System.h:115-117). The map is a
struct-of-arrays (slam_map/mapstate.py), so a checkpoint is one
compressed npz of those arrays plus scalar counters; the BoW vocabulary,
needed to relocalize into the stored map, rides along in the same file.

Vocabulary node descriptors are uint32 in the file, as the JAX package
writes them; the port holds them as (n, 8) int32 with the same bits, and
converts at this boundary in both directions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from c_orb_slam_tpu_torch.bow import vocab as vocab_mod
from c_orb_slam_tpu_torch.config import SlamConfig
from c_orb_slam_tpu_torch.slam_map.mapstate import MapState

_ARRAY_FIELDS = [
    "kf_pose", "kf_valid", "kf_frame_id", "kf_serial", "kf_timestamp",
    "kf_xy", "kf_octave", "kf_angle",
    "kf_desc", "kf_ur", "kf_depth", "kf_kp_valid", "kf_mp",
    "pt_xyz", "pt_desc", "pt_normal", "pt_min_dist", "pt_max_dist",
    "pt_valid", "pt_ref_kf", "pt_first_kf", "pt_visible", "pt_found",
    "pt_replaced_by", "pt_serial", "pt_obs_kf", "pt_obs_feat", "pt_n_obs",
    "covis", "spanning_parent",
]
_SCALAR_FIELDS = [
    "n_keyframes", "n_added_keyframes", "n_added_points", "big_change_idx",
]


def save_map(path: str, mapstate: MapState, vocabulary: Optional[vocab_mod.Vocabulary] = None):
    """Write the map (and the vocabulary, if given) to one .npz file."""
    data = {f: getattr(mapstate, f) for f in _ARRAY_FIELDS}
    for f in _SCALAR_FIELDS:
        data[f] = np.asarray(getattr(mapstate, f))
    if vocabulary is not None:
        data["voc_k"] = np.asarray(vocabulary.k)
        data["voc_L"] = np.asarray(vocabulary.L)
        data["voc_levels_up"] = np.asarray(vocabulary.levels_up)
        data["voc_word_weight"] = vocabulary.word_weight.cpu().numpy()
        for l in range(vocabulary.L):
            data[f"voc_level_{l}"] = vocabulary.levels[l].cpu().numpy().view(np.uint32)
            data[f"voc_valid_{l}"] = vocabulary.valid[l].cpu().numpy()
    np.savez_compressed(path, **data)


def load_map(path: str, cfg: SlamConfig, device) -> tuple[MapState, Optional[vocab_mod.Vocabulary]]:
    """Rebuild (MapState, Vocabulary or None) from a checkpoint; the map's
    device mirror and the vocabulary live on `device`.

    Stored capacities win over cfg capacities (arrays are loaded as they
    are); cfg supplies everything else (thresholds, camera, ...). The
    mirror is built at its first use, from the loaded arrays, so every
    loaded row reaches the device before the first dispatch.
    """
    device = torch.device(device)
    with np.load(path, allow_pickle=False) as z:
        m = MapState(cfg, compute_device=device)
        for f in _ARRAY_FIELDS:
            if f in z:
                setattr(m, f, z[f].copy())
        for f in _SCALAR_FIELDS:
            if f in z:
                setattr(m, f, int(z[f]))
        if "kf_serial" not in z:
            # Pre-serial checkpoint: slots were never recycled, so slot id
            # order is insertion order.
            m.kf_serial[: m.n_keyframes] = np.arange(m.n_keyframes)
        if "n_added_keyframes" not in z:
            m.n_added_keyframes = m.n_keyframes
        if "pt_serial" not in z:
            # Pre-serial checkpoint: give live points fresh serials.
            live = np.nonzero(m.pt_valid)[0]
            m.pt_serial[live] = np.arange(len(live))
            m.n_added_points = len(live)
        voc = None
        if "voc_k" in z:
            L = int(z["voc_L"])
            voc = vocab_mod._from_numpy(
                int(z["voc_k"]), L,
                [z[f"voc_level_{l}"] for l in range(L)],
                [z[f"voc_valid_{l}"] for l in range(L)],
                z["voc_word_weight"], int(z["voc_levels_up"]), device,
            )
    return m, voc
