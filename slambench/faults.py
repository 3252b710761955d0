"""Faults planted under the timed path, for the tests and for the readings
that a limit's upper end is set from: each patches the tracker while its
context is open.

- ``state_unchanged``: the step hands back the state it was given: after
  the warm-up, each frame's pose is the last one.
- ``answer_altered``: one answer changed where the tracker produces it
  (frame 30, the fifteenth after the warm-up, a metre and more from where
  the map began): its translation doubled, as a wrong sum would.
"""

from __future__ import annotations

import contextlib

import numpy as np

WARMUP = 15
ALTERED_FRAME = 30


def _unchanged(original):
    def _finalize(self, f, ok, pose, cur_mp):
        if self.last_pose is not None and self.frame_id > WARMUP:
            pose = self.last_pose
        return original(self, f, ok, pose, cur_mp)
    return _finalize


def _altered(original):
    def _finalize(self, f, ok, pose, cur_mp):
        if ok and self.frame_id == ALTERED_FRAME:
            pose = np.array(pose, copy=True)
            pose[:, 3] *= 2.0
        return original(self, f, ok, pose, cur_mp)
    return _finalize


FAULTS = {"state_unchanged": _unchanged, "answer_altered": _altered}


@contextlib.contextmanager
def planted(name: str):
    """Tracking._finalize patched with fault `name` inside the context."""
    from c_orb_slam_tpu_torch.tracking import Tracking

    original = Tracking._finalize
    Tracking._finalize = FAULTS[name](original)
    try:
        yield
    finally:
        Tracking._finalize = original
