"""Faults planted under the timed path, for the tests and for the readings
that a limit's upper end is set from: each patches the program while its
context is open.

- ``state_unchanged``: the step hands back the state it was given: after
  the warm-up, each frame's pose is the last one.
- ``answer_altered``: one answer changed where the tracker produces it
  (frame 30, the fifteenth after the warm-up, a metre and more from where
  the map began): its translation doubled, as a wrong sum would.
- ``ba_rounded``: every local BA's answer, its keyframe poses and its
  points, rounded to a 10-bit mantissa (float16's, and TF32's) where the
  mapper applies it (``LocalMapping._ba_apply``): a lower precision that
  reaches the monocular mapper on any device, the CPU included.
"""

from __future__ import annotations

import contextlib

import numpy as np

WARMUP = 15
ALTERED_FRAME = 30
MANTISSA_BITS = 10


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


def round_mantissa(x: np.ndarray, bits: int = MANTISSA_BITS) -> np.ndarray:
    """float32 `x` rounded to nearest (ties to even) on a `bits`-bit
    mantissa, float32 still; finite values only."""
    drop = 23 - bits
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    half = np.uint64(1 << (drop - 1)) - np.uint64(1) + ((u >> np.uint64(drop)) & np.uint64(1))
    u = (u + half) & ~np.uint64((1 << drop) - 1)
    return u.astype(np.uint32).view(np.float32).reshape(np.shape(x))


class _Rounded:
    """A BA readback whose poses and points come back rounded."""

    def __init__(self, fut):
        self.fut = fut

    def result(self):
        cam_T, points, inlier = self.fut.result()
        return round_mantissa(cam_T), round_mantissa(points), inlier


def _ba_rounded(original):
    def _ba_apply(self):
        if self._pending_ba is not None and not isinstance(self._pending_ba[-1], _Rounded):
            self._pending_ba = (*self._pending_ba[:-1], _Rounded(self._pending_ba[-1]))
        return original(self)
    return _ba_apply


# name -> (the module of the patched class, the class, its method, the patch)
FAULTS = {
    "state_unchanged": ("c_orb_slam_tpu_torch.tracking", "Tracking", "_finalize", _unchanged),
    "answer_altered": ("c_orb_slam_tpu_torch.tracking", "Tracking", "_finalize", _altered),
    "ba_rounded": ("c_orb_slam_tpu_torch.mapping", "LocalMapping", "_ba_apply", _ba_rounded),
}


@contextlib.contextmanager
def planted(name: str):
    """The method that fault `name` breaks, patched inside the context."""
    import importlib

    module, cls_name, method, patch = FAULTS[name]
    cls = getattr(importlib.import_module(module), cls_name)
    original = getattr(cls, method)
    setattr(cls, method, patch(original))
    try:
        yield
    finally:
        setattr(cls, method, original)
