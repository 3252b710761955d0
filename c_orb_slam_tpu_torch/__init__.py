"""c_orb_slam_tpu_torch — the PyTorch + CUDA port of c_orb_slam_tpu (JAX).

The JAX package ``c_orb_slam_tpu`` is the reference; this package mirrors
its module paths (``ops/match.py`` here is the counterpart of
``ops/match.py`` there) and its public API (``System``, ``Tracking``,
``LocalMapping``, ``MapState``, ``DeviceMap``). It imports torch and
numpy, never jax, and nothing from the JAX package.

Every function takes its tensors on an explicit ``torch.device`` that the
caller chose (``System(cfg, device)`` carries it down); there is no global
default device. On a CUDA device the projection-window matcher and the
motion-only pose solve run the hand-written Hopper kernels
``csrc/window_top2.cu`` and ``csrc/pose_gn.cu`` (built at first use); on
the CPU they run the kernels' plain PyTorch versions.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry (pose chains, 3x3 rotations, Schur blocks) needs full float32,
# as in the JAX package (c_orb_slam_tpu/__init__.py pins
# jax_default_matmul_precision=float32). Matmuls default to float32 on a
# CUDA card, but cuDNN convolutions default to TF32 (~3 decimal digits):
# pin both so no path silently drops precision.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from c_orb_slam_tpu_torch.config import SlamConfig, CameraConfig, OrbConfig  # noqa: E402,F401
