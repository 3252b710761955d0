"""Images and pyramids for FAST detection and keypoint selection
(ops/fast_select.py) at the shapes of extract_orb's callers. Used by
tests/test_torch_fast_select.py, tests/test_torch_fast_select_cuda.py and
chip_smoke.py's phase 1; numpy and torch only.
"""

import numpy as np
import torch

from c_orb_slam_tpu_torch.config import OrbConfig
from c_orb_slam_tpu_torch.ops import pyramid


def textured(h, w, seed=0, n_rects=None, noise=2.0):
    """A float32 (h, w) image in [0, 255]: a gradient, random rectangles of
    random grey levels (corners at every scale) and Gaussian noise (noise=0
    leaves every pixel an integer)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 60.0 + 60.0 * (xs / w) + 30.0 * (ys / h)
    for _ in range(n_rects if n_rects is not None else h * w // 400):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        dy, dx = rng.integers(2, max(3, h // 6)), rng.integers(2, max(3, w // 6))
        img[y0:y0 + dy, x0:x0 + dx] = rng.integers(0, 256)
    if noise:
        img = img + rng.normal(0.0, noise, img.shape)
    else:
        img = np.round(img)
    return np.clip(img, 0, 255).astype(np.float32)


def checkerboard(h, w, square=7, seed=0):
    """An integer-valued (h, w) image of squares of a few grey levels: many
    equal FAST scores, within a cell and across cells, for the tie order."""
    rng = np.random.default_rng(seed)
    tiles = rng.choice(np.float32([0, 90, 180, 250]), (h // square + 1, w // square + 1))
    return np.kron(tiles, np.ones((square, square), np.float32))[:h, :w].copy()


def blank(h, w):
    return np.full((h, w), 128.0, np.float32)


# (image, OrbConfig) of each case: the main path's shapes and the edges.
CASES = {
    "kitti_1241x376_2000": lambda: (textured(376, 1241, 1), OrbConfig(n_features=2000)),
    "tum_640x480_1000": lambda: (textured(480, 640, 2), OrbConfig(n_features=1000)),
    "euroc_752x480_1200": lambda: (textured(480, 752, 3), OrbConfig(n_features=1200)),
    "qvga_320x240_1000": lambda: (textured(240, 320, 4), OrbConfig(n_features=1000)),
    # 4 x cells < budget on every level: the pool is padded with zeros.
    "tiny_64x48_500": lambda: (textured(48, 64, 5, n_rects=12), OrbConfig(n_features=500)),
    "blank_640x480_1000": lambda: (blank(480, 640), OrbConfig(n_features=1000)),
    "integer_ties_640x480_1000": lambda: (checkerboard(480, 640), OrbConfig(n_features=1000)),
}


def levels_of(image, cfg, device):
    """The pyramid of an image on `device`, as extract_orb builds it."""
    img = torch.from_numpy(image).to(device)
    return pyramid.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
