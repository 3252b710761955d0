"""Gray image writers with no dependency beyond numpy and the standard
library: binary PNM (P5) and PNG, 8- or 16-bit, and a TUM RGB-D tree of
them. They write the rendered dataset trees that the drivers read back
(the tests, chip_smoke.py and tools/eval_cli_kitti.py), on machines
without PIL too.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _gray(image: np.ndarray) -> np.ndarray:
    a = np.asarray(image)
    if a.ndim != 2 or a.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"need an (H, W) uint8 or uint16 array, not {a.dtype} {a.shape}")
    return a


def write_pgm(path: str, image: np.ndarray):
    """Binary PGM (P5); 16-bit samples big-endian, as the format says."""
    a = _gray(image)
    maxval = 255 if a.dtype == np.uint8 else 65535
    with open(path, "wb") as f:
        f.write(f"P5\n{a.shape[1]} {a.shape[0]}\n{maxval}\n".encode())
        f.write(a.astype(">u2").tobytes() if a.dtype == np.uint16 else a.tobytes())


def write_png(path: str, image: np.ndarray):
    """Gray PNG, bit depth 8 or 16, rows unfiltered."""
    a = _gray(image)
    h, w = a.shape
    rows = a.astype(">u2") if a.dtype == np.uint16 else a
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rows.view(np.uint8).reshape(h, -1)], axis=1
    ).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8 * a.itemsize, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_tum_rgbd_tree(d: str, images, depths, stamps, depth_writer=write_png) -> str:
    """A TUM RGB-D sequence under d: rgb/<i>.pgm (uint8 images), depth/<i>
    (uint16 depth maps, PNG as TUM ships them, or PGM), rgb.txt and an
    associations file, whose path is returned; the drivers read it with
    datasets.load_tum_associations."""
    os.makedirs(os.path.join(d, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(d, "depth"), exist_ok=True)
    depth_ext = "png" if depth_writer is write_png else "pgm"
    rgb_lines, assoc = [], []
    for i, (img, depth, t) in enumerate(zip(images, depths, stamps)):
        rgb, dep = f"rgb/{i:06d}.pgm", f"depth/{i:06d}.{depth_ext}"
        write_pgm(os.path.join(d, rgb), img)
        depth_writer(os.path.join(d, dep), depth)
        rgb_lines.append(f"{t:.6f} {rgb}\n")
        assoc.append(f"{t:.6f} {rgb} {t:.6f} {dep}\n")
    with open(os.path.join(d, "rgb.txt"), "w") as f:
        f.write("# color images\n# file\n# timestamp filename\n" + "".join(rgb_lines))
    path = os.path.join(d, "associations.txt")
    with open(path, "w") as f:
        f.write("".join(assoc))
    return path
