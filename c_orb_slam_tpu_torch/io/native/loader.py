"""ctypes wrapper for the native image loader, built at first use.

Counterpart of c_orb_slam_tpu/io/native/loader.py. The reference links
OpenCV for imread (reference: Examples/*/*.cc); here a small C++ library
(image_loader.cc: PNM always, PNG and JPEG where libpng / libjpeg headers
exist, and an ordered multithreaded prefetcher) is compiled once with g++
into the package's ``_build/`` directory. A file the native decoders
cannot read goes to PIL where PIL is installed; where neither can read
it, the read raises.

Two reads: ``decode_gray`` gives luma in [0, 255] (16-bit images
rescaled, as the JAX package's loader does); ``decode_raw`` keeps the
stored values, 16-bit included, and is the read for depth maps (a TUM
depth PNG holds 5000 per metre: the [0, 255] read would truncate it).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "image_loader.cc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "_build")
_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False
build_log = ""

# The decoder sets to try, best first: every decoder whose header the
# compiler finds, linked to libpng and libjpeg; else PNM only, which links
# no library (the first fails where a library is missing).
_VARIANTS = (
    ([], ["-lpng", "-ljpeg", "-lz"]),
    (["-DCOSL_NO_PNG", "-DCOSL_NO_JPEG"], []),
)
_DECODER_BITS = (("pnm", 1), ("png", 2), ("jpeg", 4))


def _build(force: bool = False) -> Optional[str]:
    """Compile image_loader.cc unless an up-to-date build exists (or
    `force`); returns the library's path, or None when no variant compiles
    (build_log says why)."""
    global build_log
    os.makedirs(_BUILD_DIR, exist_ok=True)
    out = os.path.join(_BUILD_DIR, "libcosl_image.so")
    if not force and os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(_SRC):
        build_log = f"up to date: {out}"
        return out
    cxx = shutil.which(os.environ.get("CXX") or "g++") or shutil.which("g++")
    if cxx is None:
        build_log = "no C++ compiler on PATH ($CXX, g++)"
        return None
    logs = []
    for defines, libs in _VARIANTS:
        # Build beside the target and rename: processes that build at the
        # same time never load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [cxx, "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
               "-Wl,--no-undefined", *defines, _SRC, "-o", tmp, *libs, "-lstdc++", "-lpthread"]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            r = None
            logs.append(f"{' '.join(cmd)}: {e}")
        if r is not None and r.returncode == 0:
            os.replace(tmp, out)
            build_log = "\n".join(logs + [" ".join(cmd) + ": ok"])
            return out
        if os.path.exists(tmp):  # the linker removes its output when it fails
            os.unlink(tmp)
        if r is not None:
            logs.append(f"{' '.join(cmd)}: {r.stderr.strip()[-400:]}")
    build_log = "\n".join(logs)
    return None


def _load(path: Optional[str]) -> Optional[ctypes.CDLL]:
    global build_log
    if path is None:
        return None
    try:
        return ctypes.CDLL(path)
    except OSError as e:
        build_log += f"\n{path} does not load: {e}"
        return None


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED, build_log
    with _LIB_LOCK:
        if _LIB is not None or _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        path = _build()
        lib = _load(path)
        if lib is None and path is not None:
            # A build that does not load here (one copied from a machine
            # with other libraries or another CPU): build afresh.
            first = build_log
            lib = _load(_build(force=True))
            build_log = f"{first}\n{build_log}"
        if lib is None:
            return None
        lib.cosl_decoders.restype = ctypes.c_int
        lib.cosl_decoders.argtypes = []
        lib.cosl_decode.restype = ctypes.c_int
        lib.cosl_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.cosl_prefetch_create.restype = ctypes.c_void_p
        lib.cosl_prefetch_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.cosl_prefetch_next.restype = ctypes.c_int
        lib.cosl_prefetch_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.cosl_prefetch_destroy.restype = None
        lib.cosl_prefetch_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return _get_lib() is not None


def native_decoders() -> list[str]:
    """Formats the native build decodes (a subset of pnm, png, jpeg)."""
    lib = _get_lib()
    mask = lib.cosl_decoders() if lib is not None else 0
    return [name for name, bit in _DECODER_BITS if mask & bit]


def _decode_pil(path: str, raw: bool = False) -> np.ndarray:
    """PIL's read, for machines that have PIL; raises where it has not."""
    from PIL import Image

    with Image.open(path) as img:
        if img.mode not in ("L", "F", "I", "I;16", "I;16B"):
            img = img.convert("L")
        arr = np.asarray(img, dtype=np.float32)
    if not raw and arr.max() > 255.0:  # 16-bit gray
        arr = arr * (255.0 / 65535.0)
    return arr


def _decode(path: str, raw: bool, max_pixels: int) -> np.ndarray:
    lib = _get_lib()
    if lib is not None:
        buf = np.empty(max_pixels, np.float32)
        w, h = ctypes.c_int(), ctypes.c_int()
        rc = lib.cosl_decode(
            os.fsencode(path), int(raw), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_pixels, ctypes.byref(w), ctypes.byref(h),
        )
        if rc == 0:
            return buf[: w.value * h.value].reshape(h.value, w.value).copy()
    try:
        return _decode_pil(path, raw)
    except ImportError:
        raise OSError(
            f"cannot decode {path}: the native build reads {native_decoders() or 'nothing'} "
            f"and PIL is not installed"
        ) from None


def decode_gray(path: str, max_pixels: int = 1 << 24) -> np.ndarray:
    """Decode an image file to (H, W) float32 grayscale in [0, 255]."""
    return _decode(path, False, max_pixels)


def decode_raw(path: str, max_pixels: int = 1 << 24) -> np.ndarray:
    """Decode an image file to (H, W) float32 holding its stored values
    (0-65535 for a 16-bit file): the read for depth maps."""
    return _decode(path, True, max_pixels)


class Prefetcher:
    """Ordered lookahead decoder over a list of image paths.

    Iterating yields (index, (H, W) float32) in order while C++ worker
    threads decode up to `ahead` frames in advance; `raw` selects the
    read of decode_raw over that of decode_gray. A frame the native
    decoders cannot read, or a machine without the native library, goes
    through decode_gray / decode_raw, which raise if nothing can read it.
    """

    def __init__(self, paths: Sequence[str], n_threads: int = 3, ahead: int = 12,
                 max_pixels: int = 1 << 24, raw: bool = False):
        self._handle = None
        self.paths = [str(p) for p in paths]
        self.max_pixels = max_pixels
        self.raw = raw
        self._lib = _get_lib()
        self._next = 0
        if self._lib is not None and self.paths:
            self._paths_arr = (ctypes.c_char_p * len(self.paths))(
                *[os.fsencode(p) for p in self.paths]
            )  # kept alive while the workers read it
            self._handle = self._lib.cosl_prefetch_create(
                self._paths_arr, len(self.paths), n_threads, ahead, int(raw)
            )

    def __iter__(self):
        return self

    def __next__(self):
        if self._next >= len(self.paths):
            raise StopIteration
        i = self._next
        self._next += 1
        if self._handle is not None:
            buf = np.empty(self.max_pixels, np.float32)
            w, h = ctypes.c_int(), ctypes.c_int()
            rc = self._lib.cosl_prefetch_next(
                self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.max_pixels, ctypes.byref(w), ctypes.byref(h),
            )
            if rc == i:
                return i, buf[: w.value * h.value].reshape(h.value, w.value).copy()
        return i, _decode(self.paths[i], self.raw, self.max_pixels)

    def close(self):
        if self._handle is not None:
            self._lib.cosl_prefetch_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
