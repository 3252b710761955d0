"""Native (C++) image IO: decode and ordered prefetch, built with g++ at
first use; PIL reads what the native decoders cannot, where it is
installed (loader.py)."""

from c_orb_slam_tpu_torch.io.native.loader import (  # noqa: F401
    Prefetcher,
    decode_gray,
    decode_raw,
    native_available,
    native_decoders,
)
