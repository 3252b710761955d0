"""Host ms a window frame spends in FAST detection and keypoint selection
over the pyramid's levels: the program's span `frame.detect`
(`detect_levels` and `select_levels`), summed over a frame's extractions
(two for a stereo pair), inside `frame_build`."""


def read(ctx):
    ms = ctx["stages"].get("frame.detect")
    return None if ms is None else ms / ctx["frames"]
