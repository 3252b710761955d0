"""Host ms a window frame spends in the stereo SAD refinement: the
program's span `frame.stereo_sad` (the SAD parabola over the pyramid's
levels, the median-SAD trim and the depth), inside `frame_build`."""


def read(ctx):
    ms = ctx["stages"].get("frame.stereo_sad")
    return None if ms is None else ms / ctx["frames"]
