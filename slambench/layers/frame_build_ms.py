"""Host ms a window frame spends in the `frame_build` stage (System.metrics):
the ORB extraction, and for a stereo pair the L x R match and SAD refinement."""


def read(ctx):
    ms = ctx["stages"].get("frame_build")
    return None if ms is None else ms / ctx["frames"]
