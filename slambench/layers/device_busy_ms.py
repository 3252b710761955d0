"""Device ms per traced frame in which some kernel ran: the union of the
kernels' intervals in the profiler session."""


def read(ctx):
    t = ctx["trace"]
    if not t or not t["kernels"]:
        return None
    return t["busy_s"] * 1e3 / t["frames"]
