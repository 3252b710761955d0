"""Launch calls the host made in the profiler session, per traced frame
(cudaLaunchKernel, cuLaunchKernel and their kin; one graph launch counts one)."""


def read(ctx):
    t = ctx["trace"]
    if not t or not t["launches"]:
        return None
    return t["launches"] / t["frames"]
