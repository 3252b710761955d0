"""Local bundle adjustments applied per window frame
(`LocalMapping.n_local_ba` over the window)."""


def read(ctx):
    return ctx["local_ba"] / ctx["frames"]
