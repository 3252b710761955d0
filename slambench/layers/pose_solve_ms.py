"""Host ms a window frame spends enqueueing the fused tracking step's two
pose solves: the program's spans `track.motion_pose` (the motion model's
Gauss-Newton) and `track.local_pose` (the local map's), inside
`track.dispatch`."""

SPANS = ("track.motion_pose", "track.local_pose")


def read(ctx):
    parts = [ctx["stages"][k] for k in SPANS if k in ctx["stages"]]
    return sum(parts) / ctx["frames"] if parts else None
