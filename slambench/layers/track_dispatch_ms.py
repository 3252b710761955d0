"""Host ms a window frame spends enqueueing the fused tracking step
(`Tracking.stage_ms["dispatch"]`: the two projection searches and two pose
solves of `_full_track_step`)."""


def read(ctx):
    ms = ctx["track_stage_ms"].get("dispatch")
    return None if ms is None else ms / ctx["frames"]
