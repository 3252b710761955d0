"""Host ms a window frame spends in loop closing: the stage `loop_stage`
(BoW detection, and the staged Sim3, correction and global BA chunks)."""


def read(ctx):
    ms = ctx["stages"].get("loop_stage")
    return None if ms is None else ms / ctx["frames"]
